"""int4 quantization, the quantized linear layer and quantization plans."""
