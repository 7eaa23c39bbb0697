"""Serve a small model under mixed-precision quantization plans and from a
quantized checkpoint with the PyTorch port, on an NVIDIA GPU: sensitive
sites (lm_head, block 0's attention) keep higher precision while the bulk
runs 4-bit.

Three acts:
  1. uniform plans: float vs weight-only int4 vs W4A4 on one trace;
  2. mixed plans: the ``w4a16_sensitive_fp`` and ``mixed_sensitive``
     presets and an inline plan string (``--quant-plan`` semantics);
  3. a quantized checkpoint: packed nibbles, scales and the plan saved,
     restored with no float master, and served with logits and tokens
     bit-identical to the same plan packed from the float masters.

    PYTHONPATH=src python examples/serve_quantized_torch.py
    PYTHONPATH=src python examples/serve_quantized_torch.py --device cpu

``--device cpu`` runs the kernels' plain PyTorch versions instead.
"""

import argparse

from repro_torch.launch.serve import serve


def show(tag, out):
    print(f"{tag:22s} decode={out['tokens_per_s']:8.1f} tok/s "
          f"p50={out['latency_p50_s'] * 1e3:7.1f} ms "
          f"p95={out['latency_p95_s'] * 1e3:7.1f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    common = dict(reduced=True, layers=2, layout="paged", max_batch=4,
                  requests=args.requests, rate=0.5, prompt_lens=(8, 16),
                  gen_lens=(8,), page_size=8, num_pages=48, max_ctx=64,
                  device=args.device)

    # -- 1. uniform plans ---------------------------------------------------
    for plan in ("*=float", "*=w4a16_packed;lm_head=float", "serve_w4a4"):
        show(plan, serve("qwen2-0.5b", quant_plan=plan, **common))

    # -- 2. mixed plans: presets and an inline rule string ------------------
    for plan in ("w4a16_sensitive_fp", "mixed_sensitive",
                 "block[0].*=float;ffn.*=w4a16;*=int_sim;lm_head=float"):
        show(plan[:22], serve("qwen2-0.5b", quant_plan=plan, **common))

    # -- 3. quantized checkpoint: save -> restore -> serve, verified --------
    out = serve("qwen2-0.5b", quant_plan="mixed_sensitive",
                quantized_ckpt=True, **common)
    q = out["quantized_ckpt"]
    show("from quantized ckpt", out)
    print(f"checkpoint: {q['quantized_bytes'] / 1e3:.0f} kB packed vs "
          f"{q['float_master_bytes'] / 1e3:.0f} kB float masters, "
          f"load {q['load_s'] * 1e3:.0f} ms")
    print("bit-identical logits vs plan-on-masters:",
          q["bit_identical_logits"], "| generated tokens match:",
          q["tokens_match"])
    assert q["bit_identical_logits"] and q["tokens_match"]
    return out


if __name__ == "__main__":
    main()
