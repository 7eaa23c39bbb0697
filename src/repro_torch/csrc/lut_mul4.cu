// Elementwise exact int4 x int4 -> int8 product through the 256-entry
// product table: out[i] = lut[(a[i] & 0xF) << 4 | (b[i] & 0xF)].
//
// Replaces: src/repro/kernels/lut_mul4.py::lut_mul4 (Pallas `_kernel_onehot`
//   and `_kernel_take`).  On the TPU the two strategies are two ways to read
//   a table (a one-hot contraction on the MXU, a lane gather on the VPU);
//   on this card both are one shared-memory read, so they are one kernel.
//
// What bounds it on the card: memory; each element reads two bytes and
// writes one, and the table read is on chip.  What the design does about
// it: the 256-byte table (ref.make_product_lut) is copied into shared
// memory once per CTA, and a grid-stride loop keeps consecutive threads on
// consecutive bytes so every warp's loads and stores coalesce.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) lut_mul4_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const int8_t* __restrict__ lut, int8_t* __restrict__ out, long long n) {
  __shared__ int8_t T[256];
  for (int e = threadIdx.x; e < 256; e += THREADS) T[e] = lut[e];
  __syncthreads();
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const uint32_t idx = (((uint32_t)(uint8_t)a[i] & 0xFu) << 4)
                         | ((uint32_t)(uint8_t)b[i] & 0xFu);
    out[i] = T[idx];
  }
}

}  // namespace

extern "C" int lut_mul4_launch(const void* a, const void* b, const void* lut,
                               void* out, long long n, int n_blocks,
                               void* stream) {
  lut_mul4_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const int8_t*)lut, (int8_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
