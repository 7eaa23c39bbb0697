// One-token decode attention read straight out of the paged KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention
//   (Pallas `_decode_kernel`), with bf16, int8 and int4 pools.
//
// Computes, for batch row b with newest position lp = last_pos[b], the row
// math of decode_common.cuh over the block-table row tbl[b]; rows with
// lp < 0 output exact zeros.  Quantized pools dequantize each K/V element
// in registers as bf16(f32(q) * scale) before it enters the dot.
//
// What bounds it on the card: each step reads every live K/V token once
// (2 * ctx * KV * hd * bytes per element, plus two f32 scales per token and
// head for a quantized pool) for ~4*H*hd operations per token, so it is
// bound by memory; at serving batch sizes the pool slice is small and the
// kernel is bound by latency instead.  What the design does about it: one
// CTA per (batch row, KV head) reads its own block-table row (no scalar
// prefetch on this card) and stops loading at lp, so the work follows the
// live context, not the table's capacity; the G query heads of the group
// share each K/V read (decode_common.cuh).
#include "decode_common.cuh"

namespace {

using namespace decode_common;

template <int HD, int MAXG, typename PoolT>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const PoolT* __restrict__ kpool,           // [P, ps, KV, HD (int4: HD/2)]
    const PoolT* __restrict__ vpool,
    const float* __restrict__ kscale,          // [P, ps, KV, 1] or unused
    const float* __restrict__ vscale,
    const int* __restrict__ tbl,               // [B, pps]
    const int* __restrict__ last_pos,          // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    int H, int KV, int G, int P, int ps, int pps, int window, float scale) {
  const int b = blockIdx.x, hk = blockIdx.y;
  const size_t head0 = (size_t)b * H + (size_t)hk * G;
  attend_row<HD, MAXG>(q + head0 * HD, kpool, vpool, kscale, vscale,
                       tbl + (size_t)b * pps, last_pos[b], out + head0 * HD,
                       hk, KV, G, P, ps, window, scale);
}

template <int HD, int MAXG, typename PoolT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tbl, const void* lp, void* out, int B,
           int H, int KV, int P, int ps, int pps, int window, float scale,
           cudaStream_t st) {
  dim3 grid(B, KV);
  paged_decode_kernel<HD, MAXG, PoolT><<<grid, NW * 32, 0, st>>>(
      (const __nv_bfloat16*)q, (const PoolT*)kp, (const PoolT*)vp,
      (const float*)ks, (const float*)vs, (const int*)tbl, (const int*)lp,
      (__nv_bfloat16*)out, H, KV, H / KV, P, ps, pps, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for anything but head dim 64
// with at most 8 query heads per KV head (the ported configurations) and a
// pool kind of decode_common.cuh's PoolKind.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* tbl,
                                   const void* lp, void* out, int B, int H,
                                   int KV, int hd, int P, int ps, int pps,
                                   int window, int pool_kind, float scale,
                                   void* stream) {
  if (hd != 64 || H % KV || H / KV > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pool_kind) {
    case decode_common::POOL_BF16:
      return launch<64, 8, __nv_bfloat16>(q, kp, vp, ks, vs, tbl, lp, out, B,
                                          H, KV, P, ps, pps, window, scale, st);
    case decode_common::POOL_INT8:
      return launch<64, 8, int8_t>(q, kp, vp, ks, vs, tbl, lp, out, B, H, KV,
                                   P, ps, pps, window, scale, st);
    case decode_common::POOL_INT4:
      return launch<64, 8, uint8_t>(q, kp, vp, ks, vs, tbl, lp, out, B, H, KV,
                                    P, ps, pps, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
