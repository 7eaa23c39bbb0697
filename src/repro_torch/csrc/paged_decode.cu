// One-token decode attention read straight out of the paged KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention
//   (Pallas `_decode_kernel`), with bf16, int8 and int4 pools.
//
// Computes, for batch row b with newest position lp = last_pos[b], the row
// math of decode_common.cuh over the block-table row tbl[b]; rows with
// lp < 0 output exact zeros.  Quantized pools dequantize each K/V element
// as bf16(f32(q) * scale) before it enters the dot.
//
// What bounds it on the card: each step reads every live K/V token once
// (2 * ctx * KV * hd * bytes per element, plus two f32 scales per token and
// head for a quantized pool) for ~4*H*hd operations per token, so it is
// bound by memory; at serving batch sizes the pool slice is a few hundred
// KB and the kernel is bound by latency: the chain of dependent global
// loads and the FMA chains each CTA walks.  What the design does about it:
// the grid is (B, KV, nsplit), each row's context split across the nsplit
// CTAs of one thread-block cluster (the rule's `split_plan`: at max_ctx
// 512, ps 16, 8 splits of 64 tokens, 128 CTAs at batch 8 with 2 KV heads;
// or a tuned split, 1 to 8 CTAs a row), each CTA
// loading its table entries once and then all its K/V rows at once in
// 16-byte loads, the G query heads of the group sharing each K/V read, and
// the splits merged through distributed shared memory in rank order: one
// launch a call, the same bits every call (decode_common.cuh).
#include "decode_common.cuh"

namespace {

using namespace decode_common;

template <int HD, int MAXG, typename PoolT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS<HD>) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const PoolT* __restrict__ kpool,           // [P, ps, KV, HD (int4: HD/2)]
    const PoolT* __restrict__ vpool,
    const float* __restrict__ kscale,          // [P, ps, KV, 1] or unused
    const float* __restrict__ vscale,
    const int* __restrict__ tbl,               // [B, pps]
    const int* __restrict__ last_pos,          // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    int H, int KV, int G, int P, int ps, int pps, int window, float scale,
    int split_tok) {
  extern __shared__ int tbl_s[];               // split_tok / ps entries
  const int b = blockIdx.x, hk = blockIdx.y;
  const size_t head0 = (size_t)b * H + (size_t)hk * G;
  attend_split<HD, MAXG>(q + head0 * HD, kpool, vpool, kscale, vscale,
                         tbl + (size_t)b * pps, last_pos[b], out + head0 * HD,
                         hk, KV, G, P, ps, pps, window, scale, split_tok,
                         tbl_s);
}

// An empty kernel of the decode kernels' grid, cluster, block and dynamic
// shared memory: the floor of a launch, for measurement only.
__global__ void __launch_bounds__(THREADS) decode_floor_kernel() {}

template <int HD, int MAXG, typename PoolT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tbl, const void* lp, void* out, int B,
           int H, int KV, int P, int ps, int pps, int window, float scale,
           int split_tok, int nsplit, cudaStream_t st) {
  return launch_split(
      paged_decode_kernel<HD, MAXG, PoolT>, B, KV, nsplit,
      (int)(split_tok / ps * sizeof(int)), (int)sizeof(Smem<HD, MAXG>), st,
      (const __nv_bfloat16*)q,
      (const PoolT*)kp, (const PoolT*)vp, (const float*)ks, (const float*)vs,
      (const int*)tbl, (const int*)lp, (__nv_bfloat16*)out, H, KV, H / KV, P,
      ps, pps, window, scale, split_tok);
}

// The instantiation of head dim hd (shape_ok has passed).
template <typename PoolT>
int launch_hd(int hd, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const void* tbl, const void* lp,
              void* out, int B, int H, int KV, int P, int ps, int pps,
              int window, float scale, int split_tok, int nsplit,
              cudaStream_t st) {
  return hd == HD_LARGE
      ? launch<HD_LARGE, MAXG_LARGE, PoolT>(q, kp, vp, ks, vs, tbl, lp, out,
                                            B, H, KV, P, ps, pps, window,
                                            scale, split_tok, nsplit, st)
      : launch<HD_SMALL, MAXG_SMALL, PoolT>(q, kp, vp, ks, vs, tbl, lp, out,
                                            B, H, KV, P, ps, pps, window,
                                            scale, split_tok, nsplit, st);
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for a shape the kernel is
// not built for (decode_common.cuh `shape_ok`: head dim 64 with at most 8
// query heads per KV head, or head dim 128 with at most 9), a pool kind
// not of decode_common.cuh's PoolKind, or a split `plan_ok` refuses (the
// wrapper's `decode_plan_for`).
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* ks,
                                   const void* vs, const void* tbl,
                                   const void* lp, void* out, int B, int H,
                                   int KV, int hd, int P, int ps, int pps,
                                   int window, int pool_kind, float scale,
                                   int split_tok, int nsplit, void* stream) {
  if (!shape_ok(hd, H, KV) || !plan_ok(pps, ps, split_tok, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pool_kind) {
    case POOL_BF16:
      return launch_hd<__nv_bfloat16>(hd, q, kp, vp, ks, vs, tbl, lp, out, B,
                                      H, KV, P, ps, pps, window, scale,
                                      split_tok, nsplit, st);
    case POOL_INT8:
      return launch_hd<int8_t>(hd, q, kp, vp, ks, vs, tbl, lp, out, B, H, KV,
                               P, ps, pps, window, scale, split_tok, nsplit,
                               st);
    case POOL_INT4:
      return launch_hd<uint8_t>(hd, q, kp, vp, ks, vs, tbl, lp, out, B, H, KV,
                                P, ps, pps, window, scale, split_tok, nsplit,
                                st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The empty kernel on the grid, cluster and shared memory a decode launch
// of `rows` rows over a table of pps pages of ps tokens takes.
extern "C" int decode_floor_launch(int rows, int KV, int ps, int pps,
                                   void* stream) {
  int split_tok, nsplit;
  split_plan(pps * ps, ps, &split_tok, &nsplit);
  return launch_split(decode_floor_kernel, rows, KV, nsplit,
                      (int)(split_tok / ps * sizeof(int)), 0,
                      (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
