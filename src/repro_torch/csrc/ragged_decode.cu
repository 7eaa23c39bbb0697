// Ragged token-major attention over the paged KV pool: one launch for a flat
// pack of chunked-prefill rows and decode rows.
//
// Replaces: src/repro/kernels/ragged_attention.py::ragged_decode_attention
//   (Pallas `_ragged_kernel`), with bf16, int8 and int4 pools.
//
// Computes, for packed row t with table row slot = token_slot[t] and
// position tp = token_pos[t]: a padding row (slot < 0 or tp < 0) outputs
// exact zeros; any other row runs the row math of decode_common.cuh over
// the block-table row tbl[slot] with newest position tp.  The engine writes
// the step's K/V into the pool before this kernel runs, so `pos <= tp` is
// causal for a prefill-chunk row and last-token for a decode row.
//
// What bounds it on the card: the pages a row reads, ~2 * (tp + 1) * KV *
// hd * bytes per element, for ~4*H*hd operations per token, so memory; the
// least it could read is each live page once, however many rows of a
// chunk share it.  What the design does about it: the grid is (T, KV,
// nsplit), each row's context split across one cluster's CTAs by the
// table's width exactly as csrc/paged_decode.cu splits it, through the same
// body (decode_common.cuh: table entries loaded once, K/V rows in 16-byte
// loads shared by the G query heads, splits merged in rank order), so a
// decode-only pack gives, bit for bit, what csrc/paged_decode.cu gives for
// those rows.  A prefill chunk of n rows re-reads its request's pages once
// per row; sharing them across the chunk's rows, as csrc/flash_prefill.cu
// shares K/V tiles, is left for later.
#include "decode_common.cuh"

namespace {

using namespace decode_common;

template <int HD, int MAXG, typename PoolT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS<HD>) ragged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [T, H, HD]
    const PoolT* __restrict__ kpool,           // [P, ps, KV, HD (int4: HD/2)]
    const PoolT* __restrict__ vpool,
    const float* __restrict__ kscale,          // [P, ps, KV, 1] or unused
    const float* __restrict__ vscale,
    const int* __restrict__ tbl,               // [maxB, pps]
    const int* __restrict__ token_slot,        // [T]
    const int* __restrict__ token_pos,         // [T]
    __nv_bfloat16* __restrict__ out,           // [T, H, HD]
    int H, int KV, int G, int P, int ps, int maxB, int pps, int window,
    float scale, int split_tok) {
  extern __shared__ int tbl_s[];               // split_tok / ps entries
  const int t = blockIdx.x, hk = blockIdx.y;
  const size_t head0 = (size_t)t * H + (size_t)hk * G;
  const int slot = token_slot[t];
  // a padding row takes the body's lp < 0 path: exact zeros
  const int tp = slot < 0 ? -1 : token_pos[t];
  attend_split<HD, MAXG>(q + head0 * HD, kpool, vpool, kscale, vscale,
                         tbl + (size_t)min(max(slot, 0), maxB - 1) * pps, tp,
                         out + head0 * HD, hk, KV, G, P, ps, pps, window,
                         scale, split_tok, tbl_s);
}

template <int HD, int MAXG, typename PoolT>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tbl, const void* slot,
           const void* pos, void* out, int T, int H, int KV, int P, int ps,
           int maxB, int pps, int window, float scale, int split_tok,
           int nsplit, cudaStream_t st) {
  return launch_split(
      ragged_decode_kernel<HD, MAXG, PoolT>, T, KV, nsplit,
      (int)(split_tok / ps * sizeof(int)), (int)sizeof(Smem<HD, MAXG>), st,
      (const __nv_bfloat16*)q,
      (const PoolT*)kp, (const PoolT*)vp, (const float*)ks, (const float*)vs,
      (const int*)tbl, (const int*)slot, (const int*)pos,
      (__nv_bfloat16*)out, H, KV, H / KV, P, ps, maxB, pps, window, scale,
      split_tok);
}

// The instantiation of head dim hd (shape_ok has passed).
template <typename PoolT>
int launch_hd(int hd, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const void* tbl,
              const void* slot, const void* pos, void* out, int T, int H,
              int KV, int P, int ps, int maxB, int pps, int window,
              float scale, int split_tok, int nsplit, cudaStream_t st) {
  return hd == HD_LARGE
      ? launch<HD_LARGE, MAXG_LARGE, PoolT>(q, kp, vp, ks, vs, tbl, slot, pos,
                                            out, T, H, KV, P, ps, maxB, pps,
                                            window, scale, split_tok, nsplit,
                                            st)
      : launch<HD_SMALL, MAXG_SMALL, PoolT>(q, kp, vp, ks, vs, tbl, slot, pos,
                                            out, T, H, KV, P, ps, maxB, pps,
                                            window, scale, split_tok, nsplit,
                                            st);
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for a shape the kernel is
// not built for (decode_common.cuh `shape_ok`, as csrc/paged_decode.cu), a
// pool kind not of decode_common.cuh's PoolKind, or a split `plan_ok`
// refuses (the wrapper's `decode_plan_for`).
extern "C" int ragged_decode_launch(const void* q, const void* kp,
                                    const void* vp, const void* ks,
                                    const void* vs, const void* tbl,
                                    const void* slot, const void* pos,
                                    void* out, int T, int H, int KV, int hd,
                                    int P, int ps, int maxB, int pps,
                                    int window, int pool_kind, float scale,
                                    int split_tok, int nsplit, void* stream) {
  if (!shape_ok(hd, H, KV) || maxB < 1 || !plan_ok(pps, ps, split_tok, nsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pool_kind) {
    case POOL_BF16:
      return launch_hd<__nv_bfloat16>(hd, q, kp, vp, ks, vs, tbl, slot, pos,
                                      out, T, H, KV, P, ps, maxB, pps, window,
                                      scale, split_tok, nsplit, st);
    case POOL_INT8:
      return launch_hd<int8_t>(hd, q, kp, vp, ks, vs, tbl, slot, pos, out, T,
                               H, KV, P, ps, maxB, pps, window, scale,
                               split_tok, nsplit, st);
    case POOL_INT4:
      return launch_hd<uint8_t>(hd, q, kp, vp, ks, vs, tbl, slot, pos, out, T,
                                H, KV, P, ps, maxB, pps, window, scale,
                                split_tok, nsplit, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
