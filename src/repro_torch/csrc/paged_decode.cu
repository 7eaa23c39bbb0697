// One-token decode attention read straight out of the paged KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_decode_attention
//   (Pallas `_decode_kernel`), bf16 pools.
//
// Computes, for batch row b with newest position lp = last_pos[b] and each
// query head h (KV head hk = h / G):
//   key t (0 <= t <= lp) lives at pool[tbl[b, t / ps], t % ps, hk]; a
//   sentinel table entry (== P) is clamped to page P - 1 and its positions
//   are masked like the reference does
//   s[t] = bf16(q[b,h] . k_t) * (1 / sqrt(hd)), masked unless t <= lp,
//          lp >= 0 and (window == 0 || lp - t < window)
//   out  = sum_t softmax(s)[t] * v_t; rows with lp < 0 output exact zeros.
//
// What bounds it on the card: each step reads every live K/V token once
// (2 * ctx * KV * hd * 2 bytes per row) for ~4*H*hd operations per token,
// so it is bound by memory; at serving batch sizes the pool slice is small
// and the kernel is bound by latency instead.  What the design does about
// it: one CTA per (batch row, KV head) reads its own block-table row (no
// scalar prefetch on this card); 8 warps walk the row's tokens 4 at a time
// with every lane holding hd/32 dims, so each token's K and V are one
// coalesced 2*hd-byte read shared by all G query heads of the group; each
// warp keeps an online softmax per head in registers, and the warps' partial
// (m, l, acc) merge once through shared memory.  Loads stop at lp, so the
// work follows the live context, not the table's capacity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;    // warps per CTA
constexpr int U = 4;     // tokens per warp per round

template <int HD, int MAXG>
__global__ void __launch_bounds__(NW * 32) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, H, HD]
    const __nv_bfloat16* __restrict__ kpool,   // [P, ps, KV, HD]
    const __nv_bfloat16* __restrict__ vpool,
    const int* __restrict__ tbl,               // [B, pps]
    const int* __restrict__ last_pos,          // [B]
    __nv_bfloat16* __restrict__ out,           // [B, H, HD]
    int H, int KV, int G, int P, int ps, int pps, int window, float scale) {
  constexpr int DPL = HD / 32;   // dims per lane
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][HD];

  const int b = blockIdx.x, hk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lp = last_pos[b];

  float qv[MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      acc[g][j] = 0.0f;
      qv[g][j] = g < G ? __bfloat162float(
                             q[((size_t)b * H + hk * G + g) * HD + lane * DPL + j])
                       : 0.0f;
    }
  }

  if (lp >= 0) {
    const int n_tok = lp + 1;
    const int t_start = window > 0 ? max(0, lp - window + 1) : 0;
    for (int t0 = t_start + warp * U; t0 < n_tok; t0 += NW * U) {
      float kk[U][DPL], vv[U][DPL];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u;
        ok[u] = t < n_tok;
        if (ok[u]) {
          int page = tbl[(size_t)b * pps + t / ps];
          page = min(page, P - 1);
          const size_t base =
              (((size_t)page * ps + t % ps) * KV + hk) * HD + lane * DPL;
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            kk[u][j] = __bfloat162float(kpool[base + j]);
            vv[u][j] = __bfloat162float(vpool[base + j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < DPL; ++j) kk[u][j] = vv[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) continue;
        float s[U];
        float cmax = NEG_INF;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.0f;
#pragma unroll
          for (int j = 0; j < DPL; ++j) part += qv[g][j] * kk[u][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          part = __bfloat162float(__float2bfloat16_rn(part)) * scale;
          s[u] = ok[u] ? part : NEG_INF;
          cmax = fmaxf(cmax, s[u]);
        }
        const float m_new = fmaxf(m[g], cmax);
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? expf(s[u] - m_new) : 0.0f;
          l[g] += p;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[g][j] += p * vv[u][j];
        }
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) sm_acc[warp][g][lane * DPL + j] = acc[g][j];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * HD; e += NW * 32) {
    const int g = e / HD, d = e % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    const float o = (lp >= 0 && L > 0.0f) ? A / L : 0.0f;
    out[((size_t)b * H + hk * G + g) * HD + d] = __float2bfloat16_rn(o);
  }
}

template <int HD, int MAXG>
int launch(const void* q, const void* kp, const void* vp, const void* tbl,
           const void* lp, void* out, int B, int H, int KV, int P, int ps,
           int pps, int window, float scale, cudaStream_t st) {
  dim3 grid(B, KV);
  paged_decode_kernel<HD, MAXG><<<grid, NW * 32, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kp,
      (const __nv_bfloat16*)vp, (const int*)tbl, (const int*)lp,
      (__nv_bfloat16*)out, H, KV, H / KV, P, ps, pps, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for anything but head dim 64
// with at most 8 query heads per KV head (the ported configurations).
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* tbl,
                                   const void* lp, void* out, int B, int H,
                                   int KV, int hd, int P, int ps, int pps,
                                   int window, float scale, void* stream) {
  if (hd != 64 || H / KV > 8) return (int)cudaErrorInvalidValue;
  return launch<64, 8>(q, kp, vp, tbl, lp, out, B, H, KV, P, ps, pps, window,
                       scale, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
