// The per-row body shared by the two decode kernels that read the paged KV
// pool in place: csrc/paged_decode.cu (one CTA per (batch row, KV head)) and
// csrc/ragged_decode.cu (one CTA per (packed token row, KV head)).  The two
// kernels differ only in how a CTA finds its block-table row and its last
// position; everything after that is `attend_row`, so a row gets bit for bit
// the same output from either kernel.
//
// Pools: bf16 [P, ps, KV, HD]; int8 [P, ps, KV, HD] or int4 [P, ps, KV, HD/2]
// (uint8, element 2i in the low nibble of byte i, 2i+1 in the high nibble)
// with f32 scales [P, ps, KV, 1].  A quantized element enters the dot as
// bf16(f32(q) * scale), the rounding of the reference's `_dequant_slab`
// (src/repro/kernels/paged_attention.py) and of the port's plain version.
//
// Row math, for newest position lp and each of the G query heads of KV head
// hk: key t (0 <= t <= lp) lives at pool[tbl_row[t / ps], t % ps, hk]; a
// sentinel table entry (== P) is clamped to page P - 1 (its positions lie
// past lp and are never loaded)
//   s[t] = bf16(q . k_t) * (1 / sqrt(HD)), kept unless window > 0 and
//          lp - t >= window
//   out  = sum_t softmax(s)[t] * v_t; lp < 0 outputs exact zeros.
// 8 warps walk the row's tokens 4 at a time, every lane holding HD/32 dims
// (at HD 64 a lane's 2 dims of an int4 row are exactly one packed byte), so
// each token's K and V are one coalesced read shared by all G query heads;
// each warp keeps an online softmax per head in registers and the warps'
// partial (m, l, acc) merge once through shared memory.  The arithmetic is
// written with the _rn intrinsics so no compiler contraction can make the
// two kernels round differently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_common {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;    // warps per CTA
constexpr int U = 4;     // tokens per warp per round

// pool element types, as the wrappers name them (kernels/paged_attention.py)
enum PoolKind : int { POOL_BF16 = 0, POOL_INT8 = 1, POOL_INT4 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dequant(int q, float scale) {
  return bf16_round(__fmul_rn((float)q, scale));
}

// The DPL dims lane*DPL .. lane*DPL + DPL - 1 of pool row `row`
// (= (page * ps + slot) * KV + head) as floats.
template <int HD, int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ pool,
                                         const float* __restrict__, size_t row,
                                         int lane, float (&out)[DPL]) {
  const __nv_bfloat16* p = pool + row * HD + lane * DPL;
#pragma unroll
  for (int j = 0; j < DPL; ++j) out[j] = __bfloat162float(p[j]);
}

template <int HD, int DPL>
__device__ __forceinline__ void load_row(const int8_t* __restrict__ pool,
                                         const float* __restrict__ scale,
                                         size_t row, int lane,
                                         float (&out)[DPL]) {
  const int8_t* p = pool + row * HD + lane * DPL;
  const float s = scale[row];
#pragma unroll
  for (int j = 0; j < DPL; ++j) out[j] = dequant(p[j], s);
}

template <int HD, int DPL>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ pool,
                                         const float* __restrict__ scale,
                                         size_t row, int lane,
                                         float (&out)[DPL]) {
  static_assert(DPL % 2 == 0, "a lane must hold whole packed int4 bytes");
  const uint8_t* p = pool + row * (HD / 2) + lane * (DPL / 2);
  const float s = scale[row];
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    const int b = p[i];
    out[2 * i] = dequant(((b & 0xF) ^ 8) - 8, s);
    out[2 * i + 1] = dequant(((b >> 4) ^ 8) - 8, s);
  }
}

// One row's attention for the G query heads of KV head hk: q and out point
// at the row's [G, HD] slice, tbl_row at its block-table row.  Every thread
// of the CTA (NW warps) must call it.
template <int HD, int MAXG, typename PoolT>
__device__ __forceinline__ void attend_row(
    const __nv_bfloat16* __restrict__ q, const PoolT* __restrict__ kpool,
    const PoolT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tbl_row, int lp,
    __nv_bfloat16* __restrict__ out, int hk, int KV, int G, int P, int ps,
    int window, float scale) {
  constexpr int DPL = HD / 32;   // dims per lane
  __shared__ float sm_m[NW][MAXG];
  __shared__ float sm_l[NW][MAXG];
  __shared__ float sm_acc[NW][MAXG][HD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float qv[MAXG][DPL], acc[MAXG][DPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      acc[g][j] = 0.0f;
      qv[g][j] = g < G ? __bfloat162float(q[g * HD + lane * DPL + j]) : 0.0f;
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
          const int page = min(tbl_row[t / ps], P - 1);
          const size_t row = ((size_t)page * ps + t % ps) * KV + hk;
          load_row<HD, DPL>(kpool, kscale, row, lane, kk[u]);
          load_row<HD, DPL>(vpool, vscale, row, lane, vv[u]);
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
          for (int j = 0; j < DPL; ++j) part = __fmaf_rn(qv[g][j], kk[u][j], part);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
          part = __fmul_rn(bf16_round(part), scale);
          s[u] = ok[u] ? part : NEG_INF;
          cmax = fmaxf(cmax, s[u]);
        }
        const float m_new = fmaxf(m[g], cmax);
        const float alpha = expf(__fsub_rn(m[g], m_new));
        l[g] = __fmul_rn(l[g], alpha);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = __fmul_rn(acc[g][j], alpha);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = ok[u] ? expf(__fsub_rn(s[u], m_new)) : 0.0f;
          l[g] = __fadd_rn(l[g], p);
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[g][j] = __fmaf_rn(p, vv[u][j], acc[g][j]);
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
      const float f = expf(__fsub_rn(sm_m[w][g], M));
      L = __fmaf_rn(sm_l[w][g], f, L);
      A = __fmaf_rn(sm_acc[w][g][d], f, A);
    }
    const float o = (lp >= 0 && L > 0.0f) ? __fdiv_rn(A, L) : 0.0f;
    out[e] = __float2bfloat16_rn(o);
  }
}

}  // namespace decode_common
