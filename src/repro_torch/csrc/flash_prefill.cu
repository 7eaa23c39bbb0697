// Tiled causal GQA prefill attention with online softmax.
//
// Replaces: src/repro/kernels/paged_attention.py::flash_prefill
//   (Pallas `_prefill_kernel`).
//
// Computes, for every query row (b, i, h) with G = H / KV query heads per
// KV head hk = h / G:
//   s[t]   = bf16(q[b,i,h] . k[b,t,hk]) * (1 / sqrt(hd))   (scores rounded
//            to bf16 before the scale, as the bf16 dense path rounds them)
//   valid  = qpos[b,i] >= kpos[b,t] && kpos[b,t] >= 0
//            && (window == 0 || qpos[b,i] - kpos[b,t] < window)
//   out    = sum_t softmax(s)[t] * v[b,t,hk]   over valid t, else 0
// The mask comes only from the explicit position vectors: prompts are
// left-padded with position -1, so the iota is not causal.  Fully masked
// rows (padding queries) come out as exact zeros.
//
// What bounds it on the card: at the serving prompt lengths (<= a few
// hundred tokens) the work is ~4*H*hd operations per (query, key) pair on
// a few hundred KB of q/k/v, far below either roof; the kernel is bound by
// latency and occupancy.  What the design does about it: one CTA per
// (q tile, KV head, batch row); the G query heads of a group share each K/V
// tile staged once in shared memory (as f32), one thread owns one query row
// with its q vector and f32 accumulator in registers, keys are read as
// broadcasts from shared memory, and a K/V tile that no row of the CTA can
// see (beyond the tile's largest query position, or outside the window) is
// skipped.  No tensor cores yet: a later change moves QK and PV to mma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 32;   // keys per shared-memory tile
constexpr int CH = 8;    // keys per online-softmax update

template <int HD>
__global__ void flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Sq, H, HD]
    const __nv_bfloat16* __restrict__ k,   // [B, Skv, KV, HD]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ qpos,          // [B, Sq]
    const int* __restrict__ kpos,          // [B, Skv]
    __nv_bfloat16* __restrict__ out,       // [B, Sq, H, HD]
    int Sq, int Skv, int H, int KV, int G, int BQ, int window, float scale) {
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];
  __shared__ int Kp[BK];
  __shared__ int s_qmax, s_qmin;

  const int b = blockIdx.z, hk = blockIdx.y, i0 = blockIdx.x * BQ;
  const int t = threadIdx.x;
  const int g = t / BQ, i = t % BQ;
  const int qi = i0 + i;
  const bool active = g < G && qi < Sq;
  const int h = hk * G + g;
  const int qp = active ? qpos[(size_t)b * Sq + qi] : -1;

  if (t == 0) {
    s_qmax = -1;
    s_qmin = 0x7fffffff;
  }
  __syncthreads();
  if (qp >= 0) {
    atomicMax(&s_qmax, qp);
    atomicMin(&s_qmin, qp);
  }

  float qv[HD], acc[HD];
  if (active) {
    const __nv_bfloat16* qrow = q + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qv[d] = __bfloat162float(qrow[d]);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qv[d] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
  float m = NEG_INF, l = 0.0f;
  __syncthreads();
  const int qmax = s_qmax, qmin = s_qmin;

  for (int kt = 0; kt < Skv; kt += BK) {
    for (int e = t; e < BK * HD; e += blockDim.x) {
      const int r = e / HD, d = e % HD;
      const int kk = kt + r;
      float kv = 0.0f, vv = 0.0f;
      if (kk < Skv) {
        const size_t off = (((size_t)b * Skv + kk) * KV + hk) * HD + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      Ks[r][d] = kv;
      Vs[r][d] = vv;
    }
    for (int e = t; e < BK; e += blockDim.x)
      Kp[e] = (kt + e < Skv) ? kpos[(size_t)b * Skv + kt + e] : -1;
    __syncthreads();
    int useful = 0;
    if (t < BK) {
      const int kp = Kp[t];
      useful = kp >= 0 && kp <= qmax && (window == 0 || qmin - kp < window);
    }
    useful = __syncthreads_or(useful);

    if (useful && qp >= 0) {
      for (int c = 0; c < BK; c += CH) {
        float s[CH];
        bool ok[CH];
        float cmax = NEG_INF;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int kp = Kp[c + u];
          ok[u] = kp >= 0 && qp >= kp && (window == 0 || qp - kp < window);
          float dot = 0.0f;
          const float4* kr = reinterpret_cast<const float4*>(&Ks[c + u][0]);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kk4 = kr[d4];
            dot += qv[4 * d4] * kk4.x;
            dot += qv[4 * d4 + 1] * kk4.y;
            dot += qv[4 * d4 + 2] * kk4.z;
            dot += qv[4 * d4 + 3] * kk4.w;
          }
          dot = __bfloat162float(__float2bfloat16_rn(dot)) * scale;
          s[u] = ok[u] ? dot : NEG_INF;
          cmax = fmaxf(cmax, s[u]);
        }
        const float m_new = fmaxf(m, cmax);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const float p = ok[u] ? expf(s[u] - m_new) : 0.0f;
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(&Vs[c + u][0]);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 vv4 = vr[d4];
            acc[4 * d4] += p * vv4.x;
            acc[4 * d4 + 1] += p * vv4.y;
            acc[4 * d4 + 2] += p * vv4.z;
            acc[4 * d4 + 3] += p * vv4.w;
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float denom = l > 0.0f ? l : 1.0f;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = __float2bfloat16_rn(acc[d] / denom);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Skv, int H, int KV,
           int window, float scale, cudaStream_t st) {
  const int G = H / KV;
  const int threads = 64 * ((G + 63) / 64);
  const int BQ = threads / G;
  dim3 grid((Sq + BQ - 1) / BQ, KV, B);
  flash_prefill_kernel<HD><<<grid, threads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)qpos, (const int*)kpos,
      (__nv_bfloat16*)out, Sq, Skv, H, KV, G, BQ, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for a head dim other than 64
// (the one the ported configurations use).
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* kpos, void* out, int B, int Sq,
                                    int Skv, int H, int KV, int hd, int window,
                                    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
