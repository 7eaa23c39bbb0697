// W4A16 GEMM: float activations (bf16 or f32) times planar int4 weights,
// with scales per output channel or per group of the contraction.
//
// Replaces: src/repro/kernels/w4a16_matmul.py::w4a16_matmul
//   (Pallas `_kernel_per_channel`, `_kernel_grouped`).
//
// With w_q[k, n] the int4 value of the planar K-major weight (byte
// w_km[r, n] holds row r in its low nibble and row r + Kh in its high
// nibble), computes in f32
//   per channel: out[m, n] = (sum_k x[m, k] * w_q[k, n]) * s[n]
//   grouped:     out[m, n] = sum_g (sum_{k in g} x[m, k] * w_q[k, n]) * s[g, n]
// Each group's partial sum is scaled before it is added to the total, as
// `_kernel_grouped` does; the weight tile is never scaled.  Both widen x and
// the nibble to f32 and accumulate with FFMA, which is right for bf16 and
// f32 activations alike (a bf16 value times an int4 value is exact in f32).
// Grouped weights are packed with K padded to a multiple of 2G, so each
// planar half covers whole groups: the low plane holds groups 0 .. Kh/G - 1
// and the high plane the rest, padding groups (index >= n_groups) hold zero
// weights and read no scale.
//
// What bounds it on the card: at decode (M = 1..8) the packed weight bytes
// (K * N / 2) and, grouped, the scales (K/G * N * 4 bytes) dominate: the
// kernel is bound by memory.  At prefill (M = 256) it does 2*M*K*N
// operations and would be bound by the bf16 tensor-core rate; this kernel
// runs on CUDA cores.  What the design does about it: the weight is read from
// device memory once per CTA row-block as packed nibbles and widened only in
// shared memory; the x tile is staged once per k-step and reused across the
// CTA's 64 columns; scales are read once per group per output.  No tensor
// cores yet: a later change moves the bf16 path to mma.sync / wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per CTA
constexpr int BKH = 32;       // packed weight rows per k-step (both planes)
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sext4(uint32_t nib) {
  return (float)((int)(nib ^ 8u) - 8);
}

template <int BM, typename T, bool GROUPED>
__global__ void __launch_bounds__(THREADS) w4a16_kernel(
    const T* __restrict__ x,              // [M, K] row-major
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ scale,      // [N], or grouped [n_groups, N]
    float* __restrict__ out,              // [M, N]
    int M, int K, int N, int Kh, int G, int n_groups) {
  constexpr int TM = BM / 16;   // rows per thread
  constexpr int TN = BN / 16;   // columns per thread
  __shared__ float Xs[2][BKH][BM + 4];  // [plane][k][m]
  __shared__ float Ws[2][BKH][BN];      // [plane][k][n] int4 values

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float part[2][TM][TN];        // per plane: the current group's sums
  float total[TM][TN];          // grouped: the scaled groups so far
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      part[0][i][j] = part[1][i][j] = 0.0f;
      total[i][j] = 0.0f;
    }

  int r0 = 0;
  while (r0 < Kh) {
    // a k-step never crosses a group boundary (Kh is a multiple of G)
    int step = min(BKH, Kh - r0);
    if constexpr (GROUPED) step = min(step, G - r0 % G);
    for (int e = tid; e < 2 * BKH * BM; e += THREADS) {
      const int p = e / (BKH * BM), rem = e % (BKH * BM);
      const int m = rem / BKH, kk = rem % BKH;
      const int gm = m0 + m, k = p * Kh + r0 + kk;
      Xs[p][kk][m] = (gm < M && kk < step && k < K)
                         ? to_f32(x[(size_t)gm * K + k]) : 0.0f;
    }
    for (int e = tid; e < BKH * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int gn = n0 + n;
      const uint32_t b = (kk < step && gn < N)
                             ? (uint32_t)w[(size_t)(r0 + kk) * N + gn] : 0u;
      Ws[0][kk][n] = sext4(b & 0xFu);
      Ws[1][kk][n] = sext4(b >> 4);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll 4
      for (int kk = 0; kk < BKH; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = Xs[p][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Ws[p][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            part[p][i][j] = fmaf(a[i], b[j], part[p][i][j]);
      }
    }
    __syncthreads();
    r0 += step;
    if constexpr (GROUPED) {
      if (r0 % G != 0 && r0 != Kh) continue;
      // the groups just finished: rows of the low plane in group g_lo, rows
      // of the high plane in group g_hi
      const int g_lo = (r0 - 1) / G, g_hi = (Kh + r0 - 1) / G;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + 16 * j;
        const float s_lo = (gn < N && g_lo < n_groups)
                               ? scale[(size_t)g_lo * N + gn] : 0.0f;
        const float s_hi = (gn < N && g_hi < n_groups)
                               ? scale[(size_t)g_hi * N + gn] : 0.0f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          total[i][j] += part[0][i][j] * s_lo;
          total[i][j] += part[1][i][j] * s_hi;
          part[0][i][j] = part[1][i][j] = 0.0f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      out[(size_t)gm * N + gn] =
          GROUPED ? total[i][j]
                  : (part[0][i][j] + part[1][i][j]) * scale[gn];
    }
  }
}

template <typename T, bool GROUPED>
void launch(const void* x, const void* w, const void* scale, void* out,
            int M, int K, int N, int Kh, int G, int n_groups,
            cudaStream_t st) {
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    w4a16_kernel<16, T, GROUPED><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)w, (const float*)scale, (float*)out, M,
        K, N, Kh, G, n_groups);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    w4a16_kernel<64, T, GROUPED><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)w, (const float*)scale, (float*)out, M,
        K, N, Kh, G, n_groups);
  }
}

}  // namespace

// x [M, K] bf16 (x_bf16 = 1) or f32; group_size 0 = per-channel scale [N],
// else scale [n_groups, N] with Kh a multiple of group_size
extern "C" int w4a16_launch(const void* x, int x_bf16, const void* w,
                            const void* scale, void* out, int M, int K, int N,
                            int Kh, int group_size, int n_groups,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = group_size, ng = n_groups;
  if (x_bf16) {
    if (G) launch<__nv_bfloat16, true>(x, w, scale, out, M, K, N, Kh, G, ng, st);
    else launch<__nv_bfloat16, false>(x, w, scale, out, M, K, N, Kh, G, ng, st);
  } else {
    if (G) launch<float, true>(x, w, scale, out, M, K, N, Kh, G, ng, st);
    else launch<float, false>(x, w, scale, out, M, K, N, Kh, G, ng, st);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
