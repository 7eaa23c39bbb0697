// W4A4 GEMM: with the activation quantize fused into the tile prologue, or
// on activations quantized beforehand.
//
// Replaces: src/repro/kernels/int4_matmul.py::int4_matmul_fused and
//   ::int4_matmul (Pallas `_call(fused=True / False)`, `_kernel`,
//   `_quantize_tile`).
//
// Computes out[m, n] = (float(acc[m, n]) * a_scale[m]) * w_scale[n] with
//   acc[m, n] = sum_k q(m, k) * w[k, n],
// where q(m, k) is, fused (FUSED = true):
//   clamp(rint(x[m, k] / a_scale[m]), -8, 7)   (IEEE division, round half
//   to even: the rounding of jnp.round / torch.round),
// and unfused (FUSED = false) the int8 a_q[m, k] handed in.  w is stored
// planar K-major: byte w_km[r, n] holds row r in its low nibble and row
// r + Kh in its high nibble (Kh = ceil(K / 2)).  The two variants share the
// weight tile, the __dp4a loop and the epilogue, so on the same a_q and
// a_scale they give the same bits.
//
// What bounds it on the card: at decode (M = 1..8) the packed weight bytes
// (K * N / 2) dominate, so the kernel is bound by memory; at prefill
// (M = 256) it does 2*M*K*N integer operations on ~K*N/2 weight bytes and is
// bound by the integer rate.  What the design does about it: weights are read
// from device memory once per CTA row-block as packed nibbles (4 bits each,
// never widened in device memory), the fused activation never round-trips
// device memory as int8 (quantized in the prologue into shared memory), and
// the inner product runs on __dp4a (four int8 products per instruction).  The
// nibble planes are expanded with one mask per 32-bit word and kept as
// signed nibble*16 bytes, so the accumulator carries a factor 16 that one
// arithmetic shift removes exactly at the end.  No tensor cores yet: a later
// change moves the inner product to mma.sync / wgmma s8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;             // output columns per CTA
constexpr int BKH = 64;            // packed weight rows per k-step
constexpr int HALF_WORDS = BKH / 4;    // int32 words per plane (4 k each)
constexpr int WORDS = 2 * HALF_WORDS;  // lo plane words, then hi plane words
constexpr int THREADS = 256;

template <int BM, bool FUSED>
__global__ void __launch_bounds__(THREADS) w4a4_kernel(
    const void* __restrict__ a,           // [M, K] row-major: f32 x (FUSED)
                                          // or int8 a_q
    const float* __restrict__ a_scale,    // [M]
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ w_scale,    // [N]
    float* __restrict__ out,              // [M, N]
    int M, int K, int N, int Kh) {
  constexpr int TM = BM / 16;   // rows per thread
  constexpr int TN = BN / 16;   // columns per thread
  __shared__ int As[BM][WORDS + 1];
  __shared__ int Bs[BN][WORDS + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int r0 = 0; r0 < Kh; r0 += BKH) {
    // A tile: quantize 4 consecutive k of one row into one int32 word.
    // Word wd < HALF_WORDS covers k = r0 + 4*wd .. (low plane); the rest
    // cover k = Kh + r0 + 4*(wd - HALF_WORDS) .. (high plane).
    for (int e = tid; e < BM * WORDS; e += THREADS) {
      const int m = e / WORDS, wd = e % WORDS;
      const int plane = wd / HALF_WORDS;
      const int r = r0 + (wd % HALF_WORDS) * 4;
      const int gm = m0 + m;
      uint32_t word = 0;
      if (gm < M) {
        const float s = a_scale[gm];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = r + u;
          const int k = plane * Kh + rr;
          int q = 0;
          if (rr < Kh && k < K) {
            if constexpr (FUSED) {
              const float* row = (const float*)a + (size_t)gm * K;
              float v = rintf(__fdiv_rn(row[k], s));
              v = fminf(fmaxf(v, -8.0f), 7.0f);
              q = (int)v;
            } else {
              q = ((const int8_t*)a)[(size_t)gm * K + k];
            }
          }
          word |= (uint32_t)(q & 0xFF) << (8 * u);
        }
      }
      As[m][wd] = (int)word;
    }
    // B tile: 4 packed rows of one column -> a low-plane word and a
    // high-plane word, each byte holding (signed nibble) * 16.
    for (int e = tid; e < BN * HALF_WORDS; e += THREADS) {
      const int n = e % BN, quad = e / BN;
      const int gn = n0 + n;
      uint32_t raw = 0;
      if (gn < N) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = r0 + quad * 4 + u;
          const uint32_t b = rr < Kh ? (uint32_t)w[(size_t)rr * N + gn] : 0u;
          raw |= b << (8 * u);
        }
      }
      Bs[n][quad] = (int)((raw << 4) & 0xF0F0F0F0u);
      Bs[n][HALF_WORDS + quad] = (int)(raw & 0xF0F0F0F0u);
    }
    __syncthreads();
#pragma unroll 4
    for (int wd = 0; wd < WORDS; ++wd) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + 16 * i][wd];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[tx + 16 * j][wd];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float sa = a_scale[gm];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[(size_t)gm * N + gn] = ((float)(acc[i][j] >> 4) * sa) * w_scale[gn];
    }
  }
}

template <bool FUSED>
int w4a4_launch_impl(const void* a, const void* a_scale, const void* w,
                     const void* w_scale, void* out, int M, int K, int N,
                     int Kh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    w4a4_kernel<16, FUSED><<<grid, THREADS, 0, st>>>(
        a, (const float*)a_scale, (const uint8_t*)w, (const float*)w_scale,
        (float*)out, M, K, N, Kh);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    w4a4_kernel<64, FUSED><<<grid, THREADS, 0, st>>>(
        a, (const float*)a_scale, (const uint8_t*)w, (const float*)w_scale,
        (float*)out, M, K, N, Kh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] f32: quantized per row in the prologue
extern "C" int w4a4_fused_launch(const void* x, const void* a_scale,
                                 const void* w, const void* w_scale, void* out,
                                 int M, int K, int N, int Kh, void* stream) {
  return w4a4_launch_impl<true>(x, a_scale, w, w_scale, out, M, K, N, Kh,
                                stream);
}

// a_q [M, K] int8 holding int4 values, quantized by the caller
extern "C" int w4a4_launch(const void* a_q, const void* a_scale,
                           const void* w, const void* w_scale, void* out,
                           int M, int K, int N, int Kh, void* stream) {
  return w4a4_launch_impl<false>(a_q, a_scale, w, w_scale, out, M, K, N, Kh,
                                 stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
