// Table-lookup W4A4 GEMM: every int4 x int4 product is read from the 16x256
// per-nibble product tables, never multiplied; the reads are summed in int32.
// The paper's 4-bit LUT multiplier, tiled across a GEMM.
//
// Replaces: src/repro/kernels/lut4_matmul.py::lut4_matmul (Pallas `_kernel`).
//
// Computes out[m, n] = (float(acc[m, n]) * a_scale[m]) * w_scale[n] with
//   acc[m, n] = sum_r t_lo[a_q[m, r] & 0xF][w_km[r, n]]
//             + t_hi[a_q[m, r + Kh] & 0xF][w_km[r, n]]
// over the Kh = ceil(K / 2) packed rows of the planar K-major weight (byte
// w_km[r, n] holds row r in its low nibble and row r + Kh in its high).
// t_lo[a, byte] = sext4(a) * sext4(byte & 0xF) and t_hi[a, byte] =
// sext4(a) * sext4(byte >> 4) (kernels/packing.py nibble_product_tables):
// the row is the activation's unsigned nibble code, the column the packed
// weight byte, so the signed product of either nibble is one read.  Zero
// padding absorbs: code 0 selects the all-zero row, byte 0 zero products.
// The epilogue is the one of csrc/int4_matmul.cu in the same order, so on
// the same a_q and a_scale the result is that kernel's, bit for bit (the
// table holds the exact products and |acc| < 2^24).
//
// What bounds it on the card: the function is row 2's integer GEMM (2*M*K*N
// operations on K*N/2 weight bytes), bound by memory at decode and by the
// int8 rate at prefill.  This method does two shared-memory reads per
// product instead of a quarter of a __dp4a, so it is bound by shared-memory
// bandwidth well before either.  What the design does about it: the two
// tables (8 KiB) sit in shared memory for the CTA's life; the activation
// codes and weight bytes of a k-step are staged once in shared memory, the
// table row offset of each activation (code << 8) is formed once per row and
// k, and the inner loop is an OR, two table reads and two int32 adds per
// output.  Weights stay packed all the way: the tables index the byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output columns per CTA
constexpr int BKH = 32;       // packed weight rows per k-step
constexpr int THREADS = 256;
constexpr int TABLE = 16 * 256;

template <int BM>
__global__ void __launch_bounds__(THREADS) lut4_kernel(
    const int8_t* __restrict__ a_q,       // [M, K] int4 values
    const float* __restrict__ a_scale,    // [M]
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ w_scale,    // [N]
    const int8_t* __restrict__ t_lo,      // [16, 256]
    const int8_t* __restrict__ t_hi,      // [16, 256]
    float* __restrict__ out,              // [M, N]
    int M, int K, int N, int Kh) {
  constexpr int TM = BM / 16;   // rows per thread
  constexpr int TN = BN / 16;   // columns per thread
  __shared__ int8_t T[2][TABLE];
  __shared__ uint16_t Ac[2][BKH][BM + 2];  // [plane][k][m]: code << 8
  __shared__ uint8_t Ws[BKH][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int e = tid; e < TABLE; e += THREADS) {
    T[0][e] = t_lo[e];
    T[1][e] = t_hi[e];
  }
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int r0 = 0; r0 < Kh; r0 += BKH) {
    for (int e = tid; e < 2 * BKH * BM; e += THREADS) {
      const int p = e / (BKH * BM), rem = e % (BKH * BM);
      const int m = rem / BKH, kk = rem % BKH;
      const int gm = m0 + m, r = r0 + kk, k = p * Kh + r;
      const uint32_t code =
          (gm < M && r < Kh && k < K)
              ? ((uint32_t)(uint8_t)a_q[(size_t)gm * K + k] & 0xFu) : 0u;
      Ac[p][kk][m] = (uint16_t)(code << 8);
    }
    for (int e = tid; e < BKH * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int gn = n0 + n, r = r0 + kk;
      Ws[kk][n] = (r < Kh && gn < N) ? w[(size_t)r * N + gn] : (uint8_t)0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BKH; ++kk) {
      uint32_t lo[TM], hi[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        lo[i] = Ac[0][kk][ty + 16 * i];
        hi[i] = Ac[1][kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += (int)T[0][lo[i] | b[j]] + (int)T[1][hi[i] | b[j]];
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
      if (gn < N) out[(size_t)gm * N + gn] = ((float)acc[i][j] * sa) * w_scale[gn];
    }
  }
}

}  // namespace

extern "C" int lut4_launch(const void* a_q, const void* a_scale, const void* w,
                           const void* w_scale, const void* t_lo,
                           const void* t_hi, void* out, int M, int K, int N,
                           int Kh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    lut4_kernel<16><<<grid, THREADS, 0, st>>>(
        (const int8_t*)a_q, (const float*)a_scale, (const uint8_t*)w,
        (const float*)w_scale, (const int8_t*)t_lo, (const int8_t*)t_hi,
        (float*)out, M, K, N, Kh);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    lut4_kernel<64><<<grid, THREADS, 0, st>>>(
        (const int8_t*)a_q, (const float*)a_scale, (const uint8_t*)w,
        (const float*)w_scale, (const int8_t*)t_lo, (const int8_t*)t_hi,
        (float*)out, M, K, N, Kh);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
