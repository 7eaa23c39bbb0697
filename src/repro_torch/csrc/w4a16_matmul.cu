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
// `_kernel_grouped` does; the weight tile is never scaled.  A bf16 value
// times an int4 value is exact in f32, so every path below sums the same
// exact products and the paths differ only by f32 rounding in the order
// of the sums.  Grouped weights are packed with K padded to a multiple of
// 2G, so each planar half covers whole groups: the low plane holds groups
// 0 .. Kh/G - 1 and the high plane the rest, padding groups
// (index >= n_groups) hold zero weights and read no scale.
//
// Launch paths, picked by M and, above 16, by x's type and the group size:
//
// M <= 16 (every decode step): bound by bytes.  The packed weight
// (K * N / 2 bytes) and, grouped, the scales are read once and each byte
// feeds only 2 * M FFMA, so the card's 3.35 TB/s, not its FFMA rate, is the
// limit, and only many bytes in flight on every SM reach it.  The design:
// split K across CTAs (the plan, `splitk_plan` in kernels/w4a16_matmul.py:
// column tile, packed rows per split, number of splits; a grouped split
// lies inside one group of each plane) so that a (4864, 896) projection
// runs on hundreds of CTAs, not 14; each thread loads 16 neighbouring
// columns of one packed row as one 16-byte vector, eight rows in flight,
// issued with the epilogue's scale loads before x is staged, and widens
// the 32 nibbles in registers (PRMT into 2^23 + n, one FADD); only the
// split's x slice is staged in shared memory, once.  At most 64 sums a
// thread (two rows of x a CTA), so four CTAs fit an SM.  Each split sums its rows over the CTA in
// a fixed order (shuffles, then warps) and writes an f32 partial to a
// workspace [splits, M, N], grouped already scaled (low-plane sum *
// s[g_lo] + high-plane sum * s[g_hi]); a second kernel, launched early
// (programmatic dependent launch) to hide its launch, sums the splits in
// split order and, per channel, scales by s[n] after summing.  No atomics:
// two calls on the same inputs give the same bits.  Where N % 16 != 0 or the weight is not 16-byte aligned, the same
// kernel is instantiated with 1-byte loads.
//
// M > 16 (prefill), bf16 x, G % 16 == 0 or per channel: 2*M*K*N
// operations, bound by the bf16 tensor-core rate (989 TFLOP/s: 0.0077 ms
// for one qwen2-0.5b layer's projections at M = 256), far above what FFMA
// can reach.  The kernel (`w4a16_mma_kernel`) contracts on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 sums), as the Pallas kernel
// contracts bf16 x on the MXU: since x * q is exact in f32 either way, it
// computes what `_kernel_grouped` / `_kernel_per_channel` and their XLA
// twin compute (the port's plain version), up to f32 rounding, and not the
// JAX package's dequantize-then-round-to-bf16 CPU branch.  A CTA covers BM
// x 64 outputs with 4 warps (2 x 2, each BM / 2 x 32); BM is 64, or 32
// where 64-row tiles would leave SMs idle (the rule, `prefill_plan` in
// kernels/w4a16_matmul.py).  A k-step takes 32 packed rows of the weight:
// the same bytes feed the low plane (x columns r0 ..) and the high plane
// (x columns Kh + r0 ..), so two MMAs read each weight byte once.  x (both
// planes) and the weight bytes come into a 3-stage shared-memory ring by
// 16-byte cp.async (zero-filled past M, K, N and the step's rows), or by
// 2-byte / 1-byte loads where a row is not 16-byte aligned.  A fragments
// come from the x tile by ldmatrix; B fragments from the packed bytes by
// ldmatrix.trans, widened to bf16 in registers (the bits 0x4300 | (nib ^
// 8) are 128 + (nib ^ 8), minus 136 is the signed nibble, exactly: PRMT and
// one bf16x2 subtract per pair), one load for both planes; a fragment then
// holds every other column, which the epilogue undoes.  Grouped: the loop
// walks one group at a time (16-row k-steps where G % 32 != 0), requests
// the group's scales as it starts, keeps one f32 partial per plane and at
// its end adds part_lo * s[g_lo] + part_hi * s[g_hi] to the total; per
// channel one set of sums, times s[n] at the end.  No split K, no atomics:
// two calls give the same bits.  What bounds it on the card is each
// k-step's fixed cost in a CTA (about 0.5 us on an H100, issuing the x
// tile's cp.async the largest part), not memory latency: a deeper ring (up
// to 12 stages), 8 warps or 64-row k-steps moved little.  wgmma and TMA
// are a later change.
//
// f32 x, and bf16 x grouped with G % 16 != 0, keep the first port's tiled
// FFMA kernel (`w4a16_kernel`): a bf16 contraction would round f32 x, and
// a 16-deep step could not stay inside such a group.  The rule that picks
// the kernel is `prefill_plan` in kernels/w4a16_matmul.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 64;        // M > 16: output columns per CTA
constexpr int BKH = 32;       // M > 16: packed weight rows per k-step
constexpr int THREADS = 256;  // M > 16, FFMA: threads per CTA

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

// ------------------------------------- M > 16, bf16 x: tensor cores ----
constexpr int MMA_BM = 64;       // output rows per CTA at most (BN columns)
constexpr int MMA_THREADS = 128; // 4 warps, 2 x 2, each BM / 2 x 32 outputs
constexpr int MMA_STAGES = 3;    // k-steps in the shared-memory ring
constexpr int XS_LD = BKH + 8;   // x tile row, bf16: 80 bytes
constexpr int WS_LD = BN + 16;   // weight tile row, bytes: 80
// the widening: bf16 bits WIDEN_BITS | u are 128 + u for u = nib ^ 8 < 16,
// so minus WIDEN_BIAS they are u - 8, the signed nibble, exactly
constexpr uint32_t WIDEN_BITS = 0x4300u;
constexpr float WIDEN_BIAS = 136.0f;

// One ring slot a k-step; 80-byte rows keep the 8 rows of every ldmatrix
// on distinct banks.  bf16 values as their bits.
struct __align__(16) MmaSmem {
  uint16_t x[MMA_STAGES][2][MMA_BM][XS_LD];  // [stage][plane][m][k]
  uint8_t w[MMA_STAGES][BKH][WS_LD];         // [stage][row][n] packed bytes
};
static_assert(sizeof(MmaSmem) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices; lane i gives the address of row i % 16 at column
// (i / 16) * 8 (in b16) of a 16-row tile
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bytes of `u` (each u = nib ^ 8 < 16), picked by `sel`, as a bf16x2
// of the signed nibbles: PRMT puts WIDEN_BITS >> 8 above each, one subtract
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, uint32_t sel) {
  uint32_t v = __byte_perm(u, WIDEN_BITS >> 8, sel);
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             __float2bfloat162_rn(WIDEN_BIAS));
  return *reinterpret_cast<uint32_t*>(&h);
}

// One CTA: outputs [m0, m0 + BM) x [n0, n0 + 64) (BM = 64 or 32), walking
// the packed rows in k-steps of KSTEP (32, or 16 where a grouped
// G % 32 != 0).
// x_vec16 / w_vec16: 16-byte cp.async for x / the weight (every row
// 16-byte aligned), else 2-byte / 1-byte loads.
//
// B fragments straight from the packed bytes: ldmatrix.trans of the byte
// tile as b16 (byte pairs) gives a lane the bytes w[k0][2c], w[k0][2c + 1],
// w[k1][2c], w[k1][2c + 1] (k0 = 2 * (lane % 4), k1 = k0 + 1, c = lane / 4
// of a 16-column block).  PRMT 0x4240 pairs (k0, k1) of column 2c, 0x4341
// of column 2c + 1, from the low nibbles for the low plane and the high
// nibbles for the high plane: each 16-column block is two n8 fragments,
// its even and its odd columns, so fragment j of a warp holds columns
// 16 * (j / 2) + 2 * v + j % 2 (v = 0 .. 7), and the epilogue writes the
// outputs back to their columns.
template <bool GROUPED, int KSTEP, int BM>
__global__ void __launch_bounds__(MMA_THREADS) w4a16_mma_kernel(
    const __nv_bfloat16* __restrict__ x,  // [M, K] row-major
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ scale,      // [N], or grouped [n_groups, N]
    float* __restrict__ out,              // [M, N]
    int M, int K, int N, int Kh, int G, int n_groups, bool x_vec16,
    bool w_vec16) {
  constexpr int P = GROUPED ? 2 : 1;    // partial sums: one per plane
  constexpr int MI = BM / 32;           // m16 fragments a warp
  static_assert(KSTEP == 16 || KSTEP == BKH, "a k-step of 16 or 32 rows");
  static_assert(BM == 32 || BM == MMA_BM, "a row tile of 32 or 64");
  __shared__ MmaSmem sm;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nsteps = (Kh + KSTEP - 1) / KSTEP;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);

  // k-step t (rows [t * KSTEP, ...)) into ring slot t % MMA_STAGES;
  // always commits one cp.async group, empty past the last step
  auto load_step = [&](int t) {
    if (t < nsteps) {
      const int st = t % MMA_STAGES, r0 = t * KSTEP;
      const int rows = min(KSTEP, Kh - r0);
      for (int e = tid; e < 2 * BM * (KSTEP / 8); e += MMA_THREADS) {
        const int c = e % (KSTEP / 8), m = (e / (KSTEP / 8)) % BM;
        const int p = e / (BM * (KSTEP / 8));
        const int gm = m0 + m, kk = 8 * c, k = p * Kh + r0 + kk;
        uint16_t* dst = &sm.x[st][p][m][kk];
        const uint16_t* src = xb + (size_t)gm * K + k;
        if (x_vec16) {
          const bool ok = gm < M && kk < rows && k < K;
          cp_async16(dst, ok ? src : xb, ok);
        } else {
#pragma unroll
          for (int v = 0; v < 8; ++v)
            dst[v] = (gm < M && kk + v < rows && k + v < K) ? src[v]
                                                            : (uint16_t)0;
        }
      }
      for (int e = tid; e < KSTEP * (BN / 16); e += MMA_THREADS) {
        const int c = e % (BN / 16), kk = e / (BN / 16);
        const int gn = n0 + 16 * c;
        uint8_t* dst = &sm.w[st][kk][16 * c];
        const uint8_t* src = w + (size_t)(r0 + kk) * N + gn;
        if (w_vec16) {
          const bool ok = kk < rows && gn < N;
          cp_async16(dst, ok ? src : w, ok);
        } else {
#pragma unroll
          for (int v = 0; v < 16; ++v)
            dst[v] = (kk < rows && gn + v < N) ? src[v] : (uint8_t)0;
        }
      }
    }
    cp_async_commit();
  };

  float part[P][MI][4][4];              // [plane][m16][n8][fragment]
  float total[MI][4][4];                // grouped: scaled groups so far
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
#pragma unroll
        for (int p = 0; p < P; ++p) part[p][i][j][f] = 0.0f;
        total[i][j][f] = 0.0f;
      }
  // the thread's output columns: fragment j, element pair v
  int col[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      col[j][v] = n0 + wn * 32 + 16 * (j / 2) + 4 * (lane % 4) + 2 * v
                  + j % 2;

#pragma unroll
  for (int t = 0; t < MMA_STAGES - 1; ++t) load_step(t);

  // one pass of the outer loop a group (grouped; Kh and G are multiples of
  // KSTEP) or the whole contraction (per channel): the group's scales are
  // requested as it starts and first read at its end
  const int group_steps = GROUPED ? G / KSTEP : nsteps;
  for (int t0 = 0; t0 < nsteps; t0 += group_steps) {
    float s_lo[4][2], s_hi[4][2];
    if constexpr (GROUPED) {
      const int g_lo = t0 * KSTEP / G, g_hi = (Kh + t0 * KSTEP) / G;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int gn = col[j][v];
          s_lo[j][v] = gn < N ? __ldg(scale + (size_t)g_lo * N + gn) : 0.0f;
          s_hi[j][v] = (gn < N && g_hi < n_groups)
                           ? __ldg(scale + (size_t)g_hi * N + gn) : 0.0f;
        }
    }
    for (int t = t0; t < t0 + group_steps; ++t) {
      const int st = t % MMA_STAGES;
      cp_async_wait<MMA_STAGES - 2>();  // step t has landed (this thread's)
      __syncthreads();                  // ... every thread's; slot t - 1 free
      load_step(t + MMA_STAGES - 1);
#pragma unroll
      for (int ks = 0; ks < KSTEP / 16; ++ks) {
        uint32_t raw[4], b[2][4][2];    // b[plane][fragment][k half]
        ldmatrix_x4_trans(raw, &sm.w[st][16 * ks + lane % 16]
                                    [wn * 32 + 16 * (lane / 16)]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // block q / 2, rows k half q % 2
          const uint32_t f = raw[q] ^ 0x88888888u;
          const uint32_t u[2] = {f & 0x0F0F0F0Fu, (f >> 4) & 0x0F0F0F0Fu};
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            b[p][2 * (q / 2)][q % 2] = widen_pair(u[p], 0x4240u);
            b[p][2 * (q / 2) + 1][q % 2] = widen_pair(u[p], 0x4341u);
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t a[MI][4];
#pragma unroll
          for (int i = 0; i < MI; ++i)
            ldmatrix_x4(a[i], &sm.x[st][p][wm * 16 * MI + 16 * i + lane % 16]
                                   [16 * ks + 8 * (lane / 16)]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(part[GROUPED ? p : 0][i][j], a[i], b[p][j][0],
                       b[p][j][1]);
        }
      }
    }
    if constexpr (GROUPED) {            // the group's partials, scaled
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            total[i][j][f] += part[0][i][j][f] * s_lo[j][f % 2]
                              + part[P - 1][i][j][f] * s_hi[j][f % 2];
            part[0][i][j][f] = part[P - 1][i][j][f] = 0.0f;
          }
    }
  }
  cp_async_wait<0>();

  // fragment f of (i, j): row lane / 4 (+ 8 for f >= 2), element pair f % 2
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int gm = m0 + wm * 16 * MI + 16 * i + lane / 4 + 8 * (f / 2);
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = col[j][f % 2];
        if (gn >= N) continue;
        out[(size_t)gm * N + gn] = GROUPED ? total[i][j][f]
                                           : part[0][i][j][f] * __ldg(scale + gn);
      }
    }
}

// ------------------------------------------------- M <= 16: split K ----
constexpr int SK_THREADS = 128;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_MAX_ROWS = 128;  // packed rows per split, at most
constexpr int SK_LOADS = 8;       // weight loads in flight per thread

// output columns per CTA: 8 threads x 16 bytes, or a warp x 1 byte
template <int VEC> struct SplitCols;
template <> struct SplitCols<16> { static constexpr int BN = 128; };
template <> struct SplitCols<1> { static constexpr int BN = 32; };

// VEC neighbouring bytes of one packed row as 32-bit words (0 if !ok)
template <int VEC>
__device__ __forceinline__ void load_cols(const uint8_t* p, bool ok,
                                          uint32_t (&wd)[(VEC + 3) / 4]) {
  if constexpr (VEC == 16) {
    const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(p))
                       : make_uint4(0u, 0u, 0u, 0u);
    wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
  } else {
    wd[0] = ok ? (uint32_t)__ldg(p) : 0u;
  }
}

// byte b of `nibs` (each byte a nibble n ^ 8, n the int4 value) as f32:
// the bits of 2^23 + (n ^ 8), minus 2^23 + 8, which is exact
__device__ __forceinline__ float widen(uint32_t nibs, int b) {
  return __int_as_float(__byte_perm(nibs, 0x4B000000u, 0x7540u | b))
         - 8388616.0f;
}

// One CTA: BN columns, MT rows of x, `rows_per_split` packed rows (both
// planes) of split blockIdx.y.  Writes the split's partial to
// ws[split, m, n]: grouped scaled by the split's group in each plane, per
// channel unscaled.
template <int VEC, int MT, typename T, bool GROUPED>
__global__ void __launch_bounds__(SK_THREADS) w4a16_splitk_kernel(
    const T* __restrict__ x,              // [M, K] row-major
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ scale,      // grouped [n_groups, N]
    float* __restrict__ ws,               // [splits, M, N]
    int M, int K, int N, int Kh, int G, int n_groups, int rows_per_split) {
  constexpr int BN = SplitCols<VEC>::BN;
  constexpr int TX = BN / VEC;          // threads across a row: 8 or 32
  constexpr int WY = 32 / TX;           // rows a warp covers at once
  constexpr int TY = SK_WARPS * WY;     // rows the CTA covers at once
  constexpr int P = GROUPED ? 2 : 1;    // sums per output: one per plane
  constexpr int NW = (VEC + 3) / 4;     // 32-bit words per load
  constexpr int NB = VEC < 4 ? VEC : 4; // bytes used of each word
  __shared__ __align__(16) float Xs[2][SK_MAX_ROWS][MT];  // [plane][row][m]
  __shared__ float Red[P][SK_WARPS][MT][BN];     // per warp sums

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % TX, ty = warp * WY + lane / TX;
  const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * MT;
  const int r0 = split * rows_per_split;
  const int rows = min(rows_per_split, Kh - r0);
  const int n = n0 + tx * VEC;          // this thread's first column
  const uint8_t* wrow = w + (size_t)r0 * N + n;

  // the first SK_LOADS rows of weight and the epilogue's scales are
  // requested before x is staged, so the three latencies overlap
  uint32_t wd[SK_LOADS][NW];
#pragma unroll
  for (int u = 0; u < SK_LOADS; ++u) {
    const int rr = ty + u * TY;
    load_cols<VEC>(wrow + (size_t)rr * N, n < N && rr < rows, wd[u]);
  }
  // the epilogue's column: every output this thread writes lies in it
  static_assert(SK_THREADS % BN == 0, "one epilogue column a thread");
  const int gn_out = n0 + tid % BN;
  const int g_lo = GROUPED ? r0 / G : 0, g_hi = GROUPED ? (Kh + r0) / G : 0;
  float s_lo = 0.0f, s_hi = 0.0f;
  if (GROUPED && gn_out < N) {
    s_lo = g_lo < n_groups ? __ldg(scale + (size_t)g_lo * N + gn_out) : 0.0f;
    s_hi = g_hi < n_groups ? __ldg(scale + (size_t)g_hi * N + gn_out) : 0.0f;
  }

  for (int e = tid; e < 2 * MT * rows; e += SK_THREADS) {
    const int rr = e % rows, i = (e / rows) % MT, p = e / (rows * MT);
    const int m = m0 + i, k = p * Kh + r0 + rr;
    Xs[p][rr][i] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.0f;
  }
  __syncthreads();

  float acc[P][MT][VEC];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[p][i][v] = 0.0f;

  for (int rb = ty; rb < rows; rb += SK_LOADS * TY) {
    if (rb != ty) {
#pragma unroll
      for (int u = 0; u < SK_LOADS; ++u) {
        const int rr = rb + u * TY;
        load_cols<VEC>(wrow + (size_t)rr * N, n < N && rr < rows, wd[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < SK_LOADS; ++u) {
      const int rr = rb + u * TY;
      if (rr >= rows) break;
      float xl[MT], xh[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        xl[i] = Xs[0][rr][i];
        xh[i] = Xs[1][rr][i];
      }
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const uint32_t f = wd[u][j] ^ 0x88888888u;
        const uint32_t lo = f & 0x0F0F0F0Fu, hi = (f >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int v = 4 * j + b;
          const float ql = widen(lo, b), qh = widen(hi, b);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            acc[0][i][v] = fmaf(xl[i], ql, acc[0][i][v]);
            acc[P - 1][i][v] = fmaf(xh[i], qh, acc[P - 1][i][v]);
          }
        }
      }
    }
  }

  // the split's sums over its rows: the warp's WY row lanes by shuffles,
  // then the warps in order through shared memory
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float s = acc[p][i][v];
#pragma unroll
        for (int off = TX; off < 32; off *= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane < TX) Red[p][warp][i][tx * VEC + v] = s;
      }
  __syncthreads();
  if (gn_out < N) {
    const int c = tid % BN;
    for (int i = tid / BN; i < MT && m0 + i < M; i += SK_THREADS / BN) {
      float part[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        part[p] = Red[p][0][i][c];
#pragma unroll
        for (int q = 1; q < SK_WARPS; ++q) part[p] += Red[p][q][i][c];
      }
      float val = part[0];
      if constexpr (GROUPED) {
        val = part[0] * s_lo;
        val += part[P - 1] * s_hi;
      }
      ws[((size_t)split * M + m0 + i) * N + gn_out] = val;
    }
  }
  // the reduce may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;");
}

// out[m, n] = sum of the splits' partials in split order (per channel, then
// times s[n]); each thread requests RED_LOADS partials before it adds them
constexpr int RED_THREADS = 128;
constexpr int RED_LOADS = 16;

template <bool GROUPED>
__global__ void __launch_bounds__(RED_THREADS) w4a16_splitk_reduce(
    const float* __restrict__ ws, const float* __restrict__ scale,
    float* __restrict__ out, int MN, int N, int splits) {
  // launched early (programmatic stream serialization): wait until the
  // split kernel's partials are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= MN) return;
  float s = 0.0f;
  for (int q0 = 0; q0 < splits; q0 += RED_LOADS) {
    float v[RED_LOADS];
#pragma unroll
    for (int j = 0; j < RED_LOADS; ++j)
      v[j] = q0 + j < splits ? ws[(size_t)(q0 + j) * MN + e] : 0.0f;
#pragma unroll
    for (int j = 0; j < RED_LOADS; ++j)
      if (q0 + j < splits) s = q0 + j == 0 ? v[j] : s + v[j];
  }
  out[e] = GROUPED ? s : s * scale[e % N];
}

template <typename T, bool GROUPED, int VEC, int MT>
int launch_splitk(const void* x, const void* w, const void* scale, void* out,
                  void* ws, int M, int K, int N, int Kh, int G, int n_groups,
                  int rows_per_split, int splits, cudaStream_t st) {
  constexpr int BNs = SplitCols<VEC>::BN;
  dim3 grid((N + BNs - 1) / BNs, splits, (M + MT - 1) / MT);
  w4a16_splitk_kernel<VEC, MT, T, GROUPED><<<grid, SK_THREADS, 0, st>>>(
      (const T*)x, (const uint8_t*)w, (const float*)scale, (float*)ws, M, K,
      N, Kh, G, n_groups, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int MN = M * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((MN + RED_THREADS - 1) / RED_THREADS);
  cfg.blockDim = dim3(RED_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, w4a16_splitk_reduce<GROUPED>,
                                 (const float*)ws, (const float*)scale,
                                 (float*)out, MN, N, splits);
}

// the plan's rows of x per CTA picks the instantiation: 1 or 2 under
// 16-byte loads (at most 64 sums a thread), up to 8 under 1-byte loads
template <typename T, bool GROUPED, int VEC>
int launch_splitk_mt(int mt, const void* x, const void* w, const void* scale,
                     void* out, void* ws, int M, int K, int N, int Kh, int G,
                     int n_groups, int rows_per_split, int splits,
                     cudaStream_t st) {
#define W4A16_SPLITK(MT_)                                                    \
  return launch_splitk<T, GROUPED, VEC, MT_>(x, w, scale, out, ws, M, K, N,  \
                                             Kh, G, n_groups, rows_per_split, \
                                             splits, st)
  switch (mt) {
    case 1: W4A16_SPLITK(1);
    case 2: W4A16_SPLITK(2);
    case 4:
      if constexpr (VEC == 1) { W4A16_SPLITK(4); }
      break;
    case 8:
      if constexpr (VEC == 1) { W4A16_SPLITK(8); }
      break;
  }
#undef W4A16_SPLITK
  return (int)cudaErrorInvalidValue;
}

// bm rows of x a CTA: 64 or 32
template <bool GROUPED, int KSTEP>
int launch_mma(const void* x, const void* w, const void* scale, void* out,
               int M, int K, int N, int Kh, int G, int n_groups, int x_vec,
               int vec, int bm, cudaStream_t st) {
#define W4A16_MMA(BM_)                                                       \
  do {                                                                       \
    dim3 grid((N + BN - 1) / BN, (M + BM_ - 1) / BM_);                       \
    w4a16_mma_kernel<GROUPED, KSTEP, BM_><<<grid, MMA_THREADS, 0, st>>>(     \
        (const __nv_bfloat16*)x, (const uint8_t*)w, (const float*)scale,     \
        (float*)out, M, K, N, Kh, G, n_groups, x_vec == 16, vec == 16);      \
    return (int)cudaGetLastError();                                          \
  } while (0)
  if (bm == MMA_BM) W4A16_MMA(MMA_BM);
  if (bm == 32) W4A16_MMA(32);
#undef W4A16_MMA
  return (int)cudaErrorInvalidValue;
}

// the kernel a call runs, as `prefill_plan` / `splitk_plan` in
// kernels/w4a16_matmul.py pick it
enum Path { SPLITK = 0, FFMA = 1, MMA = 2 };

template <typename T, bool GROUPED>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, int M, int K, int N, int Kh, int G, int n_groups,
           int path, int vec, int x_vec, int mt, int rows_per_split,
           int splits, cudaStream_t st) {
  if (path == SPLITK) {
    if (M > 16 || splits < 1 || rows_per_split < 1
        || rows_per_split > SK_MAX_ROWS
        || (long long)splits * rows_per_split < Kh
        || (GROUPED && G % rows_per_split != 0))
      return (int)cudaErrorInvalidValue;
    if (vec == 16)
      return launch_splitk_mt<T, GROUPED, 16>(mt, x, w, scale, out, ws, M, K,
                                              N, Kh, G, n_groups,
                                              rows_per_split, splits, st);
    if (vec == 1)
      return launch_splitk_mt<T, GROUPED, 1>(mt, x, w, scale, out, ws, M, K,
                                             N, Kh, G, n_groups,
                                             rows_per_split, splits, st);
    return (int)cudaErrorInvalidValue;
  }
  if (M <= 16) return (int)cudaErrorInvalidValue;
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (BF16) {
    if (path == MMA) {
      // 16-byte loads need every row 16-byte aligned
      const bool x16 = (uintptr_t)x % 16 == 0 && K % 8 == 0 && Kh % 8 == 0;
      const bool w16 = (uintptr_t)w % 16 == 0 && N % 16 == 0;
      if ((GROUPED && G % 16 != 0) || !(vec == 1 || (vec == 16 && w16))
          || !(x_vec == 2 || (x_vec == 16 && x16)))
        return (int)cudaErrorInvalidValue;
      if constexpr (GROUPED) {
        if (G % BKH != 0)
          return launch_mma<true, 16>(x, w, scale, out, M, K, N, Kh, G,
                                      n_groups, x_vec, vec, mt, st);
      }
      return launch_mma<GROUPED, BKH>(x, w, scale, out, M, K, N, Kh, G,
                                      n_groups, x_vec, vec, mt, st);
    }
    // FFMA takes bf16 x only grouped with G % 16 != 0
    if (!GROUPED || G % 16 == 0) return (int)cudaErrorInvalidValue;
  }
  if (path != FFMA) return (int)cudaErrorInvalidValue;
  if constexpr (!BF16 || GROUPED) {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
    w4a16_kernel<64, T, GROUPED><<<grid, THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)w, (const float*)scale, (float*)out, M,
        K, N, Kh, G, n_groups);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, K] bf16 (x_bf16 = 1) or f32; group_size 0 = per-channel scale [N],
// else scale [n_groups, N] with Kh a multiple of group_size.  path 0 (M <=
// 16) runs the split-K plan (vec = 16 or 1 bytes per weight load, mt rows
// of x per CTA, rows_per_split packed rows in each of `splits` splits) with
// ws an f32 workspace of splits * M * N; path 1 (M > 16) the tiled FFMA
// kernel; path 2 (M > 16, bf16 x) the tensor-core kernel with vec = 16 or
// 1 bytes per weight load, x_vec = 16 or 2 bytes per x load and mt = 64 or
// 32 rows of x per CTA.  Paths 1 and 2 ignore the rest of the split plan
// and ws.
extern "C" int w4a16_launch(const void* x, int x_bf16, const void* w,
                            const void* scale, void* out, void* ws, int M,
                            int K, int N, int Kh, int group_size,
                            int n_groups, int path, int vec, int x_vec,
                            int mt, int rows_per_split, int splits,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = group_size, ng = n_groups, rs = rows_per_split;
  if (x_bf16) {
    if (G) return launch<__nv_bfloat16, true>(x, w, scale, out, ws, M, K, N,
                                              Kh, G, ng, path, vec, x_vec,
                                              mt, rs, splits, st);
    return launch<__nv_bfloat16, false>(x, w, scale, out, ws, M, K, N, Kh, G,
                                        ng, path, vec, x_vec, mt, rs, splits,
                                        st);
  }
  if (G) return launch<float, true>(x, w, scale, out, ws, M, K, N, Kh, G, ng,
                                    path, vec, x_vec, mt, rs, splits, st);
  return launch<float, false>(x, w, scale, out, ws, M, K, N, Kh, G, ng, path,
                              vec, x_vec, mt, rs, splits, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
