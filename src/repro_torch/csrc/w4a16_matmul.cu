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
// `_kernel_grouped` does; the weight tile is never scaled.  Both paths widen
// x and the nibble to f32 and accumulate with FFMA, which is right for bf16
// and f32 activations alike (a bf16 value times an int4 value is exact in
// f32).  Grouped weights are packed with K padded to a multiple of 2G, so
// each planar half covers whole groups: the low plane holds groups
// 0 .. Kh/G - 1 and the high plane the rest, padding groups
// (index >= n_groups) hold zero weights and read no scale.
//
// Two launch paths, picked by M:
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
// M > 16 (prefill): 2*M*K*N operations, bound by the bf16 tensor-core rate,
// but this path still runs the first port's design on CUDA cores: the weight
// is read once per CTA row-block as packed nibbles and widened in shared
// memory; the x tile is staged once per k-step and reused across the CTA's
// 64 columns; scales are read once per group per output.  Moving it to
// bf16 mma.sync / wgmma is a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // M > 16: output columns per CTA
constexpr int BKH = 32;       // M > 16: packed weight rows per k-step
constexpr int THREADS = 256;  // M > 16: threads per CTA

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

template <typename T, bool GROUPED>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, int M, int K, int N, int Kh, int G, int n_groups,
           int vec, int mt, int rows_per_split, int splits, cudaStream_t st) {
  if (M <= 16) {
    if (splits < 1 || rows_per_split < 1 || rows_per_split > SK_MAX_ROWS
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
  dim3 grid((N + BN - 1) / BN, (M + 63) / 64);
  w4a16_kernel<64, T, GROUPED><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const uint8_t*)w, (const float*)scale, (float*)out, M,
      K, N, Kh, G, n_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 (x_bf16 = 1) or f32; group_size 0 = per-channel scale [N],
// else scale [n_groups, N] with Kh a multiple of group_size.  M <= 16 runs
// the split-K plan (vec = 16 or 1 bytes per weight load, mt rows of x per
// CTA, rows_per_split packed rows in each of `splits` splits) with ws an f32
// workspace of splits * M * N; M > 16 ignores the plan and ws.
extern "C" int w4a16_launch(const void* x, int x_bf16, const void* w,
                            const void* scale, void* out, void* ws, int M,
                            int K, int N, int Kh, int group_size,
                            int n_groups, int vec, int mt, int rows_per_split,
                            int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = group_size, ng = n_groups, rs = rows_per_split;
  if (x_bf16) {
    if (G) return launch<__nv_bfloat16, true>(x, w, scale, out, ws, M, K, N,
                                              Kh, G, ng, vec, mt, rs, splits,
                                              st);
    return launch<__nv_bfloat16, false>(x, w, scale, out, ws, M, K, N, Kh, G,
                                        ng, vec, mt, rs, splits, st);
  }
  if (G) return launch<float, true>(x, w, scale, out, ws, M, K, N, Kh, G, ng,
                                    vec, mt, rs, splits, st);
  return launch<float, false>(x, w, scale, out, ws, M, K, N, Kh, G, ng, vec,
                              mt, rs, splits, st);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
