// Table-lookup W4A4 GEMM: every int4 x int4 product is read from the 4x4-bit
// product table, never multiplied; the reads are summed as integers.  The
// paper's 4-bit LUT multiplier, tiled across a GEMM.
//
// Replaces: src/repro/kernels/lut4_matmul.py::lut4_matmul (Pallas `_kernel`).
//
// Computes out[m, n] = (float(acc[m, n]) * a_scale[m]) * w_scale[n] with
//   acc[m, n] = sum_r P[a_q[m, r] & 0xF][w_km[r, n] & 0xF]
//             + P[a_q[m, r + Kh] & 0xF][w_km[r, n] >> 4]
// over the Kh = ceil(K / 2) packed rows of the planar K-major weight (byte
// w_km[r, n] holds row r in its low nibble and row r + Kh in its high; an
// activation index r + Kh >= K, odd K's pad, reads code 0).
//
// The table.  P[x][y] = sext4(x) * sext4(y) is the paper's 256-entry truth
// table (`kernels/ref.py::make_product_lut`, lut_mul4's table), passed in
// as int8 [x << 4 | y].  The Pallas kernel reads the 16x256 per-nibble
// tables t_lo[a, byte] = P[a][byte & 0xF] and t_hi[a, byte] = P[a][byte >> 4]
// (kernels/packing.py nibble_product_tables): a column of t_lo depends only
// on the byte's low nibble and one of t_hi only on its high nibble, so the
// reads here are the same products from the same truth table.  P is
// symmetric, so the 16 bytes at x << 4 are both row x and column x: all the
// products of one weight nibble with every activation code, or of one
// activation code with every weight nibble.  Code 0 and nibble 0 read zero,
// so padding absorbs.  The epilogue is the one of csrc/int4_matmul.cu in the
// same order, and every partial stays an integer until it: on the same a_q
// and a_scale the result is that kernel's, bit for bit (|acc| < 2^24).
//
// What bounds it on the card: the function is row 2's integer GEMM (2*M*K*N
// operations on K*N/2 weight bytes), bound by memory at decode and by the
// int8 rate at prefill.  Keeping the method (no multiply, no dp4a, no tensor
// core on the products) it is bound by the instructions a product costs.
// What the design does about it:
//
// * Split K.  The plan (`lut4_plan` in kernels/lut4_matmul.py) cuts the Kh
//   packed rows into splits so that a call launches at least 132 CTAs (one
//   per SM of an H100) where K allows it; each split writes int32 partial
//   sums to a workspace [splits, M, N], and `lut4_splitk_reduce`, launched
//   early (programmatic dependent launch), adds them and applies the
//   epilogue.  Integer sums are exact in any order.  With one split the
//   kernel applies the epilogue itself.  A CTA covers BM rows (M rounded up
//   to a power of two at M <= 16, else 64) x 128 columns; it stages its
//   split's weight bytes (16-byte loads where N % 16 == 0 and the weight is
//   16-byte aligned, else 1-byte) and activation codes in shared memory,
//   64 packed rows at a time.  At M <= 16 the CTA's threads also share the
//   split's rows ("k-lanes") and add their sums through shared memory.
//
// * Products picked from registers, not read one by one from shared memory.
//   One 16-byte shared load brings the 16 products of one nibble x with
//   every other nibble (T[x], four registers).  `prmt` picks four of those
//   bytes by four 3-bit selectors from a register pair; bit 3 of each index
//   picks the pair (one LOP3 with a per-byte mask).  So four products cost
//   two PRMT and one LOP3, and no shared-memory read of their own.  Each
//   tile takes the orientation that was the faster on its path on the H100
//   (PERF.md, lut4_ablation.py):
//     A_SEL, the prefill tile (BM = 64): x is a weight nibble (one column,
//            one packed row), the selectors are the codes of four rows,
//            formed once per (row group, packed row) when the chunk is
//            staged and reused for every column of the thread (16 rows x 4
//            columns a thread);
//     W_SEL, the decode tiles (BM <= 16): x is a row's activation code, the
//            selectors are the weight nibbles of four columns, formed once
//            per (4 columns, packed row) and reused for every row of the
//            thread (16 columns a thread).
//   The table holds P + 56 (BIAS): every entry in [0, 120], so the bytes of
//   the two planes' picks add in one 32-bit add without a carry (<= 240),
//   and two PRMT widen the even and the odd bytes into 16-bit lanes.  A lane
//   gains at most 240 a packed row and is flushed into the int32 sums after
//   each chunk of at most CH = 64 rows (64 * 240 < 2^16), and 2 * 56 a
//   packed row comes off each sum at the end.  11 instructions for 8
//   products in the inner loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BN = 128;          // output columns per CTA
constexpr int CH = 64;           // packed rows staged at once
constexpr int BIAS = 56;         // added to every product in the lanes' table
static_assert(CH * 2 * (64 + BIAS) < 65536, "a 16-bit lane overflows");

// The thread tile: TM rows x TN columns; RT row threads x CT column threads
// x KL k-lanes = THREADS.  A_SEL (BM = 64): 16 x 4 (selectors reused over 4
// columns, table columns over 16 rows); W_SEL: 16 columns (one 16-byte
// weight vector) x up to 4 rows.
template <int BM>
struct Tile {
  static constexpr bool A_SEL = BM == 64;
  static constexpr int TM = A_SEL ? 16 : (BM < 4 ? BM : 4);
  static constexpr int TN = A_SEL ? 4 : 16;
  static constexpr int RT = BM / TM;
  static constexpr int CT = BN / TN;
  static constexpr int KL = THREADS / (RT * CT);
  static_assert(RT * CT * KL == THREADS, "the tile covers the CTA");
};

// PTX prmt.b32, default mode: byte i of the result is byte (nibble i of
// sel) & 7 of {y, x}, or that byte's sign bit repeated where the nibble's
// bit 3 is set.  (__byte_perm reads only 3 bits of each nibble: no sign.)
__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(sel));
  return r;
}

// prmt selector nibbles 0..3 from the low 3 bits of the bytes of v
__device__ __forceinline__ uint32_t selector(uint32_t v) {
  const uint32_t t = v & 0x07070707u;
  return prmt(t | (t >> 4), 0u, 0x0020u);
}

// 0xFF in byte i where bit 3 of byte i of v is set (prmt's sign replicate)
__device__ __forceinline__ uint32_t half_mask(uint32_t v) {
  return prmt(v << 4, 0u, 0xBA98u);
}

// byte i: c's byte (8 if mask byte i else 0) + (selector nibble i)
__device__ __forceinline__ uint32_t pick(const uint4& c, uint32_t sel,
                                         uint32_t mask) {
  const uint32_t lo = prmt(c.x, c.y, sel);
  const uint32_t hi = prmt(c.z, c.w, sel);
  return (lo & ~mask) | (hi & mask);
}

// One CTA: rows [m0, m0 + BM) x columns [n0, n0 + BN) over the packed rows
// of split blockIdx.y.  One split: the epilogue into out; more: int32
// partials into ws[split, m, n].
template <int BM>
__global__ void __launch_bounds__(THREADS) lut4_kernel(
    const int8_t* __restrict__ a_q,       // [M, K] int4 values
    const float* __restrict__ a_scale,    // [M]
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ w_scale,    // [N]
    const int8_t* __restrict__ lut,       // [256] P[x << 4 | y]
    float* __restrict__ out,              // [M, N]
    int32_t* __restrict__ ws,             // [splits, M, N]
    int M, int K, int N, int Kh, int rows_per_split, bool vec16) {
  using T = Tile<BM>;
  constexpr bool A_SEL = T::A_SEL;
  constexpr int TM = T::TM, TN = T::TN, RT = T::RT, CT = T::CT, KL = T::KL;
  constexpr int NQ = TN / 4;              // weight words of a row
  constexpr int NG = TM / 4;              // A_SEL: row groups
  constexpr int GB = BM / 4;              // A_SEL: row groups of the CTA
  // the lanes: A_SEL [row group][column], W_SEL [row][4-column word]
  constexpr int LA = A_SEL ? NG : TM;
  constexpr int LB = A_SEL ? TN : NQ;
  // staged codes: A_SEL per (plane, row, row group) the selector and the
  // half mask; W_SEL per (plane, row, m) the code
  constexpr int STAGE = A_SEL ? 2 * CH * GB * 8 : 2 * CH * BM;
  __shared__ __align__(16) uint8_t table[256];
  __shared__ __align__(16) uint8_t stage[STAGE];
  __shared__ __align__(16) uint8_t wsm[CH * BN];   // [row][column]
  __shared__ int32_t red[KL > 1 ? BM * BN : 1];

  const int tid = threadIdx.x;
  // A_SEL: the threads of a quarter warp share columns, so the table
  // columns they load coincide; W_SEL: they share rows and packed row
  int tr, tc, tk;
  if constexpr (A_SEL) {
    tr = tid % RT; tc = (tid / RT) % CT; tk = tid / (RT * CT);
  } else {
    tc = tid % CT; tr = (tid / CT) % RT; tk = tid / (CT * RT);
  }
  const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
  const int r0 = split * rows_per_split;
  const int rows = min(rows_per_split, Kh - r0);

  for (int e = tid; e < 256; e += THREADS)
    table[e] = (uint8_t)(lut[e] + BIAS);
  if constexpr (KL > 1)
    for (int e = tid; e < BM * BN; e += THREADS) red[e] = 0;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[i][v] = 0;
  uint32_t ev[LA][LB], od[LA][LB];
  int nrows = 0;                          // packed rows this thread summed
  const uint4* t4 = reinterpret_cast<const uint4*>(table);

  for (int c0 = 0; c0 < rows; c0 += CH) {
    const int ch = min(CH, rows - c0), rc = r0 + c0;
    // the chunk's weight bytes
    if (vec16) {
      for (int e = tid; e < CH * (BN / 16); e += THREADS) {
        const int rr = e / (BN / 16), c = 16 * (e % (BN / 16));
        const bool ok = rr < ch && n0 + c < N;
        *reinterpret_cast<uint4*>(&wsm[rr * BN + c]) =
            ok ? __ldg(reinterpret_cast<const uint4*>(
                     w + (size_t)(rc + rr) * N + n0 + c))
               : make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < CH * BN; e += THREADS) {
        const int rr = e / BN, c = e % BN;
        wsm[e] = (rr < ch && n0 + c < N) ? w[(size_t)(rc + rr) * N + n0 + c]
                                         : (uint8_t)0;
      }
    }
    // the chunk's activation codes (rr fastest: neighbouring k)
    if constexpr (A_SEL) {
      uint2* sa = reinterpret_cast<uint2*>(stage);
      for (int e = tid; e < 2 * CH * GB; e += THREADS) {
        const int rr = e % CH, g = (e / CH) % GB, p = e / (CH * GB);
        const int k = p * Kh + rc + rr;
        uint32_t cw = 0;
        if (rr < ch && k < K) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int gm = m0 + 4 * g + i;
            if (gm < M)
              cw |= ((uint32_t)(uint8_t)a_q[(size_t)gm * K + k] & 0xFu)
                    << (8 * i);
          }
        }
        sa[(p * CH + rr) * GB + g] = make_uint2(selector(cw), half_mask(cw));
      }
    } else {
      for (int e = tid; e < 2 * CH * BM; e += THREADS) {
        const int rr = e % CH, m = (e / CH) % BM, p = e / (CH * BM);
        const int k = p * Kh + rc + rr, gm = m0 + m;
        stage[(p * CH + rr) * BM + m] =
            (rr < ch && gm < M && k < K)
                ? (uint8_t)((uint32_t)(uint8_t)a_q[(size_t)gm * K + k] & 0xFu)
                : (uint8_t)0;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < LA; ++a)
#pragma unroll
      for (int b = 0; b < LB; ++b) ev[a][b] = od[a][b] = 0u;
    for (int rr = tk; rr < ch; rr += KL) {
      ++nrows;
      uint32_t wd[NQ];
      const uint8_t* wrow = &wsm[rr * BN + tc * TN];
      if constexpr (TN == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(wrow);
        wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
      } else {
        wd[0] = *reinterpret_cast<const uint32_t*>(wrow);
      }
      if constexpr (A_SEL) {
        const uint2* sa = reinterpret_cast<const uint2*>(stage);
        uint2 s_lo[NG], s_hi[NG];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          s_lo[g] = sa[rr * GB + tr * NG + g];
          s_hi[g] = sa[(CH + rr) * GB + tr * NG + g];
        }
#pragma unroll
        for (int v = 0; v < TN; ++v) {
          const uint32_t byte = (wd[v / 4] >> (8 * (v % 4))) & 0xFFu;
          const uint4 c_lo = t4[byte & 0xFu], c_hi = t4[byte >> 4];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const uint32_t s = pick(c_lo, s_lo[g].x, s_lo[g].y)
                               + pick(c_hi, s_hi[g].x, s_hi[g].y);
            ev[g][v] += prmt(s, 0u, 0x4240u);
            od[g][v] += prmt(s, 0u, 0x4341u);
          }
        }
      } else {
        const uint8_t* code_lo = &stage[rr * BM + tr * TM];
        const uint8_t* code_hi = &stage[(CH + rr) * BM + tr * TM];
        uint32_t sl[NQ], ml[NQ], sh[NQ], mh[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          sl[q] = selector(wd[q]);
          ml[q] = half_mask(wd[q]);
          sh[q] = selector(wd[q] >> 4);
          mh[q] = half_mask(wd[q] >> 4);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const uint4 c_lo = t4[code_lo[i]], c_hi = t4[code_hi[i]];
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const uint32_t s = pick(c_lo, sl[q], ml[q])
                               + pick(c_hi, sh[q], mh[q]);
            ev[i][q] += prmt(s, 0u, 0x4240u);
            od[i][q] += prmt(s, 0u, 0x4341u);
          }
        }
      }
    }
    // flush the lanes: even bytes are outputs 0 and 2 of a 4-group, odd 1, 3
#pragma unroll
    for (int a = 0; a < LA; ++a)
#pragma unroll
      for (int b = 0; b < LB; ++b) {
        const int e0 = (int)(ev[a][b] & 0xFFFFu), e2 = (int)(ev[a][b] >> 16);
        const int o1 = (int)(od[a][b] & 0xFFFFu), o3 = (int)(od[a][b] >> 16);
        if constexpr (A_SEL) {
          acc[4 * a][b] += e0; acc[4 * a + 1][b] += o1;
          acc[4 * a + 2][b] += e2; acc[4 * a + 3][b] += o3;
        } else {
          acc[a][4 * b] += e0; acc[a][4 * b + 1] += o1;
          acc[a][4 * b + 2] += e2; acc[a][4 * b + 3] += o3;
        }
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int v = 0; v < TN; ++v) acc[i][v] -= 2 * BIAS * nrows;

  const bool one_split = gridDim.y == 1;
  auto put = [&](int gm, int gn, int val) {
    if (gm >= M || gn >= N) return;
    if (one_split)
      out[(size_t)gm * N + gn] = ((float)val * a_scale[gm]) * w_scale[gn];
    else
      ws[((size_t)split * M + gm) * N + gn] = val;
  };
  if constexpr (KL > 1) {
    // the k-lanes' sums: integer adds, exact in any order
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        atomicAdd(&red[(tr * TM + i) * BN + tc * TN + v], acc[i][v]);
    __syncthreads();
    for (int e = tid; e < BM * BN; e += THREADS)
      put(m0 + e / BN, n0 + e % BN, red[e]);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int v = 0; v < TN; ++v)
        put(m0 + tr * TM + i, n0 + tc * TN + v, acc[i][v]);
  }
  // the reduce may launch now; it waits for this grid's writes
  if (!one_split) asm volatile("griddepcontrol.launch_dependents;");
}

// out[m, n] = the splits' int32 partials summed, then the epilogue
constexpr int RED_THREADS = 128;

__global__ void __launch_bounds__(RED_THREADS) lut4_splitk_reduce(
    const int32_t* __restrict__ ws, const float* __restrict__ a_scale,
    const float* __restrict__ w_scale, float* __restrict__ out, int M, int N,
    int splits) {
  // launched early (programmatic stream serialization): wait until the
  // split kernel's partials are complete and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int MN = M * N;
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= MN) return;
  int s = 0;
#pragma unroll 8
  for (int q = 0; q < splits; ++q) s += ws[(size_t)q * MN + e];
  out[e] = ((float)s * a_scale[e / N]) * w_scale[e % N];
}

template <int BM>
int launch(const void* a_q, const void* a_scale, const void* w,
           const void* w_scale, const void* lut, void* out, void* ws, int M,
           int K, int N, int Kh, int rows_per_split, int splits, bool vec16,
           cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  lut4_kernel<BM><<<grid, THREADS, 0, st>>>(
      (const int8_t*)a_q, (const float*)a_scale, (const uint8_t*)w,
      (const float*)w_scale, (const int8_t*)lut, (float*)out, (int32_t*)ws,
      M, K, N, Kh, rows_per_split, vec16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M * N + RED_THREADS - 1) / RED_THREADS);
  cfg.blockDim = dim3(RED_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, lut4_splitk_reduce,
                                 (const int32_t*)ws, (const float*)a_scale,
                                 (const float*)w_scale, (float*)out, M, N,
                                 splits);
}

}  // namespace

// bm rows a CTA (64 where M > 16, else a power of two >= M: 1, 2, 4, 8 or
// 16); vec = 16 or 1 bytes per weight load; `splits` splits of
// `rows_per_split` packed rows, with ws an int32 workspace of
// splits * M * N where splits > 1.  The plan is `lut4_plan` in
// kernels/lut4_matmul.py.
extern "C" int lut4_launch(const void* a_q, const void* a_scale, const void* w,
                           const void* w_scale, const void* lut, void* out,
                           void* ws, int M, int K, int N, int Kh, int bm,
                           int vec, int rows_per_split, int splits,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool bm_ok = M > 16 ? bm == 64 : (bm >= M && bm <= 16);
  const bool vec_ok = vec == 1 || (vec == 16 && N % 16 == 0
                                   && (uintptr_t)w % 16 == 0);
  if (!bm_ok || !vec_ok || splits < 1 || rows_per_split < 1
      || (long long)splits * rows_per_split < Kh
      || (long long)(splits - 1) * rows_per_split >= Kh
      || (splits > 1 && ws == nullptr) || 2 * Kh < K || 2 * Kh > K + 1)
    return (int)cudaErrorInvalidValue;
#define LUT4_BM(BM_)                                                          \
  return launch<BM_>(a_q, a_scale, w, w_scale, lut, out, ws, M, K, N, Kh,     \
                     rows_per_split, splits, vec == 16, st)
  switch (bm) {
    case 1: LUT4_BM(1);
    case 2: LUT4_BM(2);
    case 4: LUT4_BM(4);
    case 8: LUT4_BM(8);
    case 16: LUT4_BM(16);
    case 64: LUT4_BM(64);
  }
#undef LUT4_BM
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
