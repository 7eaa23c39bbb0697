// W4A4 GEMM: with the activation quantize fused into the kernel, or on
// activations quantized beforehand, on the int8 tensor cores.
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
// r + Kh in its high nibble (Kh = ceil(K / 2); an activation index
// r + Kh >= K, odd K's pad, reads 0).  Every sum is an integer, so any
// order of k, any split and any order of the splits' sums give the same
// bits: the two entries share this kernel, and on the same a_q and a_scale
// they give the same bits.
//
// What bounds it on the card: 2*M*K*N integer operations on K*N/2 packed
// weight bytes.  At decode (M = 1..8) the bytes bound it (each weight byte
// feeds 2*M multiply-adds); at M = 256 the int8 tensor-core rate is 10 to 40
// times above what the bytes allow, so a call is bound by how many bytes
// each SM keeps in flight and by the fixed cost of a k-step, not by the
// arithmetic.  What the design does about it:
//
// * Split K, reduced inside a cluster.  The plan (`w4a4_plan` in
//   kernels/int4_matmul.py) cuts a call into BM x BN output tiles (BM 16,
//   32 or 64 rows; BN 64, or 128 where 64-row tiles are many enough)
//   and, where the tiles leave SMs idle, the Kh packed rows into at most 8
//   splits (multiples of the 32-row k-step).  A tile's splits are one
//   thread-block cluster (grid y, a cluster-dimension launch attribute): each
//   CTA leaves its int32 partial tile in its own shared memory, and after a
//   cluster barrier every CTA sums a slice of the tile over the cluster's
//   CTAs through distributed shared memory, in split order, and writes that
//   slice with the epilogue.  One launch a call, no workspace, no atomics:
//   two calls on the same inputs give the same bits.
//
// * The inner product on mma.sync.m16n8k32 s8 x s8 -> s32 (IMMA), as the
//   Pallas kernel contracts both nibble planes on the TPU's int8 matrix
//   unit.  4 warps a CTA, each a (BM / WM) x (BN / WN) slice.  A k-step
//   takes 32 packed rows: the same weight bytes feed the low plane (A
//   columns r0 ..) and the high plane (A columns Kh + r0 ..), so each byte
//   is loaded once for two MMAs.
//
// * B straight from the packed bytes.  An s8 B fragment wants 4
//   consecutive k of one column in a register, and the tile is K-major
//   (consecutive k of a column are a row pitch apart).  ldmatrix.trans of
//   the byte tile as b16 gives a lane the bytes of two rows at a column
//   pair; the rows each lane address names are chosen so that matrix 0
//   holds rows {0, 1, 4, 5, 8, 9, 12, 13} and matrix 1 rows {2, 3, 6, 7,
//   10, 11, 14, 15} of a 16-row block: a lane (g, t) then holds k {4t,
//   4t + 1} in one register and {4t + 2, 4t + 3} in the other, each for
//   columns 2g and 2g + 1, and one PRMT each (0x6420, 0x7531) gives the
//   four k of column 2g and of column 2g + 1 in the natural order.  So A
//   keeps the natural k order (no permutation of either operand), and each
//   16-column block is two n8 fragments, its even and its odd columns; a
//   thread's four sums of a row are then columns 4t .. 4t + 3, one float4
//   in the epilogue.  The planes are widened exactly in registers: low
//   (b << 4) & 0xF0F0F0F0, high b & 0xF0F0F0F0, each a signed nibble * 16
//   in an s8 lane, so the sums carry a factor 16 that one arithmetic shift
//   removes at the end (|acc| <= 1024 * K < 2^31).
//
// * A 4-stage cp.async ring, one barrier a k-step.  Weight bytes come by
//   16-byte cp.async where N % 16 == 0 and the weight is 16-byte aligned
//   (the plan's `vec`), else by 1-byte loads; past N, Kh and the split's
//   rows they are zero-filled.  Unfused, a_q comes the same way into the
//   ring (16 bytes where K % 32 == 0 and a_q is aligned, else 1-byte).
//   Fused, f32 x comes into the ring (16 bytes where K % 8 == 0 and x is
//   aligned, else 4-byte cp.async), and while the tensor cores run k-step
//   t the CTA quantizes k-step t + 1 from the ring into a two-slot int8
//   tile, exactly as `_quantize_tile`: rintf(__fdiv_rn(x, s)) clamped to
//   [-8, 7] (not a multiply by the reciprocal: that changes bits at ties).
//   A fragments come from the int8 tile by ldmatrix.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;       // 4 warps
constexpr int BKH = 32;            // packed weight rows per k-step
constexpr int STAGES = 4;          // k-steps in the cp.async ring
constexpr int MAX_SPLITS = 8;      // CTAs of a cluster (the portable limit)
constexpr int A_LD = 2 * BKH + 16; // int8 A row: both planes + 16 (80 bytes)
constexpr int X_LD = 2 * BKH;      // f32 x row: both planes
constexpr uint32_t NIB_HI = 0xF0F0F0F0u;

// The CTA's layout: WM x WN warps, each MI m16 fragments x NJ 16-column
// blocks; shared memory: the weight ring [STAGES][BKH][BN], the int8 A
// tiles (unfused: a ring slot a k-step; fused: two slots) and, fused, the
// f32 x ring [STAGES][BM][X_LD].  A rows of 80 bytes keep the 8 rows of
// every ldmatrix on distinct banks.  The weight rows an ldmatrix.trans
// names ({0, 1, 4, 5, 8, 9, 12, 13}, see below) cannot be spread so by a
// pitch (rows 0 and 8 always share banks), so a weight row's 16-byte
// chunks are stored XOR-swizzled by `wswz`.  The split's int32 partial
// tile [BM][BN] reuses the space once the k-loop is done.
template <int BM, int BN, bool FUSED>
struct Layout {
  static constexpr int WM = BM == 16 ? 1 : 2;
  static constexpr int WN = 4 / WM;
  static constexpr int MI = BM / (16 * WM);
  static constexpr int NJ = BN / (16 * WN);
  static_assert(MI >= 1 && NJ >= 1 && WM * WN * 32 == THREADS, "tile");
  static constexpr int A_SLOTS = FUSED ? 2 : STAGES;
  static constexpr int W_BYTES = STAGES * BKH * BN;
  static constexpr int A_BYTES = A_SLOTS * BM * A_LD;
  static constexpr int X_BYTES = FUSED ? STAGES * BM * X_LD * 4 : 0;
  static constexpr int RED_BYTES = BM * BN * 4;
  static constexpr int LOOP_BYTES = W_BYTES + A_BYTES + X_BYTES;
  static constexpr int BYTES = LOOP_BYTES > RED_BYTES ? LOOP_BYTES
                                                      : RED_BYTES;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 b16 matrices; lane i names row i % 8 of matrix i / 8
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

// d += a (16 x 32, row) * b (32 x 8, col), s8 in, s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the chunk swizzle of weight row r: the 8 rows of every ldmatrix.trans
// matrix land on 8 distinct 4-bank groups (64-byte rows: bit 2 of the row
// picks the half, rows / 4 the chunk; 128-byte rows: (rows / 4, r % 2))
template <int BN>
__device__ __forceinline__ int wswz(int r) {
  return BN == 128 ? (2 * ((r >> 2) & 3)) | (r & 1) : (r >> 2) & 3;
}

// four packed bytes -> one plane's s8 lanes, each a signed nibble * 16
__device__ __forceinline__ uint32_t widen(uint32_t v, int plane) {
  return plane == 0 ? (v << 4) & NIB_HI : v & NIB_HI;
}

// `_quantize_tile` on one value: rint(x / s) clamped to [-8, 7], as a byte
__device__ __forceinline__ uint32_t quant4(float x, float s) {
  float v = rintf(__fdiv_rn(x, s));
  v = fminf(fmaxf(v, -8.0f), 7.0f);
  return (uint32_t)((int)v) & 0xFFu;
}

// One CTA: outputs [m0, m0 + BM) x [n0, n0 + BN) over the packed rows of
// split blockIdx.y (rows [split * rows_per_split, ...)).  With one split
// the epilogue runs from registers; with more, the split's CTAs are one
// cluster and reduce through distributed shared memory.
template <int BM, int BN, bool FUSED>
__global__ void __launch_bounds__(THREADS) w4a4_mma_kernel(
    const void* __restrict__ a,           // [M, K]: f32 x (FUSED) or int8
    const float* __restrict__ a_scale,    // [M]
    const uint8_t* __restrict__ w,        // [Kh, N] planar K-major
    const float* __restrict__ w_scale,    // [N]
    float* __restrict__ out,              // [M, N]
    int M, int K, int N, int Kh, int rows_per_split, bool a_vec,
    bool w_vec) {
  using L = Layout<BM, BN, FUSED>;
  constexpr int MI = L::MI, NJ = L::NJ;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const ws = smem;                              // weight ring
  uint8_t* const as = smem + L::W_BYTES;                 // int8 A
  float* const xs = reinterpret_cast<float*>(smem + L::W_BYTES
                                             + L::A_BYTES);  // fused: x ring

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / L::WN, wn = warp % L::WN;
  const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, Kh);
  const int nsteps = (r_end - r_begin + BKH - 1) / BKH;
  const float* const xg = reinterpret_cast<const float*>(a);
  const uint8_t* const ag = reinterpret_cast<const uint8_t*>(a);

  // k-step t (packed rows [r_begin + t * BKH, ...)) into ring slot
  // t % STAGES; always commits one cp.async group, empty past the last step
  auto load_step = [&](int t) {
    if (t < nsteps) {
      const int slot = t % STAGES, r0 = r_begin + t * BKH;
      const int rows = min(BKH, r_end - r0);
      for (int e = tid; e < BKH * (BN / 16); e += THREADS) {
        const int kk = e / (BN / 16), c = 16 * (e % (BN / 16));
        const int gn = n0 + c;
        uint8_t* dst = ws + (slot * BKH + kk) * BN
                       + 16 * ((c / 16) ^ wswz<BN>(kk));
        const uint8_t* src = w + (size_t)(r0 + kk) * N + gn;
        if (w_vec) {
          const bool ok = kk < rows && gn < N;
          cp_async16(dst, ok ? src : w, ok);
        } else {
#pragma unroll
          for (int v = 0; v < 16; ++v)
            dst[v] = (kk < rows && gn + v < N) ? src[v] : (uint8_t)0;
        }
      }
      if constexpr (FUSED) {
        // x: 16 units of 4 floats a row, plane c / 8, k offset 4 * (c % 8)
        for (int e = tid; e < BM * 16; e += THREADS) {
          const int m = e / 16, c = e % 16;
          const int kk = 4 * (c % 8), k = (c / 8) * Kh + r0 + kk;
          const int gm = m0 + m;
          float* dst = xs + (slot * BM + m) * X_LD + 4 * c;
          const float* src = xg + (size_t)gm * K + k;
          if (a_vec) {
            const bool ok = gm < M && kk < rows;
            cp_async16(dst, ok ? src : xg, ok);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const bool ok = gm < M && kk + v < rows && k + v < K;
              cp_async4(dst + v, ok ? src + v : xg, ok);
            }
          }
        }
      } else {
        // a_q: 4 units of 16 bytes a row, plane c / 2, k offset 16 * (c % 2)
        for (int e = tid; e < BM * 4; e += THREADS) {
          const int m = e / 4, c = e % 4;
          const int kk = 16 * (c % 2), k = (c / 2) * Kh + r0 + kk;
          const int gm = m0 + m;
          uint8_t* dst = as + (slot * BM + m) * A_LD + 16 * c;
          const uint8_t* src = ag + (size_t)gm * K + k;
          if (a_vec) {
            const bool ok = gm < M && kk < rows;
            cp_async16(dst, ok ? src : ag, ok);
          } else {
#pragma unroll
            for (int v = 0; v < 16; ++v)
              dst[v] = (gm < M && kk + v < rows && k + v < K) ? src[v]
                                                              : (uint8_t)0;
          }
        }
      }
    }
    cp_async_commit();
  };

  // fused: the thread quantizes rows tid / 16 + 8u, 4 floats at 4 * (tid %
  // 16) of the x row, with the row's scale kept in a register
  constexpr int QU = FUSED ? BM / 8 : 1;
  float scale[QU];
  if constexpr (FUSED) {
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int gm = m0 + tid / 16 + 8 * u;
      scale[u] = gm < M ? a_scale[gm] : 1.0f;
    }
  }
  // x of k-step t (ring slot t % STAGES) -> int8 A slot t % 2
  auto quantize = [&](int t) {
    const float* xsl = xs + (t % STAGES) * BM * X_LD;
    uint8_t* asl = as + (t % 2) * BM * A_LD;
    const int c = tid % 16;
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const int m = tid / 16 + 8 * u;
      uint32_t word = 0u;
      if (m0 + m < M) {
        const float4 v = *reinterpret_cast<const float4*>(xsl + m * X_LD
                                                          + 4 * c);
        const float s = scale[u];
        word = quant4(v.x, s) | (quant4(v.y, s) << 8)
               | (quant4(v.z, s) << 16) | (quant4(v.w, s) << 24);
      }
      *reinterpret_cast<uint32_t*>(asl + m * A_LD + 4 * c) = word;
    }
  };

  int acc[MI][NJ][2][4];               // [m16][16-col block][even, odd][.]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[i][j][h][f] = 0;

  // the weight row this lane names for ldmatrix.trans: matrix lane / 8 of
  // a 32-row step, rows {0, 1, 4, 5, 8, 9, 12, 13} (+ 2 for matrices 1
  // and 3, + 16 for matrices 2 and 3)
  const int brow = 16 * (lane / 16) + 2 * ((lane / 8) % 2)
                   + 4 * ((lane % 8) / 2) + lane % 2;
  const int arow = wm * 16 * MI + lane % 16;
  const int acol = 16 * (lane / 16);
  const int bcol = wn * 16 * NJ;
  const int bswz = wswz<BN>(brow);

  auto compute = [&](int t) {
    const uint8_t* wsl = ws + (t % STAGES) * BKH * BN + brow * BN;
    const uint8_t* asl = as + (FUSED ? t % 2 : t % STAGES) * BM * A_LD;
    uint32_t af[2][MI][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[p][i], asl + (arow + 16 * i) * A_LD + 32 * p + acol);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t raw[4];
      ldmatrix_x4_trans(raw, wsl + 16 * ((bcol / 16 + j) ^ bswz));
      // [k half][even, odd column]: 4 k of one column each, natural order
      const uint32_t b[2][2] = {
          {__byte_perm(raw[0], raw[1], 0x6420),
           __byte_perm(raw[0], raw[1], 0x7531)},
          {__byte_perm(raw[2], raw[3], 0x6420),
           __byte_perm(raw[2], raw[3], 0x7531)}};
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b0 = widen(b[0][h], p), b1 = widen(b[1][h], p);
#pragma unroll
          for (int i = 0; i < MI; ++i) mma_s8(acc[i][j][h], af[p][i], b0, b1);
        }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load_step(t);
  if constexpr (FUSED) {
    cp_async_wait<STAGES - 2>();       // k-step 0 (this thread's copies)
    __syncthreads();
    quantize(0);
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 3>();       // k-steps <= t + 1 have landed ...
    __syncthreads();                   // ... every thread's; slot t - 1 free
    load_step(t + STAGES - 1);
    if constexpr (FUSED)
      if (t + 1 < nsteps) quantize(t + 1);
    compute(t);
  }
  cp_async_wait<0>();

  // fragment (i, j, h), element f: row g (+ 8 for f >= 2), column
  // 4t + 2 (f % 2) + h of the 16-column block
  const int g = lane / 4, tq = lane % 4;
  auto epilogue = [&](int gm, int gn, const int (&v)[4]) {
    if (gm >= M) return;
    const float sa = a_scale[gm];
    float* o = out + (size_t)gm * N + gn;
    if (gn + 3 < N && N % 4 == 0) {
      const float4 s4 = *reinterpret_cast<const float4*>(w_scale + gn);
      *reinterpret_cast<float4*>(o) = make_float4(
          ((float)(v[0] >> 4) * sa) * s4.x, ((float)(v[1] >> 4) * sa) * s4.y,
          ((float)(v[2] >> 4) * sa) * s4.z, ((float)(v[3] >> 4) * sa) * s4.w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (gn + c < N) o[c] = ((float)(v[c] >> 4) * sa) * w_scale[gn + c];
    }
  };

  if (gridDim.y == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int v[4] = {acc[i][j][0][2 * r], acc[i][j][1][2 * r],
                            acc[i][j][0][2 * r + 1], acc[i][j][1][2 * r + 1]};
          epilogue(m0 + wm * 16 * MI + 16 * i + g + 8 * r,
                   n0 + bcol + 16 * j + 4 * tq, v);
        }
    return;
  }

  // split K: the partial tile into shared memory, then each CTA of the
  // cluster sums its slice of the tile over the splits, in split order
  __syncthreads();                     // every warp is done with the ring
  int* red = reinterpret_cast<int*>(smem);      // [BM][BN]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wm * 16 * MI + 16 * i + g + 8 * r;
        *reinterpret_cast<int4*>(red + row * BN + bcol + 16 * j + 4 * tq) =
            make_int4(acc[i][j][0][2 * r], acc[i][j][1][2 * r],
                      acc[i][j][0][2 * r + 1], acc[i][j][1][2 * r + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = gridDim.y;
  for (int u = split * THREADS + tid; u < BM * BN / 4;
       u += splits * THREADS) {
    int v[4] = {0, 0, 0, 0};
    for (int q = 0; q < splits; ++q) {
      const int4 p = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(red, q) + 4 * u);
      v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
    }
    epilogue(m0 + 4 * u / BN, n0 + 4 * u % BN, v);
  }
  cluster.sync();                      // keep this CTA's partials alive
}

template <int BM, int BN, bool FUSED>
cudaError_t launch(const void* a, const void* a_scale, const void* w,
                   const void* w_scale, void* out, int M, int K, int N,
                   int Kh, int rows_per_split, int splits, bool a_vec,
                   bool w_vec, cudaStream_t st) {
  constexpr int bytes = Layout<BM, BN, FUSED>::BYTES;
  auto kernel = w4a4_mma_kernel<BM, BN, FUSED>;
  if constexpr (bytes > 48 * 1024) {   // the fused 64-row tiles
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = splits;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a, (const float*)a_scale,
                            (const uint8_t*)w, (const float*)w_scale,
                            (float*)out, M, K, N, Kh, rows_per_split, a_vec,
                            w_vec);
}

template <bool FUSED>
int launch_plan(const void* a, const void* a_scale, const void* w,
                const void* w_scale, void* out, int M, int K, int N, int Kh,
                int bm, int bn, int vec, int rows_per_split, int splits,
                void* stream) {
  const bool vec_ok = vec == 1 || (vec == 16 && N % 16 == 0
                                   && (uintptr_t)w % 16 == 0);
  if (!vec_ok || splits < 1 || splits > MAX_SPLITS || rows_per_split < 1
      || (splits > 1 && rows_per_split % BKH != 0)
      || (long long)splits * rows_per_split < Kh
      || (long long)(splits - 1) * rows_per_split >= Kh
      || 2 * Kh < K || 2 * Kh > K + 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte activation loads where every k-step's rows start 16-byte
  // aligned in both planes: f32 x with K % 8 == 0, int8 a_q with K % 32 == 0
  const bool a_vec = (uintptr_t)a % 16 == 0
                     && K % (FUSED ? 8 : 32) == 0;
  cudaStream_t st = (cudaStream_t)stream;
#define W4A4_TILE(BM_, BN_)                                                   \
  if (bm == BM_ && bn == BN_)                                                 \
    return (int)launch<BM_, BN_, FUSED>(a, a_scale, w, w_scale, out, M, K, N, \
                                        Kh, rows_per_split, splits, a_vec,    \
                                        vec == 16, st);
  W4A4_TILE(16, 64)
  W4A4_TILE(32, 64)
  W4A4_TILE(64, 64)
  W4A4_TILE(64, 128)
#undef W4A4_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan is `w4a4_plan` in kernels/int4_matmul.py: bm x bn output tiles
// ((16, 64), (32, 64), (64, 64) or (64, 128)), vec = 16 or 1 bytes per
// weight load, `splits` splits (at most 8, one cluster) of
// `rows_per_split` packed rows (a multiple of 32 where splits > 1).

// x [M, K] f32: quantized per row in the kernel
extern "C" int w4a4_fused_launch(const void* x, const void* a_scale,
                                 const void* w, const void* w_scale, void* out,
                                 int M, int K, int N, int Kh, int bm, int bn,
                                 int vec, int rows_per_split, int splits,
                                 void* stream) {
  return launch_plan<true>(x, a_scale, w, w_scale, out, M, K, N, Kh, bm, bn,
                           vec, rows_per_split, splits, stream);
}

// a_q [M, K] int8 holding int4 values, quantized by the caller
extern "C" int w4a4_launch(const void* a_q, const void* a_scale,
                           const void* w, const void* w_scale, void* out,
                           int M, int K, int N, int Kh, int bm, int bn,
                           int vec, int rows_per_split, int splits,
                           void* stream) {
  return launch_plan<false>(a_q, a_scale, w, w_scale, out, M, K, N, Kh, bm,
                            bn, vec, rows_per_split, splits, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
