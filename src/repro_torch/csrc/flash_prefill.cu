// Tiled causal GQA prefill attention with online softmax, on bf16 tensor
// cores.
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
// rows (padding queries) come out as exact zeros.  The reference's PV is an
// f32 product (p in f32, v widened); v is exact in bf16, so p is split as
// hi = bf16(p), lo = bf16(p - hi) and both go through bf16 MMAs against the
// same V fragments with f32 sums: what is lost is p's bits below 2^-16 of
// p, against 2^-9 for one bf16 p.
//
// What bounds it on the card: at the serving prompt lengths (<= a few
// hundred tokens) the work is ~4*H*hd operations per visible (query, key)
// pair on a few hundred KB of q/k/v: 0.07 us of bf16 tensor-core time and
// 0.3 us of memory time at Sq = 256, so neither roof binds; the kernel is
// bound by latency: the dependent global reads before the first tile, and
// the chain of loads, MMAs, exponentials and shuffles a warp runs per K/V
// tile, with at most one or two warps on an SM sub-partition to hide it.
// What the design does about it:
//  - Rows are the (query, head-in-group) pairs of one KV head, query-major
//    (row r = i * G + g, q's own memory order), so one CTA's rows share
//    every K/V tile it stages, and a 16-row tile spans few query
//    positions, which keeps the causal skip tight whatever G is.
//  - A 16-row tile is shared by WK = BK / KS warps, each taking KS keys of
//    every K/V tile with its own online softmax, which cuts each warp's
//    chain a tile by WK; at the end the slices merge through shared memory
//    in slice order (M = max m_w; O and L summed with weights
//    exp(m_w - M); out = O * (1 / L), within an f32 step of O / L), so two
//    calls give the same bits.  The plan picks KS (16 at hd 64 and 256,
//    32 at hd 128) and the row tiles a CTA.
//  - QK and PV run as mma.sync.m16n8k16 (bf16 in, f32 sums).  Q fragments
//    come once from the CTA's staged Q tile by ldmatrix and stay in
//    registers (hd 64 and 128; at hd 256 see below); K fragments by
//    ldmatrix (K [key][d] is the B operand column-major), V fragments by
//    ldmatrix.trans.  P's A fragments are the score accumulators
//    themselves (the m16n8k16 C layout of two n-tiles is the A layout of
//    one k-step), split into hi and lo.
//  - Head dim 256 (recurrentgemma-9b: 16 query heads over 1 KV head): a
//    thread's output accumulators alone are o[HD / 8][4] = 128 registers,
//    and held Q fragments would add qf[HD / 16][4] = 64 more, past what
//    ptxas can keep beside the scores and addresses without spilling.  So
//    at hd 256 the Q fragments are not held: each QK k-step reads its
//    fragment again from the staged Q tile by ldmatrix (the tile stays in
//    shared memory until the merge), and the warp takes 16 keys of each
//    tile (key split 4, s[2][4]), the fewest score registers.  The
//    arithmetic is the same MMA on the same fragments, so the bits are
//    those of a held fragment.  The K/V ring is 132.5 KB at hd 256, so one
//    CTA fills an SM's shared memory; the plan cuts the rows so that the
//    grid runs in as few waves as it can (16 or 32 rows a CTA).
//  - The softmax lives in registers: a thread holds two rows' scores, the
//    row max goes over the four threads of a quad by shuffles, the row sum
//    is kept per thread and summed over the quad once at the end.  Every
//    exponential is taken and then selected (a branch around each would
//    cost a reconvergence point apiece).
//  - K/V tiles of BK keys come into a STAGES-deep shared-memory ring by
//    16-byte cp.async (positions by 4-byte cp.async), tiles t + 1 ..
//    t + STAGES - 1 in flight while tile t is computed; each thread's
//    addresses are set once and stepped by constants.  Keys at or past
//    Skv are zero-filled (an MMA multiplies every element, and 0 x NaN is
//    NaN) with position -1.
//  - The key positions are read in one round of loads, with the query
//    positions, to find the first and the last tile some row of the CTA
//    can see (not past its largest query position, not wholly outside the
//    window of its smallest): the CTA walks only those, and a warp skips
//    the compute of a tile none of its rows can see in its slice.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;         // keys per K/V tile
constexpr int STAGES = 2;      // K/V tiles in the shared-memory ring
constexpr int MAX_WARPS = 8;   // warps a CTA
constexpr int SCAN = 16;       // key positions a thread reads per round
constexpr unsigned FULL = 0xffffffffu;
constexpr int INT_MAX_ = 0x7fffffff;

// Dynamic shared memory: the K and V rings, the ring's key positions and
// the CTA's Q tile.  Rows of HD + 8 bf16 keep the 8 rows of every ldmatrix
// on distinct banks.  After the last tile the same bytes hold each warp's
// partial output (rows of HD + 8 f32), row maxima and row sums for the
// merge of the key slices.
template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;
  static constexpr int PLD = HD + 8;    // f32 partial-output row
  static constexpr int TILE = BK * LD;  // bf16 elements of one K or V tile
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = K_OFF + (size_t)STAGES * TILE * 2;
  static constexpr size_t KP_OFF = V_OFF + (size_t)STAGES * TILE * 2;
  static constexpr size_t Q_OFF = KP_OFF + (size_t)STAGES * BK * 4;
  static constexpr size_t merge_bytes(int warps) {
    return (size_t)warps * 16 * (PLD * 4 + 8);
  }
  static constexpr size_t bytes(int rows, int warps) {
    return Q_OFF + (size_t)rows * LD * 2 > merge_bytes(warps)
               ? Q_OFF + (size_t)rows * LD * 2
               : merge_bytes(warps);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (p0, p1) as hi = bf16(p) and lo = bf16(p - hi) pairs, p0 in the low half
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(p0 - __low2float(h),
                                         p1 - __high2float(h)));
}

__device__ __forceinline__ bool sees(int qp, int kp, int window) {
  return kp >= 0 && qp >= kp && (window == 0 || qp - kp < window);
}

// hd 64 and 128 hold the warp's Q fragments in registers; hd 256 reads
// each k-step's fragment from the staged Q tile (see the header)
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 128; }

template <int HD, int KS>
__global__ void __launch_bounds__(MAX_WARPS * 32) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Sq, H, HD]
    const __nv_bfloat16* __restrict__ k,   // [B, Skv, KV, HD]
    const __nv_bfloat16* __restrict__ v,
    const int* __restrict__ qpos,          // [B, Sq]
    const int* __restrict__ kpos,          // [B, Skv]
    __nv_bfloat16* __restrict__ out,       // [B, Sq, H, HD]
    int Sq, int Skv, int H, int KV, int G, int window, float scale) {
  using L = Smem<HD>;
  constexpr int LD = L::LD;
  constexpr int CH = HD / 8;      // 16-byte chunks a row
  constexpr int WK = BK / KS;     // warps sharing a row tile, KS keys each
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  int* Kp = reinterpret_cast<int*>(smem + L::KP_OFF);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __shared__ int s_qmax, s_qmin, s_lo, s_hi;

  const int b = blockIdx.z, hk = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads / 32;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp / WK, kb0 = (warp % WK) * KS;  // row tile, first key
  const int R = G * Sq;                          // rows of this (b, hk)
  const int rows = nwarps / WK * 16;             // rows of the CTA
  const int r0 = blockIdx.x * rows, wr0 = r0 + wr * 16;
  // row r = i * G + g: query i, head hk * G + g
  auto row_off = [&](int r) -> size_t {
    const int i = r / G, g = r - i * G;
    return (((size_t)b * Sq + i) * H + hk * G + g) * HD;
  };

  if (tid == 0) {
    s_qmax = -1;
    s_qmin = INT_MAX_;
    s_lo = INT_MAX_;
    s_hi = -1;
  }

  // the CTA's Q tile (rows past R zero-filled), one cp.async group
  for (int e = tid; e < rows * CH; e += nthreads) {
    const int rr = e / CH, c = e % CH, r = r0 + rr;
    const bool ok = r < R;
    cp_async16(Qs + rr * LD + c * 8, q + (ok ? row_off(r) + c * 8 : 0), ok);
  }
  cp_async_commit();

  // key positions, SCAN a thread per round, all of a round's reads in
  // flight at once; the first round goes out with the query positions
  int kpr[SCAN];
  auto load_kpos = [&](int t0) {
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int t = t0 + u * nthreads + tid;
      kpr[u] = t < Skv ? kpos[(size_t)b * Skv + t] : -1;
    }
  };
  load_kpos(0);

  // the thread's two rows (the C fragment's rows lane / 4 and + 8)
  const int ra = wr0 + lane / 4, rb = ra + 8;
  const int qa = ra < R ? qpos[(size_t)b * Sq + ra / G] : -1;
  const int qb = rb < R ? qpos[(size_t)b * Sq + rb / G] : -1;
  int wqmax = max(qa, qb);
  int wqmin = min(qa >= 0 ? qa : INT_MAX_, qb >= 0 ? qb : INT_MAX_);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    wqmax = max(wqmax, __shfl_xor_sync(FULL, wqmax, off));
    wqmin = min(wqmin, __shfl_xor_sync(FULL, wqmin, off));
  }
  __syncthreads();
  if (lane == 0 && wqmax >= 0) {
    atomicMax(&s_qmax, wqmax);
    atomicMin(&s_qmin, wqmin);
  }
  __syncthreads();
  const int qmax = s_qmax, qmin = s_qmin;

  // the first and the last K/V tile holding a key some row can see
  int lo = INT_MAX_, hi = -1;
  for (int t0 = 0; qmax >= 0 && t0 < Skv; t0 += SCAN * nthreads) {
    if (t0) load_kpos(t0);
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int kp = kpr[u], t = t0 + u * nthreads + tid;
      if (kp >= 0 && kp <= qmax && (window == 0 || qmin - kp < window)) {
        lo = min(lo, t / BK);
        hi = max(hi, t / BK);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0 && hi >= 0) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  lo = s_lo;
  hi = s_hi;

  // tile kt -> ring slot st: K and V rows (zero past Skv) and positions
  // (-1 past Skv).  A thread copies 16-byte chunk c_t of rows r_t,
  // r_t + RSTEP, ...: its addresses are set once and stepped by constants.
  const int RSTEP = nthreads / CH, c_t = tid % CH, r_t = tid / CH;
  const size_t gstep = (size_t)RSTEP * KV * HD;
  const size_t g0 = (((size_t)b * Skv + r_t) * KV + hk) * HD + c_t * 8;
  auto load_tile = [&](int kt, int st) {
    const int key0 = kt * BK;
    const size_t off = g0 + (size_t)key0 * KV * HD;
    const __nv_bfloat16* kg = k + off;
    const __nv_bfloat16* vg = v + off;
    __nv_bfloat16* kd = Ks + st * L::TILE + r_t * LD + c_t * 8;
    __nv_bfloat16* vd = Vs + st * L::TILE + r_t * LD + c_t * 8;
#pragma unroll 4
    for (int rr = r_t; rr < BK; rr += RSTEP) {
      const bool ok = key0 + rr < Skv;
      cp_async16(kd, ok ? kg : k, ok);
      cp_async16(vd, ok ? vg : v, ok);
      kg += gstep;
      vg += gstep;
      kd += RSTEP * LD;
      vd += RSTEP * LD;
    }
    for (int e = tid; e < BK; e += nthreads) {
      if (key0 + e < Skv)
        cp_async4(Kp + st * BK + e, kpos + (size_t)b * Skv + key0 + e);
      else
        Kp[st * BK + e] = -1;
    }
  };

  // the first STAGES - 1 tiles, one cp.async group each (empty past hi)
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (lo + t <= hi) load_tile(lo + t, t);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();         // this thread's Q copies have landed
  __syncthreads();                     // and every other thread's
  constexpr bool QREG = q_in_registers<HD>();
  const __nv_bfloat16* qrow = Qs + (wr * 16 + lane % 16) * LD
                              + (lane / 16) * 8;
  uint32_t qf[QREG ? HD / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qf[kk], qrow + 16 * kk);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  const int c0 = 2 * (lane % 4);

  for (int kt = lo, n = 0; kt <= hi; ++kt, ++n) {
    if (kt + STAGES - 1 <= hi)
      load_tile(kt + STAGES - 1, (n + STAGES - 1) % STAGES);
    cp_async_commit();                 // one group a tile, empty at the end
    cp_async_wait<STAGES - 1>();       // tile kt (this thread's copies)
    __syncthreads();
    const int st = n % STAGES;
    // this warp's KS keys of the tile
    const __nv_bfloat16* Kt = Ks + st * L::TILE + kb0 * LD;
    const __nv_bfloat16* Vt = Vs + st * L::TILE + kb0 * LD;
    const int* kp_t = Kp + st * BK + kb0;

    bool any = false;
    for (int e = lane; e < KS; e += 32) {
      const int kp = kp_t[e];
      any |= kp >= 0 && kp <= wqmax && (window == 0 || wqmin - kp < window);
    }
    if (__any_sync(FULL, any)) {
      // S = Q K^T: KS / 8 n-tiles of 8 keys, HD / 16 k-steps
      float s[KS / 8][4];
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qk[4];
        if constexpr (QREG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qk[e] = qf[kk][e];
        } else {
          ldmatrix_x4(qk, qrow + 16 * kk);
        }
#pragma unroll
        for (int nn = 0; nn < KS / 16; ++nn) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Kt + (16 * nn + lane % 8 + (lane / 16) * 8) * LD
                              + 16 * kk + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * nn], qk, kf[0], kf[1]);
          mma_bf16(s[2 * nn + 1], qk, kf[2], kf[3]);
        }
      }
      // mask, bf16-round then scale; bit 4j + e: row a, 4j + 2 + e: row b
      uint32_t vis = 0;
      float xa = NEG_INF, xb = NEG_INF;
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = kp_t[8 * j + c0 + e];
          const bool oa = sees(qa, kp, window), ob = sees(qb, kp, window);
          vis |= ((uint32_t)oa << (4 * j + e)) | ((uint32_t)ob << (4 * j + 2 + e));
          s[j][e] = oa ? __bfloat162float(__float2bfloat16_rn(s[j][e])) * scale
                       : NEG_INF;
          s[j][2 + e] =
              ob ? __bfloat162float(__float2bfloat16_rn(s[j][2 + e])) * scale
                 : NEG_INF;
          xa = fmaxf(xa, s[j][e]);
          xb = fmaxf(xb, s[j][2 + e]);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        xa = fmaxf(xa, __shfl_xor_sync(FULL, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(FULL, xb, off));
      }
      const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
      const float aa = expf(ma - na), ab = expf(mb - nb);
      ma = na;
      mb = nb;
      // every exponential taken, then selected: a branch around each
      // would cost a reconvergence point apiece
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < KS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa = expf(s[j][e] - na), pb = expf(s[j][2 + e] - nb);
          s[j][e] = (vis >> (4 * j + e)) & 1u ? pa : 0.f;
          s[j][2 + e] = (vis >> (4 * j + 2 + e)) & 1u ? pb : 0.f;
          sa += s[j][e];
          sb += s[j][2 + e];
        }
      }
      la = la * aa + sa;
      lb = lb * ab + sb;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j][0] *= aa;
        o[j][1] *= aa;
        o[j][2] *= ab;
        o[j][3] *= ab;
      }
      // O += P V, P = hi + lo: KS / 16 k-steps, HD / 8 n-tiles
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vt + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LD
                                    + 16 * dd + (lane / 16) * 8);
          mma_bf16(o[2 * dd], ph, vf[0], vf[1]);
          mma_bf16(o[2 * dd], pl, vf[0], vf[1]);
          mma_bf16(o[2 * dd + 1], ph, vf[2], vf[3]);
          mma_bf16(o[2 * dd + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                   // slot st is free for a later tile
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring's bytes now hold partials

  // each warp's partial: o (f32), row max and row sum (summed over the quad)
  float* Po = reinterpret_cast<float*>(smem);
  float* Pm = Po + nwarps * 16 * L::PLD;
  float* Pl = Pm + nwarps * 16;
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    la += __shfl_xor_sync(FULL, la, off);
    lb += __shfl_xor_sync(FULL, lb, off);
  }
  float* mine = Po + warp * 16 * L::PLD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(mine + (lane / 4) * L::PLD + 8 * j + c0) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(mine + (lane / 4 + 8) * L::PLD + 8 * j + c0) =
        make_float2(o[j][2], o[j][3]);
  }
  if (lane % 4 == 0) {
    Pm[warp * 16 + lane / 4] = ma;
    Pm[warp * 16 + lane / 4 + 8] = mb;
    Pl[warp * 16 + lane / 4] = la;
    Pl[warp * 16 + lane / 4 + 8] = lb;
  }
  __syncthreads();

  // merge the row tile's WK key slices in slice order: M = max m_w,
  // O = sum_w exp(m_w - M) o_w, L likewise, out = O * (1 / L) (within an f32
  // step of O / L, one reciprocal for two outputs).  Warp w of the tile writes
  // columns [w * HD / WK, (w + 1) * HD / WK), two a thread per step.
  constexpr int CW = HD / WK;
  const int w0 = wr * WK;
  for (int e = lane; e < 16 * CW / 2; e += 32) {
    const int r = e / (CW / 2), d = (warp % WK) * CW + 2 * (e % (CW / 2));
    if (wr0 + r >= R) continue;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, Pm[(w0 + w) * 16 + r]);
    float Ls = 0.f, x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float f = expf(Pm[(w0 + w) * 16 + r] - M);
      const float* src = Po + ((w0 + w) * 16 + r) * L::PLD + d;
      Ls += f * Pl[(w0 + w) * 16 + r];
      x0 += f * src[0];
      x1 += f * src[1];
    }
    const float inv = __frcp_rn(Ls > 0.f ? Ls : 1.f);
    *reinterpret_cast<__nv_bfloat162*>(out + row_off(wr0 + r) + d) =
        __floats2bfloat162_rn(x0 * inv, x1 * inv);
  }
}

template <int HD, int KS>
int launch(const void* q, const void* k, const void* v, const void* qpos,
           const void* kpos, void* out, int B, int Sq, int Skv, int H, int KV,
           int window, float scale, int warps, cudaStream_t st) {
  const int rows = warps / (BK / KS) * 16;
  const size_t smem = Smem<HD>::bytes(rows, warps);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<HD, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int G = H / KV;
  dim3 grid((G * Sq + rows - 1) / rows, KV, B);
  flash_prefill_kernel<HD, KS><<<grid, 32 * warps, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)qpos, (const int*)kpos,
      (__nv_bfloat16*)out, Sq, Skv, H, KV, G, window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* qpos,
              const void* kpos, void* out, int B, int Sq, int Skv, int H,
              int KV, int window, float scale, int warps, int key_split,
              cudaStream_t st) {
  if constexpr (!q_in_registers<HD>()) {
    // 16 keys a warp: the only split whose scores fit beside o[HD / 8][4]
    if (key_split != 4) return (int)cudaErrorInvalidValue;
    return launch<HD, BK / 4>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, st);
  } else {
    switch (key_split) {
    case 1: return launch<HD, BK>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, st);
    case 2: return launch<HD, BK / 2>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, st);
    case 4: return launch<HD, BK / 4>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, st);
    default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// Returns a cudaError_t; cudaErrorInvalidValue for a head dim other than 64,
// 128 or 256, a key split other than 1, 2 or 4 (only 4 at hd 256; warps
// sharing a row tile), or
// warps that are not 1, 2, 4 or 8 row tiles' worth, at most MAX_WARPS (the
// plan's choices).  q, k and v must start 16-byte aligned.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* qpos,
                                    const void* kpos, void* out, int B, int Sq,
                                    int Skv, int H, int KV, int hd, int window,
                                    float scale, int warps, int key_split,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int row_tiles = key_split > 0 ? warps / key_split : 0;
  if (key_split < 1 || warps % key_split || warps > MAX_WARPS
      || (row_tiles != 1 && row_tiles != 2 && row_tiles != 4
          && row_tiles != 8))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_hd<64>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, key_split, st);
    case 128: return launch_hd<128>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, key_split, st);
    case 256: return launch_hd<256>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, window, scale, warps, key_split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
