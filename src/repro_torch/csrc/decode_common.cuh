// The per-row body shared by the two decode kernels that read the paged KV
// pool in place: csrc/paged_decode.cu (rows are batch rows) and
// csrc/ragged_decode.cu (rows are packed token rows).  The two kernels
// differ only in how a CTA finds its block-table row and its last
// position; everything after that is `attend_split`, with the same split of
// the table's width, so a row gets bit for bit the same output from either
// kernel.
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
//
// The split: the table's width W = pps * ps tokens is cut into nsplit <= 8
// ranges of split_tok tokens (a multiple of ps, at most W, nsplit =
// ceil(W / split_tok); `plan_ok`, mirrored by `decode_split_ok` in
// kernels/paged_attention.py).  The wrappers pick it from the table's
// width, page size, KV heads, head dim and pool dtype alone (the rule,
// `split_plan`, mirrored by `decode_plan`, at least min(64, W) tokens a
// split; or the one tuned entry both kernels read), so a decode-only ragged
// pack and the paged batch it packs get the same split.  A row's nsplit CTAs (grid z)
// form one thread-block cluster.  Each CTA
//   1. loads its range's table entries and q (as f32) into shared memory,
//      their loads issued beside the row's lp,
//   2. walks its live tokens (its range cut to [lp - window + 1, lp]) CHUNK
//      at a time: every thread issues its share of the chunk's K and V rows
//      as LOAD_BYTES-byte loads back to back, then dequantizes them to bf16
//      rows in shared memory (pitch HD + 8, so the QK reads below hit 32
//      banks); thread (token j, heads h, h + 4, h + 8) takes the dots of
//      token j with its heads (h = warp / 2; a third head only at G = 9),
//      each one f32 FMA chain over the dims; warp w then runs the online
//      softmax of heads w and w + 8 (the second only at G = 9) over the
//      chunk (token j in lane j % 32) and their PV, lane l holding dims
//      HD / 32 * l .. HD / 32 * l + HD / 32 - 1 (two at HD 64, four at HD
//      128), one FMA chain in token order per dim,
//   3. writes its partial (m, l per head; acc per output element; m =
//      -1e30, l = 0, acc = 0 for a CTA with no live token) through
//      distributed shared memory into the rank that merges each element:
//      the row's G * HD outputs are cut into nsplit slices, rank r merging
//      the r-th; after one cluster barrier each rank merges its slice in
//      rank order, so two calls give the same bits, and writes it.
// Distributed shared memory may be written only once every CTA of the
// cluster is known to run: each CTA arrives on a cluster barrier before its
// walk and waits on it before its push, so the wait costs little.
// The arithmetic at HD 64 is that of the first design (G <= 8: two heads a
// thread in QK, one head a warp, rank 0 merging every element), so its
// outputs are bit for bit those.  Shared memory is static (Smem below):
// 46,944 bytes at HD 128 and G <= 9.
// A row with lp < 0 (idle, or padding) is written as zeros by rank 0 and
// its whole cluster returns before any barrier.  The arithmetic is written
// with the _rn intrinsics so no compiler contraction can make the two
// kernels round differently.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_common {

namespace cg = cooperative_groups;

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;             // warps per CTA
constexpr int THREADS = NW * 32;
constexpr int CHUNK = 64;         // tokens staged in shared memory per round
constexpr int LOAD_BYTES = 16;    // bytes per K/V load instruction
constexpr int MIN_SPLIT_TOK = 64; // a split's least width (or the table's)
constexpr int MAX_SPLITS = 8;     // CTAs a row: the portable cluster size

// pool element types, as the wrappers name them (kernels/paged_attention.py)
enum PoolKind : int { POOL_BF16 = 0, POOL_INT8 = 1, POOL_INT4 = 2 };

// The split of a table `width` tokens wide with pages of ps tokens
// (kernels/paged_attention.py::decode_plan): the fewest tokens a split,
// rounded up to whole pages, with at most MAX_SPLITS splits and at least
// min(MIN_SPLIT_TOK, width) tokens each.
__host__ __device__ inline void split_plan(int width, int ps, int* split_tok,
                                           int* nsplit) {
  int lo = (width + MAX_SPLITS - 1) / MAX_SPLITS;
  const int least = width < MIN_SPLIT_TOK ? width : MIN_SPLIT_TOK;
  if (lo < least) lo = least;
  *split_tok = (lo + ps - 1) / ps * ps;
  *nsplit = (width + *split_tok - 1) / *split_tok;
}

// A split the kernels take (kernels/paged_attention.py::decode_split_ok):
// whole pages a split, no wider than the table, nsplit = ceil(width /
// split_tok) CTAs a row, at most MAX_SPLITS (one portable cluster).  Each
// CTA's table entries are split_tok / ps ints of dynamic shared memory
// (`launch_split` raises the limit past 48 KB, the wrappers keep it within
// the block's), and the merge's slices of the G * HD outputs,
// ceil(G * HD / nsplit) each, fit Merge::acc at every nsplit from 1.
inline bool plan_ok(int pps, int ps, int split_tok, int nsplit) {
  if (pps < 1 || ps < 1) return false;
  const int width = pps * ps;
  if (split_tok < ps || split_tok % ps || split_tok > width) return false;
  return nsplit == (width + split_tok - 1) / split_tok && nsplit >= 1
      && nsplit <= MAX_SPLITS;
}

// Launch `kernel` on grid (rows, KV, nsplit), the nsplit CTAs of a
// (row, KV head) one cluster, with `dyn_smem` bytes of dynamic shared
// memory (the split's table entries) beside `static_smem` bytes of static
// shared memory; returns the launch's cudaError_t.
template <typename Kernel, typename... Args>
int launch_split(Kernel kernel, int rows, int KV, int nsplit, int dyn_smem,
                 int static_smem, cudaStream_t st, Args... args) {
  if (static_smem + dyn_smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows, KV, nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn_smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = nsplit;
  cfg.attrs = at;
  cfg.numAttrs = nsplit > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// barrier.cluster in two halves: arrive (no memory order) and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two bf16 values, dequantized: lo and hi halves of a 32-bit word.
__device__ __forceinline__ uint32_t dequant2(int q0, int q1, float s) {
  return bf16_bits(__fmul_rn((float)q0, s))
         | (bf16_bits(__fmul_rn((float)q1, s)) << 16);
}

// Pool rows as the kernel sees them: bytes per (token, head) row and bf16
// words (two elements) that one 32-bit word of the pool expands to.
template <typename PoolT, int HD> struct Row;
template <int HD> struct Row<__nv_bfloat16, HD> {
  static constexpr int BYTES = HD * 2, WORDS_OUT = 1;
  static constexpr bool QUANT = false;
};
template <int HD> struct Row<int8_t, HD> {
  static constexpr int BYTES = HD, WORDS_OUT = 2;
  static constexpr bool QUANT = true;
};
template <int HD> struct Row<uint8_t, HD> {
  static constexpr int BYTES = HD / 2, WORDS_OUT = 4;
  static constexpr bool QUANT = true;
};

// One 32-bit pool word -> Row::WORDS_OUT words of bf16 pairs.
__device__ __forceinline__ void expand(__nv_bfloat16*, uint32_t w, float,
                                       uint32_t* o) {
  o[0] = w;
}
__device__ __forceinline__ void expand(int8_t*, uint32_t w, float s,
                                       uint32_t* o) {
  const int b0 = (int)(int8_t)(w & 0xFF), b1 = (int)(int8_t)((w >> 8) & 0xFF);
  const int b2 = (int)(int8_t)((w >> 16) & 0xFF), b3 = (int)(int8_t)(w >> 24);
  o[0] = dequant2(b0, b1, s);
  o[1] = dequant2(b2, b3, s);
}
__device__ __forceinline__ void expand(uint8_t*, uint32_t w, float s,
                                       uint32_t* o) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = (w >> (8 * i)) & 0xFF;
    o[i] = dequant2(((b & 0xF) ^ 8) - 8, ((b >> 4) ^ 8) - 8, s);
  }
}

// the register type of one K/V load (16 bytes; 4 in decode_ablation.py's
// `narrow`)
template <int NB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<4> { using T = uint32_t; };

// What one rank of a row's cluster receives to merge: every rank's running
// max and sum of each head, and every rank's partial PV of the rank's slice
// of the row's G * HD outputs (per = ceil(G * HD / nsplit) elements: rank
// r's element i of the slice at acc[r * per + i]).
template <int MAXG, int HD> struct Merge {
  float m[MAX_SPLITS][MAXG], l[MAX_SPLITS][MAXG];
  float acc[MAXG * HD + MAX_SPLITS];
};

// A CTA's static shared memory: the staged K/V chunk (pitch HD + 8 bf16),
// q as f32, the chunk's scores and probabilities, and what the CTA's peers
// push for it to merge.  46,944 bytes at HD 128, MAXG 9 (25,120 at HD 64,
// MAXG 8).
template <int HD, int MAXG> struct Smem {
  __nv_bfloat16 kv[2][CHUNK][HD + 8];
  float q[MAXG][HD];
  float p[MAXG][CHUNK];
  Merge<MAXG, HD> merge;
};

// The (head dim, most query heads a KV head) pairs the kernels are built
// for: hd 64 up to G = 8 (qwen2-0.5b's 7, musicgen-large's 1) and hd 128
// up to G = 9 (qwen3-4b's 4, qwen2-vl-2b's and internlm2-20b's 6,
// starcoder2-7b's 9).  The entry points refuse any other shape.
constexpr int HD_SMALL = 64, MAXG_SMALL = 8;
constexpr int HD_LARGE = 128, MAXG_LARGE = 9;
// The CTAs an SM each head dim's kernels are compiled for
// (`__launch_bounds__`): ptxas, left to itself, took the int8 ragged kernel
// at HD 128 down to 64 registers and spilled 36 bytes; at 2 CTAs an SM it
// takes 96 to 127 registers at HD 128 (int4, int8, bf16) and no spill, and
// at 4 the HD 64 kernels keep to 64.
template <int HD> constexpr int MIN_CTAS = HD == HD_LARGE ? 2 : 4;
inline bool shape_ok(int hd, int H, int KV) {
  if (KV < 1 || H % KV) return false;
  const int G = H / KV;
  return (hd == HD_SMALL && G <= MAXG_SMALL)
      || (hd == HD_LARGE && G <= MAXG_LARGE);
}

// DPL consecutive bf16 dims of a staged row as f32: 2 (one 32-bit word)
// at HD 64, 4 (one 64-bit word) at HD 128.
template <int DPL>
__device__ __forceinline__ void load_dims(const __nv_bfloat16* row,
                                          float* out) {
  static_assert(DPL == 2 || DPL == 4, "two or four dims a lane");
  uint32_t w[DPL / 2];
  if constexpr (DPL == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(row);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(row);
    w[0] = v.x;
    w[1] = v.y;
  }
#pragma unroll
  for (int i = 0; i < DPL / 2; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// One split of one row's attention for the G query heads of KV head hk: q
// and out point at the row's [G, HD] slice, tbl_row at its block-table row
// (pps entries).  Every thread of every CTA of the row's cluster calls it;
// `tbl_s` is dynamic shared memory of split_tok / ps ints.
template <int HD, int MAXG, typename PoolT>
__device__ __forceinline__ void attend_split(
    const __nv_bfloat16* __restrict__ q, const PoolT* __restrict__ kpool,
    const PoolT* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ tbl_row, int lp,
    __nv_bfloat16* __restrict__ out, int hk, int KV, int G, int P, int ps,
    int pps, int window, float scale, int split_tok, int* tbl_s) {
  static_assert((HD == HD_SMALL && MAXG <= MAXG_SMALL)
                || (HD == HD_LARGE && MAXG <= MAXG_LARGE),
                "an instantiated (head dim, G) pair");
  using R = Row<PoolT, HD>;
  constexpr int LD = HD + 8;                    // bf16 pitch of a staged row
  constexpr int VPR = R::BYTES / LOAD_BYTES;    // loads per pool row
  constexpr int WPL = LOAD_BYTES / 4;           // pool words per load
  constexpr int NLOAD = 2 * CHUNK * VPR;        // loads per chunk, K and V
  constexpr int PER_T = (NLOAD + THREADS - 1) / THREADS;
  constexpr int TOK_WARPS = CHUNK / 32;         // warps a head's tokens take
  constexpr int QK_SLOTS = NW / TOK_WARPS;      // heads a QK pass takes
  constexpr int HPT = (MAXG + QK_SLOTS - 1) / QK_SLOTS;  // QK heads a thread
  constexpr int HPW = (MAXG + NW - 1) / NW;     // softmax/PV heads a warp
  constexpr int DPL = HD / 32;                  // PV dims a lane
  static_assert(R::BYTES % LOAD_BYTES == 0, "whole loads per row");
  static_assert(NW % TOK_WARPS == 0 && HD % 32 == 0, "the warp mappings");
  using V = typename Vec<LOAD_BYTES>::T;

  __shared__ __align__(16) Smem<HD, MAXG> sm;
  auto& kv_s = sm.kv;
  auto& q_s = sm.q;
  auto& p_s = sm.p;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.z, nsplit = gridDim.z;
  const int s0 = rank * split_tok, page0 = s0 / ps;

  // the split's table entries and q do not wait for lp: their loads are
  // in flight with its load
  for (int i = tid; i < min(split_tok / ps, pps - page0); i += THREADS)
    tbl_s[i] = min(tbl_row[page0 + i], P - 1);
  for (int e = tid; e < G * HD; e += THREADS)
    q_s[e / HD][e % HD] = __bfloat162float(q[e]);

  if (lp < 0) {                          // the whole cluster leaves together
    if (rank == 0)
      for (int e = tid; e < G * HD; e += THREADS)
        out[e] = __float2bfloat16_rn(0.0f);
    return;
  }
  if (nsplit > 1) cluster_arrive_relaxed();   // this CTA runs

  const int width = pps * ps;
  const int t_start = window > 0 ? max(0, lp - window + 1) : 0;
  const int t_lo = max(s0, t_start);
  const int t_hi = min(min(s0 + split_tok, width), lp + 1);   // exclusive

  // the warp's heads warp, warp + NW, ...: their running max, sum and
  // the lane's DPL dims of each one's PV
  float m[HPW], l[HPW], acc[HPW][DPL];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int x = 0; x < DPL; ++x) acc[i][x] = 0.0f;
  }
  for (int c0 = t_lo; c0 < t_hi; c0 += CHUNK) {
    const int n = min(CHUNK, t_hi - c0);
    __syncthreads();                     // table, q, and the last chunk read
    // stage: every load of the chunk in flight before any is used
    V raw[PER_T];
    float sc[PER_T];
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const int v = tid + i * THREADS;
      const int j = (v % (CHUNK * VPR)) / VPR, part_i = v % VPR;
      const bool is_v = v >= CHUNK * VPR;
      sc[i] = 1.0f;
      if (v < NLOAD && j < n) {
        const int t = c0 + j;
        const size_t row =
            ((size_t)tbl_s[t / ps - page0] * ps + t % ps) * KV + hk;
        const PoolT* pool = is_v ? vpool : kpool;
        raw[i] = *reinterpret_cast<const V*>(
            reinterpret_cast<const uint8_t*>(pool) + row * R::BYTES
            + part_i * LOAD_BYTES);
        if constexpr (R::QUANT) sc[i] = (is_v ? vscale : kscale)[row];
      }
    }
#pragma unroll
    for (int i = 0; i < PER_T; ++i) {
      const int v = tid + i * THREADS;
      const int j = (v % (CHUNK * VPR)) / VPR, part_i = v % VPR;
      if (v < NLOAD && j < n) {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw[i]);
        constexpr int NO = WPL * R::WORDS_OUT;  // bf16 pairs this load holds
        uint32_t o[NO];
#pragma unroll
        for (int k = 0; k < WPL; ++k)
          expand((PoolT*)nullptr, w[k], sc[i], o + k * R::WORDS_OUT);
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(&kv_s[v >= CHUNK * VPR][j][0])
            + part_i * NO;
        if constexpr (NO % 4 == 0) {
#pragma unroll
          for (int k = 0; k < NO; k += 4)
            *reinterpret_cast<uint4*>(dst + k) =
                make_uint4(o[k], o[k + 1], o[k + 2], o[k + 3]);
        } else {
#pragma unroll
          for (int k = 0; k < NO; ++k) dst[k] = o[k];
        }
      }
    }
    __syncthreads();
    // QK: thread (token j, heads h, h + QK_SLOTS, ...), one FMA chain per
    // head
    {
      const int j = (warp % TOK_WARPS) * 32 + lane, h = warp / TOK_WARPS;
      if (j < n && h < G) {
        float d[HPT];
#pragma unroll
        for (int i = 0; i < HPT; ++i) d[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < HD; c += 8) {
          const uint4 kw = *reinterpret_cast<const uint4*>(&kv_s[0][j][c]);
          const uint32_t kk[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const float kf = __uint_as_float(
                x % 2 ? kk[x / 2] & 0xFFFF0000u : kk[x / 2] << 16);
#pragma unroll
            for (int i = 0; i < HPT; ++i)
              if (h + i * QK_SLOTS < G)
                d[i] = __fmaf_rn(q_s[h + i * QK_SLOTS][c + x], kf, d[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < HPT; ++i)
          if (h + i * QK_SLOTS < G)
            p_s[h + i * QK_SLOTS][j] = __fmul_rn(bf16_round(d[i]), scale);
      }
    }
    __syncthreads();
    // softmax and PV: warp w takes heads w, w + NW, ...
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + i * NW;
      if (g >= G) break;
      const float s_a = lane < n ? p_s[g][lane] : NEG_INF;
      const float s_b = lane + 32 < n ? p_s[g][lane + 32] : NEG_INF;
      float cmax = fmaxf(s_a, s_b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
      const float m_new = fmaxf(m[i], cmax);
      const float alpha = expf(__fsub_rn(m[i], m_new));
      const float p_a = lane < n ? expf(__fsub_rn(s_a, m_new)) : 0.0f;
      const float p_b = lane + 32 < n ? expf(__fsub_rn(s_b, m_new)) : 0.0f;
      float psum = __fadd_rn(p_a, p_b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), psum);
      m[i] = m_new;
      p_s[g][lane] = p_a;
      p_s[g][lane + 32] = p_b;
      __syncwarp();
#pragma unroll
      for (int x = 0; x < DPL; ++x) acc[i][x] = __fmul_rn(acc[i][x], alpha);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float p = p_s[g][j];
        float vf[DPL];
        load_dims<DPL>(&kv_s[1][j][DPL * lane], vf);
#pragma unroll
        for (int x = 0; x < DPL; ++x) acc[i][x] = __fmaf_rn(p, vf[x], acc[i][x]);
      }
    }
  }

  // every rank's partial, element by element, into the shared memory of
  // the rank that merges it, once every rank is known to run; after one
  // cluster barrier each rank merges its slice in rank order
  cg::cluster_group cluster = cg::this_cluster();
  if (nsplit > 1) cluster_wait();
  const int total = G * HD, per = (total + nsplit - 1) / nsplit;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + i * NW;
    if (g >= G) break;
    if (lane < nsplit) {
      Merge<MAXG, HD>* dst =
          nsplit > 1 ? cluster.map_shared_rank(&sm.merge, lane) : &sm.merge;
      dst->m[rank][g] = m[i];
      dst->l[rank][g] = l[i];
    }
#pragma unroll
    for (int x = 0; x < DPL; ++x) {
      const int e = g * HD + DPL * lane + x, o = e / per;
      Merge<MAXG, HD>* dst =
          nsplit > 1 ? cluster.map_shared_rank(&sm.merge, o) : &sm.merge;
      dst->acc[rank * per + e - o * per] = acc[i][x];
    }
  }
  if (nsplit > 1) cluster.sync(); else __syncthreads();
  const Merge<MAXG, HD>& got = sm.merge;
  for (int e = rank * per + tid; e < min(total, (rank + 1) * per);
       e += THREADS) {
    const int g = e / HD, i = e - rank * per;
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < nsplit) M = fmaxf(M, got.m[r][g]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < nsplit) {
        const float f = expf(__fsub_rn(got.m[r][g], M));
        L = __fmaf_rn(got.l[r][g], f, L);
        A = __fmaf_rn(got.acc[r * per + i], f, A);
      }
    }
    out[e] = __float2bfloat16_rn(L > 0.0f ? __fdiv_rn(A, L) : 0.0f);
  }
}

}  // namespace decode_common
