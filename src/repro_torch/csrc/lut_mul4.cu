// Elementwise exact int4 x int4 -> int8 product through the 256-entry
// product table: out[i] = lut[(a[i] & 0xF) << 4 | (b[i] & 0xF)].
//
// Replaces: src/repro/kernels/lut_mul4.py::lut_mul4 (Pallas `_kernel_onehot`
//   and `_kernel_take`).  On the TPU the two strategies are two ways to read
//   a table (a one-hot contraction on the MXU, a lane gather on the VPU);
//   on this card both are one shared-memory read, so they are one kernel.
//
// What bounds it on the card: memory; each element reads two bytes and
// writes one, and the table read is on chip.  At the sizes it is called
// with (1M elements, 3 MB) a call is a few microseconds, so the launch and
// the first loads' latency bound it.  What the design does about it: each
// thread moves 16 elements, a 16-byte load of a and of b issued before the
// table is copied (so their latency overlaps the copy) and one 16-byte
// store; the grid is sized to the elements (1M -> 256 blocks of 256
// threads).  Four table indices are formed in one word
// ((a & 0x0F0F0F0F) << 4 | b & 0x0F0F0F0F) and each product is one
// shared-memory read from one 256-byte copy of the table.  32
// lane-private copies (word w of lane l at [w * 32 + l], 8 KB), so that a
// warp's reads never share a bank, measured slower at 1M elements (their
// fill is 8 stores a thread against one store by 64 threads;
// decode_ablation.py, `onecopy` / `lanecopies`).  Where a, b and out do
// not share their address modulo 16, every element is read as a byte; the
// head before the first 16-byte boundary and the tail after the last whole
// vector are read as bytes by the first thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EPT = 16;              // elements a thread: one vector

struct Table {
  uint32_t w[64];

  __device__ __forceinline__ void fill(const uint32_t* __restrict__ lut) {
    if (threadIdx.x < 64) w[threadIdx.x] = lut[threadIdx.x];
  }

  __device__ __forceinline__ uint32_t at(uint32_t idx) const {
    return (w[idx >> 2] >> ((idx & 3) * 8)) & 0xFFu;
  }

  // the four products of the int4 pairs in the bytes of wa and wb
  __device__ __forceinline__ uint32_t mul4(uint32_t wa, uint32_t wb) const {
    const uint32_t idx = ((wa & 0x0F0F0F0Fu) << 4) | (wb & 0x0F0F0F0Fu);
    return at(idx & 0xFF) | (at((idx >> 8) & 0xFF) << 8)
           | (at((idx >> 16) & 0xFF) << 16) | (at(idx >> 24) << 24);
  }

  __device__ __forceinline__ int8_t mul1(int8_t a, int8_t b) const {
    return (int8_t)at((((uint32_t)(uint8_t)a & 0xFu) << 4)
                      | ((uint32_t)(uint8_t)b & 0xFu));
  }
};

static_assert(THREADS >= 64, "64 threads copy the table");

// vec: thread i takes the 16-element vector i (i < nvec) at head + 16 i,
// and thread 0 also the elements before head and from head + 16 nvec on,
// as bytes; else thread i takes elements 16 i .. 16 i + 15 as bytes.
__global__ void __launch_bounds__(THREADS) lut_mul4_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const uint32_t* __restrict__ lut, int8_t* __restrict__ out, long long n,
    int head, long long nvec, int vec) {
  __shared__ Table T;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool body = vec && i < nvec;
  uint4 va, vb;
  if (body) {                          // in flight while the table is copied
    va = reinterpret_cast<const uint4*>(a + head)[i];
    vb = reinterpret_cast<const uint4*>(b + head)[i];
  }
  T.fill(lut);
  __syncthreads();
  if (body)
    reinterpret_cast<uint4*>(out + head)[i] =
        make_uint4(T.mul4(va.x, vb.x), T.mul4(va.y, vb.y),
                   T.mul4(va.z, vb.z), T.mul4(va.w, vb.w));
  if (vec) {
    if (i == 0) {
      for (int e = 0; e < head; ++e) out[e] = T.mul1(a[e], b[e]);
      for (long long e = head + EPT * nvec; e < n; ++e)
        out[e] = T.mul1(a[e], b[e]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      if (i * EPT + k < n) out[i * EPT + k] = T.mul1(a[i * EPT + k],
                                                     b[i * EPT + k]);
  }
}

// An empty kernel on lut_mul4_kernel's grid: the floor of a launch, for
// measurement only.
__global__ void __launch_bounds__(THREADS) lut_mul4_floor_kernel() {}

// The launch's plan: (head, nvec, vec, blocks).
void plan(const void* a, const void* b, const void* out, long long n,
          int* head, long long* nvec, int* vec, long long* blocks) {
  const uintptr_t ra = (uintptr_t)a % 16;
  *vec = ra == (uintptr_t)b % 16 && ra == (uintptr_t)out % 16;
  if (*vec) {
    *head = (int)((16 - ra) % 16);
    if (*head > n) *head = (int)n;
    *nvec = (n - *head) / EPT;
    *blocks = (*nvec + THREADS - 1) / THREADS;
    if (*blocks == 0) *blocks = 1;
  } else {
    *head = 0;
    *nvec = 0;
    *blocks = ((n + EPT - 1) / EPT + THREADS - 1) / THREADS;
  }
}

}  // namespace

// lut: the 256-byte table (ref.make_product_lut), 4-byte aligned.
extern "C" int lut_mul4_launch(const void* a, const void* b, const void* lut,
                               void* out, long long n, void* stream) {
  if (n <= 0 || (uintptr_t)lut % 4) return (int)cudaErrorInvalidValue;
  int head, vec;
  long long nvec, blocks;
  plan(a, b, out, n, &head, &nvec, &vec, &blocks);
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  lut_mul4_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (const uint32_t*)lut, (int8_t*)out,
      n, head, nvec, vec);
  return (int)cudaGetLastError();
}

// The empty kernel on the grid lut_mul4_launch takes for these operands.
extern "C" int lut_mul4_floor_launch(const void* a, const void* b,
                                     const void* out, long long n,
                                     void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int head, vec;
  long long nvec, blocks;
  plan(a, b, out, n, &head, &nvec, &vec, &blocks);
  lut_mul4_floor_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
