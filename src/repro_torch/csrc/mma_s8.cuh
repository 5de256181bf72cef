// Shared int8 tensor-core tile of the two GEMM-shaped kernels (K3
// clause_votes.cu, K6 binary_matmul.cu).
//
// A block computes one BM x BN int32 tile of
//
//   acc[m, n] = sum_k A[m, k] * B[n, k]          (A, B int8, K-major)
//
// with mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the int8 tensor
// cores, fed by ldmatrix from shared memory.  Both operands sit K-major in
// shared memory (one row of BK bytes per m or n, padded to ROW bytes so
// that the eight rows an ldmatrix phase reads fall in eight distinct
// 16-byte bank groups).  The accumulation is int32 and exact for any int8
// operands while |acc| < 2^31.
//
// Work split.  The block's threads form KSPLIT groups of four warps; the
// four warps of a group tile BM x BN as 2 x 2 warp tiles of 32 x 32 (two
// m16 and four n8 mma tiles each).  Group g walks the depth chunks
// g, g + KSPLIT, ... through its own two shared-memory stages: the next
// chunk's loads are issued before the current chunk's mma steps and land
// after them, with one named barrier per chunk.  KSPLIT > 1 puts several
// chunks in flight at once, for tile grids too small to fill the card
// (a serving batch, the BNN's one GEMM); the groups then add their partial
// sums in shared memory, and group 0 ends holding the block's sums.  The
// depth is never split across blocks, so a kernel may test the whole sum
// (K3's viol == 0).
//
// An operand op supplies the staging of one chunk:
//   void issue(uint8_t* stage, int k0, int t)  start the loads of bytes
//       [k0, k0 + BK) of the block's A rows into stage[0 .. BM*ROW) and
//       B rows into stage[BM*ROW .. STAGE) (t: thread index in its group)
//   void land(uint8_t* stage, int t)           finish them (after the mma
//       steps of the current chunk; cp.async copies need nothing here)
// Bytes past the depth, rows past M and columns past N must land as zero.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "phase_clocks.cuh"

namespace mma_s8 {

constexpr int BM = 64, BN = 64;        // block tile
constexpr int BK = 128;                // depth bytes per staged chunk
constexpr int ROW = BK + 16;           // shared row stride, bytes
constexpr int GROUP = 128;             // threads per depth group (4 warps)
constexpr int STAGE = (BM + BN) * ROW;  // bytes of one stage (A then B)
constexpr int GROUP_SMEM = 2 * STAGE;   // two stages per group
constexpr int RED_LD = BN + 8;          // row stride of the int32 reduction
constexpr int RED_BYTES = BM * RED_LD * 4;
static_assert(RED_BYTES + BM * 8 <= GROUP_SMEM,
              "the reduction and K3's fire masks fit in one group's stages");

// acc[mt][nt][r]: the m16n8 C fragment of mma tile (mt, nt) of this warp;
// see each_acc for the (row, column) of each register
struct Acc {
  int32_t v[2][4][4];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_16832(int32_t (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier of one depth group's 128 threads (ids 1.., 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(GROUP) : "memory");
}

// the first `valid` (<= 0: none) of 16 bytes at p, zero beyond; one
// 16-byte load when `vec` (p 16-byte aligned) and all 16 are valid
__device__ __forceinline__ uint4 load16(const int8_t* p, int valid,
                                        bool vec) {
  if (vec && valid >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                  << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage rows [r0, r0 + 64) x bytes [k0, k0 + BK) of a row-major (rows, K)
// int8 matrix into a K-major shared tile (row stride ROW).  `vec`: K is a
// multiple of 16 and the base 16-byte aligned, so every 16-byte piece goes
// by cp.async (zero-filled past the matrix); otherwise byte loads.
__device__ __forceinline__ void stage_kmajor(uint8_t* tile,
                                             const int8_t* __restrict__ src,
                                             int rows, int r0, int K, int k0,
                                             bool vec, int t) {
#pragma unroll
  for (int i = 0; i < BM * BK / 16 / GROUP; ++i) {
    const int idx = t + GROUP * i;
    const int r = idx / (BK / 16), k = k0 + 16 * (idx % (BK / 16));
    const int valid = r0 + r < rows ? min(16, K - k) : 0;
    const int8_t* p = src + (static_cast<size_t>(r0 + r) * K + k);
    uint8_t* dst = tile + r * ROW + 16 * (idx % (BK / 16));
    if (vec)
      cp_async16(dst, valid > 0 ? p : src, max(valid, 0));
    else
      *reinterpret_cast<uint4*>(dst) = load16(p, valid, false);
  }
}

// One chunk's mma steps for this warp: BK / 32 k-steps over its 32 x 32
// warp tile.  kNotA: use (1 - a) for every A byte, by XOR with 1 — exact
// for {0,1} bytes, and a zero padding byte becomes 1, which meets a zero
// B byte.
template <bool kNotA>
__device__ __forceinline__ void warp_chunk(const uint8_t* As,
                                           const uint8_t* Bs, int wm, int wn,
                                           int lane, Acc& acc) {
#pragma unroll
  for (int s = 0; s < BK / 32; ++s) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ldmatrix_x4(a[mt], As + (wm * 32 + mt * 16 + lane % 16) * ROW +
                             s * 32 + (lane / 16) * 16);
      if (kNotA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mt][i] ^= 0x01010101u;
      }
    }
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldmatrix_x4(b[np], Bs + (wn * 32 + np * 16 + lane % 8 +
                               8 * (lane / 16)) * ROW +
                             s * 32 + ((lane / 8) % 2) * 16);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_16832(acc.v[mt][nt], a[mt], b[nt / 2][2 * (nt % 2)],
                  b[nt / 2][2 * (nt % 2) + 1]);
  }
}

// f(row, col, value) for each accumulator register of this thread, with
// its (row, column) in the block tile; `value` is a reference into acc
template <class A, class F>
__device__ __forceinline__ void each_acc(A& acc, int wm, int wn, int lane,
                                         F f) {
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(wm * 32 + mt * 16 + g + 8 * (r / 2), wn * 32 + nt * 8 + 2 * q + r % 2,
          acc.v[mt][nt][r]);
}

// Walk `n_chunks` depth chunks through `op` and return, in the registers
// of group 0, the block's BM x BN sums (the other groups' registers are
// partial).  Needs KSPLIT * GROUP_SMEM bytes of dynamic shared memory.
// Every thread of the block calls it; it ends with a __syncthreads, after
// which `smem` is free.
template <int KSPLIT, bool kNotA, class Op>
__device__ __forceinline__ void mma_tile(Op& op, uint8_t* smem, int n_chunks,
                                         Acc& acc) {
  const int kg = threadIdx.x / GROUP, t = threadIdx.x % GROUP;
  const int warp = t / 32, lane = t % 32, wm = warp / 2, wn = warp % 2;
  uint8_t* stages = smem + kg * GROUP_SMEM;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.v[mt][nt][r] = 0;

  if (kg < n_chunks) {
    op.issue(stages, kg * BK, t);
    op.land(stages, t);
  }
  cp_async_wait_all();
  group_sync(kg);
  PHASE(1);  // the first chunk staged (phase_clocks.cuh)
  int i = 0;
  for (int c = kg; c < n_chunks; c += KSPLIT, ++i) {
    uint8_t* cur = stages + (i & 1) * STAGE;
    uint8_t* nxt = stages + ((i + 1) & 1) * STAGE;
    const bool more = c + KSPLIT < n_chunks;
    if (more) op.issue(nxt, (c + KSPLIT) * BK, t);
    warp_chunk<kNotA>(cur, cur + BM * ROW, wm, wn, lane, acc);
    if (more) op.land(nxt, t);
    cp_async_wait_all();
    group_sync(kg);  // nxt is complete and cur is consumed
  }

  __syncthreads();  // every group is done with its stages
  if (KSPLIT > 1) {
    int32_t* red = reinterpret_cast<int32_t*>(smem);
    if (kg == 0)
      each_acc(acc, wm, wn, lane,
               [&](int r, int c, int v) { red[r * RED_LD + c] = v; });
    __syncthreads();
    if (kg != 0)
      each_acc(acc, wm, wn, lane,
               [&](int r, int c, int v) {
                 atomicAdd(red + r * RED_LD + c, v);
               });
    __syncthreads();
    if (kg == 0)
      each_acc(acc, wm, wn, lane,
               [&](int r, int c, int32_t& v) { v = red[r * RED_LD + c]; });
    __syncthreads();  // red is read before the caller reuses smem
  }
}

// Depth groups per block (1, 2 or 4): more than one only while the tile
// grid leaves SMs idle, and never more groups than chunks.
inline int pick_ksplit(long long tiles, int n_chunks, int n_sm) {
  int ks = 1;
  while (ks < 4 && tiles * ks < n_sm && 2 * ks <= n_chunks) ks *= 2;
  return ks;
}

// Launch `fn` (an instance with `ks` depth groups) on `ks` * GROUP threads
// and its dynamic shared memory, raising the per-kernel limit past 48 KB
// where needed.  Returns a cudaError_t.
template <class... P, class... A>
int launch(void (*fn)(P...), int ks, dim3 grid, cudaStream_t s, A... args) {
  const int smem = ks * GROUP_SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fn<<<grid, ks * GROUP, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma_s8
