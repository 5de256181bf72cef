// Shared skeleton of the two fused TM vote kernels (K1 swar_fused.cu,
// K3 clause_votes.cu).
//
// Both compute, for batch rows b and flattened clauses i = c*M + m,
//
//   viol[b,i]  = sum_w step(lhs[b,w], rhs[i,w])      (a violation count)
//   votes[b,c] = sum_i (viol[b,i] == 0) * vote_matrix[i,c]
//
// and differ only in what a word is and how `step` counts violations
// (popcount of an AND over packed bits, or an int8 dot product over four
// literals), which the Op template parameter supplies.
//
// Work split.  The TPU kernels ran a sequential grid whose second axis
// carried the (rows, C) vote block across clause tiles.  Hopper blocks run
// in parallel with no carry, so here a block owns BB batch rows and a
// contiguous slice of clause tiles (TC clauses each).  Its thread t takes
// (row t / TC, clause t % TC) of the tile, stages BB rows and TC clauses
// in KW-word chunks in shared memory, and keeps the violation count in a
// register; the fired flags of the tile go to shared memory and fold into
// the block's (BB, C) vote tile, each entry owned by one thread.  Neither
// the per-word intermediate nor the (B, CM) clause matrix reaches device
// memory.  When the batch alone gives too few blocks to fill the card, the
// clause axis is cut into slices across grid.y and the slices add their
// vote tiles into the output with int32 atomicAdd, which is exact and
// independent of order; the launcher zeroes the output first.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace tm_votes {

constexpr int BB = 8;             // batch rows per block
constexpr int TC = 32;            // clauses per tile (one warp's width)
constexpr int KW = 64;            // words per staged chunk
constexpr int THREADS = BB * TC;  // one (row, clause) pair per thread
constexpr int kStaticSmem =
    (BB + TC) * (KW + 1) * static_cast<int>(sizeof(uint32_t)) + BB * TC;

// Op provides, for rows b < B, clauses i < CM and words w < W:
//   uint32_t lhs(int b, int w), uint32_t rhs(int i, int w)
//   uint32_t step(uint32_t acc, uint32_t lhs_word, uint32_t rhs_word)
// where step adds the word's violations to acc.  Zero words must add
// nothing (they pad the ragged chunk edge).
template <class Op>
__global__ void __launch_bounds__(THREADS)
votes_kernel(Op op, const int8_t* __restrict__ vote_matrix,
             int32_t* __restrict__ out, int B, int CM, int W, int C,
             int tiles_per_slice) {
  // odd row stride (KW + 1): a warp's 32 clauses read 32 distinct banks
  __shared__ uint32_t lhs_s[BB][KW + 1];
  __shared__ uint32_t rhs_s[TC][KW + 1];
  __shared__ uint8_t fire_s[BB][TC];
  extern __shared__ int32_t acc_s[];  // (BB, C) vote tile

  const int tid = threadIdx.x;
  const int r = tid / TC;
  const int j = tid % TC;
  const int row0 = blockIdx.x * BB;
  const int n_tiles = (CM + TC - 1) / TC;
  const int t_begin = blockIdx.y * tiles_per_slice;
  const int t_end = min(n_tiles, t_begin + tiles_per_slice);

  for (int p = tid; p < BB * C; p += THREADS) acc_s[p] = 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int cm0 = t * TC;
    uint32_t viol = 0;
    for (int w0 = 0; w0 < W; w0 += KW) {
      __syncthreads();  // the previous chunk is consumed
      for (int p = tid; p < BB * KW; p += THREADS) {
        const int rr = p / KW, ww = p % KW;
        const int row = row0 + rr, w = w0 + ww;
        lhs_s[rr][ww] = (row < B && w < W) ? op.lhs(row, w) : 0u;
      }
      for (int p = tid; p < TC * KW; p += THREADS) {
        const int jj = p / KW, ww = p % KW;
        const int cm = cm0 + jj, w = w0 + ww;
        rhs_s[jj][ww] = (cm < CM && w < W) ? op.rhs(cm, w) : 0u;
      }
      __syncthreads();
      const int kw = min(KW, W - w0);
      for (int ww = 0; ww < kw; ++ww)
        viol = op.step(viol, lhs_s[r][ww], rhs_s[j][ww]);
    }
    // clauses past CM (the ragged last tile) never fire
    fire_s[r][j] = (viol == 0u && cm0 + j < CM) ? 1 : 0;
    __syncthreads();
    const int tc = min(TC, CM - cm0);
    for (int p = tid; p < BB * C; p += THREADS) {
      const int rr = p / C, c = p % C;
      int32_t s = 0;
      for (int jj = 0; jj < tc; ++jj)
        if (fire_s[rr][jj])
          s += vote_matrix[static_cast<size_t>(cm0 + jj) * C + c];
      acc_s[p] += s;
    }
    __syncthreads();  // fire_s is read before the next tile rewrites it
  }

  for (int p = tid; p < BB * C; p += THREADS) {
    const int row = row0 + p / C;
    if (row < B && acc_s[p] != 0)
      atomicAdd(&out[static_cast<size_t>(row) * C + p % C], acc_s[p]);
  }
}

// Zero `out` (B, C) int32 and launch votes_kernel on `stream` of `device`.
// Returns the cudaError_t of the last runtime call (0 = success); never
// synchronises.
template <class Op>
int launch(const Op& op, const void* vote_matrix, void* out, int B, int CM,
           int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * C * sizeof(int32_t),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (B + BB - 1) / BB;
  const int n_tiles = (CM + TC - 1) / TC;
  // about two blocks per SM: slice the clause axis only when the batch
  // alone leaves SMs idle
  int slices = (2 * n_sm + row_tiles - 1) / row_tiles;
  slices = std::max(1, std::min(slices, n_tiles));
  const int tiles_per_slice =
      n_tiles == 0 ? 0 : (n_tiles + slices - 1) / slices;
  if (tiles_per_slice > 0)
    slices = (n_tiles + tiles_per_slice - 1) / tiles_per_slice;
  const size_t smem = static_cast<size_t>(BB) * C * sizeof(int32_t);
  if (smem + kStaticSmem > 48 * 1024) {
    err = cudaFuncSetAttribute(votes_kernel<Op>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  votes_kernel<Op><<<dim3(row_tiles, slices), THREADS, smem, s>>>(
      op, static_cast<const int8_t*>(vote_matrix), static_cast<int32_t*>(out),
      B, CM, W, C, tiles_per_slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tm_votes
