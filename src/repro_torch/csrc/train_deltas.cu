// Kernel K2: fused TM Type I/II feedback deltas + per-class batch sum.
//
// Replaces the Pallas kernel repro/kernels/train_fused.py:171
// train_deltas_pallas (bodies _train_deltas_kernel, _delta_body):
//
//   cl_t[b,m]  = no literal included in clause m of class y[b] is 0 in row b
//   d1         = Type I from the raw word w = threefry(keys1[b], m*L + l):
//                +1 if cl & lit & (w>>9) < t_inc; -1 if (!cl | !lit) &
//                (w>>9) < t_dec
//   d2         = Type II: +1 if cl & !lit & !include[y[b], m, l]
//   out[y[b], m, l] += m1_t[b,m] * d1 + m2_t[b,m] * d2
//
// and the same for the sampled negative class y_neg[b] with keys2 and the
// masks m1_n / m2_n.  Integer arithmetic throughout; the result is
// bitwise the plain version's (kernels/train_fused.py,
// train_deltas_keyed_plain).
//
// Design.  The TPU kernel took the (B, M, L) uniform words as inputs and
// accumulated its (C, bm, L) output block across sequential batch tiles.
// Here:
// - the words are drawn in registers from each row's threefry key
//   (threefry.cuh), only where a Type I mask selects them, so the two
//   (B, M, L) uint32 word tensors of the JAX path (20 MB at B = 32,
//   tm-mnist-50) are never written;
// - clause outputs need a reduction over all L literals before any delta
//   of their (row, clause), so a first pass (clause_pass, one warp per
//   row, clause and side) writes them to a (B, M, 2) byte scratch;
// - the second pass (delta_pass) gives each thread one (clause, literal)
//   column.  It walks the batch in order and adds each row's deltas into
//   a shared-memory accumulator of its own column for kClassTile classes
//   at a time, then writes those classes' entries of its column.  No two
//   threads touch one address, so the sum is exact and deterministic
//   without atomics, and the output needs no zeroing.  A row whose
//   classes fall outside the current class tile is skipped after two
//   compares, so each row's deltas are computed once whatever C is.
//
// Bound on an H100 at tm-mnist-50 (M = 50, L = 1568, C = 10): the
// threefry words, about 76 integer operations each (threefry.cuh, plus
// the threshold shift and compares), one per (row, clause, literal) whose
// Type I mask is set, at 16.75 T/s on the CUDA cores — at most 2*B*M*L
// words, 24 us at B = 32 if every mask were set.  Bytes are fewer: the
// include mask (0.78 MB), the literals and the (C, M, L) int32 output
// (3.1 MB), about 1.2 us at 3.35 TB/s.  Each thread's word is one
// dependent chain of ~75 operations, and only M*L = 78,400 threads exist
// (18 warps per SM), so this first version is latency-bound below the
// throughput bound; splitting the batch across blocks is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

namespace {

constexpr int kClauseWarps = 8;   // (row, clause, side) triples per block
constexpr int kThreads = 256;     // (clause, literal) columns per block
constexpr int kClassTile = 16;    // classes accumulated per batch walk

// clauses[(b*M + m)*2 + side] = 1 iff no literal included in clause m of
// class (side ? y_neg : y)[b] is 0 in row b.
__global__ void __launch_bounds__(kClauseWarps * 32)
clause_pass(const int8_t* __restrict__ lits,
            const int8_t* __restrict__ include,
            const int32_t* __restrict__ y,
            const int32_t* __restrict__ y_neg,
            uint8_t* __restrict__ clauses, int B, int M, int L) {
  const int warp = blockIdx.x * kClauseWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * M * 2) return;  // whole warps leave together
  const int side = warp % 2;
  const int m = (warp / 2) % M;
  const int b = warp / (2 * M);
  const int c = side ? y_neg[b] : y[b];
  const int8_t* inc = include + (static_cast<size_t>(c) * M + m) * L;
  const int8_t* lit = lits + static_cast<size_t>(b) * L;
  int viol = 0;
  for (int l = lane; l < L; l += 32) viol |= inc[l] & (lit[l] ^ 1);
  viol = __any_sync(0xffffffffu, viol != 0);
  if (lane == 0) clauses[warp] = viol ? 0 : 1;
}

// One side's delta of one (row, clause, literal).
__device__ __forceinline__ int side_delta(bool type_i, bool type_ii,
                                          bool cl, bool lit,
                                          const uint32_t* key, uint32_t c_hi,
                                          uint32_t c_lo, uint32_t t_inc,
                                          uint32_t t_dec,
                                          const int8_t* include_at) {
  int d = 0;
  if (type_i) {
    const uint32_t r = threefry::bits(key[0], key[1], c_hi, c_lo) >> 9;
    d += (cl && lit && r < t_inc) ? 1 : 0;
    d -= ((!cl || !lit) && r < t_dec) ? 1 : 0;
  }
  if (type_ii && cl && !lit && *include_at == 0) d += 1;
  return d;
}

__global__ void __launch_bounds__(kThreads)
delta_pass(const int8_t* __restrict__ lits,
           const uint32_t* __restrict__ keys1,
           const uint32_t* __restrict__ keys2,
           const int8_t* __restrict__ include,
           const uint8_t* __restrict__ m1_t, const uint8_t* __restrict__ m2_t,
           const uint8_t* __restrict__ m1_n, const uint8_t* __restrict__ m2_n,
           const int32_t* __restrict__ y, const int32_t* __restrict__ y_neg,
           const uint8_t* __restrict__ clauses, int32_t* __restrict__ out,
           int B, int C, int M, int L, uint32_t t_inc, uint32_t t_dec) {
  __shared__ int32_t acc[kClassTile][kThreads];  // [class][own column]
  const int tid = threadIdx.x;
  const long long ml = static_cast<long long>(M) * L;
  const long long col = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (col >= ml) return;  // no barrier below: each thread owns its column
  const int m = static_cast<int>(col / L);
  const int l = static_cast<int>(col % L);
  // the column's counter in every row's (M, L) draw
  const uint32_t c_hi = static_cast<uint32_t>(col >> 32);
  const uint32_t c_lo = static_cast<uint32_t>(col);
  for (int c0 = 0; c0 < C; c0 += kClassTile) {
    const int cc = min(kClassTile, C - c0);
    for (int k = 0; k < cc; ++k) acc[k][tid] = 0;
    for (int b = 0; b < B; ++b) {
      const int yt = y[b] - c0;
      const int yn = y_neg[b] - c0;
      const bool tgt = yt >= 0 && yt < cc;
      const bool neg = yn >= 0 && yn < cc;
      if (!tgt && !neg) continue;
      const bool lit = lits[static_cast<size_t>(b) * L + l] != 0;
      const size_t bm = static_cast<size_t>(b) * M + m;
      if (tgt) {
        acc[yt][tid] += side_delta(
            m1_t[bm], m2_t[bm], clauses[2 * bm], lit, keys1 + 2 * b, c_hi,
            c_lo, t_inc, t_dec,
            include + static_cast<size_t>(c0 + yt) * ml + col);
      }
      if (neg) {
        acc[yn][tid] += side_delta(
            m1_n[bm], m2_n[bm], clauses[2 * bm + 1], lit, keys2 + 2 * b,
            c_hi, c_lo, t_inc, t_dec,
            include + static_cast<size_t>(c0 + yn) * ml + col);
      }
    }
    for (int k = 0; k < cc; ++k)
      out[static_cast<size_t>(c0 + k) * ml + col] = acc[k][tid];
  }
}

}  // namespace

// literals (B, L) int8; keys1/keys2 (B, 2) 32-bit words; include (C, M, L)
// int8; m1_t/m2_t/m1_n/m2_n (B, M) bytes (torch.bool); y/y_neg (B,) int32
// in [0, C); clauses (B, M, 2) uint8 scratch; out (C, M, L) int32, fully
// written.  Returns a cudaError_t (0 = success); never synchronises.
extern "C" int train_deltas(const void* literals, const void* keys1,
                            const void* keys2, const void* include,
                            const void* m1_t, const void* m2_t,
                            const void* m1_n, const void* m2_n,
                            const void* y, const void* y_neg, void* clauses,
                            void* out, int B, int C, int M, int L,
                            unsigned t_inc, unsigned t_dec, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0 || M <= 0 || L <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lit8 = static_cast<const int8_t*>(literals);
  const auto* inc8 = static_cast<const int8_t*>(include);
  const auto* yt = static_cast<const int32_t*>(y);
  const auto* yn = static_cast<const int32_t*>(y_neg);
  auto* cl = static_cast<uint8_t*>(clauses);
  const long long triples = 2LL * B * M;
  clause_pass<<<static_cast<unsigned>((triples + kClauseWarps - 1) /
                                      kClauseWarps),
                kClauseWarps * 32, 0, s>>>(lit8, inc8, yt, yn, cl, B, M, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cols = static_cast<long long>(M) * L;
  delta_pass<<<static_cast<unsigned>((cols + kThreads - 1) / kThreads),
               kThreads, 0, s>>>(
      lit8, static_cast<const uint32_t*>(keys1),
      static_cast<const uint32_t*>(keys2), inc8,
      static_cast<const uint8_t*>(m1_t), static_cast<const uint8_t*>(m2_t),
      static_cast<const uint8_t*>(m1_n), static_cast<const uint8_t*>(m2_n),
      yt, yn, cl, static_cast<int32_t*>(out), B, C, M, L, t_inc, t_dec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* train_deltas_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
