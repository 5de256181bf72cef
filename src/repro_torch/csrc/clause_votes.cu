// Kernel K3: fused dense int8 TM clause evaluation + class votes.
//
// Replaces the Pallas kernel repro/kernels/clause_eval.py:
// clause_votes_pallas (body _clause_votes_kernel):
//
//   viol[b,i]  = sum_l (1 - lit[b,l]) * inc[i,l]        (int8 dot)
//   votes[b,c] = sum_i (viol[b,i] == 0) * vote_matrix[i,c]
//
// The TPU kernel ran both products on the MXU in f32.
//
// Bound on an H100 at tm-mnist-50 widths (L = 1568, CM = 500, C = 10): at
// a served bucket (B <= 64) about 0.89 MB in and out, some 0.27 us at
// 3.35 TB/s, far below the cost of one launch, so serving is bound by the
// kernel's latency; at B = 4096 the 2*B*CM*L int8 operations of the first
// product (3.2 us at the 1,979 TOP/s of the int8 tensor cores) bound it.
//
// Design (mma_s8.cuh): the first product is an int8 GEMM with B rows, CM
// columns and depth L whose operands both arrive K-major, so a block
// stages a 64-row literal tile and a 64-clause include tile straight into
// shared memory (cp.async, 16 bytes a copy, when L is a multiple of 16)
// and runs mma.sync m16n8k32 on the int8 tensor cores; (1 - lit) is formed
// in the A fragments by XOR with 1 (literals are {0,1}; padding bytes meet
// zero include bytes).  The whole depth of a (row, clause) pair stays in
// one block, so the == 0 test sees the full count: at serving sizes the
// tile grid is small (8 tiles at B = 64) and the depth is cut among up to
// four thread groups of the block instead, whose partial counts are added
// in shared memory before the test.  The fired flags of each row become a
// 64-bit mask in shared memory, and the vote fold walks its set bits on
// the CUDA cores, adding vote_matrix rows (an input: nothing assumes the
// polarity structure).  Each block adds its (rows, C) votes into the
// output, zeroed first, with int32 atomicAdd, which is exact and
// independent of order.  The (B, CM) clause matrix never reaches device
// memory.  Clauses past CM, rows past B and bytes past L are masked: a
// padded clause never fires.
//
// Phase clocks (phase_clocks.cuh; empty in the libraries the port loads):
// mark 0 at entry, 1 once the first chunk is staged (in mma_tile), 2
// after the violation tiles and the depth reduction, 3 after the fire
// masks, 4 after thread 0's first vote fold, before its atomic, 5 after
// its last atomic.  The output has no store of its own: the launcher
// zeroes it, the atomics fill it.

#include "mma_s8.cuh"
#include "phase_clocks.cuh"

using namespace mma_s8;

namespace {

struct VotesOp {
  const int8_t* __restrict__ literals;  // (B, L)
  const int8_t* __restrict__ include;   // (CM, L)
  int B, CM, L, row0, cm0;
  bool vec;  // L % 16 == 0 and both bases 16-byte aligned

  __device__ __forceinline__ void issue(uint8_t* stage, int k0, int t) {
    stage_kmajor(stage, literals, B, row0, L, k0, vec, t);
    stage_kmajor(stage + BM * ROW, include, CM, cm0, L, k0, vec, t);
  }
  __device__ __forceinline__ void land(uint8_t*, int) {}
};

template <int KSPLIT>
__global__ void __launch_bounds__(GROUP * KSPLIT)
clause_votes_kernel(VotesOp op, const int8_t* __restrict__ vote_matrix,
                    int32_t* __restrict__ out, int C, int n_chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  PHASE(0);
  op.row0 = blockIdx.x * BM;
  op.cm0 = blockIdx.y * BN;
  Acc acc;
  mma_tile<KSPLIT, true>(op, smem, n_chunks, acc);
  PHASE(2);

  // fired[r]: bit j set iff clause cm0 + j fires on row row0 + r
  uint32_t* fired = reinterpret_cast<uint32_t*>(smem + RED_BYTES);  // [BM][2]
  const int t = threadIdx.x;
  if (t < GROUP) {  // group 0 holds the full violation counts
    const int wm = t / 64, wn = (t / 32) % 2, lane = t % 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
        uint32_t bits = 0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = nt * 8 + 2 * (lane % 4) + e;
            if (acc.v[mt][nt][2 * h + e] == 0 && op.cm0 + wn * 32 + j < op.CM)
              bits |= 1u << j;
          }
        bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
        bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
        if (lane % 4 == 0)
          fired[2 * (wm * 32 + mt * 16 + lane / 4 + 8 * h) + wn] = bits;
      }
  }
  __syncthreads();
  PHASE(3);

  for (int p = t; p < BM * C; p += GROUP * KSPLIT) {
    const int r = p / C, c = p % C, row = op.row0 + r;
    if (row >= op.B) break;  // p grows with r
    uint64_t m = fired[2 * r] | static_cast<uint64_t>(fired[2 * r + 1]) << 32;
    int32_t s = 0;
    for (; m; m &= m - 1)
      s += vote_matrix[static_cast<size_t>(op.cm0 + __ffsll(m) - 1) * C + c];
    if (p == t) PHASE(4);
    if (s != 0) atomicAdd(&out[static_cast<size_t>(row) * C + c], s);
  }
  PHASE(5);
}

}  // namespace

// literals (B, L) and include (CM, L) int8 {0,1}; vote_matrix (CM, C)
// int8; out (B, C) int32.  Returns a cudaError_t (0 = success); never
// synchronises.
extern "C" int clause_votes(const void* literals, const void* include,
                            const void* vote_matrix, void* out, int B, int CM,
                            int L, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * C * sizeof(int32_t),
                        s);
  if (err != cudaSuccess || CM <= 0) return static_cast<int>(err);
  const int row_tiles = (B + BM - 1) / BM, cm_tiles = (CM + BN - 1) / BN;
  if (cm_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (L + BK - 1) / BK;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  VotesOp op{};
  op.literals = static_cast<const int8_t*>(literals);
  op.include = static_cast<const int8_t*>(include);
  op.B = B;
  op.CM = CM;
  op.L = L;
  op.vec = L % 16 == 0 && aligned(literals) && aligned(include);
  const int ks = pick_ksplit(static_cast<long long>(row_tiles) * cm_tiles,
                             n_chunks, n_sm);
  void (*fn)(VotesOp, const int8_t*, int32_t*, int, int) =
      clause_votes_kernel<4>;
  if (ks == 1) fn = clause_votes_kernel<1>;
  if (ks == 2) fn = clause_votes_kernel<2>;
  return launch(fn, ks, dim3(row_tiles, cm_tiles), s, op,
                static_cast<const int8_t*>(vote_matrix),
                static_cast<int32_t*>(out), C, n_chunks);
}

extern "C" const char* clause_votes_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
