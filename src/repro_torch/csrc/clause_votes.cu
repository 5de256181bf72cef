// Kernel K3: fused dense int8 TM clause evaluation + class votes.
//
// Replaces the Pallas kernel repro/kernels/clause_eval.py:
// clause_votes_pallas (body _clause_votes_kernel):
//
//   viol[b,i]  = sum_l (1 - lit[b,l]) * inc[i,l]        (int8 dot)
//   votes[b,c] = sum_i (viol[b,i] == 0) * vote_matrix[i,c]
//
// The TPU kernel ran both products on the MXU in f32.  Here the
// violation count is an integer dot over four literals at a time
// (__dp4a on byte-packed words, exact), the clause tile goes straight
// into the vote product (tm_votes.cuh), and the (B, CM) clause matrix is
// never written out.  vote_matrix stays an input: nothing assumes the
// polarity structure.  Ragged edges (L not a multiple of 4, the last
// clause tile, the last row tile) are masked in the loads, not padded.
//
// Bound on an H100 at the serving shapes (tm-mnist-50: L = 1568,
// CM = 500, C = 10, B = 64): about 0.89 MB in and out, some 0.27 us at
// 3.35 TB/s, far below the cost of one launch.  At B = 4096 the
// 2*B*CM*L int8 operations bound it; __dp4a on the CUDA cores reaches a
// small fraction of the tensor cores' int8 rate, so a tensor-core
// (mma / wgmma) version is the later step.

#include "tm_votes.cuh"

namespace {

struct Dp4aOp {
  const int8_t* __restrict__ literals;  // (B, L)
  const int8_t* __restrict__ include;   // (CM, L)
  int L;
  bool aligned;  // L % 4 == 0 and both bases 4-byte aligned

  // word w of a byte row: bytes 4w .. 4w+3, zero past L
  __device__ __forceinline__ uint32_t word(const int8_t* row, int w) const {
    if (aligned) return reinterpret_cast<const uint32_t*>(row)[w];
    uint32_t v = 0;
    for (int k = 0; k < 4; ++k) {
      const int l = 4 * w + k;
      if (l < L) v |= static_cast<uint32_t>(static_cast<uint8_t>(row[l])) << (8 * k);
    }
    return v;
  }
  // (1 - lit) byte by byte; past L the include word is zero, so the
  // padding bytes add nothing to the dot
  __device__ __forceinline__ uint32_t lhs(int b, int w) const {
    return __vsub4(0x01010101u, word(literals + static_cast<size_t>(b) * L, w));
  }
  __device__ __forceinline__ uint32_t rhs(int i, int w) const {
    return word(include + static_cast<size_t>(i) * L, w);
  }
  __device__ __forceinline__ uint32_t step(uint32_t acc, uint32_t a,
                                           uint32_t b) const {
    return __dp4a(a, b, acc);
  }
};

}  // namespace

// literals (B, L) and include (CM, L) int8 {0,1}; vote_matrix (CM, C)
// int8; out (B, C) int32.  Returns a cudaError_t (0 = success).
extern "C" int clause_votes(const void* literals, const void* include,
                            const void* vote_matrix, void* out, int B, int CM,
                            int L, int C, int device, void* stream) {
  const bool aligned = (L % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(literals) % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(include) % 4 == 0);
  const Dp4aOp op{static_cast<const int8_t*>(literals),
                  static_cast<const int8_t*>(include), L, aligned};
  return tm_votes::launch(op, vote_matrix, out, B, CM, (L + 3) / 4, C, device,
                          stream);
}

extern "C" const char* clause_votes_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
