// Kernel K1: fused bit-packed TM clause evaluation + class votes.
//
// Replaces the Pallas kernel repro/kernels/swar_fused.py:
// swar_fused_votes_pallas (body _swar_fused_kernel):
//
//   hit[b,i,w] = inc_words[i,w] & not_words[b,w]
//   viol[b,i]  = sum_w popc(hit[b,i,w])
//   votes[b,c] = sum_i (viol[b,i] == 0) * vote_matrix[i,c]
//
// Words are the 32 bits of the port's int32 word tensors, read as
// uint32_t.  The tiling (tm_votes.cuh) keeps the (B, CM, Wl) hit tensor in
// registers: each thread ANDs and popcounts the Wl words of one
// (row, clause) pair with no early exit.
//
// Bound on an H100 at the serving shapes (tm-mnist-50: Wl = 49, CM = 500,
// C = 10, B <= 64): about 0.12 MB in and out, some 0.04 us at 3.35 TB/s,
// far below the cost of one launch, so a served batch is launch-bound and
// this first version stays simple (no TMA, no warp specialisation).  At
// B = 4096 the 2*B*CM*Wl word operations on the CUDA cores bound it.

#include "tm_votes.cuh"

namespace {

struct SwarOp {
  const uint32_t* __restrict__ not_words;  // (B, W)
  const uint32_t* __restrict__ inc_words;  // (CM, W)
  int W;

  __device__ __forceinline__ uint32_t lhs(int b, int w) const {
    return not_words[static_cast<size_t>(b) * W + w];
  }
  __device__ __forceinline__ uint32_t rhs(int i, int w) const {
    return inc_words[static_cast<size_t>(i) * W + w];
  }
  __device__ __forceinline__ uint32_t step(uint32_t acc, uint32_t a,
                                           uint32_t b) const {
    return acc + __popc(a & b);
  }
};

}  // namespace

// not_words (B, W) and inc_words (CM, W): 32-bit words; vote_matrix
// (CM, C) int8; out (B, C) int32.  Returns a cudaError_t (0 = success).
extern "C" int swar_fused_votes(const void* not_words, const void* inc_words,
                                const void* vote_matrix, void* out, int B,
                                int CM, int W, int C, int device,
                                void* stream) {
  const SwarOp op{static_cast<const uint32_t*>(not_words),
                  static_cast<const uint32_t*>(inc_words), W};
  return tm_votes::launch(op, vote_matrix, out, B, CM, W, C, device, stream);
}

extern "C" const char* swar_fused_votes_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
