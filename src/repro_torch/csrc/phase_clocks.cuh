// Phase clocks: a probe of where a block's time goes, compiled in only
// with -DREPRO_PHASE_CLOCKS (python -m repro_torch.kernels.phase_clocks
// builds K1, K2, K3 and K5 that way into a build directory of its own;
// the libraries the port loads never have it).  PHASE(i) stores, for
// thread 0 of each of the first kBlocks blocks (by linear index over the
// grid's x and y), the SM clock (clock64) and the global timer (ns) at
// mark i; phase_clocks_read copies both tables to the host.  Without the
// macro PHASE(i) is empty.

#pragma once

#ifdef REPRO_PHASE_CLOCKS

#include <cuda_runtime.h>

namespace phase_clocks {
constexpr int kMarks = 8;
constexpr int kBlocks = 8192;
__device__ unsigned long long clk[kBlocks * kMarks];
__device__ unsigned long long ns[kBlocks * kMarks];
}  // namespace phase_clocks

#define PHASE(i)                                                           \
  do {                                                                     \
    const unsigned pc_block = blockIdx.y * gridDim.x + blockIdx.x;         \
    if (threadIdx.x == 0 && pc_block < phase_clocks::kBlocks) {            \
      unsigned long long t_ns;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_ns));             \
      phase_clocks::clk[pc_block * phase_clocks::kMarks + (i)] = clock64(); \
      phase_clocks::ns[pc_block * phase_clocks::kMarks + (i)] = t_ns;      \
    }                                                                      \
  } while (0)

// Zeroes both tables (a block that never reaches a mark leaves 0 there).
extern "C" int phase_clocks_clear() {
  static unsigned long long zero[phase_clocks::kBlocks * phase_clocks::kMarks];
  cudaError_t err = cudaMemcpyToSymbol(phase_clocks::clk, zero, sizeof(zero));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemcpyToSymbol(phase_clocks::ns, zero, sizeof(zero)));
}

// clk_out, ns_out: kBlocks x kMarks uint64 each, row-major by block.
extern "C" int phase_clocks_read(void* clk_out, void* ns_out) {
  cudaError_t err = cudaMemcpyFromSymbol(
      clk_out, phase_clocks::clk, sizeof(phase_clocks::clk));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemcpyFromSymbol(ns_out, phase_clocks::ns, sizeof(phase_clocks::ns)));
}

#else
#define PHASE(i) ((void)0)
#endif
