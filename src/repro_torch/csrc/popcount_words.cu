// Kernel K4: row Hamming weight of bit-packed words.
//
// Replaces the Pallas kernel repro/kernels/popcount.py:
// popcount_words_pallas (body _popcount_kernel):
//
//   out[r] = sum_w popcount(words[r, w])        (R, W) uint32 -> (R,) int32
//
// The TPU kernel ran a SWAR bit-twiddle on the VPU over (8, 128) word
// tiles and carried each row's partial sum across the sequential word
// axis of its grid.  Here one warp owns a row: each lane counts its words
// with __popc (one instruction per word) and the warp adds its 32 partial
// counts with shuffles, so nothing carries between blocks and no atomics
// are needed.  Rows whose width is a multiple of four words are read as
// 16-byte vectors; others word by word.  The output is exact: at most
// 32 * W per row.
//
// Bound on an H100 (3.35 TB/s): the words are read once and the counts
// written once, 4 * R * W + 4 * R bytes (8.39 MB at 4096 x 512, 2.50 us).
// One __popc per word on the CUDA cores (16 per clock per SM) stays
// below that, so the kernel is bound by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
popcount_rows(const uint32_t* __restrict__ words, int32_t* __restrict__ out,
              int R, int W, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int stride = gridDim.x * WARPS;
  for (int r = first; r < R; r += stride) {
    const uint32_t* row = words + static_cast<size_t>(r) * W;
    int s = 0;
    if (vec4) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      for (int w = lane; w < W / 4; w += 32) {
        const uint4 v = __ldg(row4 + w);
        s += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
    } else {
      for (int w = lane; w < W; w += 32) s += __popc(__ldg(row + w));
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
    if (lane == 0) out[r] = s;
  }
}

}  // namespace

// words (R, W) uint32 (any 32-bit storage), out (R,) int32.  Returns a
// cudaError_t (0 = success); never synchronises.
extern "C" int popcount_words(const void* words, void* out, int R, int W,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R <= 0) return 0;
  const bool vec4 =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  // one warp per row; past 2^20 blocks the warps loop over the rows
  const long long need = (static_cast<long long>(R) + WARPS - 1) / WARPS;
  const int blocks = need < (1 << 20) ? static_cast<int>(need) : (1 << 20);
  popcount_rows<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), R, W,
      vec4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* popcount_words_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
