// Kernel K5: PDL race simulation — chain delays, arbiter argmin, first
// arrival and the top-gap metastability flag.
//
// Replaces the Pallas kernel repro/kernels/pdl_race.py: pdl_race_pallas
// (body _pdl_race_kernel).  For rows b and classes c:
//
//   delay[b,c] = sum_m (sel[b,c,m] ? low[c,m] : high[c,m]) + skew[c]
//   winner[b]  = argmin_c delay[b,c]           (ties -> lower index)
//   latency[b] = min_c delay[b,c]
//   second[b]  = min of the delays strictly later than latency[b], or
//                latency[b] when there is none (all equal, or C = 1)
//   meta[b]    = second[b] - latency[b] < t_res
//
// These are the kernel's semantics, not those of its oracle
// repro/kernels/ref.py:ref_pdl_race, whose top_k gap is 0 whenever two
// classes tie for the minimum.
//
// The TPU kernel held the (C, M) delay tables in VMEM and reduced a
// (rows, C) delay tile per grid step.  Here a block owns a few rows: one
// warp per (row, class) pair sums its M selected delays in float32 (each
// lane a strided share, then a shuffle tree), the (rows, C) delays go to
// shared memory, and one thread per row walks its C classes once, keeping
// the minimum, its index and the next distinct arrival.  The per-class
// delays never reach device memory.  Summation order differs from XLA's,
// so float delays agree to rounding; integer-valued delays are exact.
//
// Bound on an H100 (3.35 TB/s): the selects are read once (B * C * M
// bytes), the tables once (8 * C * M + 4 * C bytes) and 9 bytes written
// per row: about 1.04 MB at B = 1024, C = 10, M = 100, or 0.31 us.  The
// B * C * M float adds are far below the card's float32 rate, so it is
// bound by bytes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
pdl_race_kernel(const int8_t* __restrict__ low_sel,
                const float2* __restrict__ elem,  // (C, M) of (low, high)
                const float* __restrict__ skew, int32_t* __restrict__ winner,
                float* __restrict__ latency, uint8_t* __restrict__ meta,
                int B, int C, int M, int rows_per_block, float t_res) {
  extern __shared__ float delay_s[];  // (rows_per_block, C)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, B - row0);

  for (int p = warp; p < rows * C; p += WARPS) {
    const int rr = p / C, c = p % C;
    const int8_t* sel =
        low_sel + (static_cast<size_t>(row0 + rr) * C + c) * M;
    const float2* e = elem + static_cast<size_t>(c) * M;
    float s = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float2 d = __ldg(e + m);
      s += sel[m] ? d.x : d.y;
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) delay_s[rr * C + c] = s + __ldg(skew + c);
  }
  __syncthreads();

  for (int rr = threadIdx.x; rr < rows; rr += blockDim.x) {
    float lat = INFINITY, second = INFINITY;
    int win = 0;
    for (int c = 0; c < C; ++c) {
      const float d = delay_s[rr * C + c];
      if (d < lat) {
        second = lat;  // the old minimum is strictly later than d
        lat = d;
        win = c;
      } else if (d > lat && d < second) {
        second = d;
      }
    }
    if (second == INFINITY) second = lat;  // no later arrival: gap 0
    const int row = row0 + rr;
    winner[row] = win;
    latency[row] = lat;
    meta[row] = (second - lat) < t_res ? 1 : 0;
  }
}

}  // namespace

// low_sel (B, C, M) int8 {0,1}; elem_delays (C, M, 2) float32 (low,
// high); skew (C,) float32; winner (B,) int32, latency (B,) float32,
// meta (B,) uint8 (torch.bool storage).  Returns a cudaError_t
// (0 = success); never synchronises.
extern "C" int pdl_race(const void* low_sel, const void* elem_delays,
                        const void* skew, void* winner, void* latency,
                        void* meta, int B, int C, int M, float t_res,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a few blocks per SM before a block takes more than one row
  const int rows_per_block =
      std::max(1, std::min(8, (B + 4 * n_sm - 1) / (4 * n_sm)));
  const size_t smem = static_cast<size_t>(rows_per_block) * C * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pdl_race_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  pdl_race_kernel<<<blocks, WARPS * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(low_sel),
      static_cast<const float2*>(elem_delays),
      static_cast<const float*>(skew), static_cast<int32_t*>(winner),
      static_cast<float*>(latency), static_cast<uint8_t*>(meta), B, C, M,
      rows_per_block, t_res);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pdl_race_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
