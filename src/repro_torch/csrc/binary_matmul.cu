// Kernel K6: ±1 GEMM, the BNN xnor-popcount accumulation.
//
// Replaces the Pallas kernel repro/kernels/binary_matmul.py:
// binary_matmul_pallas (body _binary_matmul_kernel):
//
//   out[m,n] = sum_k x[m,k] * w[k,n]     (M, K) x (K, N) int8 -> int32
//
// which for ±1 operands is 2 * popcount(xnor(x_bits, w_bits)) - K.  The
// TPU kernel cast the tiles to float32 for the MXU and carried the sum in
// the output block across the sequential K axis of its grid (exact while
// K < 2^24).  Here each block owns a 64 x 64 output tile and walks K
// itself, 32 bytes at a time: x's tile is read as 4-byte words along K,
// w's tile is gathered byte by byte into words of four consecutive K
// values per column, both stored K-word-major in shared memory, and each
// of the 256 threads keeps a 4 x 4 int32 accumulator fed by __dp4a (four
// int8 products and their sum in one instruction, exact).  The
// accumulation is int32 and exact for any K.  Ragged edges are masked to
// zero bytes, which add nothing.
//
// Bound on an H100: the operands are read once and the output written
// once, M*K + K*N + 4*M*N bytes (6.29 MB at 1024^3, 1.88 us at
// 3.35 TB/s), against 2*M*N*K int8 operations (1.09 us at the 1,979 TOP/s
// of the int8 tensor cores).  __dp4a runs on the CUDA cores at a small
// fraction of the tensor-core rate, so this first version is bound by
// its dp4a throughput; an mma / wgmma int8 version is the later step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64;  // output tile
constexpr int BKW = 8;           // K words (4 int8 each) per staged chunk
constexpr int TX = 16, TY = 16;  // thread grid; 4 x 4 outputs per thread
constexpr int THREADS = TX * TY;
constexpr int PAD = 4;  // row pad: conflict-free stores of the x tile

__device__ __forceinline__ int gather_word(const int8_t* p, size_t stride,
                                           int k, int K) {
  // four consecutive K values (k .. k+3) at byte stride `stride`, zero
  // past K, little-endian in one word
  uint32_t u = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (k + j < K)
      u |= static_cast<uint32_t>(static_cast<uint8_t>(p[(k + j) * stride]))
           << (8 * j);
  return static_cast<int>(u);
}

__global__ void __launch_bounds__(THREADS)
binary_matmul_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w, int32_t* __restrict__ out,
                     int M, int N, int K, bool x_words) {
  __shared__ int xs[BKW][BM + PAD];
  __shared__ int ws[BKW][BN + PAD];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = (K + 3) / 4;
  int acc[4][4] = {};

  for (int kw0 = 0; kw0 < KW; kw0 += BKW) {
    for (int p = tid; p < BM * BKW; p += THREADS) {
      const int mm = p / BKW, kk = p % BKW;
      const int m = m0 + mm, kw = kw0 + kk;
      int v = 0;
      if (m < M && kw < KW) {
        const int8_t* row = x + static_cast<size_t>(m) * K;
        v = x_words ? __ldg(reinterpret_cast<const int*>(row) + kw)
                    : gather_word(row, 1, 4 * kw, K);
      }
      xs[kk][mm] = v;
    }
    for (int p = tid; p < BKW * BN; p += THREADS) {
      const int kk = p / BN, nn = p % BN;
      const int n = n0 + nn, kw = kw0 + kk;
      ws[kk][nn] = (n < N && kw < KW)
                       ? gather_word(w + n, static_cast<size_t>(N), 4 * kw, K)
                       : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the chunk is consumed before the next overwrites it
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + TX * j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// x (M, K) int8, w (K, N) int8, out (M, N) int32, all row-major.
// Returns a cudaError_t (0 = success); never synchronises.
extern "C" int binary_matmul(const void* x, const void* w, void* out, int M,
                             int N, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M <= 0 || N <= 0) return 0;
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool x_words =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  binary_matmul_kernel<<<dim3(n_tiles, m_tiles), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, N, K, x_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* binary_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
