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
// K < 2^24).
//
// Bound on an H100: the operands are read once and the output written
// once, M*K + K*N + 4*M*N bytes (6.29 MB at 1024^3, 1.88 us at
// 3.35 TB/s), against 2*M*N*K int8 operations (1.09 us at the 1,979 TOP/s
// of the int8 tensor cores): bound by bytes at every shape the port runs.
//
// Design (mma_s8.cuh): a block owns a 64 x 64 output tile (256 blocks at
// 1024^3, for 132 SMs) and runs the product on the int8 tensor cores with
// mma.sync m16n8k32 fed by ldmatrix, int32 accumulation, exact for any int8
// operands and any K below 2^17.  Both mma operands must be K-major in
// shared memory.  x (M, K) is, and its rows go straight in (cp.async, 16
// bytes a copy, when K is a multiple of 16).  w arrives (K, N) row-major,
// N-major, and ldmatrix transposes only 16-bit elements, so w is transposed
// while it is staged: each thread loads 16 N-values from each of four
// consecutive K-rows into registers before the current chunk's mma steps,
// and after them turns every 4 x 4 byte block into four words of four
// K-values with __byte_perm and stores those to the tile's [n][k] rows.
// When the tile grid leaves SMs idle (the BNN's 120 x 784 x 128 gives 4
// tiles) the depth is cut among up to four thread groups of the block,
// reduced in shared memory. Ragged M, N and K are masked to zero bytes in
// the loads.

#include "mma_s8.cuh"

using namespace mma_s8;

namespace {

// the 4 x 4 byte transpose: r[i] holds bytes (k = i, n = 0..3); returns
// in o[j] the bytes (k = 0..3, n = j)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // n0,n1 of k0,k1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // n2,n3 of k0,k1
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

struct MatmulOp {
  const int8_t* __restrict__ x;  // (M, K)
  const int8_t* __restrict__ w;  // (K, N)
  int M, N, K, m0, n0;
  bool x_vec, w_vec;  // 16-byte pieces: K resp. N % 16 == 0, bases aligned
  uint4 wreg[4];      // the next chunk's w: 4 K-rows x 16 N-values

  // thread t of the group: K-rows k0 + 4 * (t % 32) + 0..3, N-values
  // n0 + 16 * (t / 32) + 0..15 (one warp per 16 columns, so each store
  // below writes 32 consecutive words of one row)
  __device__ __forceinline__ void issue(uint8_t* stage, int k0, int t) {
    stage_kmajor(stage, x, M, m0, K, k0, x_vec, t);
    const int n = n0 + 16 * (t / 32);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k0 + 4 * (t % 32) + r;
      const int valid = k < K ? N - n : 0;
      wreg[r] = load16(w + (static_cast<size_t>(k) * N + n), valid, w_vec);
    }
  }

  __device__ __forceinline__ void land(uint8_t* stage, int t) {
    uint8_t* bs = stage + BM * ROW + 16 * (t / 32) * ROW + 4 * (t % 32);
    const uint32_t rows[4][4] = {
        {wreg[0].x, wreg[1].x, wreg[2].x, wreg[3].x},
        {wreg[0].y, wreg[1].y, wreg[2].y, wreg[3].y},
        {wreg[0].z, wreg[1].z, wreg[2].z, wreg[3].z},
        {wreg[0].w, wreg[1].w, wreg[2].w, wreg[3].w}};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // N-values 4j .. 4j + 3
      uint32_t o[4];
      transpose4x4(rows[j], o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(bs + (4 * j + i) * ROW) = o[i];
    }
  }
};

template <int KSPLIT>
__global__ void __launch_bounds__(GROUP * KSPLIT)
binary_matmul_kernel(MatmulOp op, int32_t* __restrict__ out, int n_chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  op.m0 = blockIdx.y * BM;
  op.n0 = blockIdx.x * BN;
  Acc acc;
  mma_tile<KSPLIT, false>(op, smem, n_chunks, acc);
  if (threadIdx.x >= GROUP) return;  // group 0 holds the sums
  const int t = threadIdx.x, wm = t / 64, wn = (t / 32) % 2;
  each_acc(acc, wm, wn, t % 32, [&](int r, int c, int v) {
    const int m = op.m0 + r, n = op.n0 + c;
    if (m < op.M && n < op.N) out[static_cast<size_t>(m) * op.N + n] = v;
  });
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
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (K + BK - 1) / BK;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  MatmulOp op{};
  op.x = static_cast<const int8_t*>(x);
  op.w = static_cast<const int8_t*>(w);
  op.M = M;
  op.N = N;
  op.K = K;
  op.x_vec = K % 16 == 0 && aligned(x);
  op.w_vec = N % 16 == 0 && aligned(w);
  const int ks = pick_ksplit(static_cast<long long>(m_tiles) * n_tiles,
                             n_chunks, n_sm);
  void (*fn)(MatmulOp, int32_t*, int) = binary_matmul_kernel<4>;
  if (ks == 1) fn = binary_matmul_kernel<1>;
  if (ks == 2) fn = binary_matmul_kernel<2>;
  return launch(fn, ks, dim3(n_tiles, m_tiles),
                static_cast<cudaStream_t>(stream), op,
                static_cast<int32_t*>(out), n_chunks);
}

extern "C" const char* binary_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
