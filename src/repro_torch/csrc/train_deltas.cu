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
// Bound on an H100 at tm-mnist-50 (M = 50, L = 1568, C = 10): the
// threefry words, one per (row, clause, literal) whose Type I mask is
// set, each 76 integer operations (threefry.cuh, plus the threshold shift
// and compares) of which 42 (20 rotations, 21 XORs, the shift) issue only
// to the integer ALU pipe, at 64 per clock per SM (16.75 T/s); the adds
// may go to the FMA pipe too — about 3.2 us at B = 32 on a fused step's
// masks.  Bytes are fewer: the include mask (0.78 MB), the literals and
// the (C, M, L) int32 output (3.1 MB), about 1.2 us at 3.35 TB/s.
//
// - One launch.  The grid is one thread block cluster per clause m; its
//   K <= 8 blocks split the L literals into tiles of TL columns.  Each
//   block packs its tile of the include mask (every class, once) and of
//   each row chunk's literals into bits in shared memory, so the clause
//   pass is a few word ANDs per (row, side) and the walk below reads no
//   literal or include byte from device memory.  The clause outputs need
//   a reduction over all L literals: each block ORs the violations of its
//   own columns and stores the flags into every peer's shared memory
//   (distributed shared memory), and after one cluster barrier each block
//   ORs the K flags it received.  The flags alternate between two
//   buffers, so one barrier per row chunk suffices and no block reads a
//   peer after the last one.  A block may write a peer's shared memory
//   only once every block of the cluster has started: each arrives on
//   the cluster barrier when it starts and waits on it just before the
//   first chunk's push, behind that chunk's staging.  So no (B, M, 2)
//   scratch and no second launch (an earlier design wrote the clause
//   outputs in a first kernel and read them back in a second).
// - Batch split.  A block's 256 threads form 4 groups of 64; the (row,
//   side) items a block has work for are listed in shared memory, the
//   threefry ones first, and dealt round-robin to the groups, so each
//   group walks about a quarter of them.  The groups add their deltas
//   into one (classes, TL) int32 partial in shared memory with
//   shared-memory atomic adds: integer adds are exact in any order, so
//   the result is deterministic, and no global atomics are needed.  (A
//   partial per group, summed in group order, cost more to zero and
//   reduce than the deltas cost at B = 32.)  The partial is then stored,
//   each output entry once, so the output needs no zeroing.
// - Independent chains.  A thread owns TL / 64 columns of its group and
//   draws their words for an item together: four threefry chains with no
//   dependence between them.
// - Per-row scalars are staged once per block and row chunk: y, y_neg,
//   both keys, the block's clause's four mask bits and the clause bits.
// - Classes beyond what the partials' shared-memory budget holds go in
//   class tiles; rows in chunks of kRows.  Each item is drawn in the one
//   class tile that holds its class.
// - Any class count.  The include tile of every class takes C * TL / 8
//   bytes (about 6,000 classes fill a block at tm-mnist-50's TL = 256).
//   Past that, a second instantiation stages instead, per row chunk, the
//   include bits of the one class each (row, side) item addresses, read
//   from global memory (2 * kRows rows of the tile); where every class
//   fits, the kernel is the one that stages them all once.
// - Words are drawn only where a Type I mask selects them (threefry.cuh),
//   so the two (B, M, L) uint32 word tensors of the JAX path (20 MB at
//   B = 32) are never written.
//
// What holds it above the bound (python -m repro_torch.kernels.phase_clocks
// times the phases between the PHASE marks): the walk issues well over
// twice the bound's 42 ALU operations per word in instructions (the
// counter, the literal bit, the compares, the atomic add), and the 350
// blocks of a tm-mnist-50 call sit 2 to 4 to an SM, so the busiest SMs
// set the time; staging, the cluster barrier and the item list cost
// about 3.5 us before the first word.

#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "phase_clocks.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

// The cluster barrier split in two: every thread of every block arrives,
// then waits until all have (cluster.sync() is the two back to back).
// The arrival is relaxed: it only says that the block has started (no
// peer reads what a block wrote before it), and a release arrival costs
// a cluster-scope fence, about 0.5 us per call on an H100.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

constexpr int kThreads = 256;
constexpr int kGroupThreads = 64;                  // threads per batch group
constexpr int kGroups = kThreads / kGroupThreads;  // batch groups per block
constexpr int kStepWords = kGroupThreads / 32;  // bit words a group spans
constexpr int kUnroll = 4;        // columns (threefry chains) per step
constexpr int kRows = 128;        // batch rows staged per chunk
static_assert(2 * kRows <= kThreads, "a thread per (row, side) candidate");
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kAccBudget = 24 * 1024;  // bytes of class partials per block
constexpr int kMaxDevices = 64;

// Per-row state of one row chunk, in shared memory.
struct RowStage {
  uint32_t keys[2][kRows][2];  // [side][row] threefry key
  int32_t cls[2][kRows];       // [side][row] addressed class
  uint16_t items[2 * kRows];   // 2 row + side, Type I items first
  uint8_t masks[kRows];        // bits: m1_t, m2_t, m1_n, m2_n
  uint8_t fires[2 * kRows];    // [2 row + side] the clause's output
  int warp_n[2][kThreads / 32];  // Type I / Type II items per warp
  int n_items;
};

// Shared-memory layout of a block: TL columns in TW = TL / 32 words.
// The include bits are per class ([C][TW]) or, with item_inc, per (row,
// side) item of the chunk ([2 kRows][TW]).
struct Layout {
  int acc, inc, lit, flags, stage, bytes;
  __host__ __device__ Layout(int C, int CT, int TL, int K, bool item_inc) {
    const int TW = TL / 32;
    const long long inc_rows = item_inc ? 2 * kRows : C;
    acc = 0;                                              // int32 [c][TL]
    inc = acc + CT * TL * 4;                              // u32 [rows][TW]
    const long long lit_at = inc + (inc_rows * TW * 4 + 15) / 16 * 16;
    // a layout past the int range is refused by the host (bytes < 0)
    lit = lit_at < (1LL << 30) ? static_cast<int>(lit_at) : -(1 << 30);
    flags = lit + kRows * TW * 4;                         // u8 [2][K][2 kRows]
    stage = flags + (2 * K * 2 * kRows + 15) / 16 * 16;   // RowStage
    bytes = stage + static_cast<int>(sizeof(RowStage));
  }
};

// label b of an int32 (y_bytes = 4) or int64 (y_bytes = 8) label vector
__device__ __forceinline__ int32_t label(const void* y, int y_bytes, int b) {
  return y_bytes == 8
             ? static_cast<int32_t>(static_cast<const long long*>(y)[b])
             : static_cast<const int32_t*>(y)[b];
}

// pack_rows over the include rows the items of a row chunk address: row
// q = 2 row + side of the bits is the tile's row of class cls[side][row]
__device__ __forceinline__ void pack_item_rows(uint32_t* bits,
                                               const int8_t* inc_tile,
                                               size_t class_stride,
                                               const RowStage& st, int n,
                                               int TW, int ncol) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int words = n * TW;
  for (int w0 = warp; w0 < words; w0 += 8 * (kThreads / 32)) {
    bool on[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * (kThreads / 32);
      const int q = w / TW, col = (w - q * TW) * 32 + lane;
      on[u] = w < words && col < ncol &&
              inc_tile[st.cls[q % 2][q / 2] * class_stride + col] != 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * (kThreads / 32);
      const uint32_t word = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0 && w < words) bits[w] = word;
    }
  }
}

// bits[w] of n rows of TW words: bit j of word w is src[32 w + j] != 0 for
// columns below ncol; a warp packs a 32-column word per ballot, eight
// loads of a lane in flight together
__device__ __forceinline__ void pack_rows(uint32_t* bits, const int8_t* src,
                                          size_t row_stride, int n, int TW,
                                          int ncol) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int words = n * TW;
  for (int w0 = warp; w0 < words; w0 += 8 * (kThreads / 32)) {
    bool on[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * (kThreads / 32);
      const int r = w / TW, col = (w - r * TW) * 32 + lane;
      on[u] = w < words && col < ncol && src[r * row_stride + col] != 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = w0 + u * (kThreads / 32);
      const uint32_t word = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0 && w < words) bits[w] = word;
    }
  }
}

// 16 bytes -> 16 bits: bit i is byte i != 0
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return ((x & 0x01010101u) * 0x01020408u) >> 24;  // byte i -> bit 24 + i
}
__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// pack_rows for 16-byte aligned rows and ncol a multiple of 16, in two
// steps so that the loads of several tiles can be in flight together: N
// 16-byte loads a thread, each 16 columns that become one half-word of
// the bits.  Half p of an n-row tile is vector p % per_row of row
// p / per_row (per_row = 2 TW halves, of which the first ncol / 16 lie
// in the tile); a thread takes halves p0, p0 + kThreads, ...
template <int N>
struct Pack16 {
  uint4 v[N];

  __device__ __forceinline__ void load(const int8_t* __restrict__ src,
                                       size_t row_stride, int n, int TW,
                                       int ncol, int p0) {
    const int per_row = 2 * TW, nv = ncol / 16, total = n * per_row;
    // row and vector of p0, then stepped by kThreads without dividing
    int r = p0 / per_row, k = p0 - r * per_row;
    const int dr = kThreads / per_row, dk = kThreads - dr * per_row;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      v[u] = p0 + u * kThreads < total && k < nv
                 ? *reinterpret_cast<const uint4*>(src + r * row_stride +
                                                   16 * k)
                 : make_uint4(0u, 0u, 0u, 0u);
      r += dr;
      k += dk;
      if (k >= per_row) {
        k -= per_row;
        ++r;
      }
    }
  }
  __device__ __forceinline__ void store(uint32_t* bits, int n, int TW,
                                        int p0) const {
    uint16_t* half = reinterpret_cast<uint16_t*>(bits);  // little-endian
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (p0 + u * kThreads < n * 2 * TW)
        half[p0 + u * kThreads] = static_cast<uint16_t>(bits16(v[u]));
  }
};

// Pack16 over a whole tile, from half first_p0 on (the halves before it
// were packed in the chunk's first batch)
__device__ __forceinline__ void pack_rest16(uint32_t* bits, const int8_t* src,
                                            size_t row_stride, int n, int TW,
                                            int ncol, int first_p0) {
  for (int p0 = first_p0; p0 < n * 2 * TW; p0 += 4 * kThreads) {
    Pack16<4> b;
    b.load(src, row_stride, n, TW, ncol, p0);
    b.store(bits, n, TW, p0);
  }
}

// at most 64 registers: four blocks per SM, so every cluster of a
// tm-mnist-50 call is resident at once (at two per SM only 32 clusters of
// 7 fit, and the grid's 50 ran in two waves).  ITEM_INC: the include
// bits are staged per item of each row chunk (Layout's item_inc).
// TILES: C > CT, so class tiles that no row addresses are skipped (a
// separate instantiation: the check's registers would make the one-tile
// kernel spill under the 64-register cap).
template <bool ITEM_INC, bool TILES>
__global__ void __launch_bounds__(kThreads, 4)
deltas_kernel(const int8_t* __restrict__ lits,
              const uint32_t* __restrict__ keys1,
              const uint32_t* __restrict__ keys2,
              const int8_t* __restrict__ include,
              const uint8_t* __restrict__ m1_t,
              const uint8_t* __restrict__ m2_t,
              const uint8_t* __restrict__ m1_n,
              const uint8_t* __restrict__ m2_n, const void* __restrict__ y,
              const void* __restrict__ y_neg, int y_bytes,
              int32_t* __restrict__ out, int B, int C, int M, int L, int TL,
              int CT, uint32_t t_inc, uint32_t t_dec, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout lay(C, CT, TL, K, ITEM_INC);
  int32_t* acc = reinterpret_cast<int32_t*>(smem + lay.acc);  // (CT, TL)
  uint32_t* inc_bits = reinterpret_cast<uint32_t*>(smem + lay.inc);
  uint32_t* lit_bits = reinterpret_cast<uint32_t*>(smem + lay.lit);
  uint8_t* flags = smem + lay.flags;  // [buffer][sender rank][2 row + side]
  RowStage& st = *reinterpret_cast<RowStage*>(smem + lay.stage);

  const int m = static_cast<int>(blockIdx.x) / K;
  const int l0 = rank * TL, TW = TL / 32;
  const int ncol = min(TL, L - l0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = tid / kGroupThreads, tg = tid % kGroupThreads;
  PHASE(0);
  cluster_arrive();  // this block has started (waited on before the push)

  const int8_t* inc_tile = include + static_cast<size_t>(m) * L + l0;
  const size_t inc_stride = static_cast<size_t>(M) * L;
  int chunk = 0;  // row chunks so far: picks the flag buffer

  for (int c0 = 0; c0 < C; c0 += CT) {
    const int ct = min(CT, C - c0);
    __syncthreads();  // the previous class tile's sums are stored
    for (int p = tid; p < CT * TL / 4; p += kThreads)  // TL % 64 == 0
      reinterpret_cast<int4*>(acc)[p] = make_int4(0, 0, 0, 0);
    // with several class tiles, one that no row addresses (as its class
    // or its negative class) sums to zero: its row chunks are skipped.
    // Every block of the cluster reads the same labels, so all skip
    // alike and the cluster barriers stay matched.
    bool live = true;
    if (TILES) {
      bool mine = false;
      for (int b = tid; b < B; b += kThreads) {
        const int yt = label(y, y_bytes, b), yn = label(y_neg, y_bytes, b);
        mine |= (yt >= c0 && yt < c0 + ct) || (yn >= c0 && yn < c0 + ct);
      }
      live = __syncthreads_or(mine);
    }

    for (int b0 = 0; live && b0 < B; b0 += kRows, ++chunk) {
      const int nr = min(kRows, B - b0);
      const int8_t* lit_tile = lits + static_cast<size_t>(b0) * L + l0;
      // one round trip for the chunk: the row scalars, the first batch of
      // its literal tile and, once, of the include tile (every class)
      const bool first = chunk == 0;
      Pack16<2> lit2;
      Pack16<1> inc1;
      if (vec16) {
        lit2.load(lit_tile, L, nr, TW, ncol, tid);
        if (!ITEM_INC && first)
          inc1.load(inc_tile, inc_stride, C, TW, ncol, tid);
      }
      const int row = tid;  // kRows <= kThreads: a row per thread
      int32_t yt = 0, yn = 0;
      uint32_t kk[4] = {0u, 0u, 0u, 0u};
      uint8_t mk = 0;
      if (row < nr) {
        const int b = b0 + row;
        const size_t bm = static_cast<size_t>(b) * M + m;
        if (y_bytes == 8) {
          yt = static_cast<int32_t>(static_cast<const long long*>(y)[b]);
          yn = static_cast<int32_t>(static_cast<const long long*>(y_neg)[b]);
        } else {
          yt = static_cast<const int32_t*>(y)[b];
          yn = static_cast<const int32_t*>(y_neg)[b];
        }
        kk[0] = keys1[2 * b];
        kk[1] = keys1[2 * b + 1];
        kk[2] = keys2[2 * b];
        kk[3] = keys2[2 * b + 1];
        mk = static_cast<uint8_t>((m1_t[bm] != 0) | (m2_t[bm] != 0) << 1 |
                                  (m1_n[bm] != 0) << 2 |
                                  (m2_n[bm] != 0) << 3);
      }
      if (row < nr) {
        st.cls[0][row] = yt;
        st.cls[1][row] = yn;
        st.keys[0][row][0] = kk[0];
        st.keys[0][row][1] = kk[1];
        st.keys[1][row][0] = kk[2];
        st.keys[1][row][1] = kk[3];
        st.masks[row] = mk;
      }
      if (vec16) {
        lit2.store(lit_bits, nr, TW, tid);
        pack_rest16(lit_bits, lit_tile, L, nr, TW, ncol, tid + 2 * kThreads);
        if (!ITEM_INC && first) {
          inc1.store(inc_bits, C, TW, tid);
          pack_rest16(inc_bits, inc_tile, inc_stride, C, TW, ncol,
                      tid + kThreads);
        }
      } else {
        pack_rows(lit_bits, lit_tile, L, nr, TW, ncol);
        if (!ITEM_INC && first)
          pack_rows(inc_bits, inc_tile, inc_stride, C, TW, ncol);
      }
      __syncthreads();
      if (ITEM_INC) {  // the addressed classes' include rows, this chunk's
        pack_item_rows(inc_bits, inc_tile, inc_stride, st, 2 * nr, TW, ncol);
        __syncthreads();
      }

      if (chunk == 0) PHASE(1);  // the first chunk staged
      // this block's share of the clause pass — a violation is an
      // included literal that is 0 — pushed to every block of the cluster
      uint8_t* buf = flags + (chunk % 2) * K * 2 * kRows;
      if (chunk == 0) cluster_wait();  // every block of the cluster started
      for (int q = tid; q < 2 * nr; q += kThreads) {
        const uint32_t* inc_row =
            inc_bits + (ITEM_INC ? q : st.cls[q % 2][q / 2]) * TW;
        const uint32_t* lit_row = lit_bits + (q / 2) * TW;
        uint32_t v = 0u;
        for (int w = 0; w < TW; ++w) v |= inc_row[w] & ~lit_row[w];
        for (int k = 0; k < K; ++k)
          cluster.map_shared_rank(buf, k)[rank * 2 * kRows + q] = v != 0u;
      }
      // every push has landed.  The other buffer is rewritten only after
      // the next chunk's barrier, which each block passes once it has read
      // this one, so one barrier per chunk suffices.
      cluster.sync();
      if (chunk == 0) PHASE(2);

      // the items of this class tile, in (row, side) order within each
      // kind: Type I first (they draw words), then Type II alone where the
      // clause fires (else they add nothing).  A thread per candidate
      // (2 kRows <= kThreads); warp ballots and counts give the offsets.
      {
        const int q = tid;
        bool t1 = false, t2 = false;
        if (q < 2 * nr) {
          uint8_t v = 0;  // a violation in any block's columns
          for (int k = 0; k < K; ++k) v |= buf[k * 2 * kRows + q];
          const int f = st.masks[q / 2] >> (2 * (q % 2));
          const int c = st.cls[q % 2][q / 2];
          const bool in_tile = c >= c0 && c < c0 + ct;
          st.fires[q] = v == 0;
          t1 = in_tile && (f & 1);
          t2 = in_tile && !(f & 1) && (f & 2) && v == 0;
        }
        const uint32_t b1 = __ballot_sync(0xffffffffu, t1);
        const uint32_t b2 = __ballot_sync(0xffffffffu, t2);
        if (lane == 0) {
          st.warp_n[0][warp] = __popc(b1);
          st.warp_n[1][warp] = __popc(b2);
        }
        __syncthreads();
        int n1 = 0, n2 = 0, before1 = 0, before2 = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
          n1 += st.warp_n[0][w];
          n2 += st.warp_n[1][w];
          before1 += w < warp ? st.warp_n[0][w] : 0;
          before2 += w < warp ? st.warp_n[1][w] : 0;
        }
        const uint32_t below = (1u << lane) - 1u;
        if (t1)
          st.items[before1 + __popc(b1 & below)] = static_cast<uint16_t>(q);
        if (t2)
          st.items[n1 + before2 + __popc(b2 & below)] =
              static_cast<uint16_t>(q);
        if (tid == 0) st.n_items = n1 + n2;
      }
      __syncthreads();

      if (chunk == 0) PHASE(3);  // the first chunk's items listed
      // column tg + kGroupThreads j is bit `lane` of word
      // tg / 32 + kStepWords j of a row
      const int n_items = st.n_items;
      for (int i = g; i < n_items; i += kGroups) {
        const int q = st.items[i];
        const int r = q / 2, side = q % 2;
        const int f = st.masks[r] >> (2 * side);
        const bool t1 = f & 1, t2 = (f >> 1) & 1;
        const bool cl = st.fires[q];
        const int c = st.cls[side][r];
        const uint32_t k0 = st.keys[side][r][0], k1 = st.keys[side][r][1];
        int32_t* acc_row = acc + (c - c0) * TL;
        const uint32_t* lit_row = lit_bits + r * TW + tg / 32;
        const uint32_t* inc_row = inc_bits + (ITEM_INC ? q : c) * TW + tg / 32;
        // the column's counter in the row's (M, L) draw: (0, m L + l),
        // as M L < 2^32 (the launcher checks)
        const uint32_t ctr0 = static_cast<uint32_t>(m) * L + l0 + tg;
        for (int j0 = 0; j0 * kGroupThreads < ncol; j0 += kUnroll) {
          // a warp whose columns of this step all lie past the tile skips it
          if ((j0 * kGroupThreads + (tg & ~31)) >= ncol) break;
          int d[kUnroll];
          bool lit[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u;
            lit[u] = j < TW / kStepWords &&
                     (lit_row[kStepWords * j] >> lane) & 1u;
            d[u] = 0;
          }
          if (t1) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const uint32_t w =
                  threefry::bits(k0, k1, 0u,
                                 ctr0 + kGroupThreads * (j0 + u)) >> 9;
              // include-reinforce where the clause fires on a 1 literal,
              // else exclude-reinforce
              d[u] = cl && lit[u] ? (w < t_inc) : -(w < t_dec);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + u;
            const int col = tg + kGroupThreads * j;
            if (col >= ncol) continue;
            if (t2 && cl && !lit[u] &&
                !((inc_row[kStepWords * j] >> lane) & 1u))
              d[u] += 1;
            if (d[u] != 0) atomicAdd(acc_row + col, d[u]);
          }
        }
      }
      __syncthreads();  // the chunk's items are drawn before it restages
      PHASE(4);  // (the last chunk's mark stays)
    }

    // the tile's sums, every entry stored once: a thread per 4 columns
    // of a class row, 16-byte stores where the rows allow them
    const int q4 = (ncol + 3) / 4;
    for (int p = tid; p < ct * q4; p += kThreads) {
      const int cc = p / q4, col = 4 * (p - cc * q4);
      const int4 v = *reinterpret_cast<const int4*>(acc + cc * TL + col);
      int32_t* dst =
          out + (static_cast<size_t>(c0 + cc) * M + m) * L + l0 + col;
      if (vec16 && col + 4 <= ncol) {
        *reinterpret_cast<int4*>(dst) = v;
      } else {
        const int32_t e[4] = {v.x, v.y, v.z, v.w};
        for (int u = 0; u < 4 && col + u < ncol; ++u) dst[u] = e[u];
      }
    }
  }
  PHASE(5);
}

struct DeviceInfo {
  std::atomic<int> smem_optin{0};
  std::atomic<bool> opted_in[3]{};  // per instantiation
};
DeviceInfo g_devices[kMaxDevices];

}  // namespace

// literals (B, L) int8; keys1/keys2 (B, 2) 32-bit words; include (C, M, L)
// int8; m1_t/m2_t/m1_n/m2_n (B, M) bytes (torch.bool); y/y_neg (B,) int32
// (y_bytes = 4) or int64 (y_bytes = 8) in [0, C); out (C, M, L) int32,
// every entry written once.  One launch on `stream` of `device`; never
// synchronises.  Returns a cudaError_t (0 = success), including what
// cudaLaunchKernelEx or cudaGetLastError report for a refused launch (a
// cluster shape included).
extern "C" int train_deltas(const void* literals, const void* keys1,
                            const void* keys2, const void* include,
                            const void* m1_t, const void* m2_t,
                            const void* m1_n, const void* m2_n,
                            const void* y, const void* y_neg, void* out,
                            int B, int C, int M, int L, int y_bytes,
                            unsigned t_inc, unsigned t_dec, int device,
                            void* stream) {
  // a thread-local switch: the launch goes to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0 || M <= 0 || L <= 0) return 0;
  if (y_bytes != 4 && y_bytes != 8) return cudaErrorInvalidValue;
  // threefry counters m L + l in 32 bits (the high word is then 0)
  if (static_cast<long long>(M) * L >= (1LL << 32))
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& dev = g_devices[device];
  int smem_optin = dev.smem_optin.load(std::memory_order_relaxed);
  if (smem_optin == 0) {  // read once per device
    err = cudaDeviceGetAttribute(&smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    dev.smem_optin.store(smem_optin, std::memory_order_relaxed);
  }
  // the literal tiles: at most kMaxCluster per clause, whole groups wide
  const int k0 = std::min(kMaxCluster, (L + kGroupThreads - 1) / kGroupThreads);
  const int per = (L + k0 - 1) / k0;
  const int TL = (per + kGroupThreads - 1) / kGroupThreads * kGroupThreads;
  const int K = (L + TL - 1) / TL;
  const int per_class = TL * static_cast<int>(sizeof(int32_t));
  const int CT = std::max(1, std::min(C, kAccBudget / per_class));
  // every class's include tile staged once where it fits, else each
  // chunk's addressed rows
  const auto fits = [&](const Layout& l) {
    return l.bytes > 0 && l.bytes <= smem_optin;
  };
  const bool item_inc = !fits(Layout(C, CT, TL, K, false));
  const Layout lay(C, CT, TL, K, item_inc);
  if (!fits(lay)) return cudaErrorInvalidValue;
  const size_t smem = lay.bytes;
  const int which = item_inc ? 2 : C > CT ? 1 : 0;
  const auto kernel = which == 2   ? deltas_kernel<true, true>
                      : which == 1 ? deltas_kernel<false, true>
                                   : deltas_kernel<false, false>;
  std::atomic<bool>& opted = dev.opted_in[which];
  if (!opted.load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.store(true, std::memory_order_relaxed);
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  // 16-byte loads of the literal and include tiles, and 16-byte stores,
  // where the rows allow them
  const int vec16 =
      L % 16 == 0 && aligned(literals) && aligned(include) && aligned(out);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(M) * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(literals),
      static_cast<const uint32_t*>(keys1), static_cast<const uint32_t*>(keys2),
      static_cast<const int8_t*>(include), static_cast<const uint8_t*>(m1_t),
      static_cast<const uint8_t*>(m2_t), static_cast<const uint8_t*>(m1_n),
      static_cast<const uint8_t*>(m2_n), y, y_neg, y_bytes,
      static_cast<int32_t*>(out), B, C, M, L, TL, CT,
      static_cast<uint32_t>(t_inc), static_cast<uint32_t>(t_dec), vec16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* train_deltas_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
