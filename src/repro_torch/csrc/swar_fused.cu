// Kernel K1: fused bit-packed TM clause evaluation + class votes.
//
// Replaces the Pallas kernel repro/kernels/swar_fused.py:62
// swar_fused_votes_pallas (body _swar_fused_kernel):
//
//   hit[b,i,w] = inc_words[i,w] & not_words[b,w]
//   viol[b,i]  = sum_w popc(hit[b,i,w])
//   votes[b,c] = sum_i (viol[b,i] == 0) * vote_matrix[i,c]
//
// Words are the 32 bits of the port's int32 word tensors, read as
// uint32_t.  Only viol == 0 matters, and it holds iff every hit word is
// zero, so the kernel ORs the hit words instead of counting their bits:
// one three-input logic op (LOP3: acc | a & b) per (row, clause, word),
// at 64 per clock per SM, where AND + POPC + IADD cost three ops and
// POPC issues at 16 per clock.
//
// Bound on an H100 at tm-mnist-50 (Wl = 49, CM = 500, C = 10): B*CM*Wl
// logic ops at 16.75 T/s (64 per clock per SM) — 0.09 us at a served
// bucket of 64 rows, 6.0 us at 4096 rows — against about 0.1 MB of
// bytes (0.03 us at 3.35 TB/s).  A served batch is therefore bound by
// latency (the launch, one pass of global loads, one reduction), a large
// batch by the logic ops, and the design answers both:
//
// - One launch, plain stores.  Blocks of one thread block cluster share
//   a tile of BB rows and split the clause tiles; each folds its fired
//   clauses into a (BB, C) vote partial in its own shared memory.  Rank q
//   owns a share of the entries: every block stores its partial's share
//   into rank q's shared memory (distributed shared memory), and after
//   one cluster.sync() each rank sums what it received in rank order and
//   stores it.  A block may write a peer's shared memory only once every
//   block of the cluster has started, so each arrives on the cluster
//   barrier when it starts and waits on it just before its first push:
//   the staging and the logic ops hide the wait.  No block touches a
//   peer after the cluster.sync().  So no memset and no atomics on the
//   output (an earlier design zeroed the output in a second launch and
//   added slices with atomicAdd).  Clusters over clause tiles rather than a grid-wide
//   reduction: the partials never leave the SMs, and the cluster size
//   adapts per call — up to the portable 8 while the row tiles alone
//   leave SMs idle (B = 1: one row tile, 8 blocks), 1 or 2 where they
//   fill the card (B = 4096).
// - Register micro-tiles.  A thread owns R rows x Q clauses (Serve: 2 x
//   2, Bulk: 4 x 4), so it carries R*Q independent OR chains and every
//   16-byte shared load feeds Q (or R) of them; in the serving tile two
//   lanes split each pair's words and OR their halves with one shuffle.
//   Bulk's 4 x 4 tile needs 8 operand words per 16 logic ops, within the
//   shared-memory rate.
// - Staging.  Rows and clause words go to shared memory through 4-byte
//   global loads (a 196-byte row of tm-mnist-50 is not 16-byte aligned),
//   all of a chunk's loads — rows, clauses and the tile's vote rows —
//   issued before any shared store waits on one, so staging costs one
//   round trip to L2.  (Four-byte cp.async copies took about one clock
//   per copy per SM.)  Rows are zero-padded to whole 16-byte vectors
//   (zero words add no violation) with a row pitch of K4 vectors,
//   K4 = S (mod 2S), so the 16-byte loads of a warp fall on distinct bank
//   groups.  Clauses past CM never fire, and rows past B fire nothing to
//   fold.  The fold walks each row's fired-clause bit mask over the
//   staged vote rows.
// - Any class count.  The (BB, C) partial, what a rank receives and the
//   tile's vote rows grow with C (about 128 bytes a class in the serving
//   tile).  Where they overrun a block's shared memory (past about 1,600
//   classes), a second instantiation tiles the class axis: grid row y
//   takes classes [y * CT, y * CT + CT), stages only those columns of
//   the vote rows, and stores its own columns of the output.  The host
//   picks the widest CT that fits; where the whole C fits, the kernel
//   is the untiled one.
// - No per-call device query: the SM count and the shared-memory limit
//   are read once per device and cached.

#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "phase_clocks.cuh"

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
constexpr int kChunkWords = 64;   // words of a row staged per chunk
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kBlocksPerSm = 2;   // blocks per SM the cluster size aims at
constexpr int kMaxDevices = 64;

// A block tile of BB rows x TQ clauses.  Thread micro-tile: R rows x Q
// clauses, over every S-th 16-byte vector of the words.  Lanes: S word
// lanes fastest, then RGW row groups, then clause groups; rows of a
// thread are NRG apart and clauses NCG apart, so neighbouring lanes read
// neighbouring shared rows.
template <int BB_, int TQ_, int R_, int Q_, int S_, int RGW_>
struct Tile {
  static constexpr int BB = BB_, TQ = TQ_, R = R_, Q = Q_, S = S_;
  static constexpr int RGW = RGW_;
  static constexpr int NRG = BB / R;             // row groups
  static constexpr int NCG = TQ / Q;             // clause groups
  static constexpr int CGW = 32 / (S * RGW);     // clause groups per warp
  static constexpr int WR = NRG / RGW;           // warps along rows
  static constexpr int FW = TQ / 32;             // fired-mask words per row
  static_assert(NRG * NCG * S == kThreads, "one micro-tile per thread");
  static_assert(NRG % RGW == 0 && NCG % CGW == 0, "warps tile the block");
  static_assert(TQ % 32 == 0, "whole fired-mask words");
};
// serving sizes: small tiles, many clusters' worth of blocks
using Serve = Tile<8, 64, 2, 2, 2, 4>;
// large batches: 4 x 4 micro-tiles keep the logic ops, not shared loads,
// the limit
using Bulk = Tile<32, 128, 4, 4, 1, 4>;

// 16-byte vectors per staged row: at least nv, and = S (mod 2S)
template <class T>
int row_pitch(int nv) {
  int k = nv < 1 ? 1 : nv;
  while (k % (2 * T::S) != T::S) ++k;
  return k;
}

// entries of the (BB, C) vote partial each cluster rank sums and stores
__host__ __device__ inline int share(int n, int cs) {
  return (n + cs - 1) / cs;
}
// int32 slots for the partials a rank receives, whole 16-byte vectors
__host__ __device__ inline int recv_len(int n, int cs) {
  return (cs * share(n, cs) + 3) / 4 * 4;
}

// C: the classes a block holds (the class tile's width CT when tiled,
// then a multiple of 4, and the fired-clause lists follow the votes)
template <class T>
size_t smem_bytes(int C, int K4, int cs, bool tiled = false) {
  const int n = T::BB * C;
  return static_cast<size_t>(n) * sizeof(int32_t)              // partial
         + static_cast<size_t>(recv_len(n, cs)) * sizeof(int32_t)  // received
         + static_cast<size_t>(T::BB) * T::FW * sizeof(uint32_t)  // fired
         + static_cast<size_t>(T::BB + T::TQ) * K4 * 16        // words
         + static_cast<size_t>(T::TQ) * C                      // votes
         + (tiled ? static_cast<size_t>(T::BB) * (T::TQ + 4) : 0);  // lists
}

// Staging in two steps, so that every global load of a chunk (rows,
// clauses, vote rows) is in flight at once before any shared store waits
// on one.  A warp stages rows warp, warp + 8, ...; a lane words lane and
// lane + 32 of each (a chunk has at most 64); zeros past kw, up to the
// row's nv4 words, and in rows past n_valid.
template <int ROWS>
struct Words {
  static constexpr int PER = ROWS / (kThreads / 32);
  uint32_t v[PER][2];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ src,
                                       int W, int kw, int n_valid) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp + 8 * i, ww = lane + 32 * h;
        v[i][h] = r < n_valid && ww < kw
                      ? src[static_cast<size_t>(r) * W + ww]
                      : 0u;
      }
  }
  __device__ __forceinline__ void store(uint32_t* dst, int pitch,
                                        int nv4) const {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h < nv4)
          dst[(warp + 8 * i) * pitch + lane + 32 * h] = v[i][h];
  }
};

// The first 4 * kThreads bytes of a tile's vote rows (all of them while
// C <= 16 at TQ = 64); stage_votes copies the rest.
struct Votes {
  int8_t v[4];
  __device__ __forceinline__ void load(const int8_t* __restrict__ src,
                                       int n) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = threadIdx.x + u * kThreads;
      v[u] = p < n ? src[p] : 0;
    }
  }
  __device__ __forceinline__ void store(int8_t* dst, int n) const {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = threadIdx.x + u * kThreads;
      if (p < n) dst[p] = v[u];
    }
  }
};

// dst[p] = src[p] for p in [4 * kThreads, n)
__device__ __forceinline__ void stage_votes(int8_t* dst,
                                            const int8_t* __restrict__ src,
                                            int n) {
  for (int p = threadIdx.x + 4 * kThreads; p < n; p += kThreads)
    dst[p] = src[p];
}

// a class tile's columns of tq vote rows: dst (tq rows of dp bytes) from
// rows of C bytes of src, ct bytes each, in V-wide pieces (ct, dp and C
// multiples of sizeof(V)); eight loads a thread in flight before its
// stores
template <class V>
__device__ __forceinline__ void stage_columns(int8_t* dst,
                                              const int8_t* __restrict__ src,
                                              int tq, int ct, int dp, int C) {
  constexpr int U = 8, w = sizeof(V);
  const int per_row = ct / w, n = tq * per_row;
  for (int p0 = threadIdx.x; p0 < n; p0 += U * kThreads) {
    V t[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kThreads, j = p / per_row;
      if (p < n)
        t[u] = *reinterpret_cast<const V*>(
            src + static_cast<size_t>(j) * C + (p - j * per_row) * w);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kThreads, j = p / per_row;
      if (p < n)
        *reinterpret_cast<V*>(dst + j * dp + (p - j * per_row) * w) = t[u];
    }
  }
}
// the widest pieces the tile's rows allow (the host makes CT a multiple
// of 16 where it can, so c0 is one, and so is every tile's width
// wherever C is); rows padded with zeros to a multiple of 4 bytes
__device__ __forceinline__ void stage_vote_columns(
    int8_t* dst, const int8_t* __restrict__ src, int tq, int ct, int C) {
  const auto a = reinterpret_cast<uintptr_t>(src);
  const int dp = (ct + 3) / 4 * 4;
  if (C % 16 == 0 && ct % 16 == 0 && a % 16 == 0)
    stage_columns<uint4>(dst, src, tq, ct, dp, C);
  else if (C % 8 == 0 && ct % 8 == 0 && a % 8 == 0)
    stage_columns<uint2>(dst, src, tq, ct, dp, C);
  else if (C % 4 == 0 && ct % 4 == 0 && a % 4 == 0)
    stage_columns<uint32_t>(dst, src, tq, ct, dp, C);
  else
    stage_columns<int8_t>(dst, src, tq, ct, dp, C);
  const int pad = dp - ct;
  for (int p = threadIdx.x; p < tq * pad; p += kThreads)
    dst[(p / pad) * dp + ct + p % pad] = 0;
}

// CTILE: this block takes classes [c0, c0 + ct) of grid row y (width CT);
// otherwise all C, and gridDim.y is 1.
template <class T, bool CTILE>
__global__ void __launch_bounds__(kThreads)
votes_kernel(const uint32_t* __restrict__ not_words,
             const uint32_t* __restrict__ inc_words,
             const int8_t* __restrict__ vote_matrix,
             int32_t* __restrict__ out, int B, int CM, int W, int C, int CT,
             int K4, int tiles_per_rank) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = CTILE ? static_cast<int>(blockIdx.y) * CT : 0;
  const int ct = CTILE ? min(CT, C - c0) : C;  // classes of this block
  const int n_part = T::BB * ct, per = share(n_part, cs);
  int32_t* part = reinterpret_cast<int32_t*>(smem);         // (BB, C)
  int32_t* recv = part + n_part;                            // (cs, per)
  uint32_t* fired = reinterpret_cast<uint32_t*>(recv + recv_len(n_part, cs));
  uint4* rows = reinterpret_cast<uint4*>(fired + T::BB * T::FW);
  uint4* cls = rows + T::BB * K4;
  int8_t* votes = reinterpret_cast<int8_t*>(cls + T::TQ * K4);
  // CTILE: each row's fired clauses as a list, and their counts
  uint8_t* flist = reinterpret_cast<uint8_t*>(votes + T::TQ * CT);
  int32_t* fcount = reinterpret_cast<int32_t*>(flist + T::BB * T::TQ);
  uint32_t* rows_w = reinterpret_cast<uint32_t*>(rows);
  uint32_t* cls_w = reinterpret_cast<uint32_t*>(cls);

  const int row0 = static_cast<int>(blockIdx.x / cs) * T::BB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = lane % T::S;
  const int rg = (lane / T::S) % T::RGW + T::RGW * (warp % T::WR);
  const int cq = lane / (T::S * T::RGW) + T::CGW * (warp / T::WR);
  const int pitch = 4 * K4;                      // words per staged row
  PHASE(0);
  cluster_arrive();  // this block has started (waited on before the push)

  for (int p = tid; p < n_part; p += kThreads) part[p] = 0;
  const int n_tiles = (CM + T::TQ - 1) / T::TQ;
  const int t_begin = rank * tiles_per_rank;
  const int t_end = min(n_tiles, t_begin + tiles_per_rank);
  const int n_chunks = (W + kChunkWords - 1) / kChunkWords;

  for (int t = t_begin; t < t_end; ++t) {
    const int cm0 = t * T::TQ;
    const int tq = min(T::TQ, CM - cm0);
    __syncthreads();  // the previous tile's fold has read fired / votes
    for (int p = tid; p < T::BB * T::FW; p += kThreads) fired[p] = 0u;
    const int8_t* tile_votes =
        vote_matrix + static_cast<size_t>(cm0) * C + c0;
    if (n_chunks == 0) {  // W = 0: no chunk below stages or syncs
      if (CTILE) {
        stage_vote_columns(votes, tile_votes, tq, ct, C);
      } else {
        Votes vt;
        vt.load(tile_votes, tq * C);
        vt.store(votes, tq * C);
        stage_votes(votes, tile_votes, tq * C);
      }
      __syncthreads();
    }
    uint32_t acc[T::R][T::Q];
#pragma unroll
    for (int i = 0; i < T::R; ++i)
#pragma unroll
      for (int k = 0; k < T::Q; ++k) acc[i][k] = 0u;

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int w0 = ch * kChunkWords;
      const int kw = min(kChunkWords, W - w0);
      const int nv = (kw + 3) / 4;
      if (ch > 0) __syncthreads();  // the previous chunk is consumed
      const bool stage_rows = n_chunks > 1 || t == t_begin;
      Words<T::BB> rw;
      Words<T::TQ> cw;
      Votes vt;
      if (stage_rows)
        rw.load(not_words + static_cast<size_t>(row0) * W + w0, W, kw,
                B - row0);
      cw.load(inc_words + static_cast<size_t>(cm0) * W + w0, W, kw, tq);
      if (!CTILE && ch == 0) vt.load(tile_votes, tq * C);
      if (stage_rows) rw.store(rows_w, pitch, 4 * nv);
      cw.store(cls_w, pitch, 4 * nv);
      if (ch == 0) {
        if (CTILE) {
          stage_vote_columns(votes, tile_votes, tq, ct, C);
        } else {
          vt.store(votes, tq * C);
          stage_votes(votes, tile_votes, tq * C);
        }
      }
      __syncthreads();
      if (t == t_begin && ch == 0) PHASE(1);  // staged
#pragma unroll 2
      for (int v = s; v < nv; v += T::S) {
        uint4 a[T::R], b[T::Q];
#pragma unroll
        for (int i = 0; i < T::R; ++i) a[i] = rows[(rg + T::NRG * i) * K4 + v];
#pragma unroll
        for (int k = 0; k < T::Q; ++k) b[k] = cls[(cq + T::NCG * k) * K4 + v];
#pragma unroll
        for (int i = 0; i < T::R; ++i)
#pragma unroll
          for (int k = 0; k < T::Q; ++k) {
            uint32_t x = acc[i][k] | (a[i].x & b[k].x);
            x |= a[i].y & b[k].y;
            x |= a[i].z & b[k].z;
            acc[i][k] = x | (a[i].w & b[k].w);
          }
      }
    }
    if (t == t_begin) PHASE(2);  // the first tile's logic ops
    // the S lanes of a micro-tile hold disjoint vectors: OR them
#pragma unroll
    for (int off = 1; off < T::S; off *= 2)
#pragma unroll
      for (int i = 0; i < T::R; ++i)
#pragma unroll
        for (int k = 0; k < T::Q; ++k)
          acc[i][k] |= __shfl_xor_sync(0xffffffffu, acc[i][k], off);
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < T::R; ++i)
#pragma unroll
        for (int k = 0; k < T::Q; ++k) {
          const int j = cq + T::NCG * k;
          // clauses past CM (the ragged last tile) never fire, and rows
          // past B (the ragged last row tile) fire nothing to fold
          if (acc[i][k] == 0u && j < tq && row0 + rg + T::NRG * i < B)
            atomicOr(&fired[(rg + T::NRG * i) * T::FW + j / 32],
                     1u << (j % 32));
        }
    }
    __syncthreads();
    if (CTILE) {
      // fold a wide class tile: a thread per row and 4 classes (one
      // 32-bit word of each vote row) walks the row's fired-clause list,
      // its loads independent; a thread per row builds the lists
      for (int r = tid; r < T::BB; r += kThreads) {
        int n = 0;
#pragma unroll
        for (int fw = 0; fw < T::FW; ++fw) {
          uint32_t f = fired[r * T::FW + fw];
          while (f) {
            flist[r * T::TQ + n++] =
                static_cast<uint8_t>(fw * 32 + __ffs(f) - 1);
            f &= f - 1;
          }
        }
        fcount[r] = n;
      }
      __syncthreads();
      const int q4 = (ct + 3) / 4;  // words per staged vote row
      const uint32_t* v32 = reinterpret_cast<const uint32_t*>(votes);
      for (int p = tid; p < T::BB * q4; p += kThreads) {
        const int r = p / q4, k = p - r * q4, n = fcount[r];
        const uint8_t* fl = flist + r * T::TQ;
        int32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const uint32_t w = v32[fl[i] * q4 + k];
          s0 += static_cast<int8_t>(w);
          s1 += static_cast<int8_t>(w >> 8);
          s2 += static_cast<int8_t>(w >> 16);
          s3 += static_cast<int8_t>(w >> 24);
        }
        int32_t* dst = part + r * ct + 4 * k;
        const int left = ct - 4 * k;  // classes of this word: 1 to 4
        dst[0] += s0;
        if (left > 1) dst[1] += s1;
        if (left > 2) dst[2] += s2;
        if (left > 3) dst[3] += s3;
      }
      continue;
    }
    // fold: each (row, class) entry has one owner, across every tile
    for (int p = tid; p < n_part; p += kThreads) {
      const int r = p / ct, c = p - r * ct;
      int32_t sum = 0;
#pragma unroll
      for (int fw = 0; fw < T::FW; ++fw) {
        uint32_t f = fired[r * T::FW + fw];
        while (f) {
          const int j = fw * 32 + __ffs(f) - 1;
          f &= f - 1;
          sum += votes[j * ct + c];
        }
      }
      part[p] += sum;
    }
  }

  PHASE(3);  // every tile folded
  // rank q sums entries [q * per, (q + 1) * per): push this block's share
  // of them into rank q's shared memory, slot `rank`
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  for (int p = tid; p < n_part; p += kThreads) {
    const int q = p / per;
    cluster.map_shared_rank(recv, q)[rank * per + p - q * per] = part[p];
  }
  cluster.sync();  // every push has landed; no remote access after this
  PHASE(4);
  for (int e = tid; e < per; e += kThreads) {
    const int p = rank * per + e;
    const int r = p / ct;
    if (p >= n_part || row0 + r >= B) break;  // the ragged row tile
    int32_t sum = 0;
    for (int q = 0; q < cs; ++q) sum += recv[q * per + e];
    out[static_cast<size_t>(row0 + r) * C + c0 + p - r * ct] = sum;
  }
  PHASE(5);
}

struct DeviceInfo {
  std::atomic<int> n_sm{0};
  std::atomic<int> smem_optin{0};
  // per tile and class tiling: the smem attribute is set
  std::atomic<bool> opted_in[4]{};
};
DeviceInfo g_devices[kMaxDevices];

// The device's SM count and opt-in shared memory per block, read once.
cudaError_t device_info(int device, int* n_sm, int* smem_optin) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[device];
  int n = d.n_sm.load(std::memory_order_relaxed);
  int sm = d.smem_optin.load(std::memory_order_relaxed);
  if (n == 0 || sm == 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sm, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return err;
    d.smem_optin.store(sm, std::memory_order_relaxed);
    d.n_sm.store(n, std::memory_order_relaxed);
  }
  *n_sm = n;
  *smem_optin = sm;
  return cudaSuccess;
}

template <class T, bool CTILE>
cudaError_t launch_kernel(int which, const uint32_t* not_words,
                          const uint32_t* inc_words,
                          const int8_t* vote_matrix, int32_t* out, int B,
                          int CM, int W, int C, int CT, int K4,
                          int tiles_per_rank, int row_tiles, int cs,
                          size_t smem, int device, int smem_optin,
                          cudaStream_t stream) {
  std::atomic<bool>& opted =
      g_devices[device].opted_in[2 * which + (CTILE ? 1 : 0)];
  if (!opted.load(std::memory_order_relaxed)) {
    // once per device: allow dynamic shared memory up to the opt-in limit
    const cudaError_t err = cudaFuncSetAttribute(
        votes_kernel<T, CTILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_optin);
    if (err != cudaSuccess) return err;
    opted.store(true, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_tiles) * cs,
                     CTILE ? static_cast<unsigned>((C + CT - 1) / CT) : 1u);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, votes_kernel<T, CTILE>, not_words, inc_words, vote_matrix, out,
      B, CM, W, C, CT, K4, tiles_per_rank);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_tile(int which, const uint32_t* not_words,
                        const uint32_t* inc_words, const int8_t* vote_matrix,
                        int32_t* out, int B, int CM, int W, int C, int device,
                        int n_sm, int smem_optin, cudaStream_t stream) {
  const int K4 = row_pitch<T>((std::min(W, kChunkWords) + 3) / 4);
  const int row_tiles = (B + T::BB - 1) / T::BB;
  const int n_tiles = (CM + T::TQ - 1) / T::TQ;
  // a cluster per row tile, as wide as it takes to give every SM about
  // kBlocksPerSm blocks: the whole grid is then resident at once (four
  // blocks per SM would overrun what clusters can pack: two waves)
  int cs = (kBlocksPerSm * n_sm + row_tiles - 1) / row_tiles;
  cs = std::max(1, std::min({cs, kMaxCluster, n_tiles}));
  const int tiles_per_rank = n_tiles == 0 ? 0 : (n_tiles + cs - 1) / cs;
  if (tiles_per_rank > 0) cs = (n_tiles + tiles_per_rank - 1) / tiles_per_rank;
  const size_t limit = static_cast<size_t>(smem_optin);
  const size_t smem = smem_bytes<T>(C, K4, cs);
  if (smem <= limit)
    return launch_kernel<T, false>(which, not_words, inc_words, vote_matrix,
                                   out, B, CM, W, C, C, K4, tiles_per_rank,
                                   row_tiles, cs, smem, device, smem_optin,
                                   stream);
  // class tiles: the widest that fits (the layout grows by about
  // 8 BB + TQ bytes a class), then evened out over the tiles
  const size_t fixed = smem_bytes<T>(0, K4, cs, true);
  const size_t per_class = 8 * T::BB + T::TQ;
  int CT = limit > fixed + 4 * cs + 16
               ? static_cast<int>((limit - fixed - 4 * cs - 16) / per_class)
               : 0;
  CT = std::min(CT, C);
  while (CT > 0 && smem_bytes<T>(CT, K4, cs, true) > limit) --CT;
  // as few tiles as fit, evened out, each a multiple of 16 classes wide
  // (whole 16-byte pieces of the vote rows), else of 4 (whole words)
  for (int n_ct = (C + std::max(CT, 1) - 1) / std::max(CT, 1);; ++n_ct) {
    const int even = (C + n_ct - 1) / n_ct;
    const int w16 = (even + 15) / 16 * 16, w4 = (even + 3) / 4 * 4;
    if (smem_bytes<T>(w16, K4, cs, true) <= limit) {
      CT = w16;
      break;
    }
    if (even <= 16) {
      if (smem_bytes<T>(w4, K4, cs, true) > limit)
        return cudaErrorInvalidValue;
      CT = w4;
      break;
    }
  }
  return launch_kernel<T, true>(which, not_words, inc_words, vote_matrix,
                                out, B, CM, W, C, CT, K4, tiles_per_rank,
                                row_tiles, cs, smem_bytes<T>(CT, K4, cs, true),
                                device, smem_optin, stream);
}

}  // namespace

// not_words (B, W) and inc_words (CM, W): 32-bit words; vote_matrix
// (CM, C) int8; out (B, C) int32, every entry written once.  One launch
// on `stream` of `device`; never synchronises.  Returns a cudaError_t
// (0 = success), including what cudaLaunchKernelEx or cudaGetLastError
// report for a refused launch (a cluster shape included).
extern "C" int swar_fused_votes(const void* not_words, const void* inc_words,
                                const void* vote_matrix, void* out, int B,
                                int CM, int W, int C, int device,
                                void* stream) {
  // a thread-local switch: the launch goes to the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0) return 0;
  int n_sm = 0, smem_optin = 0;
  err = device_info(device, &n_sm, &smem_optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* nw = static_cast<const uint32_t*>(not_words);
  const auto* iw = static_cast<const uint32_t*>(inc_words);
  const auto* vm = static_cast<const int8_t*>(vote_matrix);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // Bulk once the serving tile's row tiles alone would fill the SMs
  const bool bulk =
      (B + Serve::BB - 1) / Serve::BB >= n_sm &&
      smem_bytes<Bulk>(C, row_pitch<Bulk>((std::min(W, kChunkWords) + 3) / 4),
                       kMaxCluster) <= static_cast<size_t>(smem_optin);
  err = bulk ? launch_tile<Bulk>(1, nw, iw, vm, o, B, CM, W, C, device, n_sm,
                                 smem_optin, s)
             : launch_tile<Serve>(0, nw, iw, vm, o, B, CM, W, C, device, n_sm,
                                  smem_optin, s);
  return static_cast<int>(err);
}

extern "C" const char* swar_fused_votes_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
