// Kernel K5: PDL race simulation — chain delays, arbiter argmin, first
// arrival and the top-gap metastability flag.
//
// Replaces the Pallas kernel repro/kernels/pdl_race.py:51 pdl_race_pallas
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
// Bound on an H100 (3.35 TB/s): the selects are read once (B * C * M
// bytes), the tables once (8 * C * M + 4 * C bytes) and 9 bytes written
// per row: about 1.04 MB at B = 1024, C = 10, M = 100, or 0.31 us.  The
// B * C * M float adds are far below the card's float32 rate, so it is
// bound by bytes, and at that size a call is one launch's latency plus
// one chain of dependent steps; the design keeps that chain short:
//
// - A warp per row, no block barrier after the start.  The block stages
//   the (C, M) low and high tables and the skews once in shared memory
//   (8 KB at C = 10, M = 100) behind one __syncthreads; each warp copies
//   its row's C * M contiguous selects into its own shared buffer with
//   16-byte loads (bytes for the unaligned head and tail), the first
//   row's loads issued before the tables' so the two round trips overlap.
// - Per-class sums in registers.  While C <= 32, g = 32 / C lanes share a
//   class (lane c * g + j sums the j-th contiguous share of its M
//   elements, eight at a time) and fold their partials with log2(g)
//   guarded shuffles; past 32 classes each lane sums its classes
//   c = lane, lane + 32, ... alone.
// - The arbiter as three warp-wide min reductions (redux.sync on the
//   delays' order-preserving uint32 keys): the first arrival, then the
//   lowest class arriving then and the earliest arrival strictly later.
//   Each lane offers its own (first arrival, class, next distinct
//   arrival) over its classes; every step is a min, so exact in any
//   order.  Lane 0 stores the row.
// - Where the tables and eight row buffers overrun a block's shared
//   memory (16 * C * M bytes past 227 KB: C * M above about 14,000), a
//   second instantiation reads both from global memory instead.
//
// What holds it above the bound (python -m repro_torch.kernels.phase_clocks
// times the phases between the PHASE marks): the same launch with an
// empty body takes about 1.8 us per call on an H100; of a block's 2.6 us
// at B = 1024, the tables' and first row's round trip takes 0.7 us and
// the class sums 1.4 us (a lane's 34 selects, table picks and adds).
//
// Summation order differs from XLA's, so float delays agree to rounding;
// integer-valued delays (exact in any order) agree bit for bit.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "phase_clocks.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // 16-byte row loads of a lane in flight at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// bytes of a warp's row buffer: the row placed at its source's offset
// within 16 bytes, so the 16-byte body stores are aligned
__host__ __device__ inline int row_pitch(int cm) {
  return (cm + 15 + 15) / 16 * 16;
}
__host__ __device__ inline int table_bytes(int C, int M) {
  return ((2 * C * M + C) * 4 + 15) / 16 * 16;
}

// The arbiter's state over a set of classes: the first arrival, its class
// (the lowest on a tie) and the earliest arrival strictly later (INFINITY
// when there is none).
struct Race {
  float lat;
  int win;
  float sec;
  __device__ void merge(float l2, int w2, float s2) {
    if (l2 < lat) {
      sec = fminf(lat, s2);  // the old first arrival is strictly later
      lat = l2;
      win = w2;
    } else if (l2 > lat) {
      sec = fminf(sec, l2);
    } else {
      win = min(win, w2);
      sec = fminf(sec, s2);
    }
  }
};

// A float as a uint32 with the same order (-0 taken as +0), and back.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// The sum of the delays of elements [j0, j0 + n): the low net where the
// select is set, else the high net.  Whole batches of eight contiguous
// elements take their addresses as immediate offsets from one base per
// batch (a select byte, a pick of the low or high table, a table load
// and an add each, the loads of a batch in flight together); the last
// n % 8 elements go one at a time.  (Index arithmetic and bounds checks
// per element made one lane's 34 sums take about 1,800 clocks at
// C = 10, M = 100.)
template <bool STAGED>
__device__ __forceinline__ float sum_delays(const int8_t* rs, const float* lo,
                                            const float* hi,
                                            const float2* __restrict__ elem,
                                            int j0, int n) {
  constexpr int U = 8;
  const int8_t* sp = rs + j0;
  float s = 0.f;
  int i = 0;
  if (STAGED) {
    const float* lp = lo + j0;
    const float* hp = hi + j0;
    for (; i + U <= n; i += U) {
      bool b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) b[u] = sp[i + u] != 0;
      float d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] = (b[u] ? lp : hp)[i + u];
#pragma unroll
      for (int u = 0; u < U; ++u) s += d[u];
    }
    for (; i < n; ++i) s += (sp[i] ? lp : hp)[i];
  } else {
    const float2* ep = elem + j0;
    for (; i + U <= n; i += U) {
      bool b[U];
      float2 e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        b[u] = sp[i + u] != 0;
        e[u] = __ldg(ep + i + u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) s += b[u] ? e[u].x : e[u].y;
    }
    for (; i < n; ++i) {
      const float2 e = __ldg(ep + i);
      s += sp[i] ? e.x : e.y;
    }
  }
  return s;
}

// A row's 16-byte body loads, in two steps so that the first row's loads
// are in flight while the block stages the tables.  The body starts at
// the first 16-byte boundary of the source row; `head` bytes precede it.
struct RowCopy {
  uint4 v[kUnroll];
  const int8_t* src;
  int n, head, nv;
  int8_t hb, tb;  // a lane's head byte and tail byte (fewer than 16 each)

  __device__ void init(const int8_t* row, int cm) {
    src = row;
    n = cm;
    head = min(cm, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row)
                                           & 15)) & 15));
    nv = (cm - head) / 16;
  }
  __device__ void load(int v0, int lane) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = v0 + lane + 32 * u;
      if (k < nv) v[u] = __ldg(s4 + k);
    }
    if (v0 == 0) {  // the unaligned ends, in the same round trip
      const int t = head + 16 * nv + lane;
      hb = lane < head ? src[lane] : 0;
      tb = t < n ? src[t] : 0;
    }
  }
  __device__ void store(int8_t* dst, int v0, int lane) const {
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = v0 + lane + 32 * u;
      if (k < nv) d4[k] = v[u];
    }
  }
  // the row into `buf` (16-byte aligned) → where it starts there; the
  // loads of the first kUnroll vectors a lane and of the ends were issued
  // by the caller
  __device__ const int8_t* finish(int8_t* buf, int lane) {
    int8_t* dst = buf + (reinterpret_cast<uintptr_t>(src) & 15);
    store(dst, 0, lane);
    if (lane < head) dst[lane] = hb;
    const int t = head + 16 * nv + lane;
    if (t < n) dst[t] = tb;
    for (int v0 = 32 * kUnroll; v0 < nv; v0 += 32 * kUnroll) {
      load(v0, lane);
      store(dst, v0, lane);
    }
    __syncwarp();
    return dst;
  }
};

// The (C, M) tables into shared memory as separate low and high arrays,
// and the skews: each thread's loads (16 bytes, two elements, where the
// tables are 16-byte aligned) all issued before its stores, so staging
// costs one round trip (a loop of load-then-store took one per element).
__device__ __forceinline__ void stage_tables(
    float* lo, float* hi, float* sk, const float2* __restrict__ elem,
    const float* __restrict__ skew, int CM, int C) {
  constexpr int U = 4;
  const int tid = threadIdx.x;
  const float sk0 = tid < C ? __ldg(skew + tid) : 0.f;
  if (reinterpret_cast<uintptr_t>(elem) % 16 == 0) {
    const float4* e4 = reinterpret_cast<const float4*>(elem);
    const int n4 = CM / 2;
    for (int p0 = tid; p0 < n4; p0 += U * kThreads) {
      float4 t[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p0 + u * kThreads < n4) t[u] = __ldg(e4 + p0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * kThreads;
        if (p < n4) {
          lo[2 * p] = t[u].x;
          hi[2 * p] = t[u].y;
          lo[2 * p + 1] = t[u].z;
          hi[2 * p + 1] = t[u].w;
        }
      }
    }
    if (CM % 2 && tid == 0) {
      const float2 d = __ldg(elem + CM - 1);
      lo[CM - 1] = d.x;
      hi[CM - 1] = d.y;
    }
  } else {
    for (int p0 = tid; p0 < CM; p0 += U * kThreads) {
      float2 t[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p0 + u * kThreads < CM) t[u] = __ldg(elem + p0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * kThreads;
        if (p < CM) {
          lo[p] = t[u].x;
          hi[p] = t[u].y;
        }
      }
    }
  }
  if (tid < C) sk[tid] = sk0;
  for (int c = tid + kThreads; c < C; c += kThreads) sk[c] = __ldg(skew + c);
}

// STAGED: the tables, the skews and each warp's row live in shared
// memory; otherwise every read goes to global memory.
template <bool STAGED>
__global__ void __launch_bounds__(kThreads)
race_kernel(const int8_t* __restrict__ low_sel,
            const float2* __restrict__ elem,  // (C, M) of (low, high)
            const float* __restrict__ skew, int32_t* __restrict__ winner,
            float* __restrict__ latency, uint8_t* __restrict__ meta, int B,
            int C, int M, float t_res) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int CM = C * M;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* lo = reinterpret_cast<float*>(smem);
  float* hi = lo + CM;
  float* sk = hi + CM;
  int8_t* buf = reinterpret_cast<int8_t*>(smem + table_bytes(C, M)) +
                warp * row_pitch(CM);

  int row = blockIdx.x * kWarps + warp;
  const int first_row = row;  // the phase marks time the first row only
  RowCopy rc;
  PHASE(0);
  if (STAGED) {
    if (row < B) {
      rc.init(low_sel + static_cast<size_t>(row) * CM, CM);
      rc.load(0, lane);
    }
    stage_tables(lo, hi, sk, elem, skew, CM, C);
    __syncthreads();
  }
  PHASE(1);

  for (; row < B; row += gridDim.x * kWarps) {
    const int8_t* rs;
    if (STAGED) {
      if (row != blockIdx.x * kWarps + warp) {  // a later row of the warp
        rc.init(low_sel + static_cast<size_t>(row) * CM, CM);
        rc.load(0, lane);
      }
      rs = rc.finish(buf, lane);
    } else {
      rs = low_sel + static_cast<size_t>(row) * CM;
    }
    if (row == first_row) PHASE(2);
    auto skew_of = [&](int c) -> float {
      return STAGED ? sk[c] : __ldg(skew + c);
    };

    Race r{INFINITY, INT_MAX, INFINITY};
    if (C <= 32) {
      const int g = 32 / C;  // lanes per class, each a contiguous share
      const int c = lane / g, sub = lane - c * g;
      const int share = (M + g - 1) / g, m0 = min(M, sub * share);
      float s = c < C ? sum_delays<STAGED>(rs, lo, hi, elem, c * M + m0,
                                           min(M, m0 + share) - m0)
                      : 0.f;
      for (int off = 1; off < g; off *= 2) {
        const float o = __shfl_down_sync(kFull, s, off);
        if (sub + off < g) s += o;
      }
      if (c < C && sub == 0) r.merge(s + skew_of(c), c, INFINITY);
    } else {
      for (int c = lane; c < C; c += 32)
        r.merge(sum_delays<STAGED>(rs, lo, hi, elem, c * M, M) +
                    skew_of(c),
                c, INFINITY);
    }
    if (row == first_row) PHASE(3);
    // the arbiter across the lanes: the first arrival, the lowest class
    // arriving then, and the earliest arrival strictly later — a lane
    // offers its own next arrival where its first one ties the minimum
    const uint32_t lk = order_key(r.lat);
    const uint32_t first = __reduce_min_sync(kFull, lk);
    const uint32_t win = __reduce_min_sync(
        kFull, lk == first ? static_cast<uint32_t>(r.win) : UINT_MAX);
    const uint32_t next =
        __reduce_min_sync(kFull, lk == first ? order_key(r.sec) : lk);
    if (lane == 0) {
      const float lat = from_key(first), sec = from_key(next);
      const float second = sec == INFINITY ? lat : sec;  // gap 0
      winner[row] = static_cast<int32_t>(win);
      latency[row] = lat;
      meta[row] = (second - lat) < t_res ? 1 : 0;
    }
    if (row == first_row) PHASE(4);
    if (STAGED) __syncwarp();  // the row buffer is read before it restages
  }
  PHASE(5);
}

struct DeviceInfo {
  std::atomic<int> n_sm{0};
  std::atomic<int> smem_optin{0};
  std::atomic<int> opted_in{0};  // dynamic shared memory allowed up to this
};
DeviceInfo g_devices[kMaxDevices];

}  // namespace

// low_sel (B, C, M) int8 {0,1}; elem_delays (C, M, 2) float32 (low,
// high); skew (C,) float32; winner (B,) int32, latency (B,) float32,
// meta (B,) uint8 (torch.bool storage).  One launch on `stream` of
// `device`; never synchronises.  Returns a cudaError_t (0 = success).
extern "C" int pdl_race(const void* low_sel, const void* elem_delays,
                        const void* skew, void* winner, void* latency,
                        void* meta, int B, int C, int M, float t_res,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || C <= 0) return 0;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& dev = g_devices[device];
  int n_sm = dev.n_sm.load(std::memory_order_relaxed);
  int optin = dev.smem_optin.load(std::memory_order_relaxed);
  if (n_sm == 0 || optin == 0) {  // read once per device
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    dev.smem_optin.store(optin, std::memory_order_relaxed);
    dev.n_sm.store(n_sm, std::memory_order_relaxed);
  }
  const long long cm = static_cast<long long>(C) * M;
  const long long staged =
      cm < (1LL << 24)
          ? table_bytes(C, M) + static_cast<long long>(kWarps) *
                                    row_pitch(static_cast<int>(cm))
          : LLONG_MAX;
  const bool use_smem = staged <= optin;
  const size_t smem = use_smem ? static_cast<size_t>(staged) : 0;
  if (smem > 48 * 1024 &&
      dev.opted_in.load(std::memory_order_relaxed) < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(race_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    dev.opted_in.store(optin, std::memory_order_relaxed);
  }
  // a warp per row; past a few blocks per SM a warp takes more rows
  const int blocks = static_cast<int>(
      std::min<long long>((B + kWarps - 1) / kWarps, 4LL * n_sm));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* sel = static_cast<const int8_t*>(low_sel);
  const auto* el = static_cast<const float2*>(elem_delays);
  const auto* sk = static_cast<const float*>(skew);
  auto* w = static_cast<int32_t*>(winner);
  auto* l = static_cast<float*>(latency);
  auto* mt = static_cast<uint8_t*>(meta);
  if (use_smem)
    race_kernel<true><<<blocks, kThreads, smem, s>>>(sel, el, sk, w, l, mt,
                                                     B, C, M, t_res);
  else
    race_kernel<false><<<blocks, kThreads, 0, s>>>(sel, el, sk, w, l, mt, B,
                                                   C, M, t_res);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pdl_race_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
