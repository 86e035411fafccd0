// Deterministic row scatter-add: out[b, r, :] = sum of updates[b, k, :] over
// the k with idx[b, k] == r, summed in ascending k, in float32.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/scatter.py::
// _scatter_kernel_t (scatter_add_csum_t) and ::_scatter_kernel
// (scatter_add_csum), which compute the same sum as one-hot MXU products
// because a TPU has neither atomics nor fast dynamic stores. Their bf16
// hi/lo split of the updates (about 2^-16 relative error at parts=2) is a
// device of the MXU and is not carried over: here every update enters in
// full float32, so a permutation write is exact and a sum is the f32 sum
// in ascending k, from +0.
//
// Two launches, no float atomics, no host glue:
//
// 1. run_table_kernel builds the run table: each cloud's in-range updates
//    stably sorted by target row (the (row, k) pair of each, k ascending
//    within a row: `order`) and each row's start in that order (`offsets`,
//    n + 1 per cloud). It is an LSD radix sort of the row indices, digits
//    of at most 8 bits (two passes up to 2^16 rows), run by a thread-block
//    cluster of up to 8 blocks per cloud so that the clouds of a batch
//    fill the card's SMs. Each warp of the cluster owns one contiguous
//    segment of the input and counts its digits into its own row of its
//    block's [warp][bucket] table in shared memory (integer atomics: counts
//    do not depend on the order of the adds); the blocks then read each
//    other's bucket totals through distributed shared memory, so every
//    (bucket, block, warp) learns its first output slot; each warp walks
//    its segment in order, eight 32-entry steps per batch of loads, ranking
//    equal digits inside a step by __match_any_sync. Stable by
//    construction, so the rows come out in ascending k. Indices outside
//    [0, n) are dropped in the first pass. Each pass reads and writes the
//    (row, k) pairs in device memory.
// 2. scatter_rows_kernel sums the runs, one thread per output element
//    (b, r, c). A short run is walked by its thread with its loads issued
//    four ahead of the serial adds. A run longer than kLongRun is taken by
//    the whole warp, four channels at a time: the lanes load 128
//    consecutive updates of the run into a shared-memory stage (the next
//    128 in flight meanwhile) and lane q adds channel q's in k order, the
//    same chain of __fadd_rn, so the bits do not change; a row of 4096
//    updates costs 4096 dependent adds, not 4096 dependent round trips to
//    memory.
//
// On the card its bound is the bytes (every index and update read once,
// every output written once), but the sort sets its time: a fixed cost a
// pass (the table, the cluster barriers, the exchange of totals), then the
// serial steps of each warp's segment (the rank of a step by
// __match_any_sync, the slot update, the store of each pair to a scattered
// slot). PERF.md has its times.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kMaxDigitBits = 8;
constexpr int kMaxBuckets = 1 << kMaxDigitBits;
constexpr int kBatch = 8;        // 32-key steps whose loads go out together
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMinPerBlock = 2048;  // keys a block of the cluster at least
constexpr int kRowThreads = 256;
constexpr int kLongRun = 32;
constexpr int kLongBatch = 4;  // 32-update chunks a long-run load batch
constexpr unsigned kFull = 0xffffffffu;

struct SortSmem {
  int table[kSortWarps * kMaxBuckets];  // [warp][bucket]: counts, then slots
  int total[kMaxBuckets];   // this block's count of each bucket (cluster-read)
  int base[kMaxBuckets];    // the cluster's count, then its first slot
  int before[kMaxBuckets];  // the counts of the lower-ranked blocks
  int warp_sums[kSortWarps];
};

// Exclusive scan of a[0 .. len) in place, len <= kMaxBuckets, by the whole
// block. Returns the total to every thread.
__device__ int block_scan(int* a, int len, int* warp_sums) {
  constexpr int kPer = (kMaxBuckets + kSortThreads - 1) / kSortThreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = threadIdx.x * kPer;
  int local[kPer];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    local[i] = sum;
    sum += first + i < len ? a[first + i] : 0;
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kSortWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int start = (warp ? warp_sums[warp - 1] : 0) + incl - sum;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (first + i < len) a[first + i] = start + local[i];
  const int total = warp_sums[kSortWarps - 1];
  __syncthreads();
  return total;
}

// One cluster of blocks per cloud (cluster b of the grid). idx: int
// [B, K]; kv: int2 [2][B, K] of (row, k); offsets: int [B, n + 1]. The
// sorted pairs end in kv plane (passes - 1) & 1.
__global__ void __launch_bounds__(kSortThreads)
    run_table_kernel(const int* __restrict__ idx, int k, int n, int passes,
                     int digit_bits, int2* __restrict__ kv,
                     int* __restrict__ offsets) {
  __shared__ SortSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = cs * kSortWarps;  // the cloud's warps
  const int gw = rank * kSortWarps + warp;
  const unsigned below = (1u << lane) - 1u;
  const int buckets = 1 << digit_bits;
  const unsigned mask = static_cast<unsigned>(buckets - 1);
  const size_t plane = static_cast<size_t>(gridDim.x / cs) * k;
  const size_t at = static_cast<size_t>(b) * k;
  const int* in_idx = idx + at;
  int count = k;  // entries this pass reads; in range after the first

  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * digit_bits;
    // warp segments of a whole number of 32-entry steps
    const int seg = ((count + nw - 1) / nw + 31) / 32 * 32;
    const int lo = min(count, gw * seg);
    const int hi = min(count, lo + seg);
    const int2* in_kv = kv + ((pass - 1) & 1) * plane + at;
    // (row, k) of entry e of this pass; row -1 past the end, and in the
    // first pass for an index outside [0, n)
    auto entry = [&](int e) {
      if (e >= hi) return make_int2(-1, 0);
      if (pass == 0) {
        const int r = in_idx[e];
        return make_int2(r >= 0 && r < n ? r : -1, e);
      }
      return in_kv[e];
    };

    for (int i = threadIdx.x; i < buckets * kSortWarps; i += kSortThreads)
      sm.table[i] = 0;
    __syncthreads();
    // counts: the order of the integer adds does not change them
    for (int s = lo; s < hi; s += 32 * kBatch) {
      int2 p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) p[u] = entry(s + 32 * u + lane);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (p[u].x >= 0) {
          const unsigned digit =
              (static_cast<unsigned>(p[u].x) >> shift) & mask;
          atomicAdd(&sm.table[warp * buckets + digit], 1);
        }
      }
    }
    __syncthreads();
    // this block's total of each bucket, each warp's start within it
    for (int d = threadIdx.x; d < buckets; d += kSortThreads) {
      int sum = 0;
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = sm.table[w * buckets + d];
        sm.table[w * buckets + d] = sum;
        sum += c;
      }
      sm.total[d] = sum;
    }
    cluster.sync();  // every block's totals are readable
    for (int d = threadIdx.x; d < buckets; d += kSortThreads) {
      int all = 0, lower = 0;
      for (int r = 0; r < cs; ++r) {
        const int c = *cluster.map_shared_rank(&sm.total[d], r);
        all += c;
        if (r < rank) lower += c;
      }
      sm.base[d] = all;
      sm.before[d] = lower;
    }
    __syncthreads();
    const int next = block_scan(sm.base, buckets, sm.warp_sums);
    for (int i = threadIdx.x; i < buckets * kSortWarps; i += kSortThreads) {
      const int d = i & (buckets - 1);
      sm.table[i] += sm.base[d] + sm.before[d];
    }
    __syncthreads();
    int2* out_kv = kv + (pass & 1) * plane + at;
    // placement, in order: a lane's rank among the equal digits of its
    // step (__match_any_sync) after the slots of the warp's earlier steps
    for (int s = lo; s < hi; s += 32 * kBatch) {
      int2 p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) p[u] = entry(s + 32 * u + lane);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool live = p[u].x >= 0;
        const unsigned digit =
            live ? (static_cast<unsigned>(p[u].x) >> shift) & mask : ~0u;
        const unsigned peers =
            __match_any_sync(kFull, digit) & __ballot_sync(kFull, live);
        int* slot = &sm.table[warp * buckets + (digit & mask)];
        const int to = live ? *slot + __popc(peers & below) : 0;
        __syncwarp();
        if (live) {
          if ((peers & below) == 0) *slot = to + __popc(peers);
          out_kv[to] = p[u];
        }
        __syncwarp();
      }
    }
    count = next;
    // the pass's writes are the next pass's reads; the totals are read
    cluster.sync();
  }

  // offsets[r] = the first sorted slot whose row is >= r
  const int2* sorted = kv + ((passes - 1) & 1) * plane + at;
  int* off = offsets + static_cast<size_t>(b) * (n + 1);
  for (int i = rank * kSortThreads + threadIdx.x; i <= count;
       i += cs * kSortThreads) {
    const int prev = i == 0 ? -1 : sorted[i - 1].x;
    const int cur = i == count ? n : sorted[i].x;
    for (int r = prev + 1; r <= cur; ++r) off[r] = i;
  }
}

// One thread per output element e = (b n + r) C + c, e < total. order:
// int2 [B, K], the (row, k) of each sorted slot; offsets: int [B, n + 1];
// upd: float [B, K, C]; out: float [B, n, C]. The grid covers the elements
// exactly and every lane takes part in the warp's long-run loop.
template <typename Index>
__global__ void __launch_bounds__(kRowThreads)
    scatter_rows_kernel(const float* __restrict__ upd,
                        const int2* __restrict__ order,
                        const int* __restrict__ offsets, int n, int k, int c,
                        Index total, float* __restrict__ out) {
  __shared__ float stage[kRowThreads / 32][kLongBatch * 32][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Index e = static_cast<Index>(blockIdx.x) * kRowThreads + threadIdx.x;
  const bool valid = e < total;
  const Index row = valid ? e / c : 0;  // b n + r
  const int ch = static_cast<int>(e - row * c);
  const int b = static_cast<int>(row / n);
  const int r = static_cast<int>(row - static_cast<Index>(b) * n);
  const int* off = offsets + static_cast<Index>(b) * (n + 1);
  const int lo = valid ? off[r] : 0;
  const int hi = valid ? off[r + 1] : 0;
  const bool long_run = valid && hi - lo > kLongRun;

  if (valid && !long_run) {
    const int2* ord = order + static_cast<Index>(b) * k;
    const float* u = upd + static_cast<Index>(b) * k * c + ch;
    float acc = 0.f;
    int j = lo;
    for (; j + 4 <= hi; j += 4) {
      const int o0 = ord[j].y, o1 = ord[j + 1].y, o2 = ord[j + 2].y,
                o3 = ord[j + 3].y;
      const float v0 = u[static_cast<Index>(o0) * c];
      const float v1 = u[static_cast<Index>(o1) * c];
      const float v2 = u[static_cast<Index>(o2) * c];
      const float v3 = u[static_cast<Index>(o3) * c];
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v0), v1), v2), v3);
    }
    for (; j < hi; ++j)
      acc = __fadd_rn(acc, u[static_cast<Index>(ord[j].y) * c]);
    out[e] = acc;
  }

  // Long runs: the warp takes each long row whose first channel in this
  // warp a lane holds, four channels at a time. The lanes load 128 updates
  // of the run into the warp's stage (the next 128 in flight meanwhile),
  // and lane q adds channel q's in k order; each lane holding one of the
  // row's channels then takes its sum.
  unsigned todo = __ballot_sync(kFull, long_run && (ch == 0 || lane == 0));
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int s_lo = __shfl_sync(kFull, lo, src);
    const int s_hi = __shfl_sync(kFull, hi, src);
    const Index s_row = __shfl_sync(kFull, row, src);
    const int s_ch = __shfl_sync(kFull, ch, src);
    const int s_b = static_cast<int>(s_row / n);
    const int c_end = min(c, s_ch + 32 - src);  // this warp's channels
    const int2* s_ord = order + static_cast<Index>(s_b) * k;
    const float* s_u = upd + static_cast<Index>(s_b) * k * c;
    for (int c0 = s_ch; c0 < c_end; c0 += 4) {
      const int nc = min(4, c_end - c0);
      float v[kLongBatch][4];
      auto fetch = [&](int j0) {
        int o[kLongBatch];
#pragma unroll
        for (int t = 0; t < kLongBatch; ++t) {
          const int j = j0 + 32 * t + lane;
          o[t] = j < s_hi ? s_ord[j].y : 0;
        }
#pragma unroll
        for (int t = 0; t < kLongBatch; ++t) {
          const int j = j0 + 32 * t + lane;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[t][q] = j < s_hi && q < nc
                          ? s_u[static_cast<Index>(o[t]) * c + c0 + q]
                          : 0.f;
        }
      };
      float acc = 0.f;  // lane q < nc: channel c0 + q
      fetch(s_lo);
      for (int j0 = s_lo; j0 < s_hi; j0 += 32 * kLongBatch) {
#pragma unroll
        for (int t = 0; t < kLongBatch; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) stage[warp][32 * t + lane][q] = v[t][q];
        __syncwarp();
        if (j0 + 32 * kLongBatch < s_hi) fetch(j0 + 32 * kLongBatch);
        const int len = min(32 * kLongBatch, s_hi - j0);
        if (lane < nc) {
          int i = 0;
          for (; i + 4 <= len; i += 4) {
            const float w0 = stage[warp][i][lane];
            const float w1 = stage[warp][i + 1][lane];
            const float w2 = stage[warp][i + 2][lane];
            const float w3 = stage[warp][i + 3][lane];
            acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, w0), w1), w2),
                            w3);
          }
          for (; i < len; ++i) acc = __fadd_rn(acc, stage[warp][i][lane]);
        }
        __syncwarp();
      }
      const float mine =
          __shfl_sync(kFull, acc, min(max(ch - c0, 0), 31));
      if (long_run && row == s_row && ch >= c0 && ch < c0 + nc) out[e] = mine;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace

// idx: int [B, K]; upd: float [B, K, C]; scratch: int [4 B K + B (n + 1)]
// ((row, k) pairs ping-pong, int2 [2][B K], then the offsets); out: float
// [B, n, C]. B K and B n below 2^31 (the wrapper checks).
extern "C" int ppt_scatter_add(const int* idx, const float* upd, int b, int k,
                               int n, int c, int* scratch, float* out,
                               cudaStream_t stream) {
  if (b < 0 || k < 0 || n < 0 || c < 0) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(b) * n * c;
  if (total == 0) return cudaSuccess;
  int bits = 1;
  while ((1LL << bits) < n) ++bits;  // rows 0 .. n - 1
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int digit_bits = (bits + passes - 1) / passes;
  const size_t plane = static_cast<size_t>(b) * k;
  int2* kv = reinterpret_cast<int2*>(scratch);
  int* offsets = scratch + 4 * plane;

  // a cluster of blocks per cloud, as many as fill the SMs once, each
  // with at least kMinPerBlock keys
  int cs = 1;
  while (cs < kMaxCluster && 2LL * cs * b <= sm_count() &&
         k / (2 * cs) >= kMinPerBlock)
    cs *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * cs));
  cfg.blockDim = dim3(kSortThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, run_table_kernel, idx, k, n,
                                       passes, digit_bits, kv, offsets);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int2* order = kv + ((passes - 1) & 1) * plane;
  const long long blocks = (total + kRowThreads - 1) / kRowThreads;
  const long long reach = static_cast<long long>(b) * k * c;  // upd's size
  if (blocks * kRowThreads < (1LL << 31) && reach < (1LL << 31)) {
    scatter_rows_kernel<int><<<static_cast<unsigned>(blocks), kRowThreads, 0,
                               stream>>>(upd, order, offsets, n, k, c,
                                         static_cast<int>(total), out);
  } else {
    scatter_rows_kernel<long long><<<static_cast<unsigned>(blocks),
                                     kRowThreads, 0, stream>>>(
        upd, order, offsets, n, k, c, total, out);
  }
  return cudaGetLastError();
}
