// Morton-ring exact k nearest neighbours (kernels K9 and K10, and the ring
// stats twin): (squared distance ascending, original index), ties to the
// lowest index, bitwise equal to the streaming scan (K8) on the same clouds.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/topk_scan.py::
// _knn_ring_kernel (:268, knn_ring), ::_knn_ring_stats_kernel (:287,
// _knn_ring_stats_call: the same scan with per-tile counters) and
// ::_knn_ring_kernel_pf (:309, knn_ring_masked: the same scan with a table
// of ring centres).
//
// Inputs, prepared in torch ops by kernels/topk_scan.py as the reference
// prepares them: queries Morton-sorted and padded to whole tiles of kTq by
// repeating the last row; supports Morton-sorted (masked clouds over the
// valid AABB, poison last), padded to whole chunks of kTm with far-away
// rows of id 2^24, and packed as float4 (x, y, z, original index as f32).
//
// What the scan computes. Each query keeps a list of exactly K =
// round_up(k, 8) entries ordered by (d, id); K, not k, because the
// reference's buffer has K rows and both the skip test and the counters
// read its worst entry. The queries of tile i (kTq sorted rows) walk the
// chunks in ring order: step j visits chunk (c + off_j + nj) mod nj, off_j
// = ((j+1)/2)(2(j%2) - 1), around the tile's centre chunk c, the
// Morton-proportional ((i kTq + kTq/2) nj) / q_pad or the masked form's
// table entry. A chunk's lower bound for a query is the reference's
// arithmetic on the chunk's AABB over all kTm rows (pad and poison rows
// too): gap max(max(lo - q, q - hi), 0), squared, summed x, y, z, each
// operation rounded alone. A chunk whose bound exceeds a query's worst
// distance holds no candidate below that query's worst entry, so skipping
// it is exact for any set of queries: the lists after every step, and so
// the result, do not depend on how finely the skip is decided.
//
// Why this equals the reference's extraction loop. Per chunk the reference
// extracts candidates in increasing (d, id) order and inserts each one
// below the buffer's worst entry: after the chunk the buffer holds the K
// smallest of (buffer + chunk), which any order of inserts also computes.
// Its knockout removes candidates BY ID, and every pad row carries the id
// 2^24, so only the nearest pad row of a chunk is a candidate: this kernel
// folds the pad rows it scans of a chunk to their minimum and offers that
// one (a pad row in a sub-chunk it skips is farther than the worst, as its
// nearest pad row then is). Top-k results never depend on it, but the
// worst entry can, and through it the skip tests and the counters.
//
// What bounds it on this card. Each scanned (query, support) pair costs
// about 12 issued instructions (a shared-memory broadcast of the point, 8
// flops of distance, the compare with the worst distance, a share of the
// warp vote and the loop), and each insert round of a warp about 6 K for a
// register list or log2(K) loads, compares and stores for a heap: the
// kernel is bound by instruction issue and latency, over the pairs it scans
// and the insert rounds it takes, not by memory. A direct translation of
// the reference's tile (one block of 512 queries a tile, a 512-thread block
// an SM) loses most of its time to four things: a warp pays a whole K-step
// insert whenever any of its 32 lanes inserts; the block scans a chunk for
// all 512 queries when one needs it; every ring step loads the chunk and
// reduces its AABB through shared memory behind three block barriers,
// skipped chunks included; and 16 warps an SM hide little latency.
//
// The design here, against each:
// - A first launch (knn_ring_boxes_kernel) writes each chunk's AABB, and the
//   AABBs of its kSubs sub-chunks of kSub rows, once a cloud into a table
//   [B, nj, 1 + kSubs, 8], with a flag for boxes that hold pad rows. The
//   scan reads the table for its skip tests, so a skipped chunk costs no
//   load and no barrier.
// - One block a warp of 32 consecutive sorted queries (a small box): it
//   walks its tile's ring alone and decides alone (__any_sync over its
//   lanes' bounds) whether it needs a chunk, then, against the same worst
//   distances, which of the chunk's sub-chunks. It stages those by cp.async
//   into its shared memory, nearest first (by the warp's least bound), and
//   reads each point as a float4 broadcast. No block barrier anywhere, and a
//   warp that is done frees its slot at once (a tile's warps scan from 6 to
//   23 chunks).
// - Inserts are batched: a lane appends each candidate at or below its worst
//   distance to a queue in shared memory; when some lane's queue is nearly
//   full, or at the chunk's end, the warp merges every lane's queue into the
//   lists in lockstep, one insert a queued entry. The warp pays for its
//   longest queue, not for the union of its lanes' inserts; scanning near
//   sub-chunks first shortens the queues.
// - Lists of K = 8 or 16 keys live in registers (RegList: a K-step
//   compare-and-swap chain an insert, every index static); longer ones are
//   max-heaps (HeapList: one sift-down an insert), in the block's shared
//   memory up to kSharedWide keys, else in global scratch. Both, the key
//   and the queue's flush live in topk_list.cuh, which the streaming scan
//   (knn.cu) shares.
// A list entry is one 64-bit key, (d bits << 32) | (id << 1) | flag: d >= +0,
// so the key orders as (d, id), and the flag bit (STATS: "inserted from
// this chunk") never decides an order, as no two entries share (d, id).
// Every list takes the same inserts, so the skip tests, the counters and the
// result are the same for any k.
//
// Counters. counts (optional, any instance): per warp of 32 sorted queries,
// the sub-chunks it scanned; the visited pairs are 32 * kSub times their
// sum. STATS, per 512-query tile as the reference defines them: visits
// counts the ring steps at which some query of the tile had chunk bound <=
// its worst; trips counts the reference's extraction while-loop trips,
// enter ? floor(R / unroll) + 1 : 0 a visited chunk, where enter is "some
// query's minimum chunk distance is <= its worst at entry" and R is the
// tile's largest r_q, the number of this chunk's candidates in query q's
// list after the chunk (_ring_chunk's monotone verdict: the first r_q
// extractions insert and no later one does, so the loop runs floor(R / u) +
// 1 trips). A row that a warp skips, with its chunk or its sub-chunk, is
// farther than every worst distance of the warp: it adds no enter and no
// r, so the tile's verdicts are the OR and max over the warps' scans. Each
// warp that needs the chunk posts enter ? 2 + r : 1 by atomicMax to its
// tile's slot for that step; the last warp of a tile to finish sums the
// slots.
#include <float.h>
#include <math.h>

#include "common.cuh"
#include "topk_list.cuh"

namespace {

using ppt::flush;
using ppt::key_d;
using ppt::key_id;
using ppt::ListOf;
using ppt::make_key;
using ppt::u64;

constexpr int kTq = 512;  // queries per tile: the ring's and counters' unit
constexpr int kTm = 512;  // support rows per chunk
constexpr int kTileWarps = kTq / 32;
constexpr int kBoxThreads = 128;  // the box table's block
// Lists of 8 or 16 keys live in registers, of up to kSharedWide keys in a
// heap in the block's shared memory (256 bytes a key), longer ones in a heap
// in global scratch.
constexpr int kSharedWide = 384;
constexpr int kSub = 32;  // support rows of a sub-chunk box
constexpr int kSubs = kTm / kSub;
static_assert(kSubs <= 32 && kSub % 32 == 0, "a chunk's sub-chunks: a mask");
constexpr int kGroup = 8;  // candidates a scan step
constexpr int kQueue = 12;  // queue slots a lane; merged past kQueue - kGroup
constexpr int kPadId = 1 << 24;
constexpr float kPadF = 16777216.f;
constexpr unsigned kFull = 0xffffffffu;
// (+inf, 2^24, no flag): an empty list slot; kNone never enters a list
constexpr u64 kEmpty = (u64{0x7f800000u} << 32) | (u64{kPadId} << 1);
constexpr u64 kNone = ppt::kNoKey;

// A float4 from shared memory at a 32-bit shared-window address.
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Stage the n sub-chunks of src listed in order[], side by side at the
// shared address dst; returns the rows staged.
__device__ __forceinline__ int stage_async(unsigned dst, const float4* src,
                                           const unsigned char* order, int n,
                                           int lane) {
  for (int i = 0; i < n; ++i) {
    const float4* from = src + order[i] * kSub;
#pragma unroll
    for (int r = 0; r < kSub / 32; ++r)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + (i * kSub + r * 32 + lane) * 16),
                   "l"(from + r * 32 + lane));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return n * kSub;
}

// Scan the n sub-chunks listed in order[] of one chunk (kTm float4 at
// src), staged into the shared address pts, for this lane's query. PAD: the
// chunk holds pad rows, which are folded to their nearest and offered once
// at the end. STATS: dmin receives the smallest distance scanned, and every
// inserted key carries the flag bit.
template <bool STATS, bool PAD, class List>
__device__ __forceinline__ void scan_chunk(const float4* src,
                                           const unsigned char* order, int n,
                                           unsigned pts, u64* q, int lane,
                                           float qx, float qy, float qz,
                                           List& list, float& dmin) {
  const int rows = stage_async(pts, src, order, n, lane);
  __syncwarp();
  const unsigned flag = STATS ? 1u : 0u;
  // candidates at or below the worst distance, never +inf
  float wf = fminf(key_d(list.worst()), FLT_MAX);
  float padmin = INFINITY;
  int qn = 0;
#pragma unroll 1
  for (int t = 0; t < rows; t += kGroup) {
    float d[kGroup], id[kGroup];
    bool acc[kGroup];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const float4 p = lds128(pts + (t + u) * 16);
      d[u] = ppt::sqdist3(p.x, p.y, p.z, qx, qy, qz);
      id[u] = p.w;
      if (STATS) dmin = fminf(dmin, d[u]);
      acc[u] = d[u] <= wf;
      if (PAD) {
        const bool pad = p.w == kPadF;
        padmin = fminf(padmin, pad ? d[u] : INFINITY);
        acc[u] = acc[u] && !pad;
      }
      any = any || acc[u];
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (acc[u]) {
          q[qn * 32 + lane] =
              make_key(d[u], (static_cast<unsigned>(id[u]) << 1) | flag);
          ++qn;
        }
      }
      if (__any_sync(kFull, qn > kQueue - kGroup)) {
        flush(q, lane, qn, list);
        wf = fminf(key_d(list.worst()), FLT_MAX);
      }
    }
  }
  if (__any_sync(kFull, qn > 0)) flush(q, lane, qn, list);
  if (PAD)
    list.insert(padmin < INFINITY
                    ? make_key(padmin, (unsigned{kPadId} << 1) | flag)
                    : kNone);
}

// The chunk-box table: one block a (cloud, chunk) pair, writing 1 + kSubs
// boxes of two float4 each at boxes[b, j]: the chunk's, then each of its
// sub-chunks' (kSub rows), each (min x, min y, min z, 1 if a row has id
// 2^24 else 0) and (max x, max y, max z, 0) over all its rows. The grid
// also zeroes zero[0 .. n_zero).
__global__ void __launch_bounds__(kBoxThreads)
    knn_ring_boxes_kernel(const float4* __restrict__ sup, int nj,
                          float4* __restrict__ boxes, int* __restrict__ zero,
                          size_t n_zero) {
  constexpr int kWarps = kBoxThreads / 32;
  __shared__ float4 part[kSubs][2];
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4* c = sup + (static_cast<size_t>(b) * nj + j) * kTm;
  float4* out = boxes + (static_cast<size_t>(b) * nj + j) * (1 + kSubs) * 2;
  for (int s = warp; s < kSubs; s += kWarps) {
    float lx = INFINITY, ly = INFINITY, lz = INFINITY;
    float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
    bool pad = false;
    for (int t = lane; t < kSub; t += 32) {
      const float4 v = c[s * kSub + t];
      lx = fminf(lx, v.x);
      ly = fminf(ly, v.y);
      lz = fminf(lz, v.z);
      hx = fmaxf(hx, v.x);
      hy = fmaxf(hy, v.y);
      hz = fmaxf(hz, v.z);
      pad = pad || v.w == kPadF;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(kFull, lx, o));
      ly = fminf(ly, __shfl_xor_sync(kFull, ly, o));
      lz = fminf(lz, __shfl_xor_sync(kFull, lz, o));
      hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
      hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o));
      hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, o));
    }
    pad = __any_sync(kFull, pad);
    if (lane == 0) {
      part[s][0] = make_float4(lx, ly, lz, pad ? 1.f : 0.f);
      part[s][1] = make_float4(hx, hy, hz, 0.f);
      out[2 * (1 + s)] = part[s][0];
      out[2 * (1 + s) + 1] = part[s][1];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 lo = part[0][0], hi = part[0][1];
    for (int s = 1; s < kSubs; ++s) {
      lo.x = fminf(lo.x, part[s][0].x);
      lo.y = fminf(lo.y, part[s][0].y);
      lo.z = fminf(lo.z, part[s][0].z);
      lo.w = fmaxf(lo.w, part[s][0].w);
      hi.x = fmaxf(hi.x, part[s][1].x);
      hi.y = fmaxf(hi.y, part[s][1].y);
      hi.z = fmaxf(hi.z, part[s][1].z);
    }
    out[0] = lo;
    out[1] = hi;
  }
  const size_t stride =
      static_cast<size_t>(gridDim.x) * gridDim.y * kBoxThreads;
  for (size_t i = (static_cast<size_t>(b) * gridDim.x + j) * kBoxThreads +
                  threadIdx.x;
       i < n_zero; i += stride)
    zero[i] = 0;
}

// The AABB lower bound of a box for query q, in the reference's
// arithmetic: gap max(max(lo - q, q - hi), 0), squared, summed x, y, z.
__device__ __forceinline__ float box_bound(float4 lo, float4 hi, float qx,
                                           float qy, float qz) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// One block a warp of 32 sorted queries, so that a warp that is done frees
// its SM slot at once (the warps of a tile scan from 6 to 23 chunks).
template <int K, bool STATS>
__global__ void __launch_bounds__(32)
    knn_ring_kernel(const float* __restrict__ qry,
                    const float4* __restrict__ sup,
                    const float4* __restrict__ boxes,
                    const int* __restrict__ centers, int q_pad, int nj, int k,
                    int k_pad, int unroll, float* __restrict__ out_d,
                    int* __restrict__ out_i, int* __restrict__ counts,
                    int* __restrict__ stats, int* __restrict__ codes,
                    u64* __restrict__ lists) {
  __shared__ __align__(16) float4 staged[kTm];
  __shared__ u64 q[kQueue * 32];
  __shared__ unsigned char order[kSubs];
  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int wpc = q_pad / 32;  // warps a cloud
  const int ni = q_pad / kTq;
  const int gw = blockIdx.x;
  const int tile = gw / kTileWarps;
  const size_t row = static_cast<size_t>(b) * q_pad +
                     static_cast<size_t>(gw) * 32 + lane;
  const float qx = qry[3 * row], qy = qry[3 * row + 1], qz = qry[3 * row + 2];
  const int center =
      centers != nullptr
          ? centers[static_cast<size_t>(b) * ni + tile]
          : static_cast<int>(
                (static_cast<long long>(tile) * kTq + kTq / 2) * nj / q_pad);
  const float4* chunks = sup + static_cast<size_t>(b) * nj * kTm;
  const unsigned pts =
      static_cast<unsigned>(__cvta_generic_to_shared(staged));
  const float4* box = boxes + static_cast<size_t>(b) * nj * (1 + kSubs) * 2;
  int* tcodes =
      STATS ? codes + (static_cast<size_t>(b) * ni + tile) * (nj + 1)
            : nullptr;

  extern __shared__ u64 heap_slab[];  // a heap's slab, when it fits
  typename ListOf<K>::type list;
  ListOf<K>::bind(list, lists, heap_slab, static_cast<size_t>(b) * wpc + gw,
                  k_pad, lane);
  list.init(kEmpty);
  int visits = 0;

  for (int j = 0; j < nj; ++j) {
    const int off = ((j + 1) / 2) * (2 * (j % 2) - 1);
    const int chunk = (center + off + nj) % nj;
    const float4* cb = box + static_cast<size_t>(chunk) * (1 + kSubs) * 2;
    const float4 lo = __ldg(cb);
    const float worst = key_d(list.worst());
    if (!__any_sync(kFull, box_bound(lo, __ldg(cb + 1), qx, qy, qz) <= worst))
      continue;  // no lane needs the chunk
    // The sub-chunks that some lane needs, against the worst at entry,
    // scanned nearest first (by the warp's least bound, then index): the
    // lists fill with near candidates and later ones insert less. The set
    // scanned, and so every list and counter, does not depend on the order.
    unsigned need = 0, near[kSubs];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      const float lb = box_bound(__ldg(cb + 2 * (1 + s)),
                                 __ldg(cb + 2 * (1 + s) + 1), qx, qy, qz);
      if (__any_sync(kFull, lb <= worst)) need |= 1u << s;
      near[s] = __reduce_min_sync(kFull, __float_as_uint(lb));
    }
    unsigned own = 0;  // lane s ranks sub-chunk s
#pragma unroll
    for (int s = 0; s < kSubs; ++s) own = lane == s ? near[s] : own;
    int rank = 0;
#pragma unroll
    for (int s = 0; s < kSubs; ++s)
      rank += (need >> s & 1) &&
              (near[s] < own || (near[s] == own && s < lane));
    const int n = __popc(need);
    visits += n;
    __syncwarp();  // every lane is done with the previous chunk
    if (lane < kSubs && (need >> lane & 1)) order[rank] = lane;
    __syncwarp();
    const float4* src = chunks + static_cast<size_t>(chunk) * kTm;

    float dmin = INFINITY;
    if (STATS) list.clear_flags();
    if (lo.w != 0.f)
      scan_chunk<STATS, true>(src, order, n, pts, q, lane, qx, qy, qz, list,
                              dmin);
    else
      scan_chunk<STATS, false>(src, order, n, pts, q, lane, qx, qy, qz, list,
                               dmin);
    if (STATS) {
      const bool enter = __any_sync(kFull, dmin <= worst);
      const int r = static_cast<int>(
          __reduce_max_sync(kFull, static_cast<unsigned>(list.flags())));
      if (lane == 0) atomicMax(&tcodes[j], enter ? 2 + r : 1);
    }
  }

  list.store(out_d, out_i, row, k);
  if (counts != nullptr && lane == 0)
    counts[static_cast<size_t>(b) * wpc + gw] = visits;
  if (STATS) {
    // the last warp of the tile to finish sums the tile's step codes
    __threadfence();
    int last = 0;
    if (lane == 0) last = atomicAdd(&tcodes[nj], 1) == kTileWarps - 1;
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence();
      int v = 0, t = 0;
      for (int jj = lane; jj < nj; jj += 32) {
        const int c = __ldcg(&tcodes[jj]);
        v += c >= 1 ? 1 : 0;
        t += c >= 2 ? (c - 2) / unroll + 1 : 0;
      }
      v = __reduce_add_sync(kFull, v);
      t = __reduce_add_sync(kFull, t);
      if (lane == 0) {
        const size_t at = (static_cast<size_t>(b) * ni + tile) * 2;
        stats[at] = v;
        stats[at + 1] = t;
      }
    }
  }
}

template <int K, bool STATS>
void launch_scan(const dim3 grid, const float* qry, const float4* sup,
                 const float4* boxes, const int* centers, int q_pad, int nj,
                 int k, int k_pad, int unroll, float* out_d, int* out_i,
                 int* counts, int* stats, int* codes, u64* lists,
                 size_t smem, cudaStream_t stream) {
  // all of the SM's shared memory for blocks (11 KB each, and a heap's
  // slab), and room for a heap of kSharedWide keys
  static const bool once = [] {
    cudaFuncSetAttribute(knn_ring_kernel<K, STATS>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (K == -1)
      cudaFuncSetAttribute(knn_ring_kernel<K, STATS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSharedWide * 32 * sizeof(u64));
    return true;
  }();
  (void)once;
  knn_ring_kernel<K, STATS><<<grid, 32, smem, stream>>>(
      qry, sup, boxes, centers, q_pad, nj, k, k_pad, unroll, out_d, out_i,
      counts, stats, codes, lists);
}

template <int K>
cudaError_t launch(const float* qry, const float4* sup, float4* boxes,
                   const int* centers, int b, int q_pad, int nj, int k,
                   int k_pad, int unroll, float* out_d, int* out_i,
                   int* counts, int* stats, int* codes, u64* lists,
                   cudaStream_t stream) {
  const int ni = q_pad / kTq;
  const size_t n_zero =
      stats != nullptr ? static_cast<size_t>(b) * ni * (nj + 1) : 0;
  knn_ring_boxes_kernel<<<dim3(nj, b), kBoxThreads, 0, stream>>>(
      sup, nj, boxes, codes, n_zero);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(q_pad / 32, b);
  const size_t smem = K == -1 ? k_pad * 32 * sizeof(u64) : 0;
  if (stats != nullptr)
    launch_scan<K, true>(grid, qry, sup, boxes, centers, q_pad, nj, k, k_pad,
                         unroll, out_d, out_i, counts, stats, codes, lists,
                         smem, stream);
  else
    launch_scan<K, false>(grid, qry, sup, boxes, centers, q_pad, nj, k,
                          k_pad, unroll, out_d, out_i, counts, stats, codes,
                          lists, smem, stream);
  return cudaGetLastError();
}

}  // namespace

// qry: float [B, q_pad, 3], sorted and padded; sup: float [B, m_pad, 4]
// (x, y, z, id); centers: int [B, q_pad / 512] or null; boxes: float
// [B, m_pad / 512, 1 + 16, 8] of scratch; out_d, out_i: [B, q_pad, k];
// counts: int [B, q_pad / 32] (the sub-chunks of 32 rows each warp of 32
// queries scanned) or null; stats:
// int [B, q_pad / 512, 2] (visits, trips) or null, and then codes: int
// [B * (q_pad / 512) * (m_pad / 512 + 1)] of scratch. q_pad and m_pad
// multiples of 512, 1 <= k <= k_pad = round_up(k, 8). For k_pad > 384,
// lists holds B * q_pad * k_pad 64-bit keys of scratch; else it is null.
extern "C" int ppt_knn_ring(const float* qry, const float* sup,
                            const int* centers, int b, int q_pad, int m_pad,
                            int k, int k_pad, int unroll, float* boxes,
                            float* out_d, int* out_i, int* counts, int* stats,
                            int* codes, u64* lists, cudaStream_t stream) {
  if (q_pad % kTq != 0 || m_pad % kTm != 0 || m_pad == 0 || k < 1 ||
      k > k_pad || k_pad % 8 != 0 || unroll < 1 || boxes == nullptr)
    return cudaErrorInvalidValue;
  if ((k_pad > kSharedWide) != (lists != nullptr) ||
      (stats != nullptr && codes == nullptr))
    return cudaErrorInvalidValue;
  if (b == 0 || q_pad == 0) return cudaSuccess;
  const float4* s = reinterpret_cast<const float4*>(sup);
  float4* bx = reinterpret_cast<float4*>(boxes);
  const int nj = m_pad / kTm;
#define PPT_RING(KK)                                                        \
  return launch<KK>(qry, s, bx, centers, b, q_pad, nj, k, k_pad, unroll,    \
                    out_d, out_i, counts, stats, codes, lists, stream)
  if (k_pad == 8) PPT_RING(8);
  if (k_pad == 16) PPT_RING(16);
  if (k_pad <= kSharedWide) PPT_RING(-1);
  PPT_RING(0);
#undef PPT_RING
}
