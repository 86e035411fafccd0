// Exact k nearest neighbours: (squared distance ascending, index), ties to
// the lowest support index (kernel K8, the streaming scan).
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/topk_scan.py::
// _knn_kernel (the streaming scan that knn() runs for Ns < 8192 or
// sorted_ok=False).
//
// Semantics: the k smallest (d, index) pairs in lexicographic order, d the
// diff^2 form summed over the channels in index order, each operation
// rounded alone (ppt::sqdist3 for xyz; __fsub_rn, __fmul_rn, __fadd_rn for
// any C: no FMA, and never the |p|^2 + |q|^2 - 2pq form). Masked support
// arrives poisoned by the caller, as the reference poisons it. The
// reference's Pallas scan reads three channels; a [B, N, C] cloud with C !=
// 3 follows its documented [B, N, C] contract (the XLA path's all-channel
// distance) instead.
//
// The design rests on the 64-bit key (topk_list.cuh): a candidate is (d bits
// << 32) | (index << 1), which orders exactly as (d, index), so the k
// smallest keys of the support do not depend on the order in which they
// arrive. The support of a query may be split across warps, its candidates
// queued, and partial lists merged, and the result keeps the same bits.
//
// On the card, against what bounds it (instruction issue: 8 rounded
// operations a distance for xyz and 3 a channel for any C, the compare
// against the list's worst, and the queued offers; bytes are negligible):
// - Enough warps at every shape. A block is kWarps warps; a warp holds 32 Q
//   queries (Q slots a lane). When B * Nq alone gives fewer than
//   kTargetWarps warps, the support is split across `split` warps of the
//   block, each scanning a contiguous part, and the parts' lists are merged
//   by key at the end: register lists through shared memory, heaps by
//   inserting the other parts' keys. A part holds at least kMinPart rows
//   and kPartLists list lengths: each part fills a list of its own and the
//   merge inserts every part's keys, work that grows with the list, so
//   long lists split less.
// - Few instructions a pair on xyz. A warp stages kChunk support rows of its
//   part as float4 in its own shared memory (no block barrier), and reads
//   each as one 16-byte broadcast; each staged point serves the lane's Q
//   queries (Q = 4 for lists of 4 keys, else 1). A candidate is offered in
//   groups of kGroup: the rejection test against the list's worst distance
//   comes first, and the accepted keys go to a per-lane queue in shared
//   memory that the warp merges into the lists in lockstep once some lane's
//   queue is nearly full, so the warp pays for its longest queue, not for
//   the union of its lanes' inserts.
// - One pass for every k. Lists of up to 16 keys live in registers
//   (RegList); longer ones are a per-query max-heap of round_up(k, 8) keys
//   (HeapList), in shared memory up to kSharedHeap keys, else in global
//   scratch (one part a query there, so the scratch stays B * Nq * k_pad
//   keys).
// - Any C: a warp computes a register tile of kRows support rows for its
//   32 queries, channels staged kChans at a time in shared memory (queries
//   transposed, rows as float4 broadcasts), each operation rounded alone;
//   it offers the kRows distances straight from registers to the same
//   lists. A heap's instance keeps the full tile too: a smaller one pays
//   the staging and the offers on half the rows.
#include <math.h>

#include "common.cuh"
#include "topk_list.cuh"

namespace {

using ppt::flush;
using ppt::key_d;
using ppt::ListOf;
using ppt::make_key;
using ppt::RegList;
using ppt::u64;

constexpr int kWarps = 4;      // warps a block
constexpr int kChunk = 128;    // xyz: support rows a warp stages at a time
constexpr int kRows = 32;      // any C: support rows a register tile
constexpr int kChans = 32;     // any C: channels staged at a time
constexpr int kGroup = 8;      // candidates offered together
constexpr int kQueue = 12;     // queue slots a lane and query
constexpr int kSharedHeap = 160;  // heaps of up to this many keys: shared
constexpr int kMinPart = 64;   // support rows of a part, at least
constexpr int kPartLists = 32;  // and this many list lengths
// Warps a launch should reach before the support is split: about 16 an SM.
constexpr long long kTargetWarps = 2048;
constexpr unsigned kFull = 0xffffffffu;
// (+inf, every id bit set): an empty slot, above any key a candidate makes
constexpr u64 kEmpty = (u64{0x7f800000u} << 32) | 0xffffffffu;

// Shared memory of a warp, in bytes: xyz stages kChunk float4 rows; any C a
// transposed query slice [kChans][33] and a row slice [kChans][36] (rows
// 16-byte aligned for float4 reads); then Q queues, then a heap's slab.
constexpr int kXyzStage = kChunk * 16;
constexpr int kChanStage = kChans * 33 * 4 + kChans * 36 * 4;
constexpr int kQueueBytes = kQueue * 32 * 8;

// Offer G candidates, distances d[u] at support index base + u, to one
// query's list through its queue q (slot s of this lane at q[s * 32 +
// lane]). NaN distances (rows past the support, lanes past the queries)
// never pass the test.
template <int G, class List>
__device__ __forceinline__ void offer(const float (&d)[G], int base, u64* q,
                                      int lane, int& qn, List& list,
                                      float& wf) {
  bool acc[G];
  bool any = false;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    acc[u] = d[u] <= wf;
    any = any || acc[u];
  }
  if (__any_sync(kFull, any)) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (acc[u]) {
        q[qn * 32 + lane] =
            make_key(d[u], static_cast<unsigned>(base + u) << 1);
        ++qn;
      }
    }
    if (__any_sync(kFull, qn > kQueue - G)) {
      flush(q, lane, qn, list);
      wf = key_d(list.worst());
    }
  }
}

// The slab of warp w's heap: in its shared memory, or in global scratch
// (none for a register list).
template <int K>
__device__ __forceinline__ u64* slab_of(unsigned char* smem, int warp_bytes,
                                        int heap_at, u64* lists,
                                        size_t warp0, int w, int k_pad) {
  if constexpr (K == -1)
    return reinterpret_cast<u64*>(smem + w * warp_bytes + heap_at);
  else if constexpr (K == 0)
    return lists + (warp0 + w) * k_pad * 32;
  else
    return nullptr;
}

// After the scan: merge the split parts' lists of each query and store the
// first k keys of each list. Register lists: every warp writes its keys to
// the start of its shared memory, then warp `part` merges the slots j with
// j % split == part from every part of its group. Heaps (Q == 1): part 0
// inserts the other parts' keys.
template <int K, int Q>
__device__ __forceinline__ void finish(typename ListOf<K>::type (&list)[Q],
                                       unsigned char* smem, int warp_bytes,
                                       int heap_at, u64* lists, size_t warp0,
                                       int group, int part, int split,
                                       int lane, int q0, int nq, int k,
                                       int k_pad, size_t row0,
                                       float* __restrict__ out_d,
                                       int* __restrict__ out_i) {
  if constexpr (K > 0) {
    if (split > 1) {
      u64* mine = reinterpret_cast<u64*>(smem +
                                         (group * split + part) * warp_bytes);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int s = 0; s < K; ++s)
          mine[(j * K + s) * 32 + lane] = list[j].key[s];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        if (j % split != part) continue;
        RegList<K> m;
        m.init(kEmpty);
        for (int p = 0; p < split; ++p) {
          const u64* src = reinterpret_cast<const u64*>(
              smem + (group * split + p) * warp_bytes);
#pragma unroll
          for (int s = 0; s < K; ++s) m.insert(src[(j * K + s) * 32 + lane]);
        }
        list[j] = m;
      }
    }
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const int q = q0 + 32 * j + lane;
      if (j % split == part && q < nq) list[j].store(out_d, out_i, row0 + q, k);
    }
  } else {
    static_assert(Q == 1, "a heap serves one query a lane");
    if (split > 1) {
      __syncthreads();
      if (part == 0) {
        for (int p = 1; p < split; ++p) {
          const u64* o = slab_of<K>(smem, warp_bytes, heap_at, lists, warp0,
                                    group * split + p, k_pad) + lane;
          for (int s = 0; s < k_pad; ++s) list[0].insert(o[s * 32]);
        }
      }
    }
    const int q = q0 + lane;
    if (part == 0 && q < nq) list[0].store(out_d, out_i, row0 + q, k);
  }
}

// xyz clouds: warp `warp` of the block serves queries q0 + 32 j + lane (j <
// Q) over support rows [lo, hi) of its part.
template <int K, int Q>
__global__ void __launch_bounds__(kWarps * 32)
    knn_xyz_kernel(const float* __restrict__ qry,
                   const float* __restrict__ sup, int nq, int ns, int k,
                   int k_pad, int split, int part_len, int warp_bytes,
                   u64* __restrict__ lists, float* __restrict__ out_d,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / split;
  const int part = warp - group * split;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * (kWarps / split) + group) * 32 * Q;
  unsigned char* region = smem + warp * warp_bytes;
  float4* stage = reinterpret_cast<float4*>(region);
  u64* queue = reinterpret_cast<u64*>(region + kXyzStage);
  const int heap_at = kXyzStage + Q * kQueueBytes;
  const size_t warp0 =
      (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kWarps;

  typename ListOf<K>::type list[Q];
  float qx[Q], qy[Q], qz[Q], wf[Q];
  int qn[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    ListOf<K>::bind(list[j], lists,
                    slab_of<K>(smem, warp_bytes, heap_at, lists, warp0, warp,
                               k_pad),
                    warp0 + warp, k_pad, lane);
    list[j].init(kEmpty);
    wf[j] = INFINITY;
    qn[j] = 0;
    const int q = q0 + 32 * j + lane;
    qx[j] = qy[j] = qz[j] = NAN;  // past the queries: never a candidate
    if (q < nq) {
      const float* src = qry + 3 * (static_cast<size_t>(b) * nq + q);
      qx[j] = src[0];
      qy[j] = src[1];
      qz[j] = src[2];
    }
  }
  const float* sb = sup + static_cast<size_t>(b) * ns * 3;
  const int lo = part * part_len;
  const int hi = min(ns, lo + part_len);
  for (int base = lo; base < hi; base += kChunk) {
    const int len = min(kChunk, hi - base);
    const int rows = (len + kGroup - 1) / kGroup * kGroup;
    __syncwarp();  // the previous chunk is no longer read
    for (int t = lane; t < rows; t += 32) {
      float4 v = make_float4(NAN, NAN, NAN, NAN);  // past the part
      if (t < len) {
        const float* src = sb + 3 * static_cast<size_t>(base + t);
        v = make_float4(src[0], src[1], src[2], 0.f);
      }
      stage[t] = v;
    }
    __syncwarp();
#pragma unroll 1
    for (int t = 0; t < rows; t += kGroup) {
      float4 p[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) p[u] = stage[t + u];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float d[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
          d[u] = ppt::sqdist3(qx[j], qy[j], qz[j], p[u].x, p[u].y, p[u].z);
        offer<kGroup>(d, base + t, queue + j * kQueue * 32, lane, qn[j],
                      list[j], wf[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j)
    if (__any_sync(kFull, qn[j] > 0))
      flush(queue + j * kQueue * 32, lane, qn[j], list[j]);
  finish<K, Q>(list, smem, warp_bytes, heap_at, lists, warp0, group, part,
               split, lane, q0, nq, k, k_pad, static_cast<size_t>(b) * nq,
               out_d, out_i);
}

// Any C: warp `warp` serves queries q0 + lane over support rows [lo, hi) of
// its part, kRows at a time: acc[r] sums (q - s_r)^2 over the channels in
// order, the channels staged kChans at a time (the queries once, when they
// fit one slice).
template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    knn_channels_kernel(const float* __restrict__ qry,
                        const float* __restrict__ sup, int nq, int ns, int c,
                        int k, int k_pad, int split, int part_len,
                        int warp_bytes, u64* __restrict__ lists,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / split;
  const int part = warp - group * split;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * (kWarps / split) + group) * 32;
  unsigned char* region = smem + warp * warp_bytes;
  float(*qs)[33] = reinterpret_cast<float(*)[33]>(region);
  float(*ss)[36] = reinterpret_cast<float(*)[36]>(region + kChans * 33 * 4);
  u64* queue = reinterpret_cast<u64*>(region + kChanStage);
  const int heap_at = kChanStage + kQueueBytes;
  const size_t warp0 =
      (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kWarps;
  const bool active = q0 + lane < nq;

  typename ListOf<K>::type list[1];
  ListOf<K>::bind(list[0], lists,
                  slab_of<K>(smem, warp_bytes, heap_at, lists, warp0, warp,
                             k_pad),
                  warp0 + warp, k_pad, lane);
  list[0].init(kEmpty);
  float wf = INFINITY;
  int qn = 0;
  const float* qb = qry + static_cast<size_t>(b) * nq * c;
  const float* sb = sup + static_cast<size_t>(b) * ns * c;
  const int lo = part * part_len;
  const int hi = min(ns, lo + part_len);
  for (int base = lo; base < hi; base += kRows) {
    const int len = min(kRows, hi - base);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kChans) {
      const int cl = min(kChans, c - c0);
      __syncwarp();  // the previous slice is no longer read
      if (c > kChans || base == lo) {
#pragma unroll 8
        for (int r = 0; r < 32; ++r)
          qs[lane][r] = lane < cl && q0 + r < nq
                            ? qb[static_cast<size_t>(q0 + r) * c + c0 + lane]
                            : 0.f;
      }
#pragma unroll 8
      for (int r = 0; r < kRows; ++r)
        ss[lane][r] = lane < cl && r < len
                          ? sb[static_cast<size_t>(base + r) * c + c0 + lane]
                          : 0.f;
      __syncwarp();
#pragma unroll 2
      for (int cc = 0; cc < cl; ++cc) {
        const float qv = qs[cc][lane];
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const float4 s = *reinterpret_cast<const float4*>(&ss[cc][r]);
          const float d0 = __fsub_rn(qv, s.x), d1 = __fsub_rn(qv, s.y);
          const float d2 = __fsub_rn(qv, s.z), d3 = __fsub_rn(qv, s.w);
          acc[r] = __fadd_rn(acc[r], __fmul_rn(d0, d0));
          acc[r + 1] = __fadd_rn(acc[r + 1], __fmul_rn(d1, d1));
          acc[r + 2] = __fadd_rn(acc[r + 2], __fmul_rn(d2, d2));
          acc[r + 3] = __fadd_rn(acc[r + 3], __fmul_rn(d3, d3));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r >= len || !active) acc[r] = NAN;  // never a candidate
#pragma unroll
    for (int g = 0; g < kRows; g += kGroup) {
      float d[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) d[u] = acc[g + u];
      offer<kGroup>(d, base + g, queue, lane, qn, list[0], wf);
    }
  }
  if (__any_sync(kFull, qn > 0)) flush(queue, lane, qn, list[0]);
  finish<K, 1>(list, smem, warp_bytes, heap_at, lists, warp0, group, part,
               split, lane, q0, nq, k, k_pad, static_cast<size_t>(b) * nq,
               out_d, out_i);
}

// The launch's shape: Q slots a lane (qmax, or 1 when qmax gives too few
// warps), the split of the support (`list` keys a list), and the grid.
struct Plan {
  int q, split, part_len, grid_x;
};

Plan plan(int b, int nq, int ns, int list, int qmax, int max_split) {
  Plan p{};
  const long long min_part =
      kMinPart > kPartLists * list ? kMinPart : kPartLists * list;
  for (p.q = qmax;; p.q = 1) {
    const long long groups =
        static_cast<long long>(b) * ((nq + 32 * p.q - 1) / (32 * p.q));
    p.split = 1;
    while (p.split < max_split && groups * p.split < kTargetWarps &&
           ns >= 2 * p.split * min_part)
      p.split *= 2;
    if (groups * p.split >= kTargetWarps || p.q == 1) break;
  }
  p.part_len = (ns + p.split - 1) / p.split;
  const int per_block = 32 * p.q * (kWarps / p.split);
  p.grid_x = (nq + per_block - 1) / per_block;
  return p;
}

template <class Kernel>
void allow_shared(Kernel kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
}

template <int K, int Q>
cudaError_t launch_xyz(const float* qry, const float* sup, int b, int nq,
                       int ns, int k, int k_pad, const Plan& p, u64* lists,
                       float* out_d, int* out_i, cudaStream_t stream) {
  constexpr int kMaxWarpBytes =
      kXyzStage + Q * kQueueBytes + (K == -1 ? kSharedHeap * 256 : 0);
  static const bool once = [] {
    allow_shared(knn_xyz_kernel<K, Q>, kWarps * kMaxWarpBytes);
    return true;
  }();
  (void)once;
  const int warp_bytes =
      kXyzStage + Q * kQueueBytes + (K == -1 ? k_pad * 256 : 0);
  knn_xyz_kernel<K, Q>
      <<<dim3(p.grid_x, b), kWarps * 32, kWarps * warp_bytes, stream>>>(
          qry, sup, nq, ns, k, k_pad, p.split, p.part_len, warp_bytes, lists,
          out_d, out_i);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_channels(const float* qry, const float* sup, int b, int nq,
                            int ns, int c, int k, int k_pad, const Plan& p,
                            u64* lists, float* out_d, int* out_i,
                            cudaStream_t stream) {
  constexpr int kMaxWarpBytes =
      kChanStage + kQueueBytes + (K == -1 ? kSharedHeap * 256 : 0);
  static const bool once = [] {
    allow_shared(knn_channels_kernel<K>, kWarps * kMaxWarpBytes);
    return true;
  }();
  (void)once;
  const int warp_bytes =
      kChanStage + kQueueBytes + (K == -1 ? k_pad * 256 : 0);
  knn_channels_kernel<K>
      <<<dim3(p.grid_x, b), kWarps * 32, kWarps * warp_bytes, stream>>>(
          qry, sup, nq, ns, c, k, k_pad, p.split, p.part_len, warp_bytes,
          lists, out_d, out_i);
  return cudaGetLastError();
}

// The list a k takes: 4, 8 or 16 keys in registers, else a heap of k_pad
// keys in shared memory (-1) or global scratch (0).
int list_kind(int k, int k_pad) {
  if (k <= 4) return 4;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  return k_pad <= kSharedHeap ? -1 : 0;
}

}  // namespace

// The global scratch ppt_knn needs for B clouds of Nq queries at this k,
// in 64-bit keys, into *keys: B * round_up(Nq, 32 kWarps) * round_up(k, 8)
// when the lists are heaps past kSharedHeap keys, else 0 (no scratch).
extern "C" int ppt_knn_scratch_keys(int b, int nq, int k, long long* keys) {
  if (k < 1 || b < 0 || nq < 0) return cudaErrorInvalidValue;
  const int k_pad = (k + 7) / 8 * 8;
  const long long block = 32 * kWarps;
  *keys = list_kind(k, k_pad) != 0
              ? 0
              : static_cast<long long>(b) * ((nq + block - 1) / block) *
                    block * k_pad;
  return cudaSuccess;
}

// qry: float [B, Nq, C]; sup: float [B, Ns, C]; out_d, out_i: [B, Nq, k],
// 1 <= k <= Ns. lists: the scratch of ppt_knn_scratch_keys's count of
// 64-bit keys where that is not 0, else null.
extern "C" int ppt_knn(const float* qry, const float* sup, int b, int nq,
                       int ns, int c, int k, u64* lists, float* out_d,
                       int* out_i, cudaStream_t stream) {
  if (k < 1 || k > ns || c < 1 || b > 65535) return cudaErrorInvalidValue;
  const int k_pad = (k + 7) / 8 * 8;
  const int kind = list_kind(k, k_pad);
  if ((kind == 0) != (lists != nullptr)) return cudaErrorInvalidValue;
  if (b == 0 || nq == 0) return cudaSuccess;
  // a query's parts need a heap each: global heaps take no split
  const int max_split = kind == 0 ? 1 : kWarps;
  const int list = kind > 0 ? kind : k_pad;
  if (c == 3) {
    const int qmax = kind == 4 ? 4 : 1;
    const Plan p = plan(b, nq, ns, list, qmax, max_split);
#define PPT_XYZ(KK, QQ)                                                     \
  return launch_xyz<KK, QQ>(qry, sup, b, nq, ns, k, k_pad, p, lists, out_d, \
                            out_i, stream)
    switch (kind) {
      case 4:
        if (p.q == 4) PPT_XYZ(4, 4);
        PPT_XYZ(4, 1);
      case 8:
        PPT_XYZ(8, 1);
      case 16:
        PPT_XYZ(16, 1);
      case -1:
        PPT_XYZ(-1, 1);
      default:
        PPT_XYZ(0, 1);
    }
#undef PPT_XYZ
  }
  const Plan p = plan(b, nq, ns, list, 1, max_split);
#define PPT_CHANNELS(KK)                                                   \
  return launch_channels<KK>(qry, sup, b, nq, ns, c, k, k_pad, p, lists,   \
                             out_d, out_i, stream)
  switch (kind) {
    case 4:
      PPT_CHANNELS(4);
    case 8:
      PPT_CHANNELS(8);
    case 16:
      PPT_CHANNELS(16);
    case -1:
      PPT_CHANNELS(-1);
    default:
      PPT_CHANNELS(0);
  }
#undef PPT_CHANNELS
}
