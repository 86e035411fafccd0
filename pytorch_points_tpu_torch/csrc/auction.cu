// Auction assignment between two equal-size clouds (Bertsekas, eps-scaled),
// object -> person owners and object prices.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/auction.py::
// _auction_kernel (called by _auction_owner). The wrapper pads both clouds
// with twin points and reads the phase budgets; the kernel runs the whole
// auction: warm start, phases, iterations, chunks.
//
// Semantics, as the Pallas kernel's:
//  * benefit[i][j] = -(((dx*dx) + dy*dy) + dz*dz), each operation rounded on
//    its own (ppt::sqdist3); nvcc would otherwise contract into FMAs;
//  * warm start: price[j] = max_i benefit[i][j] over the persons of whole
//    chunks (i < (n / ti) * ti, the ones that bid), folded from -1e30;
//  * persons bid in chunks of ti. Every bid of a chunk uses the prices as
//    they stood at the chunk's start (Jacobi); the chunk is resolved before
//    the next one bids (Gauss-Seidel). A person who owns an object at the
//    chunk's start does not bid;
//  * a bid: net = benefit - price; a1 = the lowest index of the max net; v2
//    = the max net over every other index (a tie gives v2 = v1); bid =
//    (benefit[a1] - v2) + eps_k;
//  * per object the highest bid wins, ties to the lowest person index. A
//    packed 64-bit atomicMax on (order-preserving float bits, ~person) in
//    shared memory picks the same winner whatever order the bids land in;
//  * done (every object owned) is tested after a full sweep; owners reset
//    at each phase, prices carry over; phase ph runs at most
//    budgets[hint][ph] sweeps at eps[ph].
//
// Any number of phases: a launch runs up to kMaxPhases of them from a
// schedule passed by value, and a longer schedule chains launches, each
// starting from the prices the one before wrote (price_in). Owners reset at
// every phase anyway, so the chain computes what one launch of all the
// phases would.
//
// What bounds it on the card: the auction's own work, (bidder scans) x N'
// pair evaluations of about 14 instructions each (config 4: ~15,700 scans
// of 2048 objects a cloud), and the latency of each chunk's steps (count
// the bidders, scan, merge, bid, resolve), about 360 chunks a cloud at
// config 4, most with a few tens of bidders. The design:
//  * a cloud is a cluster of cs blocks (cs up to 8, the most whose
//    clusters all fit on the card at once, with slices of at least 256
//    objects; ppt_auction_cluster says which), else one block (more clouds
//    than fit, or the state in scratch). Each block scans a slice
//    of the objects and keeps its own copy of the persons, the owners, the
//    assigned flags and the bid slots; the slices' top-2s of each bidder
//    (with the benefit at a1) go to every block through distributed shared
//    memory, one cluster barrier a chunk (two buffers, alternating), and
//    every block then merges them in rank order and resolves every bid
//    itself, so the copies stay equal without a second barrier;
//  * a warp bids for R = 2 persons at once when a chunk has more bidders
//    than warps, reading each object once (one 16-byte load of qx, qy, qz,
//    price) for both; a chunk with few bidders splits each bidder's slice
//    over S sub-slices on as many warps and merges them in order. The
//    (v1, a1, v2) merge is exact on disjoint index sets, so the bits do not
//    depend on cs or S;
//  * every warp reads the chunk's bidders from ballots of the assigned
//    flags itself (no list pass), a winner clears its bid slot while it
//    resolves, and the resolve barrier counts newly owned objects
//    (__syncthreads_count), which is the done test;
//  * the state (44 bytes an object, plus the top-2 buffers in a cluster) in
//    shared memory, named as such so its accesses compile to shared-memory
//    instructions, up to about 4600 points; above that, one block a cloud
//    with the state in a global scratch buffer. Benefits are recomputed for
//    every bid (no SM holds the TPU's 16 MB benefit cache).
#include <cooperative_groups.h>
#include <limits.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPhases = 8;
constexpr int kR = 2;  // persons a warp bids for at once
constexpr int kWarmCols = 4;  // objects a thread folds at once (warm start)
constexpr int kMaxCluster = 8;
constexpr float kNeg = -1.0e30f;

struct Schedule {
  float eps[kMaxPhases];
  int budgets[2][kMaxPhases];  // [0] default ladder, [1] when the hint holds
  int phases;
};

// Per-cloud state layout; every array is n long (a cluster's block reads
// the coordinates and prices of its slice only), except the chunk's bid
// lists (ti long) and, in a cluster, the slices' top-2s of each bidder
// (2 x cs x ti, alternate chunks alternating buffers).
struct State {
  float4* obj;    // qx, qy, qz, price
  float4* xpart;  // v1, a1 (bits), v2, benefit at a1: [buf][rank][bidder]
  unsigned long long* slot;
  float *px, *py, *pz;
  int *owner, *assigned, *list, *tgt;
  float* bidv;
};

// Rounded up to 16 bytes, so each cloud's slice of a scratch buffer keeps
// the 16-byte alignment of its objects.
__host__ __device__ inline size_t state_bytes(int n, int ti, int cs) {
  const size_t bytes = static_cast<size_t>(n) * (16 + 8 + 3 * 4 + 2 * 4) +
                       static_cast<size_t>(ti) * 12 +
                       (cs > 1 ? static_cast<size_t>(2 * cs) * ti * 16 : 0);
  return (bytes + 15) / 16 * 16;
}

__device__ inline State carve(char* base, int n, int ti, int cs) {
  State s;
  s.obj = reinterpret_cast<float4*>(base);
  s.xpart = s.obj + n;
  s.slot = reinterpret_cast<unsigned long long*>(s.xpart +
                                                 (cs > 1 ? 2 * cs * ti : 0));
  float* f = reinterpret_cast<float*>(s.slot + n);
  s.px = f;
  s.py = f + n;
  s.pz = f + 2 * n;
  s.owner = reinterpret_cast<int*>(f + 3 * n);
  s.assigned = s.owner + n;
  s.list = s.assigned + n;
  s.tgt = s.list + ti;
  s.bidv = reinterpret_cast<float*>(s.tgt + ti);
  return s;
}

// Float bits whose unsigned order is the float order.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long bid_key(float bid, int person) {
  return (static_cast<unsigned long long>(ordered(bid)) << 32) |
         static_cast<unsigned>(0xFFFFFFFFu - static_cast<unsigned>(person));
}

// Merge another (v1, a1, v2) top-2 of a disjoint index set into this one:
// v1 the max, a1 its lowest index, v2 the max over every other index.
// Returns whether the other's a1 won.
__device__ __forceinline__ bool top2_merge(float& v1, int& a1, float& v2,
                                           float ov1, int oa1, float ov2) {
  if (ov1 > v1 || (ov1 == v1 && oa1 < a1)) {
    v2 = fmaxf(ov2, v1);
    v1 = ov1;
    a1 = oa1;
    return true;
  }
  v2 = fmaxf(v2, ov1);
  return false;
}

// The person of bid rank `rank` (the rank-th unassigned person of the chunk
// [c0, c0 + ti), in person order) for each lane that asks (rank >= 0), from
// the warp's own ballots of the assigned flags.
__device__ __forceinline__ int person_of_rank(const State& s, int c0, int ti,
                                              int rank) {
  const int lane = threadIdx.x & 31;
  int person = -1, before = 0;
  for (int o = 0; o < ti; o += 32) {
    const unsigned m = __ballot_sync(
        0xffffffffu, o + lane < ti && !s.assigned[c0 + o + lane]);
    const int here = __popc(m);
    if (rank >= before && rank < before + here)
      person = c0 + o + static_cast<int>(__fns(m, 0, rank - before + 1));
    before += here;
  }
  return person;
}

// A warp's top-2 of net = benefit - price for R persons (coordinates x, y,
// z) over the objects [lo, hi); every lane ends with the warp's result.
template <int R>
__device__ __forceinline__ void scan_slice(const State& s, const float* x,
                                           const float* y, const float* z,
                                           int lo, int hi, float* v1, int* a1,
                                           float* v2) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v1[r] = -INFINITY;
    v2[r] = -INFINITY;
    a1[r] = INT_MAX;
  }
  for (int j = lo + (threadIdx.x & 31); j < hi; j += 32) {
    const float4 o = s.obj[j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float net =
          __fsub_rn(-ppt::sqdist3(x[r], y[r], z[r], o.x, o.y, o.z), o.w);
      // net > v1: v2 takes v1, else the larger of v2 and net (v2 <= v1)
      const bool gt = net > v1[r];
      v2[r] = fmaxf(v2[r], gt ? v1[r] : net);
      v1[r] = gt ? net : v1[r];
      a1[r] = gt ? j : a1[r];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ov1 = __shfl_xor_sync(0xffffffffu, v1[r], off);
      const int oa1 = __shfl_xor_sync(0xffffffffu, a1[r], off);
      const float ov2 = __shfl_xor_sync(0xffffffffu, v2[r], off);
      top2_merge(v1[r], a1[r], v2[r], ov1, oa1, ov2);
    }
  }
}

// This block's objects [lo, hi) and, in a cluster of cs blocks, its rank
// there and the top-2 buffer of the chunk.
struct Slice {
  int lo, hi, rank, cs, buf;
};

// Bidder k (person i at x, y, z) has its top-2 over this block's objects:
// alone, the block places the bid (records it for the resolve in slot k of
// the chunk's lists and posts it to the object); in a cluster, it sends
// the top-2 with the benefit at a1 to every block of the cluster, each of
// which places every bid itself.
template <bool kCluster>
__device__ __forceinline__ void emit(const State& s, const Slice& sl, int ti,
                                     int k, int i, float x, float y, float z,
                                     float v1, int a1, float v2,
                                     float eps_k) {
  const float4 o = s.obj[a1];
  const float b1 = -ppt::sqdist3(x, y, z, o.x, o.y, o.z);
  s.list[k] = i;
  if constexpr (kCluster) {
    const float4 e = make_float4(v1, __int_as_float(a1), v2, b1);
    cg::cluster_group cl = cg::this_cluster();
    for (int c = 0; c < sl.cs; ++c)
      *cl.map_shared_rank(&s.xpart[(sl.buf * sl.cs + sl.rank) * ti + k],
                          c) = e;
  } else {
    const float bid = __fadd_rn(__fsub_rn(b1, v2), eps_k);
    s.tgt[k] = a1;
    s.bidv[k] = bid;
    atomicMax(&s.slot[a1], bid_key(bid, i));
  }
}

// The chunk's bids over this block's objects when R persons share a warp:
// tasks t = (group g of R ranks, sub-slice u of S), t < groups * S, taken
// by warps in turn. With S = 1 each warp emits its bidders' top-2s itself;
// with S > 1 it leaves its sub-slice's in part (entry t * R + r) for the
// merge.
template <int R, bool kCluster>
__device__ __forceinline__ void bid_tasks(const State& s, const Slice& sl,
                                          int c0, int ti, int nbid, int S,
                                          float eps_k, float* part_v1,
                                          int* part_a1, float* part_v2) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tasks = (nbid + R - 1) / R * S;
  const int width = sl.hi - sl.lo;
  constexpr int kPerCall = 32 / R;  // tasks whose ranks one lookup serves
  for (int t0 = warp; t0 < tasks; t0 += kWarps * kPerCall) {
    // lane u * R + r looks up rank r of the warp's u-th task from t0
    const int tl = t0 + (lane / R) * kWarps;
    const int rank = (tl / S) * R + lane % R;
    const int who = person_of_rank(s, c0, ti,
                                   tl < tasks && rank < nbid ? rank : -1);
    for (int u = 0; u < kPerCall; ++u) {
      const int t = t0 + u * kWarps;
      if (t >= tasks) break;
      const int g = t / S, sub = t % S;
      int i[R];
      float x[R], y[R], z[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        i[r] = __shfl_sync(0xffffffffu, who, u * R + r);
        const int pi = i[r] < 0 ? 0 : i[r];
        x[r] = s.px[pi];
        y[r] = s.py[pi];
        z[r] = s.pz[pi];
      }
      float v1[R], v2[R];
      int a1[R];
      const int lo =
          sl.lo + static_cast<int>(static_cast<long long>(sub) * width / S);
      const int hi = sl.lo + static_cast<int>(
                                 static_cast<long long>(sub + 1) * width / S);
      scan_slice<R>(s, x, y, z, lo, hi, v1, a1, v2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (lane == r && i[r] >= 0) {
          if (S == 1) {
            emit<kCluster>(s, sl, ti, g * R + r, i[r], x[r], y[r], z[r],
                           v1[r], a1[r], v2[r], eps_k);
          } else {
            part_v1[t * R + r] = v1[r];
            part_a1[t * R + r] = a1[r];
            part_v2[t * R + r] = v2[r];
            if (sub == 0) s.list[g * R + r] = i[r];
          }
        }
      }
    }
  }
}

// price_in (null, or the prices of the previous launch of a chain: it may
// be out_price itself) replaces the warm start or the zero start. counts:
// null or int [B, 2, total_phases]; this launch writes phases ph0 ...
// kShared: the state in shared memory, named as such, so its accesses
// compile to shared-memory instructions; else in the scratch buffer.
// kCluster: a cloud is a cluster of blocks (state in shared memory), each
// scanning a slice of the objects and keeping a copy of the rest; see the
// notes at the top.
template <bool kShared, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
    auction_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   int n, int ti, Schedule sched,
                   const uint8_t* __restrict__ hint, int warm_start,
                   const float* price_in, int* __restrict__ out_owner,
                   float* out_price, int* __restrict__ counts,
                   int total_phases, int ph0, char* __restrict__ scratch,
                   size_t scratch_stride) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float part_v1[kWarps * kR], part_v2[kWarps * kR];
  __shared__ int part_a1[kWarps * kR];
  Slice sl{0, n, 0, 1, 0};
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    sl.cs = static_cast<int>(cl.num_blocks());
    sl.rank = static_cast<int>(cl.block_rank());
    sl.lo = static_cast<int>(static_cast<long long>(sl.rank) * n / sl.cs);
    sl.hi = static_cast<int>(static_cast<long long>(sl.rank + 1) * n / sl.cs);
  }
  const int b = blockIdx.x / sl.cs;
  const int tid = threadIdx.x;
  char* base = smem;
  if constexpr (!kShared) base = scratch + b * scratch_stride;
  const State s = carve(base, n, ti, sl.cs);
  const float* pb = p + static_cast<size_t>(b) * n * 3;
  const float* qb = q + static_cast<size_t>(b) * n * 3;
  const int chunk_end = (n / ti) * ti;  // persons past it never bid

  for (int j = tid; j < n; j += kThreads) {
    s.px[j] = pb[3 * j];
    s.py[j] = pb[3 * j + 1];
    s.pz[j] = pb[3 * j + 2];
    s.slot[j] = 0ull;  // every block posts bids on every object
  }
  for (int j = sl.lo + tid; j < sl.hi; j += kThreads)
    s.obj[j] = make_float4(qb[3 * j], qb[3 * j + 1], qb[3 * j + 2], 0.f);
  if constexpr (kCluster)
    cg::this_cluster().sync();  // every block runs before any remote store
  else
    __syncthreads();
  if (price_in != nullptr || !warm_start) {
    for (int j = sl.lo + tid; j < sl.hi; j += kThreads)  // read, then written
      s.obj[j].w = price_in ? price_in[static_cast<size_t>(b) * n + j] : 0.f;
  } else {  // each object's max over the persons that bid (those of
            // whole chunks, as the reference folds), kWarmCols at a time
    for (int j0 = sl.lo + tid; j0 < sl.hi; j0 += kWarmCols * kThreads) {
      float x[kWarmCols], y[kWarmCols], z[kWarmCols], pr[kWarmCols];
#pragma unroll
      for (int u = 0; u < kWarmCols; ++u) {
        const int j = min(j0 + u * kThreads, sl.hi - 1);
        x[u] = s.obj[j].x;
        y[u] = s.obj[j].y;
        z[u] = s.obj[j].z;
        pr[u] = kNeg;
      }
      for (int i = 0; i < chunk_end; ++i) {
        const float pix = s.px[i], piy = s.py[i], piz = s.pz[i];
#pragma unroll
        for (int u = 0; u < kWarmCols; ++u)
          pr[u] = fmaxf(pr[u], -ppt::sqdist3(pix, piy, piz, x[u], y[u], z[u]));
      }
#pragma unroll
      for (int u = 0; u < kWarmCols; ++u)
        if (j0 + u * kThreads < sl.hi) s.obj[j0 + u * kThreads].w = pr[u];
    }
  }

  const int ladder = (hint != nullptr && *hint) ? 1 : 0;
  for (int ph = 0; ph < sched.phases; ++ph) {
    const int bound = sched.budgets[ladder][ph];
    const float eps_k = sched.eps[ph];
    for (int j = tid; j < n; j += kThreads) {
      s.owner[j] = -1;
      s.assigned[j] = 0;
    }
    __syncthreads();
    int owned = 0, sweeps = 0, scans = 0;
    for (int it = 0; it < bound && owned < n; ++it) {
      ++sweeps;
      for (int c0 = 0; c0 < chunk_end; c0 += ti) {
        // every warp counts the chunk's bidders from its own ballots
        int nbid = 0;
        for (int o = 0; o < ti; o += 32)
          nbid += __popc(__ballot_sync(
              0xffffffffu,
              o + (tid & 31) < ti && !s.assigned[c0 + o + (tid & 31)]));
        if (nbid == 0) continue;
        scans += nbid;
        const int R = nbid > kWarps ? kR : 1;
        const int groups = (nbid + R - 1) / R;
        const int most = (sl.hi - sl.lo) / 32 < 1 ? 1 : (sl.hi - sl.lo) / 32;
        int S = kWarps / groups;
        S = S < 1 ? 1 : (S > most ? most : S);
        if (R == kR)
          bid_tasks<kR, kCluster>(s, sl, c0, ti, nbid, S, eps_k, part_v1,
                                  part_a1, part_v2);
        else
          bid_tasks<1, kCluster>(s, sl, c0, ti, nbid, S, eps_k, part_v1,
                                 part_a1, part_v2);
        if (S > 1) {  // merge each bidder's sub-slices, in order
          __syncthreads();
          for (int k = tid; k < nbid; k += kThreads) {
            const int g = k / R, r = k % R;
            int e = (g * S) * R + r;
            float v1 = part_v1[e], v2 = part_v2[e];
            int a1 = part_a1[e];
            for (int u = 1; u < S; ++u) {
              e = (g * S + u) * R + r;
              top2_merge(v1, a1, v2, part_v1[e], part_a1[e], part_v2[e]);
            }
            const int i = s.list[k];
            emit<kCluster>(s, sl, ti, k, i, s.px[i], s.py[i], s.pz[i], v1,
                           a1, v2, eps_k);
          }
        }
        if constexpr (kCluster) {
          // every block has every bidder's top-2 of every slice: merge
          // them in rank order and post every bid (each block resolves
          // all of them, so owners and assigned flags stay equal)
          cg::this_cluster().sync();
          const float4* xp = s.xpart + sl.buf * sl.cs * ti;
          for (int k = tid; k < nbid; k += kThreads) {
            float4 e = xp[k];
            float v1 = e.x, v2 = e.z, b1 = e.w;
            int a1 = __float_as_int(e.y);
            for (int c = 1; c < sl.cs; ++c) {
              e = xp[c * ti + k];
              if (top2_merge(v1, a1, v2, e.x, __float_as_int(e.y), e.z))
                b1 = e.w;
            }
            const float bid = __fadd_rn(__fsub_rn(b1, v2), eps_k);
            s.tgt[k] = a1;
            s.bidv[k] = bid;
            atomicMax(&s.slot[a1], bid_key(bid, s.list[k]));
          }
          sl.buf ^= 1;
        }
        __syncthreads();
        // resolve: the highest bid on each object wins; the winner clears
        // the slot (a loser then reads 0, which is not its key either)
        for (int k0 = 0; k0 < nbid; k0 += kThreads) {
          const int k = k0 + tid;
          bool fresh = false;
          if (k < nbid) {
            const int j = s.tgt[k], i = s.list[k];
            const unsigned long long key = bid_key(s.bidv[k], i);
            if (s.slot[j] == key) {
              s.slot[j] = 0ull;
              const int old = s.owner[j];
              if (old >= 0) s.assigned[old] = 0;  // owned at the chunk's start
              fresh = old < 0;
              s.owner[j] = i;
              s.obj[j].w = s.bidv[k];
              s.assigned[i] = 1;
            }
          }
          owned += __syncthreads_count(fresh);
        }
      }
    }
    if (counts != nullptr && tid == 0 && sl.rank == 0) {
      const size_t row = static_cast<size_t>(b) * 2 * total_phases;
      counts[row + ph0 + ph] = scans;
      counts[row + total_phases + ph0 + ph] = sweeps;
    }
  }
  __syncthreads();
  for (int j = sl.lo + tid; j < sl.hi; j += kThreads) {
    out_owner[static_cast<size_t>(b) * n + j] = s.owner[j];
    out_price[static_cast<size_t>(b) * n + j] = s.obj[j].w;
  }
  if constexpr (kCluster) cg::this_cluster().sync();  // no block leaves early
}

// Blocks a cloud's cluster takes: the most, up to 8, whose clusters all
// fit on device dev at once (b x cs blocks, at most one a SM) with slices
// of at least 256 objects; 1 (no cluster) otherwise. A size the runtime
// refuses leaves no error behind.
int query_cluster_size(int dev, int b, int n, int ti) {
  auto* kernel = auction_kernel<true, true>;
  int sms = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  // the dynamic shared memory a block may opt into beside the static arrays
  const size_t limit = static_cast<size_t>(optin) > fa.sharedSizeBytes
                           ? static_cast<size_t>(optin) - fa.sharedSizeBytes
                           : 0;
  for (int cs = kMaxCluster; cs >= 2; --cs) {
    const size_t smem = state_bytes(n, ti, cs);
    if (n / cs < 256 || b * cs > sms || smem > limit) continue;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(b * cs);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (clusters >= b) return cs;
  }
  return 1;
}

// query_cluster_size on the current device, asked once a (device, b, n,
// ti): a train step then pays no occupancy queries.
int cluster_size(int b, int n, int ti) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int>, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  const auto key = std::make_tuple(dev, b, n, ti);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) return it->second;
  }
  const int cs = query_cluster_size(dev, b, n, ti);
  std::lock_guard<std::mutex> lock(mu);
  known.emplace(key, cs);
  return cs;
}

}  // namespace

// Blocks a cloud's cluster takes for b clouds of n points (1: no cluster).
extern "C" int ppt_auction_cluster(int b, int n, int ti) {
  return cluster_size(b, n, ti);
}

// Bytes of one cloud's state (one block a cloud); the wrapper passes a
// scratch buffer of b * this many bytes when it is above its shared-memory
// budget.
extern "C" int ppt_auction_state_bytes(int n, int ti) {
  return static_cast<int>(state_bytes(n, ti, 1));
}

// p, q: float [B, N, 3] (padded); eps: host float [phases]; budgets: host
// int [2, phases]; hint: device bool scalar or null (default ladder).
// out_owner: int [B, N]; out_price: float [B, N]; counts: null or int
// [B, 2, phases] (bidder scans, then sweeps, a phase). scratch: null (state
// in shared memory) or b * scratch_stride bytes. cluster: blocks a cloud
// (0: the most that fit, see cluster_size; 1: one block). Any phases >= 1:
// one launch per kMaxPhases of them, each after the first starting from
// the prices the one before wrote.
extern "C" int ppt_auction(const float* p, const float* q, int b, int n,
                           int ti, int phases, const float* eps,
                           const int* budgets, const uint8_t* hint,
                           int warm_start, int* out_owner, float* out_price,
                           int* counts, int cluster, char* scratch,
                           int scratch_stride, cudaStream_t stream) {
  if (phases < 1 || ti < 1 || ti > n) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  int cs = 1;
  if (scratch == nullptr && cluster != 1) {
    cs = cluster_size(b, n, ti);
    if (cluster > 1 && cluster < cs) cs = cluster;
  }
  const size_t smem = scratch ? 0 : state_bytes(n, ti, cs);
  auto* kernel = scratch ? auction_kernel<false, false>
                         : (cs > 1 ? auction_kernel<true, true>
                                   : auction_kernel<true, false>);
  // set on every launch: cluster_size may have left a smaller limit, asked
  // for another shape
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  for (int ph0 = 0; ph0 < phases; ph0 += kMaxPhases) {
    Schedule sched;
    sched.phases = phases - ph0 < kMaxPhases ? phases - ph0 : kMaxPhases;
    for (int ph = 0; ph < sched.phases; ++ph) {
      sched.eps[ph] = eps[ph0 + ph];
      sched.budgets[0][ph] = budgets[ph0 + ph];
      sched.budgets[1][ph] = budgets[phases + ph0 + ph];
    }
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, p, q, n, ti, sched, hint, warm_start,
        ph0 == 0 ? nullptr : static_cast<const float*>(out_price), out_owner,
        out_price, counts, phases, ph0, scratch,
        static_cast<size_t>(scratch_stride));
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}
