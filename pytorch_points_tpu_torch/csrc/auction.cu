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
//  * warm start: price[j] = max_i benefit[i][j], folded from -1e30;
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
// On the card: one block per cloud, the cloud's state (coordinates,
// prices, owners, assigned flags, the bid slots: 44 bytes an object) in
// shared memory up to about 5000 points, in a global scratch buffer above.
// Benefits are recomputed for every bid (no SM holds the TPU's 16 MB
// benefit cache). Only unassigned persons are scanned, one warp each over
// all N objects, so a sweep costs (bidders x N) pair evaluations of about
// 12 instructions: the first sweeps of a phase are bound by that
// arithmetic, the later ones (a few bidders, most warps idle) by the four
// block barriers of each chunk. With B blocks only B of the 132 SMs work.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPhases = 8;
constexpr float kNeg = -1.0e30f;

struct Schedule {
  float eps[kMaxPhases];
  int budgets[2][kMaxPhases];  // [0] default ladder, [1] when the hint holds
  int phases;
};

// Per-cloud state layout; every array is n long except the chunk's bid
// lists (ti long).
struct State {
  unsigned long long* slot;
  float *qx, *qy, *qz, *px, *py, *pz, *price;
  int *owner, *assigned, *list, *tgt;
  float* bidv;
};

// Rounded up to 16 bytes, so each cloud's slice of a scratch buffer keeps
// the 8-byte alignment of its slots.
__host__ __device__ inline size_t state_bytes(int n, int ti) {
  const size_t bytes = static_cast<size_t>(n) * (8 + 7 * 4 + 2 * 4) +
                       static_cast<size_t>(ti) * 12;
  return (bytes + 15) / 16 * 16;
}

__device__ inline State carve(char* base, int n, int ti) {
  State s;
  s.slot = reinterpret_cast<unsigned long long*>(base);
  float* f = reinterpret_cast<float*>(s.slot + n);
  s.qx = f;
  s.qy = f + n;
  s.qz = f + 2 * n;
  s.px = f + 3 * n;
  s.py = f + 4 * n;
  s.pz = f + 5 * n;
  s.price = f + 6 * n;
  s.owner = reinterpret_cast<int*>(f + 7 * n);
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
__device__ __forceinline__ void top2_merge(float& v1, int& a1, float& v2,
                                           float ov1, int oa1, float ov2) {
  if (ov1 > v1 || (ov1 == v1 && oa1 < a1)) {
    v2 = fmaxf(ov2, v1);
    v1 = ov1;
    a1 = oa1;
  } else {
    v2 = fmaxf(v2, ov1);
  }
}

// price_in (null, or the prices of the previous launch of a chain: it may
// be out_price itself) replaces the warm start or the zero start.
__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   int n, int ti, Schedule sched,
                   const uint8_t* __restrict__ hint, int warm_start,
                   const float* price_in, int* __restrict__ out_owner,
                   float* out_price, char* __restrict__ scratch,
                   size_t scratch_stride) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_nbid;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const State s = carve(scratch ? scratch + b * scratch_stride : smem, n, ti);
  const float* pb = p + static_cast<size_t>(b) * n * 3;
  const float* qb = q + static_cast<size_t>(b) * n * 3;

  for (int j = tid; j < n; j += kThreads) {
    s.qx[j] = qb[3 * j];
    s.qy[j] = qb[3 * j + 1];
    s.qz[j] = qb[3 * j + 2];
    s.px[j] = pb[3 * j];
    s.py[j] = pb[3 * j + 1];
    s.pz[j] = pb[3 * j + 2];
    s.slot[j] = 0ull;
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    float pr = 0.f;
    if (price_in != nullptr) {
      pr = price_in[static_cast<size_t>(b) * n + j];  // read before written
    } else if (warm_start) {
      pr = kNeg;
      const float x = s.qx[j], y = s.qy[j], z = s.qz[j];
      for (int i = 0; i < n; ++i)
        pr = fmaxf(pr, -ppt::sqdist3(s.px[i], s.py[i], s.pz[i], x, y, z));
    }
    s.price[j] = pr;
  }

  const int ladder = (hint != nullptr && *hint) ? 1 : 0;
  const int chunk_end = (n / ti) * ti;
  for (int ph = 0; ph < sched.phases; ++ph) {
    const int bound = sched.budgets[ladder][ph];
    const float eps_k = sched.eps[ph];
    for (int j = tid; j < n; j += kThreads) {
      s.owner[j] = -1;
      s.assigned[j] = 0;
    }
    __syncthreads();
    bool done = false;
    for (int it = 0; it < bound && !done; ++it) {
      for (int c0 = 0; c0 < chunk_end; c0 += ti) {
        // the chunk's bidders, in person order
        if (warp == 0) {
          int cnt = 0;
          for (int o = 0; o < ti; o += 32) {
            const int i = c0 + o + lane;
            const bool bids = o + lane < ti && !s.assigned[i];
            const unsigned m = __ballot_sync(0xffffffffu, bids);
            if (bids) s.list[cnt + __popc(m & ((1u << lane) - 1u))] = i;
            cnt += __popc(m);
          }
          if (lane == 0) s_nbid = cnt;
        }
        __syncthreads();
        const int nbid = s_nbid;
        for (int k = warp; k < nbid; k += kWarps) {
          const int i = s.list[k];
          const float x = s.px[i], y = s.py[i], z = s.pz[i];
          float v1 = -INFINITY, v2 = -INFINITY;
          int a1 = INT_MAX;
          for (int j = lane; j < n; j += 32) {
            const float net = __fsub_rn(
                -ppt::sqdist3(x, y, z, s.qx[j], s.qy[j], s.qz[j]), s.price[j]);
            if (net > v1) {
              v2 = v1;
              v1 = net;
              a1 = j;
            } else if (net > v2) {
              v2 = net;
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
            const int oa1 = __shfl_xor_sync(0xffffffffu, a1, off);
            const float ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
            top2_merge(v1, a1, v2, ov1, oa1, ov2);
          }
          if (lane == 0) {
            const float b1 = -ppt::sqdist3(x, y, z, s.qx[a1], s.qy[a1], s.qz[a1]);
            const float bid = __fadd_rn(__fsub_rn(b1, v2), eps_k);
            s.tgt[k] = a1;
            s.bidv[k] = bid;
            atomicMax(&s.slot[a1], bid_key(bid, i));
          }
        }
        __syncthreads();
        for (int k = tid; k < nbid; k += kThreads) {
          const int j = s.tgt[k], i = s.list[k];
          if (s.slot[j] == bid_key(s.bidv[k], i)) {
            const int old = s.owner[j];
            if (old >= 0) s.assigned[old] = 0;  // owned at the chunk's start
            s.owner[j] = i;
            s.price[j] = s.bidv[k];
            s.assigned[i] = 1;
          }
        }
        __syncthreads();
        for (int k = tid; k < nbid; k += kThreads) s.slot[s.tgt[k]] = 0ull;
        __syncthreads();
      }
      bool mine = true;
      for (int j = tid; j < n; j += kThreads) mine = mine && s.owner[j] >= 0;
      done = __syncthreads_and(mine);
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    out_owner[static_cast<size_t>(b) * n + j] = s.owner[j];
    out_price[static_cast<size_t>(b) * n + j] = s.price[j];
  }
}

}  // namespace

// Bytes of one cloud's state; the wrapper passes a scratch buffer of
// b * this many bytes when it is above its shared-memory budget.
extern "C" int ppt_auction_state_bytes(int n, int ti) {
  return static_cast<int>(state_bytes(n, ti));
}

// p, q: float [B, N, 3] (padded); eps: host float [phases]; budgets: host
// int [2, phases]; hint: device bool scalar or null (default ladder).
// out_owner: int [B, N]; out_price: float [B, N]. scratch: null (state in
// shared memory) or b * scratch_stride bytes. Any phases >= 1: one launch
// per kMaxPhases of them, each after the first starting from the prices
// the one before wrote.
extern "C" int ppt_auction(const float* p, const float* q, int b, int n,
                           int ti, int phases, const float* eps,
                           const int* budgets, const uint8_t* hint,
                           int warm_start, int* out_owner, float* out_price,
                           char* scratch, int scratch_stride,
                           cudaStream_t stream) {
  if (phases < 1 || ti < 1 || ti > n) return cudaErrorInvalidValue;
  if (b == 0 || n == 0) return cudaSuccess;
  const size_t smem = scratch ? 0 : state_bytes(n, ti);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  for (int ph0 = 0; ph0 < phases; ph0 += kMaxPhases) {
    Schedule sched;
    sched.phases = phases - ph0 < kMaxPhases ? phases - ph0 : kMaxPhases;
    for (int ph = 0; ph < sched.phases; ++ph) {
      sched.eps[ph] = eps[ph0 + ph];
      sched.budgets[0][ph] = budgets[ph0 + ph];
      sched.budgets[1][ph] = budgets[phases + ph0 + ph];
    }
    auction_kernel<<<b, kThreads, smem, stream>>>(
        p, q, n, ti, sched, hint, warm_start, ph0 == 0 ? nullptr : out_price,
        out_owner, out_price, scratch, static_cast<size_t>(scratch_stride));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
