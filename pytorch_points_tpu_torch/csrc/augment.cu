// JV shortest-augmenting-path endgame for the auction's stragglers: every
// person the auction left without an object gets one, along a shortest
// path in the net-cost graph, and the prices move by the Dijkstra duals.
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/auction.py::
// _augment_kernel (called by _residual_rounds). The TPU ran every cloud in
// lock-step on [B, N] planes; clouds are independent, so here each cloud is
// one block, and the reference's rounds of at most 256 stragglers are one
// pass over the stragglers in ascending person index (augmenting never
// unassigns anyone), at most `cap` of them.
//
// Semantics, as the Pallas kernel's, with every operation rounded on its own:
//  * net cost row of person i: (qn[j] - 2*dot) + psq, with qn = qsq + price
//    taken at the straggler's start, dot = (px*qx + py*qy) + pz*qz, psq
//    and qsq summed the same way;
//  * a pop takes the lowest index of the min over columns, scanned columns
//    counting as 1e30; a popped free column ends the search, any other is
//    scanned and relaxes the unscanned columns through its owner's row with
//    base = (d* - row[j*]) + eps and a strict <;
//  * after pop_cap pops without a free column, the free column of least
//    dist (lowest index) ends the path;
//  * scanned columns' prices rise by max(d* - dist, 0); then the path from
//    the end back to the straggler flips.
//
// What bounds it on the card: a chain of pops, each depending on the one
// before (config 4: up to ~13,500 on a cloud), so the latency of one pop,
// not bytes or flops (a pop relaxes N' columns at 8 flops each). A pop is
// one block barrier and a block-wide argmin after N' / T column relaxes
// on each thread: at N' = 2048 the barrier and argmin alone take ~350
// cycles on 512 threads, and the relax about as much again. The design:
//  * a thread's 4 columns (column k of thread t is j = t + k * T, T the
//    least power of two from 32 with 4 T >= N'; 512 threads at N' = 2048,
//    where 128 and 256 threads of 16 and 8 columns were measured slower)
//    keep dist and qx, qy, qz, qn in registers, so a relax reads no
//    shared memory but the popped column's owner row (a broadcast).
//    Shared memory keeps what is read by index or once a straggler:
//    owner, the owner's coordinates and psq by column
//    (so a pop reads them in one step), pred (written only where a relax
//    improves), price, a copy of qx, qy, qz and the straggler's qn for the
//    j* lookup, and the straggler list;
//  * a scanned column's dist is NaN (below), so the relax tests nothing
//    for it and a thread's min is one fminf a column; only the lanes that
//    hold their warp's least value (a __reduce_min_sync over
//    order-preserving float bits, -0 folded into +0) look for its lowest
//    index;
//  * one block barrier a pop: lane w of every warp reads warp w's partial
//    after it and reduces again (the partials double-buffered, so the next
//    pop's writes need no barrier);
//  * one block a cloud. A cluster barrier with a distributed-shared-memory
//    exchange was measured at ~990-1010 cycles a round on 2-4 blocks of
//    128 threads, more than a whole pop takes on one block, so a cloud is
//    not split.
// Past 4096 columns (4 a thread on 1024 threads) a thread's columns stay in
// the state arrays (C = 0), which then pass the shared-memory budget and
// live in a global scratch buffer. With B blocks only B of the 132 SMs
// work.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRegCols = 4;  // columns a thread keeps in registers
constexpr float kInf = 1.0e30f;

// Per-cloud state. qrow[j] = (qx, qy, qz, qn) of column j, qn the
// straggler's; orow[j] = (px, py, pz, psq) of the person owning column j
// (kept along with owner, so a pop reads its owner row in one step); price,
// owner, pred, list. With the columns in memory (C = 0) also dist and
// sdist (a scanned column's dist when it was scanned).
struct State {
  float4 *qrow, *orow;
  float *price, *dist, *sdist;
  int *owner, *pred, *list;
};

__host__ __device__ inline size_t state_bytes(int n, bool columns_in_memory) {
  return static_cast<size_t>(n) * (columns_in_memory ? 56 : 48);
}

__device__ inline State carve(char* base, int n, bool columns_in_memory) {
  State s;
  s.qrow = reinterpret_cast<float4*>(base);
  s.orow = s.qrow + n;
  s.price = reinterpret_cast<float*>(s.orow + n);
  s.owner = reinterpret_cast<int*>(s.price + n);
  s.pred = s.owner + n;
  s.list = s.pred + n;
  s.dist = s.sdist = nullptr;
  if (columns_in_memory) {
    s.dist = reinterpret_cast<float*>(s.list + n);
    s.sdist = s.dist + n;
  }
  return s;
}

__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Net cost c[i][j] + price[j] in the reference's dot form: o = (px, py,
// pz, psq) of person i, q = (qx, qy, qz, qn) of column j.
__device__ __forceinline__ float net_cost(float4 o, float qx, float qy,
                                          float qz, float qn) {
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(o.x, qx), __fmul_rn(o.y, qy)), __fmul_rn(o.z, qz));
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, dot)), o.w);
}

// A scanned column's dist reads NaN during its straggler's search: a
// relax (cand < NaN) never touches it and a min (fminf) never takes it, so
// the pops test nothing for it; its dist at the scan stays in sdist for
// the price update. A free column ends a search, so it is never scanned,
// and one with a finite dist always exists: no pop takes the 1e30 that
// the reference gives a scanned column.

// A thread's columns j = tid + k * T, k < C, in registers. Loops over k are
// unrolled, so every array index is a constant. Columns past n hold NaN
// from the start.
template <int C>
struct RegCols {
  float dist_[C], sdist_[C], qx_[C], qy_[C], qz_[C], qn_[C];
  __device__ __forceinline__ RegCols(const State&, int tid, int nt, int n) {
#pragma unroll
    for (int k = 0; k < C; ++k) dist_[k] = tid + k * nt < n ? 0.f : NAN;
  }
  __device__ __forceinline__ float& dist(int k) { return dist_[k]; }
  __device__ __forceinline__ float& sdist(int k) { return sdist_[k]; }
  __device__ __forceinline__ float& qx(int k) { return qx_[k]; }
  __device__ __forceinline__ float& qy(int k) { return qy_[k]; }
  __device__ __forceinline__ float& qz(int k) { return qz_[k]; }
  __device__ __forceinline__ float& qn(int k) { return qn_[k]; }
  __device__ __forceinline__ void scan(int k) {
#pragma unroll
    for (int kk = 0; kk < C; ++kk)
      if (kk == k) {
        sdist_[kk] = dist_[kk];
        dist_[kk] = NAN;
      }
  }
};

// The same columns kept in the state arrays (clouds past the register
// instances), ceil((n - tid) / T) of them a thread.
struct MemCols {
  const State* s;
  int tid, threads;
  __device__ __forceinline__ MemCols(const State& st, int t, int nt, int)
      : s(&st), tid(t), threads(nt) {}
  __device__ __forceinline__ int at(int k) const { return tid + k * threads; }
  __device__ __forceinline__ float& dist(int k) { return s->dist[at(k)]; }
  __device__ __forceinline__ float& sdist(int k) { return s->sdist[at(k)]; }
  __device__ __forceinline__ float& qx(int k) { return s->qrow[at(k)].x; }
  __device__ __forceinline__ float& qy(int k) { return s->qrow[at(k)].y; }
  __device__ __forceinline__ float& qz(int k) { return s->qrow[at(k)].z; }
  __device__ __forceinline__ float& qn(int k) { return s->qrow[at(k)].w; }
  __device__ __forceinline__ void scan(int k) {
    s->sdist[at(k)] = s->dist[at(k)];
    s->dist[at(k)] = NAN;
  }
};

// Float bits whose unsigned order is the float order, -0 folded into +0
// (argmin calls them equal and takes the lower index).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// (key, index) minimum over the warp; every lane gets it.
__device__ __forceinline__ void warp_argmin(unsigned& key, unsigned& idx) {
  const unsigned k = __reduce_min_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == k ? idx : UINT_MAX);
  key = k;
}

// Block-wide (min value, lowest index) from each warp's (key, idx); every
// thread gets it. One barrier: the partials alternate between two buffers,
// so a buffer is written again only after the next call's barrier.
__device__ __forceinline__ void block_finish(unsigned key, unsigned idx,
                                             float& d, int& jj,
                                             uint2 (*part)[kMaxWarps],
                                             int& buf, int warps) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[buf][threadIdx.x >> 5] = make_uint2(key, idx);
  __syncthreads();
  const uint2 w = lane < warps ? part[buf][lane]
                               : make_uint2(UINT_MAX, UINT_MAX);
  key = w.x;
  idx = w.y;
  warp_argmin(key, idx);
  d = unordered(key);
  jj = static_cast<int>(idx);
  buf ^= 1;
}

// The same from each thread's (v, j).
__device__ __forceinline__ void block_argmin(float v, int j, float& d,
                                             int& jj, uint2 (*part)[kMaxWarps],
                                             int& buf, int warps) {
  unsigned key = ordered(v), idx = static_cast<unsigned>(j);
  warp_argmin(key, idx);
  block_finish(key, idx, d, jj, part, buf, warps);
}

// C = kRegCols: RegCols<C>, the state in shared memory; C == 0: MemCols,
// the state in the scratch buffer. The register instance names shared
// memory itself, so its state accesses compile to shared-memory
// instructions. T = blockDim.x = 1 << log_t.
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
    augment_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   const int* __restrict__ owner_in,
                   const float* __restrict__ price_in, int n, int log_t,
                   float eps, int pop_cap, int cap, int* __restrict__ out_owner,
                   float* __restrict__ out_price, int* __restrict__ counts,
                   char* __restrict__ scratch, size_t scratch_stride) {
  using Cols = typename std::conditional<(C > 0), RegCols<(C > 0 ? C : 1)>,
                                         MemCols>::type;
  extern __shared__ __align__(16) char smem[];
  __shared__ uint2 part[2][kMaxWarps];
  __shared__ int s_count;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = 1 << log_t;
  const int warps = nt >> 5;
  const int lane = tid & 31;
  const int cols = C > 0 ? C : (n - tid + nt - 1) >> log_t;
  char* base = smem;
  if constexpr (C == 0) base = scratch + b * scratch_stride;
  const State s = carve(base, n, C == 0);
  Cols c(s, tid, nt, n);
  const size_t row0 = static_cast<size_t>(b) * n;
  const float* pb = p + row0 * 3;
  const float* qb = q + row0 * 3;

  for (int j = tid; j < n; j += nt) {
    const int own = owner_in[row0 + j];
    s.owner[j] = own;
    s.price[j] = price_in[row0 + j];
    s.pred[j] = 0;  // here: "person j holds an object"
    if (own >= 0) {
      const float x = pb[3 * own], y = pb[3 * own + 1], z = pb[3 * own + 2];
      s.orow[j] = make_float4(x, y, z, sumsq3(x, y, z));
    }
  }
#pragma unroll
  for (int k = 0; k < cols; ++k) {
    const int j = tid + k * nt;
    if (j < n) {
      c.qx(k) = qb[3 * j];
      c.qy(k) = qb[3 * j + 1];
      c.qz(k) = qb[3 * j + 2];
    }
  }
  __syncthreads();
  for (int j = tid; j < n; j += nt)
    if (s.owner[j] >= 0) s.pred[s.owner[j]] = 1;
  __syncthreads();
  if (tid < 32) {  // stragglers, in ascending person index
    int cnt = 0;
    for (int o = 0; o < n; o += 32) {
      const bool un = o + lane < n && !s.pred[o + lane];
      const unsigned m = __ballot_sync(0xffffffffu, un);
      const int at = cnt + __popc(m & ((1u << lane) - 1u));
      if (un && at < cap) s.list[at] = o + lane;
      cnt += __popc(m);
    }
    if (lane == 0) s_count = min(cnt, cap);
  }
  __syncthreads();
  const int count = s_count;
  int buf = 0, pops = 0, capped_count = 0;

  for (int st = 0; st < count; ++st) {
    const int i0 = s.list[st];
    const float x0 = pb[3 * i0], y0 = pb[3 * i0 + 1], z0 = pb[3 * i0 + 2];
    const float4 o0 = make_float4(x0, y0, z0, sumsq3(x0, y0, z0));
    float d, best = INFINITY;
    int jj, bj = INT_MAX;
#pragma unroll
    for (int k = 0; k < cols; ++k) {
      const int j = tid + k * nt;
      if (j < n) {
        const float qx = c.qx(k), qy = c.qy(k), qz = c.qz(k);
        const float qn = __fadd_rn(sumsq3(qx, qy, qz), s.price[j]);
        c.qn(k) = qn;
        if (C > 0) s.qrow[j] = make_float4(qx, qy, qz, qn);
        const float dj = net_cost(o0, qx, qy, qz, qn);
        c.dist(k) = dj;
        s.pred[j] = -1;
        if (dj < best) {
          best = dj;
          bj = j;
        }
      }
    }
    block_argmin(best, bj, d, jj, part, buf, warps);

    int jstar = 0;
    float dstar = 0.f;
    bool capped = false;
    for (int taken = 0;;) {
      if (taken >= pop_cap) {
        capped = true;
        break;
      }
      ++taken;
      ++pops;
      jstar = min(jj, n - 1);
      dstar = d;
      const int own = s.owner[jstar];
      const float4 o = s.orow[jstar];
      const float4 qr = s.qrow[jstar];
      if (own < 0) break;  // a free column: the path ends here
      if ((jstar & (nt - 1)) == tid) c.scan(jstar >> log_t);
      const float base =
          __fadd_rn(__fsub_rn(dstar, net_cost(o, qr.x, qr.y, qr.z, qr.w)),
                    eps);
      best = INFINITY;
#pragma unroll
      for (int k = 0; k < cols; ++k) {
        const float cand =
            __fadd_rn(base, net_cost(o, c.qx(k), c.qy(k), c.qz(k), c.qn(k)));
        if (cand < c.dist(k)) {
          c.dist(k) = cand;
          s.pred[tid + k * nt] = jstar;
        }
        best = fminf(best, c.dist(k));
      }
      // the warp's least value first; only the lanes holding it look for
      // its lowest index among their columns
      const unsigned key = __reduce_min_sync(0xffffffffu, ordered(best));
      unsigned idx = UINT_MAX;
      if (ordered(best) == key) {
#pragma unroll
        for (int k = 0; k < cols; ++k)
          if (idx == UINT_MAX && c.dist(k) == best) idx = tid + k * nt;
      }
      block_finish(key, __reduce_min_sync(0xffffffffu, idx), d, jj, part,
                   buf, warps);
    }
    if (capped) {  // the nearest free column reached so far
      ++capped_count;
      best = INFINITY;
      bj = INT_MAX;
#pragma unroll
      for (int k = 0; k < cols; ++k) {
        const int j = tid + k * nt;
        if (j < n) {
          const float v = s.owner[j] < 0 ? c.dist(k) : kInf;
          if (v < best) {
            best = v;
            bj = j;
          }
        }
      }
      block_argmin(best, bj, d, jj, part, buf, warps);
      jstar = min(jj, n - 1);
      dstar = d;
    }
#pragma unroll
    for (int k = 0; k < cols; ++k) {
      const int j = tid + k * nt;
      if (j < n && isnan(c.dist(k))) {  // scanned
        const float x = __fsub_rn(dstar, c.sdist(k));
        s.price[j] = __fadd_rn(s.price[j], x > 0.f ? x : 0.f);
      }
    }
    __syncthreads();  // every pred written
    if (tid == 0) {  // flip the path back to the straggler
      for (int jc = jstar;;) {
        const int pj = s.pred[jc];
        if (pj < 0) {
          s.owner[jc] = i0;
          s.orow[jc] = o0;
          break;
        }
        s.owner[jc] = s.owner[pj];
        s.orow[jc] = s.orow[pj];
        jc = pj;
      }
    }
    __syncthreads();  // the flip read pred, which the next straggler resets
  }
  for (int j = tid; j < n; j += nt) {
    out_owner[row0 + j] = s.owner[j];
    out_price[row0 + j] = s.price[j];
  }
  if (counts != nullptr && tid == 0) {
    counts[2 * b] = pops;
    counts[2 * b + 1] = capped_count;
  }
}

// The least time of one pop: a block argmin (one barrier) whose input
// depends on the one before, `iters` times; writes the clock64 cycles and
// the %globaltimer nanoseconds of the loop, as thread 0 read them.
__global__ void __launch_bounds__(kMaxThreads)
    pop_floor_kernel(int iters, long long* out) {
  __shared__ uint2 part[2][kMaxWarps];
  const int warps = blockDim.x >> 5;
  int buf = 0, jj = 0;
  float d = 0.f;
  __syncthreads();
  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int it = 0; it < iters; ++it) {
    const unsigned h = (threadIdx.x * 2654435761u) ^ static_cast<unsigned>(jj);
    block_argmin(static_cast<float>(h & 0xffffu), threadIdx.x, d, jj, part,
                 buf, warps);
  }
  const long long c1 = clock64();
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = jj + static_cast<long long>(d);  // keeps the loop live
  }
}

// Block for n columns: 4 a thread, on the least power of two of threads
// from 32 that covers them, up to 1024 (N' <= 4096); past that 1024
// threads over the state arrays.
int block_threads(int n) {
  const int want = (n + kRegCols - 1) / kRegCols;
  int t = 32;
  while (t < want && t < kMaxThreads) t *= 2;
  return t;
}

bool columns_in_registers(int n) { return n <= kRegCols * kMaxThreads; }

template <int C>
cudaError_t launch(int b, int threads, size_t smem, cudaStream_t stream,
                   const float* p, const float* q, const int* owner_in,
                   const float* price_in, int n, float eps, int pop_cap,
                   int cap, int* out_owner, float* out_price, int* counts,
                   char* scratch, int scratch_stride) {
  if (smem > 32 * 1024) {  // past the default 48 KB with the static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        augment_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int log_t = 0;
  while ((1 << log_t) < threads) ++log_t;
  augment_kernel<C><<<b, threads, smem, stream>>>(
      p, q, owner_in, price_in, n, log_t, eps, pop_cap, cap, out_owner,
      out_price, counts, scratch, static_cast<size_t>(scratch_stride));
  return cudaGetLastError();
}

}  // namespace

// Bytes of one cloud's state; the wrapper passes a scratch buffer of b *
// this many bytes when it is above its shared-memory budget (N' > 4096).
extern "C" int ppt_augment_state_bytes(int n) {
  return static_cast<int>(state_bytes(n, !columns_in_registers(n)));
}

// p, q: float [B, N, 3] (padded); owner_in: int [B, N] object -> person
// (-1 = free); price_in: float [B, N]. out_owner, out_price: the same after
// the endgame. counts: null or int [B, 2] (pops, capped stragglers a
// cloud). scratch: null (state in shared memory, N' <= 4096) or b *
// scratch_stride bytes (the columns then stay in the state arrays).
extern "C" int ppt_augment(const float* p, const float* q,
                           const int* owner_in, const float* price_in, int b,
                           int n, float eps, int pop_cap, int cap,
                           int* out_owner, float* out_price, int* counts,
                           char* scratch, int scratch_stride,
                           cudaStream_t stream) {
  if (b == 0 || n == 0) return cudaSuccess;
  const int t = block_threads(n);
  if (scratch != nullptr)
    return launch<0>(b, t, 0, stream, p, q, owner_in, price_in, n, eps,
                     pop_cap, cap, out_owner, out_price, counts, scratch,
                     scratch_stride);
  if (!columns_in_registers(n)) return cudaErrorInvalidValue;
  return launch<kRegCols>(b, t, state_bytes(n, false), stream, p, q,
                          owner_in, price_in, n, eps, pop_cap, cap,
                          out_owner, out_price, counts, nullptr, 0);
}

// Times the floor of one pop on K12's own block for n columns: out
// (device, 3 int64): clock64 cycles and globaltimer ns over `iters` rounds.
extern "C" int ppt_augment_pop_floor(int n, int iters, long long* out,
                                     cudaStream_t stream) {
  if (n < 1 || iters < 1) return cudaErrorInvalidValue;
  pop_floor_kernel<<<1, block_threads(n), 0, stream>>>(iters, out);
  return cudaGetLastError();
}
