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
// On the card: one block of 512 threads per cloud, each thread owning the
// columns tid, tid + 512, ...; the cloud's state (56 bytes a column) in
// shared memory up to about 4000 points, in a global scratch buffer above.
// A pop relaxes each thread's own columns and folds their argmin in the
// same pass, then one block barrier (partials double-buffered) gives every
// thread the next pop: it is bound by that barrier's latency, one per pop,
// up to pop_cap pops a straggler. With B blocks only B of the 132 SMs work.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kInf = 1.0e30f;

struct State {
  float *px, *py, *pz, *qx, *qy, *qz, *qsq, *qn, *price, *dist;
  int *owner, *pred, *scan, *list;
};

__host__ __device__ inline size_t state_bytes(int n) {
  return (static_cast<size_t>(n) * 14 * 4 + 15) / 16 * 16;
}

__device__ inline State carve(char* base, int n) {
  State s;
  float* f = reinterpret_cast<float*>(base);
  s.px = f;
  s.py = f + n;
  s.pz = f + 2 * n;
  s.qx = f + 3 * n;
  s.qy = f + 4 * n;
  s.qz = f + 5 * n;
  s.qsq = f + 6 * n;
  s.qn = f + 7 * n;
  s.price = f + 8 * n;
  s.dist = f + 9 * n;
  s.owner = reinterpret_cast<int*>(f + 10 * n);
  s.pred = s.owner + n;
  s.scan = s.pred + n;
  s.list = s.scan + n;
  return s;
}

__device__ __forceinline__ float sumsq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Net cost c[i][j] + price[j] in the reference's dot form.
__device__ __forceinline__ float net_cost(const State& s, float pix,
                                          float piy, float piz, float psq,
                                          int j) {
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(pix, s.qx[j]), __fmul_rn(piy, s.qy[j])),
      __fmul_rn(piz, s.qz[j]));
  return __fadd_rn(__fsub_rn(s.qn[j], __fmul_rn(2.0f, dot)), psq);
}

__device__ __forceinline__ void argmin_merge(float& v, int& j, float ov,
                                             int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

// Block-wide (min value, lowest index); every thread gets the result. The
// partials alternate between two buffers, so one barrier suffices: a
// buffer is written again only after the next call's barrier.
__device__ __forceinline__ void block_argmin(float& v, int& j,
                                             float (*rv)[kWarps],
                                             int (*rj)[kWarps], int& buf) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j, off);
    argmin_merge(v, j, ov, oj);
  }
  if ((threadIdx.x & 31) == 0) {
    rv[buf][threadIdx.x >> 5] = v;
    rj[buf][threadIdx.x >> 5] = j;
  }
  __syncthreads();
  v = rv[buf][0];
  j = rj[buf][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) argmin_merge(v, j, rv[buf][w], rj[buf][w]);
  buf ^= 1;
}

__global__ void __launch_bounds__(kThreads)
    augment_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   const int* __restrict__ owner_in,
                   const float* __restrict__ price_in, int n, float eps,
                   int pop_cap, int cap, int* __restrict__ out_owner,
                   float* __restrict__ out_price, char* __restrict__ scratch,
                   size_t scratch_stride) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red_v[2][kWarps];
  __shared__ int red_j[2][kWarps];
  __shared__ int s_count;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const State s = carve(scratch ? scratch + b * scratch_stride : smem, n);
  const size_t row0 = static_cast<size_t>(b) * n;
  const float* pb = p + row0 * 3;
  const float* qb = q + row0 * 3;

  for (int j = tid; j < n; j += kThreads) {
    s.px[j] = pb[3 * j];
    s.py[j] = pb[3 * j + 1];
    s.pz[j] = pb[3 * j + 2];
    s.qx[j] = qb[3 * j];
    s.qy[j] = qb[3 * j + 1];
    s.qz[j] = qb[3 * j + 2];
    s.qsq[j] = sumsq3(s.qx[j], s.qy[j], s.qz[j]);
    s.owner[j] = owner_in[row0 + j];
    s.price[j] = price_in[row0 + j];
    s.pred[j] = 0;  // here: "person j holds an object"
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads)
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
  int buf = 0;

  for (int st = 0; st < count; ++st) {
    const int i0 = s.list[st];
    {
      const float pix = s.px[i0], piy = s.py[i0], piz = s.pz[i0];
      const float psq = sumsq3(pix, piy, piz);
      for (int j = tid; j < n; j += kThreads) {
        s.qn[j] = __fadd_rn(s.qsq[j], s.price[j]);
        s.dist[j] = net_cost(s, pix, piy, piz, psq, j);
        s.pred[j] = -1;
        s.scan[j] = 0;
      }
    }
    float d = INFINITY;
    int jj = INT_MAX;
    for (int j = tid; j < n; j += kThreads) argmin_merge(d, jj, s.dist[j], j);
    block_argmin(d, jj, red_v, red_j, buf);

    int jstar = 0;
    float dstar = 0.f;
    bool capped = pop_cap <= 0;
    for (int pops = 1; !capped; ++pops) {
      jstar = min(jj, n - 1);
      dstar = d;
      const int own = s.owner[jstar];
      if (own < 0) break;  // a free column: the path ends here
      if (jstar % kThreads == tid) s.scan[jstar] = 1;
      const float pix = s.px[own], piy = s.py[own], piz = s.pz[own];
      const float psq = sumsq3(pix, piy, piz);
      const float base =
          __fadd_rn(__fsub_rn(dstar, net_cost(s, pix, piy, piz, psq, jstar)),
                    eps);
      d = INFINITY;
      jj = INT_MAX;
      for (int j = tid; j < n; j += kThreads) {
        if (!s.scan[j]) {
          const float cand = __fadd_rn(base, net_cost(s, pix, piy, piz, psq, j));
          if (cand < s.dist[j]) {
            s.dist[j] = cand;
            s.pred[j] = jstar;
          }
        }
        argmin_merge(d, jj, s.scan[j] ? kInf : s.dist[j], j);
      }
      block_argmin(d, jj, red_v, red_j, buf);
      capped = pops >= pop_cap;
    }
    if (capped) {  // the nearest free column reached so far
      d = INFINITY;
      jj = INT_MAX;
      for (int j = tid; j < n; j += kThreads)
        argmin_merge(d, jj, s.owner[j] < 0 ? s.dist[j] : kInf, j);
      block_argmin(d, jj, red_v, red_j, buf);
      jstar = min(jj, n - 1);
      dstar = d;
    }
    for (int j = tid; j < n; j += kThreads) {
      if (s.scan[j]) {
        const float x = __fsub_rn(dstar, s.dist[j]);
        s.price[j] = __fadd_rn(s.price[j], x > 0.f ? x : 0.f);
      }
    }
    if (tid == 0) {  // flip the path back to the straggler
      for (int jc = jstar;;) {
        const int pj = s.pred[jc];
        s.owner[jc] = pj < 0 ? i0 : s.owner[pj];
        if (pj < 0) break;
        jc = pj;
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < n; j += kThreads) {
    out_owner[row0 + j] = s.owner[j];
    out_price[row0 + j] = s.price[j];
  }
}

}  // namespace

// Bytes of one cloud's state; the wrapper passes a scratch buffer of
// b * this many bytes when it is above its shared-memory budget.
extern "C" int ppt_augment_state_bytes(int n) {
  return static_cast<int>(state_bytes(n));
}

// p, q: float [B, N, 3] (padded); owner_in: int [B, N] object -> person
// (-1 = free); price_in: float [B, N]. out_owner, out_price: the same after
// the endgame. scratch: null (state in shared memory) or b *
// scratch_stride bytes.
extern "C" int ppt_augment(const float* p, const float* q,
                           const int* owner_in, const float* price_in, int b,
                           int n, float eps, int pop_cap, int cap,
                           int* out_owner, float* out_price, char* scratch,
                           int scratch_stride, cudaStream_t stream) {
  if (b == 0 || n == 0) return cudaSuccess;
  const size_t smem = scratch ? 0 : state_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  augment_kernel<<<b, kThreads, smem, stream>>>(
      p, q, owner_in, price_in, n, eps, pop_cap, cap, out_owner, out_price,
      scratch, static_cast<size_t>(scratch_stride));
  return cudaGetLastError();
}
