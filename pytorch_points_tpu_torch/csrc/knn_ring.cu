// Morton-ring exact k nearest neighbours (kernels K9 and K10, and the ring
// stats twin): (squared distance ascending, original index), ties to the
// lowest index, bitwise equal to the streaming scan (K8) on the same clouds.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/topk_scan.py::
// _knn_ring_kernel (knn_ring), ::_knn_ring_kernel_pf (knn_ring_masked: the
// same scan with a table of ring centres) and ::_knn_ring_stats_kernel
// (_knn_ring_stats_call: the same scan with per-tile counters).
//
// Inputs, prepared in torch ops by kernels/topk_scan.py as the reference
// prepares them: queries Morton-sorted and padded to whole tiles of kTq by
// repeating the last row; supports Morton-sorted (masked clouds over the
// valid AABB, poison last), padded to whole chunks of kTm with far-away
// rows of id 2^24, and packed as float4 (x, y, z, original index as f32).
//
// One block per (cloud, query tile of kTq sorted queries), one thread per
// query, padded rows included. Each thread keeps a register list of exactly
// K = round_up(k, 8) entries sorted by (d, id); K, not k, because the
// reference's buffer has K rows and both the skip test and the counters
// read its worst entry. K is a template argument, so the list is never
// indexed dynamically. Step j of nj visits chunk (c + off_j + nj) mod nj,
// off_j = ((j+1)/2)(2(j%2) - 1), around the tile's centre chunk c: the
// Morton-proportional ((i kTq + kTq/2) nj) / q_pad, or the masked form's
// table entry. A step stages the chunk in shared memory, takes its AABB over
// all kTm rows (pad and poison rows too), and each thread its lower bound
// in the reference's arithmetic (gap max(max(lo - q, q - hi), 0), squared,
// summed x, y, z, each operation rounded alone). The block visits the chunk
// iff some thread's bound is <= its worst distance (__syncthreads_or: the
// reference's tile-wide test). A visit scans the chunk and inserts each
// candidate lexicographically below the worst entry; +inf never enters.
//
// Why this equals the reference's extraction loop. Per chunk the reference
// extracts candidates in increasing (d, id) order and inserts each one
// below the buffer's worst entry, evicting the highest id among the entries
// tied at the worst distance: after the chunk the buffer holds the K
// smallest of (buffer + chunk), which the insertion here also computes.
// Its knockout removes candidates BY ID, and every pad row carries the id
// 2^24, so the first extraction of a pad removes all of the chunk's pad
// rows: only the nearest pad row of a chunk is a candidate. This kernel
// folds the pad rows to their minimum and offers that one. Top-k results
// never depend on it, but the list's worst entry can, and through it the
// skip test and the counters: only this rule keeps them exact for a
// support that is not a whole number of chunks.
//
// Counters (STATS). visits counts the chunks that passed the skip test.
// trips counts the reference's extraction while-loop trips: enter ?
// floor(R / unroll) + 1 : 0 per visited chunk, where enter is "some
// thread's minimum chunk distance is <= its worst distance at entry" and R
// is the block's largest r_q, the number of this chunk's candidates in
// thread q's list after the chunk. Derivation (_ring_chunk's monotone
// verdict, topk_scan.py:157-165): a column's extractions come in increasing
// (d, id) order and the buffer's worst only decreases, so the first r_q
// extractions insert and no later one does (an inserted candidate is never
// evicted within its chunk, since every later insert is larger). Trip t
// runs extractions t u .. t u + u - 1 and continues iff the last of them
// inserted somewhere, i.e. iff (t + 1) u <= R: the loop runs floor(R/u) + 1
// trips. Each list entry carries a "from this chunk" flag, so a candidate
// inserted and then evicted inside one chunk (possible here, where
// candidates arrive in chunk order) is not counted.
//
// Lists. Up to K = 64 a thread's list lives in registers (RegList: K a
// template argument, every index static). Above 64 it lives in a global
// scratch buffer, slot-major so that a warp's accesses to one slot are
// coalesced (WideList: the worst entry cached in registers, an insert
// shifts the larger entries down one slot from the end). Both hold the same
// K = round_up(k, 8) entries and take the same inserts, so the skip test,
// the counters and the result are the same for any k; the wide list is
// slower, by the global round trips of each insert.
//
// On the card: bound by the distance arithmetic and the compare of each
// visited (query, support) pair, about 8 flops for the distance; each
// staged point is read by every thread as a shared-memory broadcast. A list
// of K = 64 entries needs more than the 128 registers a thread of a
// 512-thread block may hold and spills.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTq = 512;  // queries per block, one per thread
constexpr int kTm = 512;  // support rows per chunk
constexpr int kWarps = kTq / 32;
constexpr int kPadId = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;

// A thread's list in registers: K entries sorted by (d, id), each with a
// "from this chunk" flag when STATS.
template <int K, bool STATS>
struct RegList {
  float td[K];
  int ti[K];
  bool tf[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      td[s] = INFINITY;
      ti[s] = kPadId;
      tf[s] = false;
    }
  }
  __device__ __forceinline__ float worst() const { return td[K - 1]; }
  __device__ __forceinline__ bool below_worst(float d, int i) const {
    return d < INFINITY &&
           (d < td[K - 1] || (d == td[K - 1] && i < ti[K - 1]));
  }
  // Insert (d, i), which is below the last entry; the last entry drops
  // out. Each slot keeps the smaller of its pair and the carried pair.
  __device__ __forceinline__ void insert(float d, int i) {
    bool f = true;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (d < td[s] || (d == td[s] && i < ti[s])) {
        const float tv = td[s];
        const int tj = ti[s];
        td[s] = d;
        ti[s] = i;
        d = tv;
        i = tj;
        if (STATS) {
          const bool tg = tf[s];
          tf[s] = f;
          f = tg;
        }
      }
    }
  }
  __device__ __forceinline__ void clear_flags() {
#pragma unroll
    for (int s = 0; s < K; ++s) tf[s] = false;
  }
  __device__ __forceinline__ int flags() const {
    int r = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) r += tf[s] ? 1 : 0;
    return r;
  }
  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int* __restrict__ out_i, size_t row,
                                        int k) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        out_d[row * k + s] = td[s];
        out_i[row * k + s] = ti[s];
      }
    }
  }
};

// A thread's list in global scratch: slot s at d[s * kTq] (this thread's
// column of its block's [K][kTq] slab), the worst entry cached.
template <bool STATS>
struct WideList {
  float* d;
  int* i;
  unsigned char* f;
  int K;
  float wd;
  int wi;

  __device__ __forceinline__ void init() {
    for (int s = 0; s < K; ++s) {
      d[s * kTq] = INFINITY;
      i[s * kTq] = kPadId;
      if (STATS) f[s * kTq] = 0;
    }
    wd = INFINITY;
    wi = kPadId;
  }
  __device__ __forceinline__ float worst() const { return wd; }
  __device__ __forceinline__ bool below_worst(float dd, int ii) const {
    return dd < INFINITY && (dd < wd || (dd == wd && ii < wi));
  }
  __device__ __forceinline__ void insert(float dd, int ii) {
    int s = K - 1;
    for (; s > 0; --s) {
      const float pd = d[(s - 1) * kTq];
      const int pi = i[(s - 1) * kTq];
      if (pd < dd || (pd == dd && pi < ii)) break;
      d[s * kTq] = pd;
      i[s * kTq] = pi;
      if (STATS) f[s * kTq] = f[(s - 1) * kTq];
    }
    d[s * kTq] = dd;
    i[s * kTq] = ii;
    if (STATS) f[s * kTq] = 1;
    wd = d[(K - 1) * kTq];
    wi = i[(K - 1) * kTq];
  }
  __device__ __forceinline__ void clear_flags() {
    for (int s = 0; s < K; ++s) f[s * kTq] = 0;
  }
  __device__ __forceinline__ int flags() const {
    int r = 0;
    for (int s = 0; s < K; ++s) r += f[s * kTq];
    return r;
  }
  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int* __restrict__ out_i, size_t row,
                                        int k) const {
    for (int s = 0; s < k; ++s) {
      out_d[row * k + s] = d[s * kTq];
      out_i[row * k + s] = i[s * kTq];
    }
  }
};

// K > 0: RegList<K>; K == 0: WideList of k_pad entries in the scratch
// slabs list_d / list_i / list_f ([B, nI, k_pad, kTq] each), bound to this
// thread's column of its block's slab.
template <int K, bool STATS>
struct ListOf {
  using type = RegList<K, STATS>;
  __device__ static void bind(type&, float*, int*, unsigned char*, size_t,
                              int) {}
};
template <bool STATS>
struct ListOf<0, STATS> {
  using type = WideList<STATS>;
  __device__ static void bind(type& list, float* ld, int* li,
                              unsigned char* lf, size_t block, int k_pad) {
    const size_t at = block * k_pad * kTq + threadIdx.x;
    list.d = ld + at;
    list.i = li + at;
    list.f = STATS ? lf + at : nullptr;
    list.K = k_pad;
  }
};

template <int K, bool STATS>
__global__ void __launch_bounds__(kTq)
    knn_ring_kernel(const float* __restrict__ qry,
                    const float4* __restrict__ sup,
                    const int* __restrict__ centers, int q_pad, int nj, int k,
                    int k_pad, int unroll, float* __restrict__ out_d,
                    int* __restrict__ out_i, int* __restrict__ stats,
                    float* __restrict__ list_d, int* __restrict__ list_i,
                    unsigned char* __restrict__ list_f) {
  __shared__ float4 pts[kTm];
  __shared__ float box[kWarps][6];
  __shared__ int s_rmax;
  const int tile = blockIdx.x;
  const int ni = gridDim.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(b) * q_pad +
                     static_cast<size_t>(tile) * kTq + threadIdx.x;
  const float qx = qry[3 * row], qy = qry[3 * row + 1], qz = qry[3 * row + 2];
  const int center =
      centers != nullptr
          ? centers[static_cast<size_t>(b) * ni + tile]
          : static_cast<int>(
                (static_cast<long long>(tile) * kTq + kTq / 2) * nj / q_pad);
  const float4* chunks = sup + static_cast<size_t>(b) * nj * kTm;

  typename ListOf<K, STATS>::type list;
  ListOf<K, STATS>::bind(list, list_d, list_i, list_f,
                         static_cast<size_t>(b) * ni + tile, k_pad);
  list.init();
  int visits = 0;
  int trips = 0;
  if (STATS && threadIdx.x == 0) s_rmax = 0;

  for (int j = 0; j < nj; ++j) {
    const int off = ((j + 1) / 2) * (2 * (j % 2) - 1);
    const int chunk = (center + off + nj) % nj;
    __syncthreads();  // the previous chunk's readers are done
    const float4 v = chunks[static_cast<size_t>(chunk) * kTm + threadIdx.x];
    pts[threadIdx.x] = v;
    float lx = v.x, ly = v.y, lz = v.z, hx = v.x, hy = v.y, hz = v.z;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(kFull, lx, o));
      ly = fminf(ly, __shfl_xor_sync(kFull, ly, o));
      lz = fminf(lz, __shfl_xor_sync(kFull, lz, o));
      hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o));
      hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o));
      hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, o));
    }
    if (lane == 0) {
      box[warp][0] = lx;
      box[warp][1] = ly;
      box[warp][2] = lz;
      box[warp][3] = hx;
      box[warp][4] = hy;
      box[warp][5] = hz;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lx = fminf(lx, box[w][0]);
      ly = fminf(ly, box[w][1]);
      lz = fminf(lz, box[w][2]);
      hx = fmaxf(hx, box[w][3]);
      hy = fmaxf(hy, box[w][4]);
      hz = fmaxf(hz, box[w][5]);
    }
    const float worst = list.worst();
    const float gx = fmaxf(fmaxf(__fsub_rn(lx, qx), __fsub_rn(qx, hx)), 0.f);
    const float gy = fmaxf(fmaxf(__fsub_rn(ly, qy), __fsub_rn(qy, hy)), 0.f);
    const float gz = fmaxf(fmaxf(__fsub_rn(lz, qz), __fsub_rn(qz, hz)), 0.f);
    const float lb = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                               __fmul_rn(gz, gz));
    if (!__syncthreads_or(lb <= worst)) continue;  // uniform: skip the chunk

    if (STATS) list.clear_flags();
    float dmin = INFINITY;
    float padmin = INFINITY;
    for (int t = 0; t < kTm; ++t) {
      const float4 p = pts[t];
      const float d = ppt::sqdist3(p.x, p.y, p.z, qx, qy, qz);
      const int id = static_cast<int>(p.w);
      if (STATS) dmin = fminf(dmin, d);
      if (id == kPadId) {
        padmin = fminf(padmin, d);
      } else if (list.below_worst(d, id)) {
        list.insert(d, id);
      }
    }
    if (list.below_worst(padmin, kPadId)) list.insert(padmin, kPadId);

    if (STATS) {
      const bool enter = __syncthreads_or(dmin <= worst);
      const int r = __reduce_max_sync(kFull, list.flags());
      if (lane == 0) atomicMax(&s_rmax, r);
      __syncthreads();
      if (threadIdx.x == 0) {
        visits += 1;
        if (enter) trips += s_rmax / unroll + 1;
        s_rmax = 0;  // read by thread 0 alone; next written after a barrier
      }
    }
  }

  list.store(out_d, out_i, row, k);
  if (STATS && threadIdx.x == 0) {
    const size_t at = (static_cast<size_t>(b) * ni + tile) * 2;
    stats[at] = visits;
    stats[at + 1] = trips;
  }
}

template <int K>
cudaError_t launch(const float* qry, const float4* sup, const int* centers,
                   int b, int q_pad, int nj, int k, int k_pad, int unroll,
                   float* out_d, int* out_i, int* stats, float* list_d,
                   int* list_i, unsigned char* list_f, cudaStream_t stream) {
  const dim3 grid(q_pad / kTq, b);
  if (stats != nullptr) {
    knn_ring_kernel<K, true><<<grid, kTq, 0, stream>>>(
        qry, sup, centers, q_pad, nj, k, k_pad, unroll, out_d, out_i, stats,
        list_d, list_i, list_f);
  } else {
    knn_ring_kernel<K, false><<<grid, kTq, 0, stream>>>(
        qry, sup, centers, q_pad, nj, k, k_pad, unroll, out_d, out_i, stats,
        list_d, list_i, list_f);
  }
  return cudaGetLastError();
}

}  // namespace

// qry: float [B, q_pad, 3], sorted and padded; sup: float [B, m_pad, 4]
// (x, y, z, id); centers: int [B, q_pad / 512] or null; out_d, out_i:
// [B, q_pad, k]; stats: int [B, q_pad / 512, 2] (visits, trips) or null.
// q_pad and m_pad multiples of 512, 1 <= k <= k_pad = round_up(k, 8). For
// k_pad > 64, list_d / list_i / list_f hold [B, q_pad, k_pad] floats, ints
// and bytes of scratch (list_f only with stats); else they are null.
extern "C" int ppt_knn_ring(const float* qry, const float* sup,
                            const int* centers, int b, int q_pad, int m_pad,
                            int k, int k_pad, int unroll, float* out_d,
                            int* out_i, int* stats, float* list_d,
                            int* list_i, unsigned char* list_f,
                            cudaStream_t stream) {
  if (q_pad % kTq != 0 || m_pad % kTm != 0 || m_pad == 0 || k < 1 ||
      k > k_pad || k_pad % 8 != 0 || unroll < 1)
    return cudaErrorInvalidValue;
  if (k_pad > 64 && (list_d == nullptr || list_i == nullptr ||
                     (stats != nullptr && list_f == nullptr)))
    return cudaErrorInvalidValue;
  if (b == 0 || q_pad == 0) return cudaSuccess;
  const float4* s = reinterpret_cast<const float4*>(sup);
  const int nj = m_pad / kTm;
#define PPT_RING(KK)                                                      \
  return launch<KK>(qry, s, centers, b, q_pad, nj, k, k_pad, unroll, out_d, \
                    out_i, stats, list_d, list_i, list_f, stream)
  switch (k_pad) {
    case 8: PPT_RING(8);
    case 16: PPT_RING(16);
    case 24: PPT_RING(24);
    case 32: PPT_RING(32);
    case 40: PPT_RING(40);
    case 48: PPT_RING(48);
    case 56: PPT_RING(56);
    case 64: PPT_RING(64);
    default: PPT_RING(0);  // k_pad > 64: the wide list
  }
#undef PPT_RING
}
