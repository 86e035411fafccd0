// Furthest point sampling with emitted coordinates (K1).
//
// Replaces the TPU kernel pytorch_points_tpu/kernels/fps.py::_fps_kernel
// (:40, called through furthest_point_sample(emit_coords=True)).
//
// Semantics: a serial k-step loop per cloud. Each point keeps its running
// min squared distance to the selected set, d = (dx*dx + dy*dy) + dz*dz
// (ppt::sqdist3); each step selects the argmax, ties to the lowest index.
// Valid points start at 1e10, masked points at -inf (never selected while a
// valid point is left), an optional seed at 2e10. Step 0 skips the
// min-fold, so it selects the first valid index (or the seed). With fewer
// valid points than k, later steps re-select duplicates, exactly as the
// reference does; with no valid point every step selects index 0. The
// coordinates emitted are the selected point's own f32 values. The argmax
// is exact under any partition of the cloud, so the indices do not depend
// on the layout below.
//
// What bounds it on the card: the k steps are serial, so a step's latency
// sets the time, not bytes or flops: the fold over the cloud's points (12
// instructions a point, on the SMs that hold it), then a reduction across
// the cloud and a barrier before the next step can start. The earlier form
// (one block of 1024 threads a cloud) re-read every point's coordinates
// from L2 each step and paid two block barriers and a dependent global
// load of the winner a step.
//
// The design, from measurements on the card (PERF.md):
//  * the cloud stays on chip: a block keeps its points' x, y, z in shared
//    memory and each thread's P running minima (and its points' original
//    indices) in registers; after the first load no step touches device
//    memory except one thread writing idx and coords;
//  * up to 16,384 points a cloud is one block (fps_block_kernel), which
//    first buckets the cloud into 8 x 8 x 8 Morton cells (a counting sort
//    in shared memory), so each warp holds 32 P points of neighbouring
//    cells, and keeps the warp's bounding box. A step folds a warp's
//    points only if the box's lower bound to the new centre is below some
//    lane's largest running min; otherwise no point of the warp can
//    change (the bound is a rounded subtraction of the same operands as
//    each distance, and rounding is monotone, so it never exceeds one),
//    and the warp keeps its argmax. After the first steps most warps skip,
//    and a step costs little more than its reduction;
//  * one barrier a step: each warp reduces its (value, index) pairs with
//    two redux operations (max of the value's order-preserving bits, then
//    min of (original index << 14 | position) among the maxima); its
//    winning lane writes them to a slot, double-buffered by step parity;
//    after one __syncthreads every warp reduces all slots itself and reads
//    the winner's x, y, z from shared memory at its position, so the next
//    step needs no second barrier and no global load. Fewer warps make a
//    cheaper step (fps_step_floor on an H100: about 265 cycles at 128
//    threads, 400 at 1024; carrying the coordinates in the slots cost
//    more);
//  * a thread-block cluster a cloud was tried and dropped: a cluster
//    barrier with its remote slot stores cost more than the fold it
//    saves, at serve and at the headline's shapes;
//  * past the on-chip limit (16,384 points, what one block holds) clouds
//    take fps_stream_kernel: one block of 1024 threads a cloud, the running
//    min in a scratch buffer and the coordinates streamed from L2 each
//    step, with the one-barrier reduction. No path of the repo runs such
//    a cloud.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;  // a block at most; the streaming block
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kBlockPoints = 16384;  // the largest cloud on chip
constexpr int kPosBits = 14;  // a block's positions: kBlockPoints = 2^14
constexpr int kCellBits = 3;  // Morton cells a dimension: 8
constexpr int kCells = 1 << (3 * kCellBits);
// Padding points take kNoIndex less the thread's index: an index past any
// cloud's, unique in the warp, never selected.
constexpr unsigned kNoIndex = 0x7fffffffu;

// One step's published warp winners, double-buffered by step parity: a
// warp's slot is written at step j only after every warp of the block has
// passed the barrier of step j - 1, after reading the slots of step j - 2,
// so it never overwrites a slot that is still read.
struct Slots {
  uint2 key[2][kMaxWarps];
};

// Order-preserving bits: a larger float gives a larger key (-inf lowest).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best (larger key, then lower index), in every lane.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
  const unsigned k = __reduce_max_sync(0xffffffffu, key);
  idx = __reduce_min_sync(0xffffffffu, key == k ? idx : 0xffffffffu);
  key = k;
}

// One block's step: every thread brings its best (key, word), word unique
// in the warp and ordered as the tie rule wants, and gets the block's
// winning word (larger key, then lower word). One __syncthreads.
__device__ __forceinline__ unsigned block_step(Slots& slots, int step,
                                               unsigned key, unsigned word,
                                               int warps) {
  const int lane = threadIdx.x & 31;
  const int par = step & 1;
  const unsigned own = word;
  warp_best(key, word);
  if (own == word) slots.key[par][threadIdx.x >> 5] = make_uint2(key, word);
  __syncthreads();
  const uint2 kv =
      lane < warps ? slots.key[par][lane] : make_uint2(0u, 0xffffffffu);
  key = kv.x;
  word = kv.y;
  warp_best(key, word);
  return word;
}

// The warp-wide minimum and maximum of each of three values, in every lane.
__device__ __forceinline__ void warp_box(float (&lo)[3], float (&hi)[3]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
}

// The Morton cell of a point of the cloud's box: kCellBits a dimension,
// cell = (v - lo) * scale clamped. Only the grouping depends on it.
__device__ __forceinline__ unsigned cell_of(float x, float y, float z,
                                            const float (&lo)[3],
                                            const float (&scale)[3]) {
  const float v[3] = {x, y, z};
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int q = min(max(__float2int_rz(__fmul_rn(__fsub_rn(v[a], lo[a]),
                                                   scale[a])),
                          0),
                      (1 << kCellBits) - 1);
#pragma unroll
    for (int b = 0; b < kCellBits; ++b)
      code |= static_cast<unsigned>((q >> b) & 1) << (3 * b + a);
  }
  return code;
}

// A lower bound on the squared distance from (sx, sy, sz) to any point of
// the box [lo, hi], never above ppt::sqdist3 of a point in it: per axis
// the rounded gap max(lo - s, s - hi, 0) is at most |rounded (p - s)|.
__device__ __forceinline__ float box_bound(const float (&lo)[3],
                                           const float (&hi)[3], float sx,
                                           float sy, float sz) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo[0], sx), __fsub_rn(sx, hi[0])),
                         0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo[1], sy), __fsub_rn(sy, hi[1])),
                         0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo[2], sz), __fsub_rn(sz, hi[2])),
                         0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// A lane's argmax over its P points: (value, original index) larger value
// first, then lower index; q the point's slot.
template <int P>
__device__ __forceinline__ void lane_argmax(const float (&m)[P],
                                            const unsigned (&oi)[P],
                                            float& bv, unsigned& bidx,
                                            int& bq) {
  bv = m[0];
  bidx = oi[0];
  bq = 0;
#pragma unroll
  for (int p = 1; p < P; ++p) {
    if (m[p] > bv || (m[p] == bv && oi[p] < bidx)) {
      bv = m[p];
      bidx = oi[p];
      bq = p;
    }
  }
}

// A cloud of n <= kBlockPoints points on one block of T = blockDim.x
// threads, P points a thread (a multiple of 4). After the bucketing, the
// point at bucket position l = 32 P w + 4 (32 q + lane) + e is lane's point
// 4 q + e of warp w, so a warp's points are 32 P neighbouring positions and
// its float4 group q is one conflict-free load. A lane's best travels as
// one word, (original index << kPosBits) | position: the reduction's min
// word is the lowest index, and the position locates its coordinates.
template <int P>
__global__ void __launch_bounds__(kMaxThreads)
    fps_block_kernel(const float* __restrict__ xyz,
                     const uint8_t* __restrict__ mask,
                     const int* __restrict__ seed, int n, int k,
                     int* __restrict__ out_idx, float* __restrict__ out_xyz) {
  extern __shared__ float4 coords4[];  // x, then y, then z: P T floats each
  __shared__ Slots slots;
  __shared__ unsigned cells[kCells];
  __shared__ float part[2][3][kMaxWarps];
  const int cloud = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int span = P * threads;  // floats per coordinate array
  float* xs = reinterpret_cast<float*>(coords4);
  float* ys = xs + span;
  float* zs = ys + span;
  const float4* xs4 = coords4;
  const float4* ys4 = coords4 + span / 4;
  const float4* zs4 = coords4 + span / 2;
  int* order = reinterpret_cast<int*>(coords4);  // first: the bucket order
  const float* pts = xyz + static_cast<size_t>(cloud) * n * 3;
  const int s_idx = seed != nullptr ? seed[cloud] : -1;

  // the cloud's box, and the cells' scale
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = tid; i < n; i += threads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], pts[3 * i + a]);
      hi[a] = fmaxf(hi[a], pts[3 * i + a]);
    }
  }
  warp_box(lo, hi);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      part[0][a][warp] = lo[a];
      part[1][a][warp] = hi[a];
    }
  }
  for (int c = tid; c < kCells; c += threads) cells[c] = 0;
  __syncthreads();
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int v = 0; v < warps; ++v) {
      lo[a] = fminf(lo[a], part[0][a][v]);
      hi[a] = fmaxf(hi[a], part[1][a][v]);
    }
    scale[a] = hi[a] > lo[a] ? (1 << kCellBits) / (hi[a] - lo[a]) : 0.f;
  }
  // counting sort by cell: counts, offsets, positions
  for (int i = tid; i < n; i += threads)
    atomicAdd(&cells[cell_of(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lo,
                             scale)],
              1u);
  __syncthreads();
  if (warp == 0) {
    constexpr int kPer = kCells / 32;
    unsigned run[kPer];
    unsigned sum = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      run[c] = cells[lane * kPer + c];
      sum += run[c];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    unsigned base = incl - sum;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      cells[lane * kPer + c] = base;
      base += run[c];
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += threads) {
    const unsigned c = cell_of(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                               lo, scale);
    order[atomicAdd(&cells[c], 1u)] = i;
  }
  __syncthreads();
  unsigned oi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int l = 32 * P * warp + 4 * (32 * (p >> 2) + lane) + (p & 3);
    oi[p] = l < n ? static_cast<unsigned>(order[l])
                  : kNoIndex - static_cast<unsigned>(tid);
  }
  __syncthreads();  // the order is overwritten by the coordinates

  // coordinates, running minima, the warp's box
  float m[P];
  float wlo[3] = {INFINITY, INFINITY, INFINITY};
  float whi[3] = {-INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int l = 32 * P * warp + 4 * (32 * (p >> 2) + lane) + (p & 3);
    if (l < n) {
      const unsigned i = oi[p];
      const float c[3] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
      xs[l] = c[0];
      ys[l] = c[1];
      zs[l] = c[2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        wlo[a] = fminf(wlo[a], c[a]);
        whi[a] = fmaxf(whi[a], c[a]);
      }
      const bool valid =
          mask == nullptr || mask[static_cast<size_t>(cloud) * n + i];
      m[p] = static_cast<int>(i) == s_idx ? 2e10f
                                           : (valid ? 1e10f : -INFINITY);
    } else {  // padding: -inf forever, an index past n
      xs[l] = ys[l] = zs[l] = 0.f;
      m[p] = -INFINITY;
    }
  }
  warp_box(wlo, whi);
  float bv;
  unsigned bidx;
  int bq;
  lane_argmax(m, oi, bv, bidx, bq);
  const int own = 32 * P * warp + 4 * lane;  // + 128 q + e: point 4 q + e
  // padding words sit above every real one and differ by lane
  const unsigned pad_word = 0xffffffffu - static_cast<unsigned>(tid);
  auto word = [&]() {
    return bidx < static_cast<unsigned>(n)
               ? (bidx << kPosBits) |
                     static_cast<unsigned>(own + 128 * (bq >> 2) + (bq & 3))
               : pad_word;
  };
  unsigned bw = word();

  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < k; ++j) {
    if (j > 0 && __any_sync(0xffffffffu,
                            bv > box_bound(wlo, whi, sx, sy, sz))) {
      const int g0 = 8 * P * warp + lane;  // float4 index of group 0
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 gx = xs4[g0 + 32 * q];
        const float4 gy = ys4[g0 + 32 * q];
        const float4 gz = zs4[g0 + 32 * q];
        m[4 * q] =
            fminf(m[4 * q], ppt::sqdist3(gx.x, gy.x, gz.x, sx, sy, sz));
        m[4 * q + 1] =
            fminf(m[4 * q + 1], ppt::sqdist3(gx.y, gy.y, gz.y, sx, sy, sz));
        m[4 * q + 2] =
            fminf(m[4 * q + 2], ppt::sqdist3(gx.z, gy.z, gz.z, sx, sy, sz));
        m[4 * q + 3] =
            fminf(m[4 * q + 3], ppt::sqdist3(gx.w, gy.w, gz.w, sx, sy, sz));
      }
      lane_argmax(m, oi, bv, bidx, bq);
      bw = word();
    }
    const unsigned win = block_step(slots, j, order_key(bv), bw, warps);
    const unsigned at = win & ((1u << kPosBits) - 1u);
    sx = xs[at];
    sy = ys[at];
    sz = zs[at];
    if (tid == 0) {
      const size_t o = static_cast<size_t>(cloud) * k + j;
      out_idx[o] = static_cast<int>(win >> kPosBits);
      out_xyz[3 * o] = sx;
      out_xyz[3 * o + 1] = sy;
      out_xyz[3 * o + 2] = sz;
    }
  }
}

// Clouds past the on-chip limit: one block of 1024 threads a cloud, the
// running min in scratch (float [B, N]), coordinates streamed each step.
__global__ void __launch_bounds__(kMaxThreads)
    fps_stream_kernel(const float* __restrict__ xyz,
                      const uint8_t* __restrict__ mask,
                      const int* __restrict__ seed, int n, int k,
                      int* __restrict__ out_idx, float* __restrict__ out_xyz,
                      float* __restrict__ scratch) {
  __shared__ Slots slots;
  const int cloud = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pts = xyz + static_cast<size_t>(cloud) * n * 3;
  float* mind = scratch + static_cast<size_t>(cloud) * n;
  const int s_idx = seed != nullptr ? seed[cloud] : -1;
  for (int i = tid; i < n; i += kMaxThreads) {
    const bool valid =
        mask == nullptr || mask[static_cast<size_t>(cloud) * n + i];
    mind[i] = i == s_idx ? 2e10f : (valid ? 1e10f : -INFINITY);
  }
  // each thread reads back only its own entries: no barrier needed
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    unsigned bi = kNoIndex;
    for (int i = tid; i < n; i += kMaxThreads) {
      float v = mind[i];
      if (j > 0) {
        v = fminf(v, ppt::sqdist3(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2],
                                  sx, sy, sz));
        mind[i] = v;
      }
      if (bi == kNoIndex || v > bv) {
        bv = v;
        bi = static_cast<unsigned>(i);
      }
    }
    const unsigned sel =
        block_step(slots, j, order_key(bv), bi, kMaxThreads >> 5);
    sx = pts[3 * sel];
    sy = pts[3 * sel + 1];
    sz = pts[3 * sel + 2];
    if (tid == 0) {
      const size_t o = static_cast<size_t>(cloud) * k + j;
      out_idx[o] = static_cast<int>(sel);
      out_xyz[3 * o] = sx;
      out_xyz[3 * o + 1] = sy;
      out_xyz[3 * o + 2] = sz;
    }
  }
}

// The least time of one step on a block of `threads` threads (as the
// kernels run it): the warp reductions, the slot stores, the barrier, the
// reduction over all slots and the winner's coordinates, each step
// depending on the one before, with no points to fold. clock64 and
// %globaltimer, read by thread 0.
__global__ void __launch_bounds__(kMaxThreads)
    fps_floor_kernel(int iters, long long* out) {
  __shared__ Slots slots;
  __shared__ float xs[kMaxThreads];
  const int warps = blockDim.x >> 5;
  unsigned sel = threadIdx.x;
  float sx = 0.f;
  xs[threadIdx.x] = static_cast<float>(threadIdx.x);
  __syncthreads();
  const long long c0 = clock64();
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (int it = 0; it < iters; ++it) {
    const unsigned key = ((threadIdx.x * 2654435761u) ^ sel) & 0xffffu;
    sel = block_step(slots, it, key, threadIdx.x, warps);
    sx = xs[sel & (kMaxThreads - 1)];
  }
  const long long c1 = clock64();
  unsigned long long t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = static_cast<long long>(t1 - t0);
    out[2] = sel + static_cast<long long>(sx);  // keeps the loop live
  }
}

// A block's layout for a cloud of n points: the fewest points a thread
// (4, 8, 16) that keep the block at 1024 threads or fewer, on the fewest
// threads (a multiple of 32) that cover the cloud. More warps make
// smaller warp boxes and a shorter fold a thread.
struct Layout {
  int threads, p;
};

Layout layout(int n) {
  int p = 4;
  while (p * kMaxThreads < n) p *= 2;
  int t = ((n + p - 1) / p + 31) / 32 * 32;
  return {t < 32 ? 32 : t, p};
}

template <int P>
cudaError_t launch(int threads, int b, cudaStream_t stream, const float* xyz,
                   const uint8_t* mask, const int* seed, int n, int k,
                   int* out_idx, float* out_xyz) {
  const size_t smem = static_cast<size_t>(3) * P * threads * sizeof(float);
  // set on every launch: the static arrays count against the same limit
  const cudaError_t err = cudaFuncSetAttribute(
      fps_block_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fps_block_kernel<P><<<b, threads, smem, stream>>>(xyz, mask, seed, n, k,
                                                    out_idx, out_xyz);
  return cudaGetLastError();
}

}  // namespace

// mask (bool [B,N]) and seed (int32 [B]) may be null. Clouds of up to
// 16,384 points run on chip, one block a cloud; larger ones take the
// streaming kernel, which needs scratch (float [B,N]).
extern "C" int ppt_fps(const float* xyz, const uint8_t* mask, const int* seed,
                       int b, int n, int k, int* out_idx, float* out_xyz,
                       float* scratch, cudaStream_t stream) {
  if (n < 1 || k < 1) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  if (n > kBlockPoints) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    fps_stream_kernel<<<b, kMaxThreads, 0, stream>>>(xyz, mask, seed, n, k,
                                                     out_idx, out_xyz,
                                                     scratch);
    return cudaGetLastError();
  }
  const Layout l = layout(n);
  switch (l.p) {
    case 4: return launch<4>(l.threads, b, stream, xyz, mask, seed, n, k,
                             out_idx, out_xyz);
    case 8: return launch<8>(l.threads, b, stream, xyz, mask, seed, n, k,
                             out_idx, out_xyz);
    default: return launch<16>(l.threads, b, stream, xyz, mask, seed, n, k,
                               out_idx, out_xyz);
  }
}

// The step floor of the block ppt_fps runs for clouds of n points (1024
// threads past the on-chip limit): one block runs `iters` empty steps.
// out: int64 [3] (cycles, ns, a checksum).
extern "C" int ppt_fps_step_floor(int n, int iters, long long* out,
                                  cudaStream_t stream) {
  if (n < 1 || iters < 1) return cudaErrorInvalidValue;
  const int threads = n <= kBlockPoints ? layout(n).threads : kMaxThreads;
  fps_floor_kernel<<<1, threads, 0, stream>>>(iters, out);
  return cudaGetLastError();
}
