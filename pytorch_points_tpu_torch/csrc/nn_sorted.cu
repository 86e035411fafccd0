// Morton-pruned nearest neighbour (one direction per launch): the band pass
// that bounds each point's NN distance from above, and the NN scan, which
// decides its own candidate tiles from those bounds and scans them.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/nn_sorted.py::
// _band_kernel (:151, band_min), ::_band_kernel_pf (:242, band_min_dynamic)
// and ::_nn_resident_kernel (:387,
// _run_resident with tie_orig=True), together with the candidate mask the
// reference builds in XLA in front of the latter (_cand_mask, :316). Both
// clouds arrive Morton-sorted and padded by the wrapper
// (kernels/nn_sorted.py).
//
// Band (nn_band_kernel). For p-tile i of tb sorted points, the minimum
// squared distance over three consecutive tiles of tbq points of the
// (stride-subsampled) sorted q, at q-tiles clamp(center + {-1, 0, +1}),
// with center = i * njq / ni or, for masked clouds (K7), a per-(b, i)
// centres table, or the table _band_centers computes from each cloud's
// valid counts, computed here in its f32 order. The minimum over any subset
// of q is an upper bound on the NN distance, and it uses the scan's own
// arithmetic (ppt::sqdist3), so the bound can never undershoot the
// distance the scan computes for the true NN: a bound that disagreed with
// the kernel it prunes for would be unsound.
//
// What bounds it: issue, 8 rounded operations a (row, q point) pair (no
// FMA), a min and a shared load, against 3 tbq pairs a row; the dense form
// ran near that floor, so the design visits fewer pairs. One block a
// (p-tile, cloud) stages its window (3 tbq points, a float4 each) in shared
// memory with the AABB of each sub-tile of kBandSub consecutive window
// points and of each group of kBandGroup sub-tiles. A warp takes 32
// Morton-consecutive rows, one a lane. It visits the groups nearest its own
// box first (key: the squared gap from the warp's box to the group's box,
// its low ibits replaced by the group index, a unique key; sorted by rank
// once a warp), the sub-tiles of a group in index order, and folds a
// sub-tile only if some live lane has lb < acc, lb the squared gap from the
// lane's row to the sub-tile's box (per axis max(lo - p, p - hi, 0),
// squared, summed x, y, z, each operation rounded alone, as the scan's
// candidate test without its factor). This is exact: the gap is a rounded
// subtraction of the same operands as a distance's, so lb never exceeds the
// distance to any point of the box, and a skipped sub-tile holds no point
// below acc; the min over the rest is the dense min, bit for bit, in any
// order. A group's box holds its sub-tiles', so its gap is never above
// theirs: a group no lane passes is skipped whole. The warp's gap is never
// above a lane's (rounding is monotone), so once the smallest key left is
// at least every lane's acc (the warp max, taken anew after each skipped
// group), nothing left can pass and the warp stops. Rows at or past a
// cloud's live count (padding, poison) are written -1 and computed not at
// all: a tile wholly past it exits at once. counts (null-able) takes the
// (warp, sub-tile) folds of each block, the kernel's own work;
// band_visits_torch emulates the order and gives the same count.
//
// NN scan (nn_boxes_kernel, then nn_scan_kernel). The candidate set is the
// reference's: q-tile J (tm points) is scanned for p-tile I (tn rows) if
// some row r of I has lb(r, J) * (1 - 1e-5) <= d_ub[r], lb being the
// squared gap from r to the AABB of J's points (pad and poison rows
// included), per axis max(lo - p, p - hi) clamped at 0, squared, summed x,
// y, z in that order, each operation rounded alone, exactly as _cand_mask
// computes it in torch ops (fine sub-tiles of ft = tm points, so one box a
// tile). The first launch writes each tile's box and a packed copy of q,
// (x, y, z, original id) a float4 a point, once a cloud. The scan then
// takes one block a (cloud, p-tile), 32 rows a warp (one a lane):
//  * each warp tests its rows against every box (boxes staged in shared
//    memory, 256 at a time) and ballots, giving its own bitmask of tiles;
//    the block's mask (their OR) is the reference's candidate row, written
//    on request (cand_out) with the counters (counts: the block's tiles
//    and the tiles its warps visit);
//  * a warp then scans only the tiles its own rows pass, ascending, with
//    no block barrier: double-buffered cp.async stages the next tile while
//    the lanes fold this one, each staged float4 read as a broadcast. This
//    is exact: every q point at a row's NN distance lies in a tile whose
//    lb is at most that distance (the gap is a rounded subtraction of the
//    same operands as the distance's, and rounding is monotone), and the
//    NN distance is at most d_ub, so the row's own test keeps every tile
//    that holds it. Other tiles of the block's mask only hold points
//    farther away, so the fold, a lexicographic minimum of (d^2, original
//    index) as one 64-bit key, ends where the reference's does, in any
//    order of tiles. Rows with a negative bound (padding, poison) pass no
//    tile and come out as (inf, 2^30); the callers drop them.
//
// No worklist budget. The TPU kernel runs a static fori_loop over a
// compacted pair list of static size (_compact_pairs, _BUDGET_FRAC), so it
// needs a budget and, past it, a lax.cond to the dense kernel, and the
// candidate mask as a separate XLA step. Here a warp visits exactly its own
// candidates, of any number, and the mask is never materialised: the
// torch glue that built it took [B, nI, 512, nJ] f32 temporaries (0.5 GB
// each at B=32 N=16384) and most of the headline's device time.
//
// What bounds the scan on the card: issue, about 12 instructions a visited
// (row, point) pair (8 rounded operations for the distance, a 64-bit
// compare and two selects), since the f32 distances may not be contracted
// into FMAs. The design cuts the pairs (per-warp tiles: a third of the
// block-level pairs on uniform clouds) rather than the instructions a
// pair. The candidate test adds about 15 operations a (row, tile).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBandThreads = 256;
// Window points a sub-tile (the unit of the skip test and of the fold
// counter) and sub-tiles a group (the unit of the visiting order):
// kernels/nn_sorted.py's BAND_SUB and BAND_GROUP.
constexpr int kBandSub = 16, kBandGroup = 4;
constexpr int kSentinel = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// Squared gap between boxes, each axis max(lo - a_hi, a_lo - hi, 0),
// summed x, y, z, every operation rounded alone (a point: a_lo = a_hi).
__device__ __forceinline__ float gap2(float4 lo, float4 hi, float ax_hi,
                                      float ay_hi, float az_hi, float ax_lo,
                                      float ay_lo, float az_lo) {
  const float gx =
      fmaxf(fmaxf(__fsub_rn(lo.x, ax_hi), __fsub_rn(ax_lo, hi.x)), 0.f);
  const float gy =
      fmaxf(fmaxf(__fsub_rn(lo.y, ay_hi), __fsub_rn(ay_lo, hi.y)), 0.f);
  const float gz =
      fmaxf(fmaxf(__fsub_rn(lo.z, az_hi), __fsub_rn(az_lo, hi.z)), 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// AABB of the float4 points [from, to) (empty: +inf lo, -inf hi).
__device__ __forceinline__ void box_of(const float4* pts, int from, int to,
                                       float4* lo_out, float4* hi_out) {
  float4 lo = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  float4 hi = make_float4(-INFINITY, -INFINITY, -INFINITY, 0.f);
  for (int t = from; t < to; ++t) {
    const float4 v = pts[t];
    lo.x = fminf(lo.x, v.x);
    lo.y = fminf(lo.y, v.y);
    lo.z = fminf(lo.z, v.z);
    hi.x = fmaxf(hi.x, v.x);
    hi.y = fmaxf(hi.y, v.y);
    hi.z = fmaxf(hi.z, v.z);
  }
  *lo_out = lo;
  *hi_out = hi;
}

// One block a (p-tile, cloud), kBandThreads threads; SUB window points a
// sub-tile, GROUP sub-tiles a group. ps [B, n, 3]; q [B, m, 3], window
// point k of q-tile j at row (j * tbq + k) * stride; centers [B, ni] or
// null; vp [B] (live rows of each cloud, else `live` for every cloud) and
// vq [B] (with vp: the centres from the two valid counts) or null. Shared
// memory: the window (3 tbq float4), the sub-tile and group boxes (lo, hi
// float4 each), each warp's group keys, unsorted and sorted.
template <int SUB, int GROUP>
__global__ void __launch_bounds__(kBandThreads)
    nn_band_kernel(const float* __restrict__ ps, const float* __restrict__ q,
                   const int* __restrict__ centers, const int* __restrict__ vp,
                   const int* __restrict__ vq, int n, int m, int stride,
                   int mq, int tb, int tbq, int live, int ibits,
                   float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ float4 band_smem[];
  __shared__ int s_visits;
  const int ti = blockIdx.x;
  const int ni = gridDim.x;
  const int b = blockIdx.y;
  const int nw = 3 * tbq;
  const int k_sub = (nw + SUB - 1) / SUB;
  const int k_grp = (k_sub + GROUP - 1) / GROUP;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float4* win = band_smem;
  float4* sub_box = win + nw;
  float4* grp_box = sub_box + 2 * k_sub;
  unsigned* keys =
      reinterpret_cast<unsigned*>(grp_box + 2 * k_grp) + 2 * warp * k_grp;
  unsigned* sorted = keys + k_grp;
  const int row0 = ti * tb;
  const int rows_live = vp != nullptr ? vp[b] : live;
  float* ob = out + static_cast<size_t>(b) * n + row0;
  if (row0 >= rows_live) {  // the whole tile is past the live rows
    for (int r = threadIdx.x; r < tb; r += blockDim.x) ob[r] = -1.f;
    if (counts != nullptr && threadIdx.x == 0) counts[b * ni + ti] = 0;
    return;
  }
  const int njq = mq / tbq;
  int center;
  if (vq != nullptr) {  // _band_centers, in its f32 order
    const float r = __fmul_rn(__fadd_rn(static_cast<float>(ti), 0.5f),
                              static_cast<float>(tb));
    const float ratio = __fdiv_rn(static_cast<float>(vq[b]),
                                  fmaxf(static_cast<float>(vp[b]), 1.f));
    center = __float2int_rz(
        __fdiv_rn(__fmul_rn(r, ratio), static_cast<float>(tb)));
    center = min(max(center, 0), njq - 1);
  } else if (centers != nullptr) {
    center = centers[static_cast<size_t>(b) * ni + ti];
  } else {
    center = static_cast<int>(static_cast<long long>(ti) * njq / ni);
  }
  const float* qb = q + static_cast<size_t>(b) * m * 3;
  for (int t = threadIdx.x; t < nw; t += blockDim.x) {
    const int w = t / tbq;
    const int jt = min(max(center + w - 1, 0), njq - 1);
    const size_t row =
        (static_cast<size_t>(jt) * tbq + (t - w * tbq)) * stride;
    win[t] = make_float4(qb[3 * row], qb[3 * row + 1], qb[3 * row + 2], 0.f);
  }
  if (threadIdx.x == 0) s_visits = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < k_sub; s += blockDim.x)
    box_of(win, s * SUB, min(nw, s * SUB + SUB), &sub_box[2 * s],
           &sub_box[2 * s + 1]);
  __syncthreads();
  for (int c = threadIdx.x; c < k_grp; c += blockDim.x)
    box_of(sub_box, 2 * c * GROUP, 2 * min(k_sub, c * GROUP + GROUP),
           &grp_box[2 * c], &grp_box[2 * c + 1]);
  __syncthreads();

  const unsigned low = (1u << ibits) - 1u;
  int visits = 0;
  for (int g = warp; g * 32 < tb; g += warps) {
    const int r = g * 32 + lane;
    const bool in_tile = r < tb;
    const bool alive = in_tile && row0 + r < rows_live;
    if (!__any_sync(kFull, alive)) {
      if (in_tile) ob[r] = -1.f;
      continue;
    }
    float px = 0.f, py = 0.f, pz = 0.f;
    if (in_tile) {
      const float* pr = ps + (static_cast<size_t>(b) * n + row0 + r) * 3;
      px = pr[0];
      py = pr[1];
      pz = pr[2];
    }
    // the warp's box over its live rows
    float lx = alive ? px : INFINITY, ly = alive ? py : INFINITY,
          lz = alive ? pz : INFINITY;
    float hx = alive ? px : -INFINITY, hy = alive ? py : -INFINITY,
          hz = alive ? pz : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lx = fminf(lx, __shfl_xor_sync(kFull, lx, off));
      ly = fminf(ly, __shfl_xor_sync(kFull, ly, off));
      lz = fminf(lz, __shfl_xor_sync(kFull, lz, off));
      hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, off));
      hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, off));
      hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, off));
    }
    // the groups in key order: a stable rank sort of the unique keys
    for (int c = lane; c < k_grp; c += 32) {
      const float lbw = gap2(grp_box[2 * c], grp_box[2 * c + 1], hx, hy, hz,
                             lx, ly, lz);
      keys[c] = (__float_as_uint(lbw) & ~low) | static_cast<unsigned>(c);
    }
    __syncwarp();
    for (int c = lane; c < k_grp; c += 32) {
      const unsigned mine = keys[c];
      int rank = 0;
      for (int t = 0; t < k_grp; ++t) rank += keys[t] < mine;
      sorted[rank] = mine;
    }
    __syncwarp();
    float acc = alive ? INFINITY : -INFINITY;
    float acc2 = acc;  // a second chain of the fold's minimum
    float amax = INFINITY;  // at least every live lane's acc
    for (int it = 0; it < k_grp; ++it) {
      const unsigned key = sorted[it];
      if (__uint_as_float(key & ~low) >= amax) break;
      const int c = static_cast<int>(key & low);
      if (!__any_sync(kFull, gap2(grp_box[2 * c], grp_box[2 * c + 1], px, py,
                                  pz, px, py, pz) < acc)) {
        amax = acc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
        continue;
      }
      for (int s = c * GROUP; s < min(k_sub, c * GROUP + GROUP); ++s) {
        if (!__any_sync(kFull, gap2(sub_box[2 * s], sub_box[2 * s + 1], px,
                                    py, pz, px, py, pz) < acc))
          continue;
        ++visits;
        const int t0 = s * SUB;
        if (t0 + SUB <= nw) {
#pragma unroll
          for (int u = 0; u < SUB; u += 2) {
            const float4 v = win[t0 + u];
            const float4 v2 = win[t0 + u + 1];
            acc = fminf(acc, ppt::sqdist3(v.x, v.y, v.z, px, py, pz));
            acc2 = fminf(acc2, ppt::sqdist3(v2.x, v2.y, v2.z, px, py, pz));
          }
        } else {
          for (int t = t0; t < nw; ++t) {
            const float4 v = win[t];
            acc = fminf(acc, ppt::sqdist3(v.x, v.y, v.z, px, py, pz));
          }
        }
        acc = fminf(acc, acc2);
        acc2 = acc;
      }
    }
    if (in_tile) ob[r] = alive ? acc : -1.f;
  }
  if (counts != nullptr) {
    if (lane == 0) atomicAdd(&s_visits, visits);
    __syncthreads();
    if (threadIdx.x == 0) counts[b * ni + ti] = s_visits;
  }
}

// The candidate test's f32 factor: float(1.0 - 1e-5), the constant torch
// and JAX use when they multiply an f32 tensor by that Python float.
constexpr float kLbScale = 0x1.fffeb0p-1f;
constexpr unsigned long long kNoNeighbour =
    (static_cast<unsigned long long>(0x7f800000u) << 32) | kSentinel;
constexpr int kBoxChunk = 256;  // boxes staged in shared memory at a time

// Box of each q-tile (tm points) and the packed q: packed[b, r] = (x, y, z,
// original id as bits); boxes[b, j] = (lo x, y, z, 0), (hi x, y, z, 0). A
// warp a tile.
__global__ void __launch_bounds__(256)
    nn_boxes_kernel(const float* __restrict__ qs, const int* __restrict__ qid,
                    int b, int nj, int tm, float4* __restrict__ packed,
                    float4* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (tile >= static_cast<long long>(b) * nj) return;
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY;
  for (int r = lane; r < tm; r += 32) {
    const size_t row = static_cast<size_t>(tile) * tm + r;
    const float x = qs[3 * row], y = qs[3 * row + 1], z = qs[3 * row + 2];
    packed[row] = make_float4(x, y, z, __int_as_float(qid[row]));
    lx = fminf(lx, x);
    ly = fminf(ly, y);
    lz = fminf(lz, z);
    hx = fmaxf(hx, x);
    hy = fmaxf(hy, y);
    hz = fmaxf(hz, z);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(kFull, lx, off));
    ly = fminf(ly, __shfl_xor_sync(kFull, ly, off));
    lz = fminf(lz, __shfl_xor_sync(kFull, lz, off));
    hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, off));
    hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, off));
    hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, off));
  }
  if (lane == 0) {
    boxes[2 * tile] = make_float4(lx, ly, lz, 0.f);
    boxes[2 * tile + 1] = make_float4(hx, hy, hz, 0.f);
  }
}

// The reference's candidate test of one row against one box.
__device__ __forceinline__ bool passes(float px, float py, float pz,
                                       float dub, float4 lo, float4 hi) {
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, px), __fsub_rn(px, hi.x)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, py), __fsub_rn(py, hi.y)), 0.f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, pz), __fsub_rn(pz, hi.z)), 0.f);
  const float lb = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             __fmul_rn(gz, gz));
  return __fmul_rn(lb, kLbScale) <= dub;
}

// First set bit at or after `from` in the warp's tile mask; nj if none.
__device__ __forceinline__ int next_tile(const unsigned* mask, int words,
                                         int nj, int from) {
  for (int w = from >> 5; w < words; ++w) {
    unsigned bits = mask[w];
    if (w == (from >> 5)) bits &= ~0u << (from & 31);
    if (bits) return w * 32 + __ffs(bits) - 1;
  }
  return nj;
}

// Stage tile j's tm packed points at the shared address dst (16-byte
// cp.async, tm / 32 a lane), then commit them as one group.
__device__ __forceinline__ void stage_tile(unsigned dst, const float4* src,
                                           int tm, int lane) {
  for (int r = lane; r < tm; r += 32)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + r * 16),
                 "l"(src + r));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// One block a (p-tile, cloud), blockDim.x = tn threads, a row a thread.
// Shared memory: the staged boxes (2 kBoxChunk float4), each warp's tile
// mask (words unsigned), each warp's two stage buffers (tm float4 each).
__global__ void __launch_bounds__(1024)
    nn_scan_kernel(const float* __restrict__ ps,
                   const float* __restrict__ d_ub,
                   const float4* __restrict__ packed,
                   const float4* __restrict__ boxes, int ni, int nj, int tm,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   uint8_t* __restrict__ cand_out, int* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  __shared__ int s_tiles, s_visits;
  const int tn = blockDim.x;
  const int warps = tn >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = (nj + 31) >> 5;
  float4* box_lo = smem4;
  float4* box_hi = smem4 + kBoxChunk;
  unsigned* masks = reinterpret_cast<unsigned*>(smem4 + 2 * kBoxChunk);
  unsigned* mine = masks + warp * words;
  float4* stage = smem4 + 2 * kBoxChunk + (warps * words + 3) / 4 +
                  static_cast<size_t>(warp) * 2 * tm;
  const int ti = blockIdx.x;
  const int b = blockIdx.y;
  const size_t row = (static_cast<size_t>(b) * ni + ti) * tn + threadIdx.x;
  const float px = ps[3 * row], py = ps[3 * row + 1], pz = ps[3 * row + 2];
  const float dub = d_ub[row];
  const float4* bb = boxes + static_cast<size_t>(b) * nj * 2;

  // candidate test: this warp's tiles
  if (threadIdx.x == 0) s_tiles = s_visits = 0;
  for (int c0 = 0; c0 < nj; c0 += kBoxChunk) {
    const int cnt = min(kBoxChunk, nj - c0);
    __syncthreads();  // the chunk before is no longer read
    for (int e = threadIdx.x; e < cnt; e += tn) {
      box_lo[e] = bb[2 * (c0 + e)];
      box_hi[e] = bb[2 * (c0 + e) + 1];
    }
    __syncthreads();
    for (int f = 0; f < cnt; f += 32) {
      unsigned word = 0;
      const int len = min(32, cnt - f);
      for (int u = 0; u < len; ++u) {
        const bool ok = passes(px, py, pz, dub, box_lo[f + u], box_hi[f + u]);
        if (__any_sync(kFull, ok)) word |= 1u << u;
      }
      if (lane == 0) mine[(c0 + f) >> 5] = word;
    }
  }
  __syncwarp();

  if (cand_out != nullptr || counts != nullptr) {
    __syncthreads();  // every warp's mask written
    int tiles = 0, visits = 0;
    uint8_t* crow = cand_out != nullptr
                        ? cand_out + (static_cast<size_t>(b) * ni + ti) * nj
                        : nullptr;
    for (int w = threadIdx.x; w < words; w += tn) {
      unsigned any = 0;
      for (int v = 0; v < warps; ++v) {
        any |= masks[v * words + w];
        visits += __popc(masks[v * words + w]);
      }
      tiles += __popc(any);
      if (crow != nullptr)
        for (int j = w * 32; j < min(nj, w * 32 + 32); ++j)
          crow[j] = (any >> (j & 31)) & 1u;
    }
    if (counts != nullptr) {
      atomicAdd(&s_tiles, tiles);
      atomicAdd(&s_visits, visits);
      __syncthreads();
      if (threadIdx.x == 0) {
        int* cnt = counts + (static_cast<size_t>(b) * ni + ti) * 2;
        cnt[0] = s_tiles;
        cnt[1] = s_visits;
      }
    }
  }

  // scan: this warp's tiles, ascending, the next one staged meanwhile
  const float4* qb = packed + static_cast<size_t>(b) * nj * tm;
  const unsigned st =
      static_cast<unsigned>(__cvta_generic_to_shared(stage));
  unsigned long long best = kNoNeighbour;
  int j = next_tile(mine, words, nj, 0);
  if (j < nj) stage_tile(st, qb + static_cast<size_t>(j) * tm, tm, lane);
  int buf = 0;
  while (j < nj) {
    const int jn = next_tile(mine, words, nj, j + 1);
    if (jn < nj)
      stage_tile(st + (buf ^ 1) * tm * 16, qb + static_cast<size_t>(jn) * tm,
                 tm, lane);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const unsigned base = st + buf * tm * 16;
#pragma unroll 8
    for (int u = 0; u < tm; ++u) {
      const float4 v = lds128(base + u * 16);
      const float d = ppt::sqdist3(v.x, v.y, v.z, px, py, pz);
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
          __float_as_uint(v.w);
      best = key < best ? key : best;
    }
    __syncwarp();  // buf is refilled at the next tile's prefetch
    buf ^= 1;
    j = jn;
  }
  if (dub < 0.f) best = kNoNeighbour;
  out_d[row] = __uint_as_float(static_cast<unsigned>(best >> 32));
  out_i[row] = static_cast<int>(static_cast<unsigned>(best));
}

// Set on every launch, whatever the size: the kernel's static shared
// memory counts against the same limit, so 48 KB of dynamic memory beside
// it already needs the opt-in.
cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Shared memory of the scan's block for tn rows, nj tiles of tm points.
size_t scan_smem(int tn, int nj, int tm) {
  const int warps = tn / 32;
  const int words = (nj + 31) / 32;
  return (2 * kBoxChunk + (warps * words + 3) / 4 +
          static_cast<size_t>(warps) * 2 * tm) *
         sizeof(float4);
}

}  // namespace

// ps: float [B, ni*tb, 3]; q: float [B, m, 3], read at rows k * stride for
// k < mq (mq a multiple of tbq); centers: int [B, ni] or null; vp: int [B]
// (each cloud's live rows) or null (`live` rows in every cloud); vq: int
// [B] or null (with vp: the centres from the valid counts); out: float
// [B, ni*tb], -1 past the live rows; counts: int [B, ni] (the (warp,
// sub-tile) folds of each block) or null.
extern "C" int ppt_nn_band(const float* ps, const float* q,
                           const int* centers, const int* vp, const int* vq,
                           int b, int ni, int m, int stride, int mq, int tb,
                           int tbq, int live, float* out, int* counts,
                           cudaStream_t stream) {
  if (tb < 1 || tbq < 1 || stride < 1 || mq < tbq || mq % tbq != 0 ||
      (vq != nullptr && vp == nullptr))
    return cudaErrorInvalidValue;
  if (b == 0 || ni == 0) return cudaSuccess;
  const auto kernel = nn_band_kernel<kBandSub, kBandGroup>;
  const int k_sub = (3 * tbq + kBandSub - 1) / kBandSub;
  const int k_grp = (k_sub + kBandGroup - 1) / kBandGroup;
  int ibits = 1;
  while ((1 << ibits) < k_grp) ++ibits;
  const size_t smem =
      (static_cast<size_t>(3) * tbq + 2 * k_sub + 2 * k_grp) *
          sizeof(float4) +
      static_cast<size_t>(kBandThreads / 32) * 2 * k_grp * sizeof(unsigned);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ni, b);
  kernel<<<grid, kBandThreads, smem, stream>>>(ps, q, centers, vp, vq, ni * tb,
                                               m, stride, mq, tb, tbq, live,
                                               ibits, out, counts);
  return cudaGetLastError();
}

// ps: float [B, ni*tn, 3]; qs: float [B, nj*tm, 3]; qid: int [B, nj*tm];
// d_ub: float [B, ni*tn]; scratch: B * nj * (tm + 2) float4 (the packed
// q, then the boxes); out_d: float [B, ni*tn]; out_i: int [B, ni*tn];
// cand_out: null or uint8 [B, ni, nj]; counts: null or int [B, ni, 2] (the
// block's candidate tiles, the tiles its warps visit). tn <= 1024 and a
// multiple of 32; tm a multiple of 32 (one box a tile: ft = tm).
extern "C" int ppt_nn_scan(const float* ps, const float* qs, const int* qid,
                           const float* d_ub, int b, int ni, int nj, int tn,
                           int tm, void* scratch, float* out_d, int* out_i,
                           uint8_t* cand_out, int* counts,
                           cudaStream_t stream) {
  if (tn < 32 || tn > 1024 || tn % 32 != 0 || tm < 32 || tm % 32 != 0)
    return cudaErrorInvalidValue;
  if (b == 0 || ni == 0) return cudaSuccess;
  float4* packed = static_cast<float4*>(scratch);
  float4* boxes = packed + static_cast<size_t>(b) * nj * tm;
  const long long warps = static_cast<long long>(b) * nj;
  if (warps > 0) {
    nn_boxes_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0,
                      stream>>>(qs, qid, b, nj, tm, packed, boxes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = scan_smem(tn, nj, tm);
  const cudaError_t err =
      set_smem(reinterpret_cast<const void*>(nn_scan_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ni, b);
  nn_scan_kernel<<<grid, tn, smem, stream>>>(
      ps, d_ub, packed, boxes, ni, nj, tm, out_d, out_i, cand_out, counts);
  return cudaGetLastError();
}
