// Ball query: the first nsample support points, in index order, strictly
// within the radius of each centroid.
//
// Replaces the TPU kernels pytorch_points_tpu/kernels/ballquery.py::
// _bq_while_kernel (resident form, P <= 4096) and ::_bq_kernel (grid form);
// the two are bitwise equal, and this one kernel serves both.
//
// Semantics: hit = d2 < r2 (strict), d2 in the reference's diff^2 order and
// r2 = float32(radius**2 taken in double), as the Pallas path rounds it.
// A row keeps its first nsample hits in index order; the remaining slots
// repeat the first hit, and a zero-hit row is all 0. cnt = min(hits,
// nsample). Masked support arrives poisoned by the wrapper (sign -1), as
// the reference poisons it, so the kernel is mask-free.
//
// WITH_COORDS (ppt_ball_query_coords) replaces the same two TPU kernels run
// with with_coords=True (ball_query_and_group_coords): each hit also writes
// its coordinates centred on the centroid, (point - centroid) per
// coordinate, rounded once (__fsub_rn). Slots at or beyond cnt repeat the
// first hit's; a zero-hit row gets (raw point 0 - centroid), from the
// unpoisoned cloud's point 0, which the wrapper passes in.
//
// On the card, two launches. The first packs the support step-major into
// a scratch buffer: for each step of kStep = 128 points, its 128 x, then
// its 128 y, then its 128 z (NaN past n, which never hits), and one more
// step of NaN. The query then takes a warp per centroid, so each centroid
// stops at its own nsample-th hit, the reference's early exit, with no
// block barrier and no wait for a slower centroid. A step tests 128
// support points in index order, 4 consecutive points a lane: three
// 16-byte loads from one pointer (x, y, z at fixed offsets), each a warp's
// 512 contiguous bytes, with no bounds test (the NaN step past the end
// takes the last prefetch). The next step's loads are issued before this
// step's distances. Four ballots give the step's hits in index order; a
// hit's slot is cnt plus the hits before it (earlier lanes' popcounts,
// then the lane's own earlier points), and only slots below nsample are
// written. What bounds it: issue, about 0.4 instructions of a warp a
// (centroid, point) pair with no hit in its step (the 8 rounded operations
// of the distance and its compare, the loads and ballots shared by 4
// points), and about 100 more for each step that holds a hit. The counter
// (counts, optional) receives the points each centroid's scan tested:
// whole steps, capped at n, which the plain version derives from the
// hits' cumulative count.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // centroids a block, a warp each
constexpr int kPerLane = 4;  // consecutive support points a lane tests
constexpr int kStep = 32 * kPerLane;  // points a warp tests a step
constexpr int kStepFloats = 3 * kStep;  // a packed step: x, y, z rows
constexpr unsigned kFull = 0xffffffffu;

// Packed steps of a cloud of n points: its whole steps and one of NaN.
__host__ __device__ __forceinline__ int packed_steps(int n) {
  return (n + kStep - 1) / kStep + 1;
}

// Point-major [B, n, 3] -> step-major [B, steps, 3, kStep], NaN past n.
__global__ void pack_support(const float* __restrict__ sup, int n, int steps,
                             long long total, float* __restrict__ packed) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = i / (static_cast<long long>(steps) * kStep);
    const int r = static_cast<int>(i - b * steps * kStep);
    float x = NAN, y = NAN, z = NAN;
    if (r < n) {
      const float* src = sup + 3 * (b * n + r);
      x = src[0];
      y = src[1];
      z = src[2];
    }
    float* dst = packed + (b * steps + r / kStep) * kStepFloats + r % kStep;
    dst[0] = x;
    dst[kStep] = y;
    dst[2 * kStep] = z;
  }
}

// A lane's 4 consecutive points, one float4 a coordinate.
struct Quad {
  float4 x, y, z;
};

__device__ __forceinline__ Quad load_quad(const float* step, int lane) {
  const float4* v = reinterpret_cast<const float4*>(step) + lane;
  return {__ldg(v), __ldg(v + kStep / 4), __ldg(v + kStep / 2)};
}

template <bool WITH_COORDS>
__global__ void __launch_bounds__(32 * kWarps)
    ball_query_kernel(const float* __restrict__ packed,
                      const float* __restrict__ qry,
                      const float* __restrict__ p0, int n, int p,
                      long long rows, int ns, float r2,
                      int* __restrict__ out_idx, int* __restrict__ out_cnt,
                      float* __restrict__ out_g, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp
  const int b = static_cast<int>(row / p);
  const float* cloud =
      packed + static_cast<size_t>(b) * packed_steps(n) * kStepFloats;
  const float qx = qry[3 * row], qy = qry[3 * row + 1], qz = qry[3 * row + 2];
  int* out = out_idx + row * ns;
  float* g = WITH_COORDS ? out_g + row * ns * 3 : nullptr;
  const unsigned lt = (1u << lane) - 1u;
  int cnt = 0, first = 0;

  // One step on the points base + 4 lane + k: true once the row is full.
  auto step = [&](const Quad& v, int base) {
    const float px[kPerLane] = {v.x.x, v.x.y, v.x.z, v.x.w};
    const float py[kPerLane] = {v.y.x, v.y.y, v.y.z, v.y.w};
    const float pz[kPerLane] = {v.z.x, v.z.y, v.z.z, v.z.w};
    bool hit[kPerLane];
    unsigned ballot[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      hit[k] = ppt::sqdist3(px[k], py[k], pz[k], qx, qy, qz) < r2;
      ballot[k] = __ballot_sync(kFull, hit[k]);
    }
    const unsigned any = ballot[0] | ballot[1] | ballot[2] | ballot[3];
    if (any == 0) return false;
    if (cnt == 0) {  // the row's first hit: lowest lane, then lowest point
      const int l = __ffs(any) - 1;
      int k = kPerLane - 1;
#pragma unroll
      for (int j = kPerLane - 1; j >= 0; --j)
        if ((ballot[j] >> l) & 1u) k = j;
      first = base + kPerLane * l + k;
    }
    int slot = cnt;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      slot += __popc(ballot[k] & lt);
      cnt += __popc(ballot[k]);
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (hit[k] && slot < ns) {
        out[slot] = base + kPerLane * lane + k;
        if constexpr (WITH_COORDS) {
          g[3 * slot] = __fsub_rn(px[k], qx);
          g[3 * slot + 1] = __fsub_rn(py[k], qy);
          g[3 * slot + 2] = __fsub_rn(pz[k], qz);
        }
      }
      slot += hit[k];
    }
    return cnt >= ns;
  };

  // Two quads in turn, each step's loads issued before the other's math;
  // the last prefetch reads the NaN step.
  int tested = n;
  int base = 0;
  const float* at = cloud;
  Quad cur = load_quad(at, lane);
  while (true) {
    at += kStepFloats;
    const Quad nxt = load_quad(at, lane);
    if (step(cur, base)) {
      tested = min(n, base + kStep);
      break;
    }
    base += kStep;
    if (base >= n) break;
    at += kStepFloats;
    cur = load_quad(at, lane);
    if (step(nxt, base)) {
      tested = min(n, base + kStep);
      break;
    }
    base += kStep;
    if (base >= n) break;
  }

  cnt = min(cnt, ns);
  for (int slot = cnt + lane; slot < ns; slot += 32) out[slot] = first;
  if constexpr (WITH_COORDS) {
    float fx, fy, fz;
    if (cnt > 0) {
      const float* at_first =
          cloud + (first / kStep) * kStepFloats + first % kStep;
      fx = __fsub_rn(at_first[0], qx);
      fy = __fsub_rn(at_first[kStep], qy);
      fz = __fsub_rn(at_first[2 * kStep], qz);
    } else {
      fx = __fsub_rn(p0[3 * b], qx);
      fy = __fsub_rn(p0[3 * b + 1], qy);
      fz = __fsub_rn(p0[3 * b + 2], qz);
    }
    for (int slot = cnt + lane; slot < ns; slot += 32) {
      g[3 * slot] = fx;
      g[3 * slot + 1] = fy;
      g[3 * slot + 2] = fz;
    }
  }
  if (lane == 0) {
    out_cnt[row] = cnt;
    if (counts != nullptr) counts[row] = tested;
  }
}

template <bool WITH_COORDS>
int launch(const float* sup, const float* qry, const float* p0, int b, int n,
           int p, int nsample, float r2, float* scratch, int* out_idx,
           int* out_cnt, float* out_g, int* counts, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * p;
  if (rows == 0) return cudaSuccess;
  if (n < 1 || nsample < 1 || reinterpret_cast<uintptr_t>(scratch) % 16)
    return cudaErrorInvalidValue;
  const int steps = packed_steps(n);
  const long long total = static_cast<long long>(b) * steps * kStep;
  const long long want = (total + 255) / 256;
  pack_support<<<static_cast<int>(want < 4096 ? want : 4096), 256, 0,
                 stream>>>(sup, n, steps, total, scratch);
  const long long blocks = (rows + kWarps - 1) / kWarps;
  ball_query_kernel<WITH_COORDS><<<static_cast<unsigned>(blocks),
                                   32 * kWarps, 0, stream>>>(
      scratch, qry, p0, n, p, rows, nsample, r2, out_idx, out_cnt, out_g,
      counts);
  return cudaGetLastError();
}

}  // namespace

// sup: float [B, n, 3] (poisoned); qry: float [B, P, 3]; scratch: float
// [B, n / 128 rounded up + 1, 3, 128], 16-byte aligned; out_idx: int
// [B, P, nsample]; out_cnt: int [B, P]; counts: int [B, P] or null.
extern "C" int ppt_ball_query(const float* sup, const float* qry, int b, int n,
                              int p, int nsample, float r2, float* scratch,
                              int* out_idx, int* out_cnt, int* counts,
                              cudaStream_t stream) {
  return launch<false>(sup, qry, nullptr, b, n, p, nsample, r2, scratch,
                       out_idx, out_cnt, nullptr, counts, stream);
}

// As ppt_ball_query, and p0: float [B, 3], each cloud's unpoisoned point 0;
// out_g: float [B, P, nsample, 3].
extern "C" int ppt_ball_query_coords(const float* sup, const float* qry,
                                     const float* p0, int b, int n, int p,
                                     int nsample, float r2, float* scratch,
                                     int* out_idx, int* out_cnt, float* out_g,
                                     int* counts, cudaStream_t stream) {
  return launch<true>(sup, qry, p0, b, n, p, nsample, r2, scratch, out_idx,
                      out_cnt, out_g, counts, stream);
}
