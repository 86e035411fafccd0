// LayerNorm over the last axis followed by ReLU, forward and backward, on
// float32 rows [R, C] (the shared MLPs' norm-then-activation pair,
// layers/blocks.py SharedMLP):
//   z = gamma * ((x - mean) * rstd) + beta,  a = relu(z),
//   rstd = rsqrt(var + eps), mean and var (biased) over the row.
//
// Replaces no TPU kernel: the JAX package leaves the norm and the ReLU to
// XLA, which fuses them on the TPU. On the card torch's layer norm gave
// each row a whole block in its forward and its grad-input kernel, so at
// C = 64-128 most lanes held nothing, took the gamma/beta gradient in a
// third pass over the rows, and left the ReLU's forward and backward to
// elementwise passes of their own: about 12 passes over the elements.
//
// It is bound by device-memory bytes: 20 bytes an element (forward: read
// x, write a; backward: read da and x, write dx) and 8 a row (mean and
// rstd, written once and read once). The design moves nothing else:
//  * a row lives in registers as float4s, its lanes on consecutive 16-byte
//    vectors: C = 32 on 8 lanes (four rows a warp), C = 64 on 16 lanes
//    (two rows a warp), C = 96 on 8 lanes with 3 float4 each, C = 128 on
//    32 lanes, C = 256-1024 on 32 lanes with 2-8 float4 each; a thread
//    holds its slice of gamma and beta (and, in the backward, of their
//    gradients) in registers for all the rows it walks. At one float4 a
//    lane a thread takes two rows a step, so each lane has two loads in
//    flight; the grid strides over the rows, as many blocks as fill every
//    SM once (the occupancy the compiler's registers allow);
//  * the forward takes a row's statistics from those registers in torch's
//    own order (its Welford sums a thread, shuffle trees, then across its
//    warps: torch_stats), so mean, rstd and a are bitwise torch's layer
//    norm and ReLU. That is a requirement, not a nicety: a mean one
//    rounding away moves z by a rounding, and the few z within a rounding
//    of 0 then take the other side of the ReLU, each moving a whole
//    element's gradient; over a training step's 2.4e8 elements that moved
//    the benchmark's first-gradient norms by 1.7e-5 against torch, past
//    the 1e-5 its comparison allows;
//  * any other C that is a multiple of 4, with 16-byte aligned rows (where
//    torch takes its vectorized kernel too), takes the forward's wide
//    instance: a warp a row, lane l holding float4s l, l + 32, ... (torch's
//    thread l of each of its warps), the row's tail masked, the statistics
//    in torch's order with its empty threads and warps combined as torch
//    combines them; so it too is bitwise torch's (C = 196 in the MSG
//    segmenter's SA2). To C = 512 the row stays in registers; past it the
//    row is read again for the output;
//  * every other row (C not a multiple of 4, or rows not 16-byte aligned,
//    where torch takes its row-moments kernel) takes the generic forward:
//    a warp a row read with scalar loads, its statistics in that kernel's
//    order (a block of 512 threads, thread t summing elements t + 512 m,
//    then its block reduce), so every forward is bitwise torch's;
//  * the backward recomputes x-hat and z with the forward's own device
//    functions, so its mask z > 0 is bitwise the forward's a > 0 (a NaN
//    z passes the gradient, as torch's ReLU backward passes it), and
//    needs neither a nor z in memory; its dgamma/dbeta partials stay in
//    registers across the rows and are summed across the block in a
//    fixed order into one [2, C] row of scratch a block, which a small
//    kernel (..._dparams) sums over the blocks in a fixed order: no
//    atomics, and the block count depends on the device alone, so two
//    runs are bitwise equal. It matches torch's backward to rounding;
//  * the backward at any C without a register instance (or on rows not
//    16-byte aligned) takes the generic backward: a warp a row, the row
//    read again for each pass, and the parameter gradients by a column
//    kernel that recomputes z the same way. Nothing falls back to torch.
// Every operation is rounded on its own (explicit __fsub_rn/__fmul_rn) but
// the multiply-adds nvcc contracts in torch's kernel, which are __fmaf_rn.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;  // the scratch's capacity
constexpr unsigned kFull = 0xffffffffu;

// x-hat and z: one definition for the forward, the backward and the
// generic kernels, so that every mask is the forward's.
__device__ __forceinline__ float x_hat(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float pre_act(float t, float g, float b) {
  return __fmaf_rn(g, t, b);
}

// torch.relu: NaN stays NaN. Its backward passes the gradient where the
// output is not <= 0 (torch's threshold_backward), NaN included.
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

__device__ __forceinline__ bool passes(float z) { return !(z <= 0.f); }

template <int LPR>
__device__ __forceinline__ float row_sum(float s) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, o));
  return s;
}

__device__ __forceinline__ void unpack(float4 q, float* v) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ float4 pack(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < 64) counts[dev] = n;
  return n;
}

// Blocks of kThreads that fill every SM once: the device's SM count times
// the blocks an SM holds of `kernel` (asked once a kernel a process).
template <typename Kernel>
int resident_blocks(Kernel kernel, int* cached) {
  if (*cached <= 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0) !=
        cudaSuccess)
      return 0;
    *cached = per_sm < 1 ? 1 : per_sm;
  }
  return sm_count() * *cached;
}

// torch's Welford state of a thread and its two updates, operation for
// operation as torch's layer norm forward computes them (its
// cuWelfordOnlineSum and cuWelfordCombine, with nvcc's contractions).
struct Welford {
  float mean, m2, count;
};

__device__ __forceinline__ void welford_add(Welford& w, float v) {
  const float delta = __fsub_rn(v, w.mean);
  w.count = __fadd_rn(w.count, 1.f);
  w.mean = __fmaf_rn(delta, __frcp_rn(w.count), w.mean);
  w.m2 = __fmaf_rn(delta, __fsub_rn(v, w.mean), w.m2);
}

// `own` absorbs `other` (torch's dataB and dataA); neither is empty.
__device__ __forceinline__ Welford welford_combine(Welford own,
                                                   Welford other) {
  const float delta = __fsub_rn(own.mean, other.mean);
  const float count = __fadd_rn(other.count, own.count);
  const float coef = __frcp_rn(count);
  const float n_other = __fmul_rn(other.count, coef);
  const float n_own = __fmul_rn(own.count, coef);
  Welford w;
  w.mean = __fmaf_rn(n_other, other.mean, __fmul_rn(n_own, own.mean));
  w.m2 = __fmaf_rn(__fmul_rn(__fmul_rn(delta, delta), other.count), n_own,
                   __fadd_rn(other.m2, own.m2));
  w.count = count;
  return w;
}

// welford_combine where either side may be empty, as torch computes it:
// no count, no mean and no sum of squares. Exact where the empty side is
// `other` and own.count * (1 / own.count) rounds to 1, as it does at
// every count these kernels meet; computed all the same.
__device__ __forceinline__ Welford welford_combine_any(Welford own,
                                                       Welford other) {
  if (!(__fadd_rn(other.count, own.count) > 0.f)) return {0.f, 0.f, 0.f};
  return welford_combine(own, other);
}

__device__ __forceinline__ Welford shfl_down(Welford w, int offset) {
  return {__shfl_down_sync(kFull, w.mean, offset),
          __shfl_down_sync(kFull, w.m2, offset),
          __shfl_down_sync(kFull, w.count, offset)};
}

// A row's mean and rstd, bitwise as torch's vectorized layer norm gives
// them, from the row's values in registers (lane sub of the group grp
// holds float4 j LPR + sub, j < VPT). Torch takes a row on one block of 4
// warps x 32 threads, thread (w, l) the float4s 32 w + l + 128 m in order,
// each thread a Welford sum of its values, then each warp a shuffle-down
// tree (offsets 16 ... 1), then warps 2 and 3 into 0 and 1, then 1 into
// 0; var = m2 / C, rstd = rsqrtf(var + eps).
//  * C >= 128 (LPR = 32): state k of a lane is torch's warp k's thread
//    (floats4 j = k, k + 4, ...), and the trees run over the lanes;
//  * C < 128 (torch's warp 0 alone holds the row, thread t = j LPR + sub):
//    the tree's steps at offsets of LPR and more combine a lane's own
//    states (step 16 / LPR first; at one float4 a lane, C = 32 and 64,
//    they meet only empty threads), the smaller ones run over the lanes.
// Every combination with a thread or warp that holds no value is exact at
// these C (own.count * (1 / own.count) rounds to 1), so the trees leave
// them out.
template <int LPR, int VPT>
__device__ __forceinline__ void torch_stats(const float (&v)[4 * VPT],
                                            int grp, float eps, float& mean,
                                            float& rstd) {
  constexpr bool kNarrow = VPT > 1 && VPT * LPR < 32;
  constexpr int W = kNarrow ? 32 / LPR : (VPT < 4 ? VPT : 4);
  Welford w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    w[k] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = k; j < VPT; j += (kNarrow ? W : 4))
#pragma unroll
      for (int e = 0; e < 4; ++e) welford_add(w[k], v[4 * j + e]);
    if constexpr (!kNarrow) {
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
        w[k] = welford_combine(w[k], shfl_down(w[k], o));
    }
  }
  if constexpr (kNarrow) {
#pragma unroll
    for (int step = W / 2; step > 0; step >>= 1)
#pragma unroll
      for (int k = 0; k < step; ++k)
        if (k + step < VPT) w[k] = welford_combine(w[k], w[k + step]);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      w[0] = welford_combine(w[0], shfl_down(w[0], o));
  } else {
    if constexpr (W == 4) {
      w[0] = welford_combine(w[0], w[2]);
      w[1] = welford_combine(w[1], w[3]);
    }
    if constexpr (W >= 2) w[0] = welford_combine(w[0], w[1]);
  }
  mean = __shfl_sync(kFull, w[0].mean, grp * LPR);
  const float m2 = __shfl_sync(kFull, w[0].m2, grp * LPR);
  rstd = rsqrtf(__fadd_rn(__fdiv_rn(m2, static_cast<float>(4 * VPT * LPR)),
                          eps));
}

// LPR lanes a row, VPT float4 a lane (C = 4 VPT LPR), R rows a group of
// lanes a step. A warp takes G R consecutive rows a step (G = 32 / LPR).
template <int LPR, int VPT, int R>
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_fwd_kernel(const float4* __restrict__ x,
                               const float4* __restrict__ gamma,
                               const float4* __restrict__ beta, int rows,
                               float eps, float4* __restrict__ a,
                               float* __restrict__ mean_out,
                               float* __restrict__ rstd_out) {
  constexpr int C = 4 * VPT * LPR, CV = VPT * LPR, G = 32 / LPR;
  const int lane = threadIdx.x & 31, sub = lane % LPR, grp = lane / LPR;
  float g[4 * VPT], b[4 * VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    unpack(gamma[j * LPR + sub], g + 4 * j);
    unpack(beta[j * LPR + sub], b + 4 * j);
  }
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps +
                         threadIdx.x / 32) * (G * R);
       base < rows; base += warps * (G * R)) {
    float v[R][4 * VPT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * G + grp;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (row < rows)
          unpack(x[row * CV + j * LPR + sub], v[r] + 4 * j);
        else
          v[r][4 * j] = v[r][4 * j + 1] = v[r][4 * j + 2] =
              v[r][4 * j + 3] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * G + grp;
      float mean, rstd;
      torch_stats<LPR, VPT>(v[r], grp, eps, mean, rstd);
      if (row < rows) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * j + e;
            o[e] = relu(pre_act(x_hat(v[r][k], mean, rstd), g[k], b[k]));
          }
          a[row * CV + j * LPR + sub] = pack(o);
        }
        if (sub == 0) {
          mean_out[row] = mean;
          rstd_out[row] = rstd;
        }
      }
    }
  }
}

// One of a block's partial sums, p (a thread's, channels (j LPR + sub) 4 +
// e), into out[0, C): the G row groups of a warp (same channels) by
// shuffles, then the warps in order through shared memory.
template <int LPR, int VPT>
__device__ __forceinline__ void block_partials(
    float (&p)[4 * VPT], float (&stage)[kWarps][4 * VPT * LPR], float* out) {
  constexpr int C = 4 * VPT * LPR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < 4 * VPT; ++k) {
#pragma unroll
    for (int o = 16; o >= LPR; o >>= 1)
      p[k] = __fadd_rn(p[k], __shfl_xor_sync(kFull, p[k], o));
  }
  if (lane < LPR) {
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stage[warp][(j * LPR + lane) * 4 + e] = p[4 * j + e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = stage[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, stage[w][c]);
    out[c] = s;
  }
  __syncthreads();
}

// The backward of one row:
//   dz = da where z > 0, else 0;  g = dz * gamma;
//   dx = rstd / C * ((C g - x-hat sum(g x-hat)) - sum(g)),
// torch's layer-norm grad-input in its order, and the row's dz x-hat and dz
// added to the thread's dgamma and dbeta partials. Each block writes its
// partials to part[blockIdx.x] = [dgamma (C), dbeta (C)].
template <int LPR, int VPT, int R>
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_bwd_kernel(const float4* __restrict__ da,
                               const float4* __restrict__ x,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               const float4* __restrict__ gamma,
                               const float4* __restrict__ beta, int rows,
                               float4* __restrict__ dx,
                               float* __restrict__ part) {
  constexpr int C = 4 * VPT * LPR, CV = VPT * LPR, G = 32 / LPR;
  __shared__ float stage[kWarps][C];
  const int lane = threadIdx.x & 31, sub = lane % LPR, grp = lane / LPR;
  const int warp = threadIdx.x / 32;
  float g[4 * VPT], b[4 * VPT], pg[4 * VPT], pb[4 * VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    unpack(gamma[j * LPR + sub], g + 4 * j);
    unpack(beta[j * LPR + sub], b + 4 * j);
  }
#pragma unroll
  for (int k = 0; k < 4 * VPT; ++k) pg[k] = pb[k] = 0.f;
  const float c_f = static_cast<float>(C);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                        (G * R);
       base < rows; base += warps * (G * R)) {
    float t[R][4 * VPT], dz[R][4 * VPT], mu[R], rs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * G + grp;
      const bool in = row < rows;
      mu[r] = in ? mean[row] : 0.f;
      rs[r] = in ? rstd[row] : 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (in) {
          unpack(x[row * CV + j * LPR + sub], t[r] + 4 * j);
          unpack(da[row * CV + j * LPR + sub], dz[r] + 4 * j);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) t[r][4 * j + e] = dz[r][4 * j + e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * G + grp;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4 * VPT; ++k) {
        t[r][k] = x_hat(t[r][k], mu[r], rs[r]);
        if (!passes(pre_act(t[r][k], g[k], b[k]))) dz[r][k] = 0.f;
        const float gk = __fmul_rn(dz[r][k], g[k]);
        s1 = __fadd_rn(s1, gk);
        s2 = __fmaf_rn(gk, t[r][k], s2);
        pg[k] = __fmaf_rn(dz[r][k], t[r][k], pg[k]);
        pb[k] = __fadd_rn(pb[k], dz[r][k]);
      }
      s1 = row_sum<LPR>(s1);
      s2 = row_sum<LPR>(s2);
      if (row < rows) {
        const float term = __fmul_rn(__fdiv_rn(1.f, c_f), rs[r]);
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * j + e;
            float w = __fmul_rn(c_f, __fmul_rn(dz[r][k], g[k]));
            w = __fmaf_rn(-t[r][k], s2, w);
            o[e] = __fmul_rn(__fsub_rn(w, s1), term);
          }
          dx[row * CV + j * LPR + sub] = pack(o);
        }
      }
    }
  }
  block_partials<LPR, VPT>(pg, stage, part + 2LL * blockIdx.x * C);
  block_partials<LPR, VPT>(pb, stage, part + (2LL * blockIdx.x + 1) * C);
}

// dgamma[c] and dbeta[c]: the blocks' partials part[blocks][2][C] summed
// in a fixed order. A block takes 32 of the 2 C columns; its 8 warps sum
// every 8th partial each, in ascending block order, then warp 0 adds the
// 8 sums in order.
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_dparams_kernel(const float* __restrict__ part,
                                   int blocks, int c,
                                   float* __restrict__ dgamma,
                                   float* __restrict__ dbeta) {
  __shared__ float stage[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;  // in [0, 2 C)
  float s = 0.f;
  if (col < 2 * c) {
    for (int k = warp; k < blocks; k += kWarps)
      s = __fadd_rn(s, part[static_cast<long long>(k) * 2 * c + col]);
  }
  stage[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < 2 * c) {
    float total = stage[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, stage[w][lane]);
    if (col < c)
      dgamma[col] = total;
    else
      dbeta[col - c] = total;
  }
}

// torch's other Welford state and its two updates, operation for operation
// as its row-moments kernel (RowwiseMomentsCUDAKernel, WelfordOps) computes
// them: a division in the online update, an empty side passed through in
// the combination. The count is kept as a float, exact to 2^24.
struct Moments {
  float mean, m2, n;
};

__device__ __forceinline__ Moments moments_add(Moments s, float v) {
  const float n = __fadd_rn(s.n, 1.f);
  const float delta = __fsub_rn(v, s.mean);
  const float mean = __fadd_rn(s.mean, __fdiv_rn(delta, n));
  return {mean, __fmaf_rn(delta, __fsub_rn(v, mean), s.m2), n};
}

__device__ __forceinline__ Moments moments_combine(Moments a, Moments b) {
  if (a.n == 0.f) return b;
  if (b.n == 0.f) return a;
  const float delta = __fsub_rn(b.mean, a.mean);
  const float n = __fadd_rn(a.n, b.n);
  const float nb_over_n = __fdiv_rn(b.n, n);
  return {__fmaf_rn(delta, nb_over_n, a.mean),
          __fmaf_rn(__fmul_rn(__fmul_rn(delta, delta), a.n), nb_over_n,
                    __fadd_rn(a.m2, b.m2)),
          n};
}

// Generic forward: a warp a row, any C, scalar loads, the row read again
// for the output. torch's row-moments kernel gives a row a block of 16
// warps, thread (w, l) the elements 32 w + l + 512 m in order, then a
// shuffle-down tree in each warp (offsets 16 ... 1) and the same tree over
// the 16 warps' states in warp 0 (its lanes 16-31 empty); var = m2 / C,
// rstd = rsqrtf(var + eps). Lane l's state w here is torch's thread
// (w, l), so the trees are torch's.
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_fwd_generic_kernel(const float* __restrict__ x,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       int rows, int c, float eps,
                                       float* __restrict__ a,
                                       float* __restrict__ mean_out,
                                       float* __restrict__ rstd_out) {
  constexpr int W = 16;  // torch's warps a row
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
       row < rows; row += warps) {
    const float* xr = x + row * c;
    Moments s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) s[w] = {0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < c; k0 += 32 * W) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int k = k0 + 32 * w + lane;
        if (k < c) s[w] = moments_add(s[w], xr[k]);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[w] = moments_combine(
            s[w], {__shfl_down_sync(kFull, s[w].mean, o),
                   __shfl_down_sync(kFull, s[w].m2, o),
                   __shfl_down_sync(kFull, s[w].n, o)});
#pragma unroll
    for (int step = W / 2; step > 0; step >>= 1)
#pragma unroll
      for (int w = 0; w < step; ++w) s[w] = moments_combine(s[w], s[w + step]);
    const float mean = __shfl_sync(kFull, s[0].mean, 0);
    const float m2 = __shfl_sync(kFull, s[0].m2, 0);
    const float n = __shfl_sync(kFull, s[0].n, 0);
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(m2, n), eps));
    for (int k = lane; k < c; k += 32)
      a[row * c + k] =
          relu(pre_act(x_hat(xr[k], mean, rstd), gamma[k], beta[k]));
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Generic backward, dx: a warp a row, any C.
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_bwd_generic_kernel(const float* __restrict__ da,
                                       const float* __restrict__ x,
                                       const float* __restrict__ mean,
                                       const float* __restrict__ rstd,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       int rows, int c,
                                       float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const float c_f = static_cast<float>(c);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
       row < rows; row += warps) {
    const long long o = row * c;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int k = lane; k < c; k += 32) {
      const float t = x_hat(x[o + k], mu, rs);
      const float dz = passes(pre_act(t, gamma[k], beta[k])) ? da[o + k] : 0.f;
      const float gk = __fmul_rn(dz, gamma[k]);
      s1 = __fadd_rn(s1, gk);
      s2 = __fmaf_rn(gk, t, s2);
    }
    s1 = row_sum<32>(s1);
    s2 = row_sum<32>(s2);
    const float term = __fmul_rn(__fdiv_rn(1.f, c_f), rs);
    for (int k = lane; k < c; k += 32) {
      const float t = x_hat(x[o + k], mu, rs);
      const float dz = passes(pre_act(t, gamma[k], beta[k])) ? da[o + k] : 0.f;
      float w = __fmul_rn(c_f, __fmul_rn(dz, gamma[k]));
      w = __fmaf_rn(-t, s2, w);
      dx[o + k] = __fmul_rn(__fsub_rn(w, s1), term);
    }
  }
}

// Generic backward, dgamma/dbeta partials: block (i, chunk) takes columns
// 32 i .. 32 i + 31 of the rows chunk, chunk + chunks, ..., its warps every
// 8th of those rows, and writes part[chunk] = [dgamma (C), dbeta (C)].
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_bwd_params_generic_kernel(
        const float* __restrict__ da, const float* __restrict__ x,
        const float* __restrict__ mean, const float* __restrict__ rstd,
        const float* __restrict__ gamma, const float* __restrict__ beta,
        int rows, int c, float* __restrict__ part) {
  __shared__ float stage[2][kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  float pg = 0.f, pb = 0.f;
  if (col < c) {
    const float gc = gamma[col], bc = beta[col];
    for (long long row = static_cast<long long>(chunk) * kWarps + warp;
         row < rows; row += static_cast<long long>(chunks) * kWarps) {
      const long long o = row * c + col;
      const float t = x_hat(x[o], mean[row], rstd[row]);
      const float dz = passes(pre_act(t, gc, bc)) ? da[o] : 0.f;
      pg = __fmaf_rn(dz, t, pg);
      pb = __fadd_rn(pb, dz);
    }
  }
  stage[0][warp][lane] = pg;
  stage[1][warp][lane] = pb;
  __syncthreads();
  if (warp < 2 && col < c) {
    float s = stage[warp][0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, stage[warp][w][lane]);
    part[(2LL * chunk + warp) * c + col] = s;
  }
}

// Wide forward: a warp a row of nv float4s (C = 4 nv), lane l taking
// float4s l + 32 j in ascending j, the row's tail masked. J > 0 keeps the
// row (nv <= 32 J <= 128) and gamma and beta in registers; J = 0 takes any
// nv and reads the row again for the output. Float4 l + 32 j goes into the
// lane's state j % 4, torch's thread l of its warp j % 4 (torch's thread
// (w, l) takes float4s 32 w + l + 128 m; torch_stats above), so the warp
// trees, over all 32 lanes, and the combinations across torch's warps are
// torch's, its empty threads and warps combined as it combines them.
template <int J>
__global__ void __launch_bounds__(kThreads)
    layer_norm_relu_fwd_wide_kernel(const float4* __restrict__ x,
                                    const float4* __restrict__ gamma,
                                    const float4* __restrict__ beta,
                                    int rows, int nv, float eps,
                                    float4* __restrict__ a,
                                    float* __restrict__ mean_out,
                                    float* __restrict__ rstd_out) {
  constexpr int JR = J > 0 ? J : 1;  // float4s a lane in registers
  const int lane = threadIdx.x & 31;
  float g[4 * JR], b[4 * JR];
  if constexpr (J > 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int q = lane + 32 * j;
      if (q < nv) {
        unpack(gamma[q], g + 4 * j);
        unpack(beta[q], b + 4 * j);
      } else {
        g[4 * j] = g[4 * j + 1] = g[4 * j + 2] = g[4 * j + 3] = 0.f;
        b[4 * j] = b[4 * j + 1] = b[4 * j + 2] = b[4 * j + 3] = 0.f;
      }
    }
  }
  const float c_f = static_cast<float>(4 * nv);
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
       row < rows; row += warps) {
    float v[4 * JR];
    Welford w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = {0.f, 0.f, 0.f};
    if constexpr (J > 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int q = lane + 32 * j;
        if (q < nv) {
          unpack(x[row * nv + q], v + 4 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) welford_add(w[j], v[4 * j + e]);
        } else {
          v[4 * j] = v[4 * j + 1] = v[4 * j + 2] = v[4 * j + 3] = 0.f;
        }
      }
    } else {
      for (int j0 = 0; 32 * j0 < nv; j0 += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = lane + 32 * (j0 + j);
          if (q < nv) {
            unpack(x[row * nv + q], v);
#pragma unroll
            for (int e = 0; e < 4; ++e) welford_add(w[j], v[e]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < (J > 0 && J < 4 ? J : 4); ++j)  // the others empty
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        w[j] = welford_combine_any(w[j], shfl_down(w[j], o));
    w[0] = welford_combine_any(w[0], w[2]);
    w[1] = welford_combine_any(w[1], w[3]);
    w[0] = welford_combine_any(w[0], w[1]);
    const float mean = __shfl_sync(kFull, w[0].mean, 0);
    const float m2 = __shfl_sync(kFull, w[0].m2, 0);
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(m2, c_f), eps));
    if constexpr (J > 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int q = lane + 32 * j;
        if (q < nv) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * j + e;
            o[e] = relu(pre_act(x_hat(v[k], mean, rstd), g[k], b[k]));
          }
          a[row * nv + q] = pack(o);
        }
      }
    } else {
      for (int q = lane; q < nv; q += 32) {
        float o[4];
        unpack(x[row * nv + q], v);
        unpack(gamma[q], g);
        unpack(beta[q], b);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = relu(pre_act(x_hat(v[e], mean, rstd), g[e], b[e]));
        a[row * nv + q] = pack(o);
      }
    }
    if (lane == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename... P>
bool aligned16(const void* p, P... rest) {
  return aligned16(p) && aligned16(rest...);
}

int grid_for(long long rows, int rows_a_block, int resident) {
  const long long need = (rows + rows_a_block - 1) / rows_a_block;
  return static_cast<int>(need < resident ? need : resident);
}

template <int LPR, int VPT, int R>
cudaError_t forward(const float* x, const float* gamma, const float* beta,
                    int rows, float eps, float* a, float* mean, float* rstd,
                    cudaStream_t stream) {
  static int per_sm = 0;
  auto kernel = layer_norm_relu_fwd_kernel<LPR, VPT, R>;
  const int resident = resident_blocks(kernel, &per_sm);
  if (resident <= 0) return cudaErrorInvalidValue;
  const int blocks = grid_for(rows, kWarps * (32 / LPR) * R, resident);
  kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x),
      reinterpret_cast<const float4*>(gamma),
      reinterpret_cast<const float4*>(beta), rows, eps,
      reinterpret_cast<float4*>(a), mean, rstd);
  return cudaGetLastError();
}

template <int LPR, int VPT, int R>
cudaError_t backward(const float* da, const float* x, const float* mean,
                     const float* rstd, const float* gamma, const float* beta,
                     int rows, float* scratch, int scratch_blocks, float* dx,
                     float* dgamma, float* dbeta, cudaStream_t stream) {
  constexpr int C = 4 * VPT * LPR;
  static int per_sm = 0;
  auto kernel = layer_norm_relu_bwd_kernel<LPR, VPT, R>;
  const int resident = resident_blocks(kernel, &per_sm);
  if (resident <= 0) return cudaErrorInvalidValue;
  const int blocks = grid_for(rows, kWarps * (32 / LPR) * R, resident);
  if (blocks > scratch_blocks) return cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(da), reinterpret_cast<const float4*>(x),
      mean, rstd, reinterpret_cast<const float4*>(gamma),
      reinterpret_cast<const float4*>(beta), rows,
      reinterpret_cast<float4*>(dx), scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_relu_dparams_kernel<<<(2 * C + 31) / 32, kThreads, 0, stream>>>(
      scratch, blocks, C, dgamma, dbeta);
  return cudaGetLastError();
}

template <int J>
cudaError_t forward_wide_j(const float* x, const float* gamma,
                           const float* beta, int rows, int nv, float eps,
                           float* a, float* mean, float* rstd,
                           cudaStream_t stream) {
  static int per_sm = 0;
  auto kernel = layer_norm_relu_fwd_wide_kernel<J>;
  const int resident = resident_blocks(kernel, &per_sm);
  if (resident <= 0) return cudaErrorInvalidValue;
  kernel<<<grid_for(rows, kWarps, resident), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x),
      reinterpret_cast<const float4*>(gamma),
      reinterpret_cast<const float4*>(beta), rows, nv, eps,
      reinterpret_cast<float4*>(a), mean, rstd);
  return cudaGetLastError();
}

// nv float4s a row, nv >= 1.
cudaError_t forward_wide(const float* x, const float* gamma,
                         const float* beta, int rows, int nv, float eps,
                         float* a, float* mean, float* rstd,
                         cudaStream_t stream) {
  switch ((nv + 31) / 32) {
    case 1:
      return forward_wide_j<1>(x, gamma, beta, rows, nv, eps, a, mean, rstd,
                               stream);
    case 2:
      return forward_wide_j<2>(x, gamma, beta, rows, nv, eps, a, mean, rstd,
                               stream);
    case 3:
      return forward_wide_j<3>(x, gamma, beta, rows, nv, eps, a, mean, rstd,
                               stream);
    case 4:
      return forward_wide_j<4>(x, gamma, beta, rows, nv, eps, a, mean, rstd,
                               stream);
    default:
      return forward_wide_j<0>(x, gamma, beta, rows, nv, eps, a, mean, rstd,
                               stream);
  }
}

cudaError_t forward_generic(const float* x, const float* gamma,
                            const float* beta, int rows, int c, float eps,
                            float* a, float* mean, float* rstd,
                            cudaStream_t stream) {
  static int per_sm = 0;
  const int resident =
      resident_blocks(layer_norm_relu_fwd_generic_kernel, &per_sm);
  if (resident <= 0) return cudaErrorInvalidValue;
  layer_norm_relu_fwd_generic_kernel<<<grid_for(rows, kWarps, resident),
                                       kThreads, 0, stream>>>(
      x, gamma, beta, rows, c, eps, a, mean, rstd);
  return cudaGetLastError();
}

cudaError_t backward_generic(const float* da, const float* x,
                             const float* mean, const float* rstd,
                             const float* gamma, const float* beta, int rows,
                             int c, float* scratch, int scratch_blocks,
                             float* dx, float* dgamma, float* dbeta,
                             cudaStream_t stream) {
  static int per_sm = 0;
  const int resident =
      resident_blocks(layer_norm_relu_bwd_generic_kernel, &per_sm);
  if (resident <= 0) return cudaErrorInvalidValue;
  layer_norm_relu_bwd_generic_kernel<<<grid_for(rows, kWarps, resident),
                                       kThreads, 0, stream>>>(
      da, x, mean, rstd, gamma, beta, rows, c, dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // chunks of rows: enough column blocks x chunks to fill the card once,
  // at least 8 rows (a warp's one) a chunk
  const int col_blocks = (c + 31) / 32;
  int chunks = (sm_count() * kMaxBlocksPerSm + col_blocks - 1) / col_blocks;
  const int most = (rows + kWarps - 1) / kWarps;
  if (chunks > most) chunks = most;
  if (chunks > scratch_blocks) chunks = scratch_blocks;
  if (chunks < 1) chunks = 1;
  layer_norm_relu_bwd_params_generic_kernel<<<dim3(col_blocks, chunks),
                                              kThreads, 0, stream>>>(
      da, x, mean, rstd, gamma, beta, rows, c, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_relu_dparams_kernel<<<(2 * c + 31) / 32, kThreads, 0, stream>>>(
      scratch, chunks, c, dgamma, dbeta);
  return cudaGetLastError();
}

}  // namespace

// The scratch the backward needs, in blocks of [2, C] floats: at most this
// many per SM.
extern "C" int ppt_layer_norm_relu_scratch_blocks_per_sm() {
  return kMaxBlocksPerSm;
}

// x: float [rows, c], gamma and beta: float [c]; out a: float [rows, c],
// mean and rstd: float [rows].
extern "C" int ppt_layer_norm_relu_fwd(const float* x, const float* gamma,
                                       const float* beta, int rows, int c,
                                       float eps, float* a, float* mean,
                                       float* rstd, cudaStream_t stream) {
  if (rows < 0 || c <= 0) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  if (aligned16(x, gamma, beta, a)) {
    switch (c) {
      case 32:
        return forward<8, 1, 2>(x, gamma, beta, rows, eps, a, mean, rstd,
                                 stream);
      case 64:
        return forward<16, 1, 2>(x, gamma, beta, rows, eps, a, mean, rstd,
                                  stream);
      case 96:
        return forward<8, 3, 1>(x, gamma, beta, rows, eps, a, mean, rstd,
                                 stream);
      case 128:
        return forward<32, 1, 2>(x, gamma, beta, rows, eps, a, mean, rstd,
                                  stream);
      case 256:
        return forward<32, 2, 1>(x, gamma, beta, rows, eps, a, mean, rstd,
                                  stream);
      case 512:
        return forward<32, 4, 1>(x, gamma, beta, rows, eps, a, mean, rstd,
                                  stream);
      case 1024:
        return forward<32, 8, 1>(x, gamma, beta, rows, eps, a, mean, rstd,
                                  stream);
      default: break;
    }
    if (c % 4 == 0)
      return forward_wide(x, gamma, beta, rows, c / 4, eps, a, mean, rstd,
                          stream);
  }
  return forward_generic(x, gamma, beta, rows, c, eps, a, mean, rstd, stream);
}

// da and x: float [rows, c]; mean, rstd: float [rows] (the forward's);
// gamma, beta: float [c]; scratch: float [scratch_blocks, 2, c], at least
// ppt_layer_norm_relu_scratch_blocks_per_sm() x the SMs; out dx: float
// [rows, c], dgamma and dbeta: float [c].
extern "C" int ppt_layer_norm_relu_bwd(const float* da, const float* x,
                                       const float* mean, const float* rstd,
                                       const float* gamma, const float* beta,
                                       int rows, int c, float* scratch,
                                       int scratch_blocks, float* dx,
                                       float* dgamma, float* dbeta,
                                       cudaStream_t stream) {
  if (rows < 0 || c <= 0 || scratch_blocks < 1) return cudaErrorInvalidValue;
  if (rows == 0) {  // no row: the parameter gradients are 0
    cudaError_t err = cudaMemsetAsync(dgamma, 0, sizeof(float) * c, stream);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(dbeta, 0, sizeof(float) * c, stream);
  }
  if (aligned16(da, x, gamma, beta, dx)) {
    switch (c) {
      case 32:
        return backward<8, 1, 2>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                  scratch_blocks, dx, dgamma, dbeta, stream);
      case 64:
        return backward<16, 1, 2>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                   scratch_blocks, dx, dgamma, dbeta, stream);
      case 96:
        return backward<8, 3, 1>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                  scratch_blocks, dx, dgamma, dbeta, stream);
      case 128:
        return backward<32, 1, 2>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                   scratch_blocks, dx, dgamma, dbeta, stream);
      case 256:
        return backward<32, 2, 1>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                   scratch_blocks, dx, dgamma, dbeta, stream);
      case 512:
        return backward<32, 4, 1>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                   scratch_blocks, dx, dgamma, dbeta, stream);
      case 1024:
        return backward<32, 8, 1>(da, x, mean, rstd, gamma, beta, rows, scratch,
                                   scratch_blocks, dx, dgamma, dbeta, stream);
      default: break;
    }
  }
  return backward_generic(da, x, mean, rstd, gamma, beta, rows, c, scratch,
                          scratch_blocks, dx, dgamma, dbeta, stream);
}
