// The k-nearest lists that the kNN kernels share: the streaming scan
// (knn.cu, K8) and the Morton-ring scan (knn_ring.cu, K9/K10).
//
// A list entry is one 64-bit key, (d bits << 32) | (id << 1) | flag. d >=
// +0, so its bits order as an unsigned integer and the key orders exactly as
// (d, id): the k smallest keys of a set do not depend on the order in which
// they arrive. A scan may therefore split its candidates across lanes, warps
// or launches, queue them, and merge partial lists, and keep the same bits.
// The flag bit (the ring's stats: "inserted from this chunk") never decides
// an order, as no two entries share (d, id).
//
// A lane's list is a RegList (K keys in registers, ascending; an insert is a
// K-step compare-and-swap chain with every index static) or a HeapList (a
// max-heap of K keys, the worst at the root, in its warp's [K][32] slab of
// shared memory or global scratch; an insert is one sift-down). Candidates
// reach a list through a queue in shared memory that the warp merges in
// lockstep (flush): the warp pays for its longest queue, not for the union
// of its lanes' inserts.
#pragma once

#include <stdint.h>

namespace ppt {

using u64 = unsigned long long;

constexpr unsigned kFullMask = 0xffffffffu;
// Above every key: a queue slot that holds nothing.
constexpr u64 kNoKey = ~u64{0};

__device__ __forceinline__ u64 make_key(float d, unsigned id2) {
  return (u64{__float_as_uint(d)} << 32) | id2;
}
__device__ __forceinline__ float key_d(u64 key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}
__device__ __forceinline__ int key_id(u64 key) {
  return static_cast<int>(static_cast<unsigned>(key) >> 1);
}

// A lane's list in registers: K keys, ascending.
template <int K>
struct RegList {
  u64 key[K];

  __device__ __forceinline__ void init(u64 empty) {
#pragma unroll
    for (int s = 0; s < K; ++s) key[s] = empty;
  }
  __device__ __forceinline__ u64 worst() const { return key[K - 1]; }
  // Any key: each slot keeps the smaller of its key and the carried one,
  // so a key not below the worst drops out at the end.
  __device__ __forceinline__ void insert(u64 c) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool lt = c < key[s];
      const u64 a = lt ? c : key[s];
      c = lt ? key[s] : c;
      key[s] = a;
    }
  }
  __device__ __forceinline__ void clear_flags() {
#pragma unroll
    for (int s = 0; s < K; ++s) key[s] &= ~u64{1};
  }
  __device__ __forceinline__ int flags() const {
    int r = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) r += static_cast<int>(key[s] & 1);
    return r;
  }
  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int* __restrict__ out_i, size_t row,
                                        int k) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        out_d[row * k + s] = key_d(key[s]);
        out_i[row * k + s] = key_id(key[s]);
      }
    }
  }
};

// A lane's list as a max-heap of K keys, the worst at the root, in its
// warp's [K][32] slab in shared memory or global scratch: slot s at h[s *
// 32]. An insert replaces the root and sifts down: log2(K) levels of a
// load pair, a compare and a store, where a register list pays a K-step
// chain.
struct HeapList {
  u64* h;
  int K;
  u64 w;  // the root

  __device__ __forceinline__ void init(u64 empty) {
    for (int s = 0; s < K; ++s) h[s * 32] = empty;
    w = empty;
  }
  __device__ __forceinline__ u64 worst() const { return w; }
  // Place c at the root of a heap of n keys whose root is free.
  __device__ __forceinline__ void sift(u64 c, int n) {
    int i = 0;
    for (int l = 1; l < n; l = 2 * i + 1) {
      u64 m = h[l * 32];
      if (l + 1 < n) {
        const u64 r = h[(l + 1) * 32];
        if (m < r) {
          m = r;
          ++l;
        }
      }
      if (!(c < m)) break;
      h[i * 32] = m;
      i = l;
    }
    h[i * 32] = c;
  }
  __device__ __forceinline__ void insert(u64 c) {
    if (!(c < w)) return;
    sift(c, K);
    w = h[0];
  }
  __device__ __forceinline__ void clear_flags() {
    for (int s = 0; s < K; ++s) h[s * 32] &= ~u64{1};
    w &= ~u64{1};
  }
  __device__ __forceinline__ int flags() const {
    int r = 0;
    for (int s = 0; s < K; ++s) r += static_cast<int>(h[s * 32] & 1);
    return r;
  }
  // Pops the keys from the largest down; the k smallest land in order.
  __device__ __forceinline__ void store(float* __restrict__ out_d,
                                        int* __restrict__ out_i, size_t row,
                                        int k) {
    for (int n = K; n > 0; --n) {
      const u64 top = h[0];
      if (n <= k) {
        out_d[row * k + n - 1] = key_d(top);
        out_i[row * k + n - 1] = key_id(top);
      }
      sift(h[(n - 1) * 32], n - 1);
    }
  }
};

// K > 0: RegList<K>; otherwise a HeapList of k_pad slots bound to this
// lane's column: K == -1 in a slab of shared memory, K == 0 in the global
// scratch `lists` ([warps][k_pad][32] keys, this warp's index `warp`).
template <int K>
struct ListOf {
  using type = RegList<K>;
  __device__ static void bind(type&, u64*, u64*, size_t, int, int) {}
};
template <>
struct ListOf<-1> {
  using type = HeapList;
  __device__ static void bind(type& list, u64*, u64* slab, size_t, int k_pad,
                              int lane) {
    list.h = slab + lane;
    list.K = k_pad;
  }
};
template <>
struct ListOf<0> {
  using type = HeapList;
  __device__ static void bind(type& list, u64* lists, u64*, size_t warp,
                              int k_pad, int lane) {
    list.h = lists + warp * k_pad * 32 + lane;
    list.K = k_pad;
  }
};

// Merge every lane's queued keys (slot s at q[s * 32 + lane]) into the
// lists, the warp in lockstep for as many rounds as its longest queue.
template <class List>
__device__ __forceinline__ void flush(const u64* q, int lane, int& qn,
                                      List& list) {
#pragma unroll 1
  for (int s = 0; __any_sync(kFullMask, s < qn); ++s)
    list.insert(s < qn ? q[s * 32 + lane] : kNoKey);
  qn = 0;
}

}  // namespace ppt
