// Exact k-selection in registers, for Hopper (sm_90a): the running top-k of
// a query held across the 32 lanes of a warp (List) or, for k <= 4, in one
// lane (LaneList, at the end of this file), shared by the resident kNN
// (csrc/knn.cu) and the spatially pruned kNN (csrc/knn_spatial.cu).
//
// The order is (d2, original support index): a total order, so the k least
// of a set do not depend on the order in which its members are offered, and
// equal distances go to the lower index. Distances are direct differences,
// (dx*dx + dy*dy) + dz*dz, each step rounded on its own (__fmul_rn /
// __fadd_rn: no fma contraction), the formula of the plain knn_point.
//
// The list. Position p = e * 32 + lane of a sorted run of 32 * E entries is
// entry e of lane `lane` (E = 1, 2 or 4: k up to 32, 64 or 128). Positions
// 0 .. k-1 are the k least (d2, id) offered so far; the positions past k-1
// hold entries no smaller, which are never read out. Empty positions hold
// (+inf, INT_MAX). The kth entry, position k-1, is kept in every lane
// (kth_d, kth_i), so a lane tests its candidate against it alone.
//
// An offer. Each lane brings one candidate (a support point); the warp's
// ballot picks those before the kth entry. Few of them are inserted one at a
// time: the candidate is broadcast, every position compares itself with it,
// and one __shfl_up_sync moves the entries behind it up by one position
// (entry e of lane 0 takes entry e-1 of lane 31); after each, the lanes
// still waiting test themselves against the new kth entry. Many of them
// (at least kMergeMin) are merged at once: the warp sorts the 32 candidates
// (a bitonic sort, non-passing lanes as (+inf, INT_MAX)), takes the lesser
// of each of the list's last 32 positions and the reversed candidates (the
// list then holds the 32 * E least of both as a bitonic run), and sorts that
// run with a bitonic merge: across entries in registers, across lanes by
// __shfl_xor_sync. The first offers of a query fill its list this way.
// No shared memory, no lane that walks the list alone.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace knn_select {

constexpr unsigned kFull = 0xffffffffu;
// Passing candidates from which an offer merges instead of inserting: a merge
// costs about 20 dependent shuffle rounds, an insertion about 4; on the card
// 6 beat 3, 12 and never merging (PERF.md, section 6).
constexpr int kMergeMin = 6;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (d, i) before (od, oi) in the order of the output rows.
__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

// Entries a lane holds of a warp's list of k.
__host__ __device__ constexpr int entries_for(int k) { return k <= 32 ? 1 : k <= 64 ? 2 : 4; }

template <int E>
struct List {
  float d[E];
  int i[E];
  float kth_d;  // position k-1, the same in every lane
  int kth_i;
};

// An empty list. An inactive query (a row past M) holds a kth of -1: no
// candidate passes it, and it never raises a bound taken over a warp's lists.
template <int E>
__device__ __forceinline__ void init(List<E>& L, bool active) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    L.d[e] = __int_as_float(0x7f800000);
    L.i[e] = INT_MAX;
  }
  L.kth_d = active ? __int_as_float(0x7f800000) : -1.0f;
  L.kth_i = INT_MAX;
}

// Position p of the list, in every lane. The entry is chosen by a branch the
// whole warp takes (p is the same in every lane), never by an index into the
// entries, which would move the list out of registers into local memory.
template <int E>
__device__ __forceinline__ void read(const List<E>& L, int p, float& d, int& i) {
  const int ep = p >> 5;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e == ep) {
      d = __shfl_sync(kFull, L.d[e], p & 31);
      i = __shfl_sync(kFull, L.i[e], p & 31);
    }
  }
}

// Lanes `stride` apart exchange; the lane keeps the lesser if keep_min.
__device__ __forceinline__ void exchange(float& d, int& i, int stride, bool keep_min) {
  const float od = __shfl_xor_sync(kFull, d, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (keep_min ? before(od, oi, d, i) : before(d, i, od, oi)) {
    d = od;
    i = oi;
  }
}

// Insert (cd, ci), the same in every lane and before position k-1.
template <int E>
__device__ __forceinline__ void insert(List<E>& L, float cd, int ci, int lane) {
  float pd[E], ld[E];
  int pi[E], li[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    pd[e] = __shfl_up_sync(kFull, L.d[e], 1);
    pi[e] = __shfl_up_sync(kFull, L.i[e], 1);
    if (e + 1 < E) {
      ld[e] = __shfl_sync(kFull, L.d[e], 31);
      li[e] = __shfl_sync(kFull, L.i[e], 31);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bool prev_before = true;  // position 0 has no predecessor
    if (lane == 0) {
      if (e > 0) {  // entry e of lane 0 follows entry e-1 of lane 31
        pd[e] = ld[e - 1];
        pi[e] = li[e - 1];
        prev_before = before(pd[e], pi[e], cd, ci);
      }
    } else {
      prev_before = before(pd[e], pi[e], cd, ci);
    }
    if (!before(L.d[e], L.i[e], cd, ci)) {  // the candidate or a later entry
      L.d[e] = prev_before ? cd : pd[e];
      L.i[e] = prev_before ? ci : pi[e];
    }
  }
}

// Merge the lanes' candidates (non-passing lanes bring (+inf, INT_MAX)).
template <int E>
__device__ __forceinline__ void merge(List<E>& L, float cd, int ci, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(cd, ci, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }
  const float rd = __shfl_sync(kFull, cd, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (before(rd, ri, L.d[E - 1], L.i[E - 1])) {
    L.d[E - 1] = rd;
    L.i[E - 1] = ri;
  }
#pragma unroll
  for (int s = E / 2; s >= 1; s >>= 1) {  // positions 32 * s apart: entries e and e + s
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & s) == 0 && before(L.d[e + s], L.i[e + s], L.d[e], L.i[e])) {
        const float td = L.d[e];
        const int ti = L.i[e];
        L.d[e] = L.d[e + s];
        L.i[e] = L.i[e + s];
        L.d[e + s] = td;
        L.i[e + s] = ti;
      }
    }
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) exchange(L.d[e], L.i[e], stride, (lane & stride) == 0);
  }
}

// Offer each lane's candidate (d, id), where `valid`, to a query's list of k.
// Called by the whole warp.
template <int E>
__device__ __forceinline__ void offer(List<E>& L, float d, int id, bool valid, int k, int lane) {
  bool pending = valid && before(d, id, L.kth_d, L.kth_i);
  unsigned mask = __ballot_sync(kFull, pending);
  if (mask == 0) return;
  if (__popc(mask) >= kMergeMin) {
    merge(L, pending ? d : __int_as_float(0x7f800000), pending ? id : INT_MAX, lane);
    read(L, k - 1, L.kth_d, L.kth_i);
    return;
  }
  do {
    const int src = __ffs(mask) - 1;
    const float cd = __shfl_sync(kFull, d, src);
    const int ci = __shfl_sync(kFull, id, src);
    insert(L, cd, ci, lane);
    read(L, k - 1, L.kth_d, L.kth_i);
    pending = pending && lane != src && before(d, id, L.kth_d, L.kth_i);
    mask = __ballot_sync(kFull, pending);
  } while (mask != 0);
}

// Write positions 0 .. k-1 to dout and iout (one query's row), d2 clamped at
// >= 0; past the n_valid offered points (k > N) the last one repeats.
template <int E>
__device__ __forceinline__ void store(const List<E>& L, float* dout, int32_t* iout, int k,
                                      int n_valid, int lane) {
  float last_d;
  int last_i;
  read(L, min(k, n_valid) - 1, last_d, last_i);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = e * 32 + lane;
    if (p < k) {
      const bool have = p < n_valid;
      dout[p] = fmaxf(have ? L.d[e] : last_d, 0.0f);
      iout[p] = have ? L.i[e] : last_i;
    }
  }
}

// Small k (k <= kLaneK: three_nn's k of 3). A warp-wide insertion costs
// some 35 warp instructions whoever it serves, and with k this small most of
// a query's offers are insertions into the first few positions, so here each
// lane keeps its own sorted list of the candidates it was given, in
// registers: an insertion is a few selects in one lane, and the warp issues
// nothing for it. `LaneList<K>` (K = k) is that list, with the warp list's
// init and offer; its store merges a warp's 32 lists of one query at the end
// (K rounds of a warp argmin over the lanes' heads). Where a lane is a query of its own
// (the spatial kernel's small k), its list is the query's and needs no merge.
constexpr int kLaneK = 4;

template <int K>
struct LaneList {
  float d[K];
  int i[K];
  float kth_d;  // position K-1 of this lane's list
  int kth_i;
};

template <int K>
__device__ __forceinline__ void init(LaneList<K>& L, bool active) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    L.d[p] = __int_as_float(0x7f800000);
    L.i[p] = INT_MAX;
  }
  L.kth_d = active ? __int_as_float(0x7f800000) : -1.0f;
  L.kth_i = INT_MAX;
}

// Offer this lane's candidate to its own list of k = K (the lane argument
// keeps the warp list's signature).
template <int K>
__device__ __forceinline__ void offer(LaneList<K>& L, float d, int id, bool valid, int, int) {
  if (!(valid && before(d, id, L.kth_d, L.kth_i))) return;
#pragma unroll
  for (int p = K - 1; p > 0; --p) {  // from the back: L[p - 1] is still the old entry
    if (!before(L.d[p], L.i[p], d, id)) {
      const bool here = before(L.d[p - 1], L.i[p - 1], d, id);
      L.d[p] = here ? d : L.d[p - 1];
      L.i[p] = here ? id : L.i[p - 1];
    }
  }
  if (!before(L.d[0], L.i[0], d, id)) {
    L.d[0] = d;
    L.i[0] = id;
  }
  L.kth_d = L.d[K - 1];
  L.kth_i = L.i[K - 1];
}

// Write the K least of the warp's 32 lane lists (one query's row) to dout
// and iout, d2 clamped at >= 0; past the n_valid offered points (K > N) the
// last one repeats. Called by the whole warp.
template <int K>
__device__ __forceinline__ void store(const LaneList<K>& L, float* dout, int32_t* iout, int,
                                      int n_valid, int lane) {
  float qd[K];
  int qi[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    qd[p] = L.d[p];
    qi[p] = L.i[p];
  }
  float out_d = 0.0f;
  int out_i = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {  // the r-th least: the least of the lanes' heads
    float md = qd[0];
    int mi = qi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, md, off);
      const int oi = __shfl_xor_sync(kFull, mi, off);
      if (before(od, oi, md, mi)) {
        md = od;
        mi = oi;
      }
    }
    if (qd[0] == md && qi[0] == mi) {  // ids are unique: one lane, or all at the sentinel
#pragma unroll
      for (int p = 0; p + 1 < K; ++p) {
        qd[p] = qd[p + 1];
        qi[p] = qi[p + 1];
      }
      qd[K - 1] = __int_as_float(0x7f800000);
      qi[K - 1] = INT_MAX;
    }
    if (lane == r) {
      out_d = md;
      out_i = mi;
    }
  }
  const int last = min(K, n_valid) - 1;
  const float last_d = __shfl_sync(kFull, out_d, last);
  const int last_i = __shfl_sync(kFull, out_i, last);
  if (lane < K) {
    dout[lane] = fmaxf(lane <= last ? out_d : last_d, 0.0f);
    iout[lane] = lane <= last ? out_i : last_i;
  }
}

}  // namespace knn_select
