// Exact k-nearest-neighbour search pruned by exact spatial bounds, for Hopper
// (sm_90a): the whole-scene kNN (12288 < N <= 2^21).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/knn_spatial.py:
// _knn_spatial_kernel (wrapper _knn_spatial, reached from knn.py:knn_point
// past RESIDENT_MAX_N).
//
// Contract: the plain knn_point's. Squared distances ascending, clamped at
// >= 0; equal distances go to the lower original support index, so a query
// that lies in the support is its own first neighbour. Distances are direct
// differences, (dx*dx + dy*dy) + dz*dz, each step rounded on its own
// (__fmul_rn / __fadd_rn), the formula of the plain version and of
// csrc/knn.cu, so all three rank the same neighbours.
//
// The plan, made around the kernel in plain tensor ops on the device
// (ops/cuda/knn_spatial.py:make_plan): the support is sorted by 30-bit Morton
// code into segments of seg_w points with bounding spheres, whose radii carry
// an absolute slack of 1e-5 of the scene's extent for the float32
// cancellation of |q - c| - r, and packed as (x, y, z, original id) in one
// 16-byte word a point; the queries are sorted the same way into tiles of
// kTile with their own spheres; and each tile gets the segments in ascending
// order of the squared lower bound max(0, |qc - sc| - qr - sr)^2, with those
// bounds. The kernel's output rows are in the queries' sorted order; the
// wrapper puts them back in the caller's.
//
// What bounds it on the card: the candidates tested and the latency of
// reaching them. Each costs 8 flops and a compare, and a few shuffles when it
// enters a list; device memory is touched to read visited segments (from L2:
// the packed support of a 278528-point level is 4.5 MB) and to write the
// rows. The segments are narrow (64 points up to N = 131072), so that their
// spheres hug the points and a query tests few candidates.
//
// The kernel: a warp takes one query, its running top-k held across the
// warp's lanes in registers (csrc/knn_select.cuh); for k <= 4 a warp takes
// 32 queries, a lane each (knn_spatial_kernel_by_lane, below). The warp walks
// its tile's order alone, no block barrier anywhere: its lanes read 32 visit
// positions at once and compute each position's gate, max(0, |q - c| - r)^2;
// the warp then visits, in order, the positions whose gate is <= the kth d2,
// and stops at the first position whose lower bound exceeds it: no
// candidate there can displace an entry, not even a tie with a lower id,
// since every comparison is <=. A visited segment's points are read by the
// lanes straight from device memory (L2), 32 at a time, the next 32 in
// flight while these are tested. Rows that have not found k points hold an
// infinite kth. A query's walk can only stop earlier than the tile-wide walk
// of the streaming kernel, never skip a candidate that could enter: its
// visits and gates are the same up to its stop. Warps share nothing, and a
// row's result is the k least (d2, id) of the points it tested, which
// include every point that could enter. One query a warp, not 2 or 4 sharing
// each load: on the card the shared loads did not pay for the walks the
// queries then take together (PERF.md, section 6).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using namespace knn_select;

constexpr int kTile = 128;      // queries a tile of the plan
constexpr int kWarps = 4;       // warps a block
constexpr int kMaxSeg = 1024;   // widest segment the plan makes
constexpr int kMaxSegments = 2048;
constexpr int kMaxK = 128;
constexpr int kMaxN = kMaxSeg * kMaxSegments;  // 2^21, with a single-level visit order

template <int E>
__global__ void __launch_bounds__(kWarps * 32) knn_spatial_kernel(
    const float* __restrict__ query,      // (B, M, 3), sorted
    const float4* __restrict__ points,    // (B, N) sorted (x, y, z, id as float bits)
    const float4* __restrict__ spheres,   // (B, S) segment centre and radius
    const int32_t* __restrict__ order,    // (B, T, S) a tile's segments, nearest first
    const float* __restrict__ lower,      // (B, T, S) their squared lower bounds
    float* __restrict__ dist_out, int32_t* __restrict__ idx_out,  // (B, M, k), sorted rows
    unsigned long long* __restrict__ tested,  // pairs tested, or null
    int n, int m, int k, int seg_w, int n_seg, int n_tile) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // the warp's query
  if (row >= m) return;  // no barrier follows
  const float inf = __int_as_float(0x7f800000);
  const float* q = query + ((size_t)b * m + row) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  List<E> list;
  init(list, true);

  const float4* pts = points + (size_t)b * n;
  const float4* sph = spheres + (size_t)b * n_seg;
  const size_t plan = ((size_t)b * n_tile + row / kTile) * n_seg;
  unsigned long long n_tested = 0;
  for (int v0 = 0; v0 < n_seg; v0 += 32) {
    // This lane's visit position: its lower bound, segment and gate.
    const int v = v0 + lane;
    const bool in = v < n_seg;
    const float lo = in ? lower[plan + v] : inf;
    const int seg = in ? order[plan + v] : 0;
    const float4 c = sph[seg];
    const float gap = fmaxf(sqrtf(sqdist(qx, qy, qz, c.x, c.y, c.z)) - c.w, 0.0f);
    const float gap2 = __fmul_rn(gap, gap);
    unsigned taken = 0;  // positions visited or passed over
    bool stop = false;
    for (;;) {
      // The walk reaches the positions before the first whose lower bound
      // exceeds the kth d2 (or past the order); of those it visits the ones
      // whose gate holds, in order.
      const unsigned past = __ballot_sync(kFull, !in || lo > list.kth_d);
      const unsigned reach = past ? (1u << (__ffs(past) - 1)) - 1 : kFull;
      const unsigned go = __ballot_sync(kFull, gap2 <= list.kth_d) & reach & ~taken;
      if (go == 0) {
        stop = past != 0;
        break;
      }
      const int j = __ffs(go) - 1;
      taken |= j == 31 ? kFull : (2u << j) - 1;
      const int base = __shfl_sync(kFull, seg, j) * seg_w;
      const int cnt = min(seg_w, n - base);
      n_tested += cnt;
      float4 next = lane < cnt ? __ldg(pts + base + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c0 = 0; c0 < cnt; c0 += 32) {
        const float4 p = next;
        const bool valid = c0 + lane < cnt;
        if (c0 + 32 < cnt)  // the next 32 points are on their way while these are tested
          next = c0 + 32 + lane < cnt ? __ldg(pts + base + c0 + 32 + lane) : p;
        offer(list, sqdist(qx, qy, qz, p.x, p.y, p.z), __float_as_int(p.w), valid, k, lane);
      }
    }
    if (stop) break;
  }

  const size_t out = ((size_t)b * m + row) * k;
  store(list, dist_out + out, idx_out + out, k, n, lane);
  if (tested != nullptr && lane == 0 && n_tested != 0) atomicAdd(tested, n_tested);
}

// Small k (k <= kLaneK, three_nn): a lane per query, 32 queries a warp,
// each list in its own lane's registers. The warp walks the tile's order as
// above, visit position by visit position; the lanes whose gate holds read
// the segment's points with one broadcast load each (the same address in
// every lane, so one load serves up to 32 queries) and insert in their own
// lists.
constexpr int kUnroll = 8;

template <int K>
__global__ void __launch_bounds__(kWarps * 32) knn_spatial_kernel_by_lane(
    const float* __restrict__ query, const float4* __restrict__ points,
    const float4* __restrict__ spheres, const int32_t* __restrict__ order,
    const float* __restrict__ lower, float* __restrict__ dist_out, int32_t* __restrict__ idx_out,
    unsigned long long* __restrict__ tested, int n, int m, int k, int seg_w, int n_seg,
    int n_tile) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (q0 >= m) return;  // no barrier follows
  const float inf = __int_as_float(0x7f800000);
  const int row = q0 + lane;
  const bool active = row < m;
  const float* q = query + ((size_t)b * m + (active ? row : q0)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  LaneList<K> list;
  init(list, active);

  const float4* pts = points + (size_t)b * n;
  const float4* sph = spheres + (size_t)b * n_seg;
  const size_t plan = ((size_t)b * n_tile + q0 / kTile) * n_seg;
  unsigned long long n_tested = 0;
  float bound = inf;  // the largest kth d2 of the warp's queries
  bool stop = false;
  for (int v0 = 0; v0 < n_seg && !stop; v0 += 32) {
    const int v = v0 + lane;  // this lane holds visit position v0 + lane for the warp
    const float lo_l = v < n_seg ? lower[plan + v] : inf;
    const int seg_l = v < n_seg ? order[plan + v] : 0;
    const float4 c_l = sph[seg_l];
    const int count = min(32, n_seg - v0);
    for (int j = 0; j < count; ++j) {
      if (__shfl_sync(kFull, lo_l, j) > bound) {
        stop = true;
        break;
      }
      const int seg = __shfl_sync(kFull, seg_l, j);
      const float cx = __shfl_sync(kFull, c_l.x, j), cy = __shfl_sync(kFull, c_l.y, j);
      const float cz = __shfl_sync(kFull, c_l.z, j), cr = __shfl_sync(kFull, c_l.w, j);
      const float gap = fmaxf(sqrtf(sqdist(qx, qy, qz, cx, cy, cz)) - cr, 0.0f);
      const bool gate = __fmul_rn(gap, gap) <= list.kth_d;
      const unsigned gates = __ballot_sync(kFull, gate);
      if (gates == 0) continue;
      const int base = seg * seg_w;
      const int cnt = min(seg_w, n - base);
      n_tested += (unsigned long long)__popc(gates) * cnt;
      if (gate) {
        const float4* sp = pts + base;
        int c = 0;
        for (; c + kUnroll <= cnt; c += kUnroll) {
          float4 p[kUnroll];
          float d[kUnroll];
          bool any = false;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            p[u] = __ldg(sp + c + u);
            d[u] = sqdist(qx, qy, qz, p[u].x, p[u].y, p[u].z);
            any |= d[u] <= list.kth_d;
          }
          if (any) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              offer(list, d[u], __float_as_int(p[u].w), true, k, lane);
          }
        }
        for (; c < cnt; ++c) {
          const float4 p = __ldg(sp + c);
          offer(list, sqdist(qx, qy, qz, p.x, p.y, p.z), __float_as_int(p.w), true, k, lane);
        }
      }
      bound = list.kth_d;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bound = fmaxf(bound, __shfl_xor_sync(kFull, bound, off));
    }
  }

  if (active) {
    float* dout = dist_out + ((size_t)b * m + row) * k;
    int32_t* iout = idx_out + ((size_t)b * m + row) * k;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      dout[p] = fmaxf(list.d[p], 0.0f);
      iout[p] = list.i[p];
    }
  }
  if (tested != nullptr && lane == 0 && n_tested != 0) atomicAdd(tested, n_tested);
}

template <int E>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* query, const float4* points,
                   const float4* spheres, const int32_t* order, const float* lower, float* dist,
                   int32_t* idx, unsigned long long* tested, int n, int m, int k, int seg_w,
                   int n_seg, int n_tile) {
  knn_spatial_kernel<E><<<grid, kWarps * 32, 0, stream>>>(
      query, points, spheres, order, lower, dist, idx, tested, n, m, k, seg_w, n_seg, n_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The query tile of the plan, which the wrapper checks against its own.
int pasnl_knn_spatial_tile() { return kTile; }

// `group`: queries a warp, 1, or 32 for k <= kLaneK, a lane a query
// (ops/cuda/knn_spatial.py:walk_rows).
int pasnl_knn_spatial(const void* query, const void* points, const void* spheres,
                      const void* order, const void* lower, void* dist, void* idx, void* tested,
                      int b, int n, int m, int k, int seg_w, int n_seg, int n_tile, int group,
                      void* stream) {
  if (k < 1 || k > kMaxK || n < k || n > kMaxN || m < 1 || b < 1 || b > 65535 || seg_w < 1 ||
      seg_w > kMaxSeg || n_seg != (n + seg_w - 1) / seg_w || n_seg > kMaxSegments ||
      n_tile != (m + kTile - 1) / kTile || group != (k <= kLaneK ? 32 : 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_block = kWarps * group;
  const dim3 grid((m + per_block - 1) / per_block, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (group == 32) {
#define KNN_SPATIAL_BY_LANE(K)                                                          \
  knn_spatial_kernel_by_lane<K><<<grid, kWarps * 32, 0, st>>>(                          \
      (const float*)query, (const float4*)points, (const float4*)spheres,               \
      (const int32_t*)order, (const float*)lower, (float*)dist, (int32_t*)idx,          \
      (unsigned long long*)tested, n, m, k, seg_w, n_seg, n_tile)
    switch (k) {
      case 1: KNN_SPATIAL_BY_LANE(1); break;
      case 2: KNN_SPATIAL_BY_LANE(2); break;
      case 3: KNN_SPATIAL_BY_LANE(3); break;
      default: KNN_SPATIAL_BY_LANE(4); break;
    }
#undef KNN_SPATIAL_BY_LANE
    return (int)cudaGetLastError();
  }
  const float* q = (const float*)query;
  const float4* p = (const float4*)points;
  const float4* sp = (const float4*)spheres;
  const int32_t* o = (const int32_t*)order;
  const float* lo = (const float*)lower;
  unsigned long long* t = (unsigned long long*)tested;
  switch (entries_for(k)) {
    case 1: return (int)launch<1>(grid, st, q, p, sp, o, lo, (float*)dist, (int32_t*)idx, t, n, m, k, seg_w, n_seg, n_tile);
    case 2: return (int)launch<2>(grid, st, q, p, sp, o, lo, (float*)dist, (int32_t*)idx, t, n, m, k, seg_w, n_seg, n_tile);
    default: return (int)launch<4>(grid, st, q, p, sp, o, lo, (float*)dist, (int32_t*)idx, t, n, m, k, seg_w, n_seg, n_tile);
  }
}

}  // extern "C"
