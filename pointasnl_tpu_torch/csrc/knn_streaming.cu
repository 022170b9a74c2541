// Exact k-nearest-neighbour search with the support streamed through shared
// memory and pruned by exact spatial bounds, for Hopper (sm_90a): every
// search the resident and spatial kernels do not take (N > 2^21, or k > 128
// at any N).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/knn.py:_knn_kernel (the
// streaming kernel, reached through _knn_scan from knn_point).
//
// Contract: the plain knn_point's. support (B, N, 3), query (B, M, 3)
// float32 -> dist2 (B, M, k) float32 ascending and clamped at >= 0, idx
// (B, M, k) int32, for 1 <= k <= 512 and 1 <= N <= 2^28. Distances are direct
// differences, (dx*dx + dy*dy) + dz*dz, each step rounded on its own
// (__fmul_rn / __fadd_rn), the formula of the plain version and of
// csrc/knn.cu. Equal distances go to the lower support index, so a query
// that lies in the support is its own first neighbour. When k > N the last
// valid neighbour fills the remaining slots (ops/geometry.py:knn_point).
//
// What bounds it on the card. Brute force cannot come near the operations
// bound: a pair costs 8 rounded adds and multiplies and a compare, each
// issued once a lane and cycle, so 2228224^2 pairs need at least 1.34 s on
// the H100's 132 x 128 lanes at 1.98 GHz. What the function needs is its
// inputs read and its rows written once, and the M * k pairs of its result;
// so the kernel tests as few pairs as the bounds allow, and the candidates
// tested (pairs_tested in the wrapper) and their insertions are its cost.
//
// The plan, made around the kernel in plain tensor ops on the device
// (ops/cuda/knn_spatial.py:make_plan, the spatial kernel's): the support
// sorted by Morton code into segments of seg_w points with bounding spheres
// (radii with an absolute slack of 1e-5 of the extent), the queries sorted
// the same way into tiles of `tile` queries with their own spheres, and for
// each tile its segments in ascending order of the squared lower bound
// max(0, |qc - sc| - qr - sr)^2, with those bounds. The segment width grows
// from 64 by powers of two until the plan holds at most 2^26 (tile, segment)
// entries (ops/cuda/knn_streaming.py:segment_width); a segment is staged in
// chunks of kChunk points, so any width streams. The output rows are in the
// queries' sorted order; the wrapper puts them back in the caller's.
//
// The kernel: one block a tile, one thread a query, each row's running
// top-k sorted by (d2, original id) in shared memory (slot j of row r at
// j * tile + r, so a warp's accesses never share a bank), its kth entry in
// registers. The block walks its tile's segments nearest first. A row tests
// a segment only if max(0, |q - c| - r)^2 <= its kth d2; a segment no row
// wants is not staged. A staged chunk holds (x, y, z, id) a point, one
// broadcast load a candidate; a passing row tests eight candidates with one
// branch and inserts those below its kth (d2, id). After each visit the
// block takes the largest kth of its rows, and the walk stops when the next
// segment's lower bound exceeds it: no candidate there can displace an
// entry, not even a tie with a lower id, since every comparison is <=.
// Rows that have not found k points hold an infinite kth, so with k > N
// every segment is visited. The tile shrinks with k (128 queries up to
// k = 128, 64 to 256, 32 to 512) so that the lists stay within 128 KB.
// Blocks share nothing, and a row's result is the k least (d2, id) of the
// points it tested, which include every point that could enter: the result
// does not depend on the order of the visit or of the blocks.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;          // support points staged at once (16 KB)
constexpr int kMaxK = 512;
constexpr int kMaxN = 1 << 28;        // indices and loop counters stay in int32
constexpr int kMaxTile = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (d, i) before (od, oi) in the order of the output rows.
__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

// Insert (d, id) into the thread's sorted list if it precedes the kth entry.
__device__ __forceinline__ void consider(float d, int id, float* run_d, int* run_i, int k,
                                         int T, int tid, float& kth_d, int& kth_i) {
  if (!before(d, id, kth_d, kth_i)) return;
  int p = k - 1;  // shift the larger entries up by one
  for (; p > 0; --p) {
    const float pd = run_d[(p - 1) * T + tid];
    const int pi = run_i[(p - 1) * T + tid];
    if (!before(d, id, pd, pi)) break;
    run_d[p * T + tid] = pd;
    run_i[p * T + tid] = pi;
  }
  run_d[p * T + tid] = d;
  run_i[p * T + tid] = id;
  kth_d = run_d[(k - 1) * T + tid];
  kth_i = run_i[(k - 1) * T + tid];
}

__global__ void __launch_bounds__(kMaxTile) knn_stream_kernel(
    const float* __restrict__ query,      // (B, M, 3), sorted
    const float* __restrict__ support,    // (B, N, 3), sorted
    const int32_t* __restrict__ ids,      // (B, N) original index of each sorted point
    const float4* __restrict__ spheres,   // (B, S) segment centre and radius
    const int32_t* __restrict__ order,    // (B, T, S) a tile's segments, nearest first
    const float* __restrict__ lower,      // (B, T, S) their squared lower bounds
    float* __restrict__ dist_out, int32_t* __restrict__ idx_out,  // (B, M, k), sorted rows
    unsigned long long* __restrict__ tested,  // pairs tested, or null
    int n, int m, int k, int seg_w, int n_seg, int n_tile) {
  extern __shared__ float4 chunk[];  // kChunk points, then the lists
  float* run_d = reinterpret_cast<float*>(chunk + kChunk);  // [k][T]
  int* run_i = reinterpret_cast<int*>(run_d + (size_t)k * blockDim.x);
  __shared__ float warp_kth[kMaxTile / 32];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.x, b = blockIdx.y;
  const int row = t * T + tid;
  const bool active = row < m;
  const float inf = __int_as_float(0x7f800000);
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (active) {
    const float* q = query + ((size_t)b * m + row) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  for (int j = 0; j < k; ++j) {
    run_d[j * T + tid] = inf;
    run_i[j * T + tid] = INT_MAX;
  }
  // The row's kth entry. A row past M holds -1: it passes no gate and never
  // raises the tile's bound.
  float kth_d = active ? inf : -1.0f;
  int kth_i = INT_MAX;
  unsigned long long n_tested = 0;

  const float* s = support + (size_t)b * n * 3;
  const int32_t* sids = ids + (size_t)b * n;
  const float4* sph = spheres + (size_t)b * n_seg;
  const size_t plan = ((size_t)b * n_tile + t) * n_seg;
  float bound = inf;  // the largest kth of the tile's rows
  for (int v = 0; v < n_seg && lower[plan + v] <= bound; ++v) {
    const int seg = order[plan + v];
    const float4 c = sph[seg];
    const float gap = fmaxf(sqrtf(sqdist(qx, qy, qz, c.x, c.y, c.z)) - c.w, 0.0f);
    const bool pass = active && __fmul_rn(gap, gap) <= kth_d;
    if (!__syncthreads_or(pass)) continue;  // also: the last visit's reads are done

    const int base = seg * seg_w;
    const int cnt = min(seg_w, n - base);
    for (int c0 = 0; c0 < cnt; c0 += kChunk) {
      const int cc = min(kChunk, cnt - c0);
      if (c0 > 0) __syncthreads();  // the last chunk's reads are done
      for (int j = tid; j < cc; j += T) {
        const float* p = s + (size_t)(base + c0 + j) * 3;
        chunk[j] = make_float4(p[0], p[1], p[2], __int_as_float(sids[base + c0 + j]));
      }
      __syncthreads();
      if (pass) {
        int j = 0;
        for (; j + kUnroll <= cc; j += kUnroll) {
          float d[kUnroll];
          bool any = false;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float4 p = chunk[j + u];
            d[u] = sqdist(qx, qy, qz, p.x, p.y, p.z);
            any |= d[u] <= kth_d;
          }
          if (any) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              consider(d[u], __float_as_int(chunk[j + u].w), run_d, run_i, k, T, tid, kth_d,
                       kth_i);
          }
        }
        for (; j < cc; ++j) {
          const float4 p = chunk[j];
          consider(sqdist(qx, qy, qz, p.x, p.y, p.z), __float_as_int(p.w), run_d, run_i, k, T,
                   tid, kth_d, kth_i);
        }
      }
    }
    if (pass) n_tested += cnt;
    float w = kth_d;
    for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    if ((tid & 31) == 0) warp_kth[tid >> 5] = w;
    __syncthreads();
    bound = warp_kth[0];
    for (int i = 1; i < T / 32; ++i) bound = fmaxf(bound, warp_kth[i]);
  }

  if (active) {
    float* dout = dist_out + ((size_t)b * m + row) * k;
    int32_t* iout = idx_out + ((size_t)b * m + row) * k;
    const int last = min(k, n) - 1;  // k > N: repeat the last neighbour
    for (int j = 0; j < k; ++j) {
      const int src = min(j, last);
      dout[j] = fmaxf(run_d[src * T + tid], 0.0f);
      iout[j] = run_i[src * T + tid];
    }
  }
  if (tested != nullptr && n_tested != 0) atomicAdd(tested, n_tested);
}

size_t smem_bytes(int tile, int k) {
  return (size_t)kChunk * sizeof(float4) + (size_t)tile * k * (sizeof(float) + sizeof(int));
}

}  // namespace

extern "C" {

// Largest N and k the kernel takes.
int pasnl_knn_streaming_max_n() { return kMaxN; }
int pasnl_knn_streaming_max_k() { return kMaxK; }

int pasnl_knn_streaming(const void* query, const void* support, const void* ids,
                        const void* spheres, const void* order, const void* lower, void* dist,
                        void* idx, void* tested, int b, int n, int m, int k, int seg_w,
                        int n_seg, int n_tile, int tile, void* stream) {
  if (k < 1 || k > kMaxK || n < 1 || n > kMaxN || m < 1 || b < 1 || b > 65535 || seg_w < 1 ||
      n_seg != (n + seg_w - 1) / seg_w || tile < 32 || tile > kMaxTile || tile % 32 != 0 ||
      n_tile != (m + tile - 1) / tile) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(tile, k);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  // Always: the static warp_kth counts against the default 48 KB too.
  err = cudaFuncSetAttribute(knn_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_tile, b);
  knn_stream_kernel<<<grid, tile, smem, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)support, (const int32_t*)ids, (const float4*)spheres,
      (const int32_t*)order, (const float*)lower, (float*)dist, (int32_t*)idx,
      (unsigned long long*)tested, n, m, k, seg_w, n_seg, n_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
