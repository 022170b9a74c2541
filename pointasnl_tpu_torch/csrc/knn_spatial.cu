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
// cancellation of |q - c| - r; the queries are sorted the same way into tiles
// of kTile with their own spheres; and each tile gets the segments in
// ascending order of the squared lower bound max(0, |qc - sc| - qr - sr)^2,
// with those bounds. The kernel's output rows are in the queries' sorted
// order; the wrapper puts them back in the caller's.
//
// The kernel: one block per tile, one thread per query row, each row's
// running top-k kept sorted by (d2, original id) in shared memory (slot j of
// row r at j * kTile + r, so a warp's accesses never share a bank). The
// block walks its tile's segments nearest first. A row tests a segment only
// if its own gate holds, max(0, |q - c| - r)^2 <= its kth d2; a segment no
// row wants is not even staged. A visited segment's xyz and ids are staged
// in shared memory, and each passing row merges every candidate whose
// (d2, id) is below its kth (d2, id) by insertion. After each visit the
// block takes the largest kth of its rows, and the walk stops when the next
// segment's lower bound exceeds it: no candidate there can displace an
// entry, not even a tie with a lower id, since every comparison is <=.
// Blocks run in any order and share nothing.
//
// What bounds it on the card: the candidates tested. Each costs 8 flops and
// a compare, and an insertion of up to k slots when it enters; device memory
// is touched only to stage visited segments (from L2: the sorted support of
// a scene is 1.5 MB) and to write the rows. So the segments are narrow: a
// row tests whole segments, and the narrower they are, the closer their
// spheres hug the points and the fewer candidates a row tests (64 points up
// to N = 131072, where JAX's 512 suits the TPU's wide vector unit). They
// widen past that so that a tile's visit order never exceeds 2048 segments.
// The wrapper's pairs_tested counts the candidates.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // queries a block, one thread a query
constexpr int kMaxSeg = 1024;   // widest segment the plan makes
constexpr int kMaxSegments = 2048;
constexpr int kMaxK = 128;
constexpr int kMaxN = kMaxSeg * kMaxSegments;  // 2^21, with a single-level visit order

__device__ __forceinline__ float sqdist(float ax, float ay, float az, float bx, float by,
                                        float bz) {
  const float dx = ax - bx, dy = ay - by, dz = az - bz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (d, i) before (od, oi) in the order of the output rows.
__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

__global__ void __launch_bounds__(kTile) knn_spatial_kernel(
    const float* __restrict__ query,      // (B, M, 3), sorted
    const float* __restrict__ support,    // (B, N, 3), sorted
    const int32_t* __restrict__ ids,      // (B, N) original index of each sorted point
    const float4* __restrict__ spheres,   // (B, S) segment centre and radius
    const int32_t* __restrict__ order,    // (B, T, S) a tile's segments, nearest first
    const float* __restrict__ lower,      // (B, T, S) their squared lower bounds
    float* __restrict__ dist_out, int32_t* __restrict__ idx_out,  // (B, M, k), sorted rows
    unsigned long long* __restrict__ tested,  // pairs tested, or null
    int n, int m, int k, int seg_w, int n_seg, int n_tile) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + seg_w;
  float* sz = sy + seg_w;
  int* sid = reinterpret_cast<int*>(sz + seg_w);
  float* run_d = reinterpret_cast<float*>(sid + seg_w);  // [k][kTile]
  int* run_i = reinterpret_cast<int*>(run_d + (size_t)k * kTile);
  __shared__ float warp_kth[kTile / 32];

  const int tid = threadIdx.x;
  const int t = blockIdx.x, b = blockIdx.y;
  const int row = t * kTile + tid;
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
    run_d[j * kTile + tid] = inf;
    run_i[j * kTile + tid] = INT_MAX;
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
    for (int j = tid; j < cnt; j += kTile) {
      const float* p = s + (size_t)(base + j) * 3;
      sx[j] = p[0];
      sy[j] = p[1];
      sz[j] = p[2];
      sid[j] = sids[base + j];
    }
    __syncthreads();
    if (pass) {
      for (int j = 0; j < cnt; ++j) {
        const float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
        const int id = sid[j];
        if (!before(d, id, kth_d, kth_i)) continue;
        int p = k - 1;  // insert, shifting the larger entries up by one
        for (; p > 0; --p) {
          const float pd = run_d[(p - 1) * kTile + tid];
          const int pi = run_i[(p - 1) * kTile + tid];
          if (!before(d, id, pd, pi)) break;
          run_d[p * kTile + tid] = pd;
          run_i[p * kTile + tid] = pi;
        }
        run_d[p * kTile + tid] = d;
        run_i[p * kTile + tid] = id;
        kth_d = run_d[(k - 1) * kTile + tid];
        kth_i = run_i[(k - 1) * kTile + tid];
      }
      n_tested += cnt;
    }
    float w = kth_d;
    for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    if ((tid & 31) == 0) warp_kth[tid >> 5] = w;
    __syncthreads();
    bound = warp_kth[0];
    for (int i = 1; i < kTile / 32; ++i) bound = fmaxf(bound, warp_kth[i]);
  }

  if (active) {
    float* dout = dist_out + ((size_t)b * m + row) * k;
    int32_t* iout = idx_out + ((size_t)b * m + row) * k;
    for (int j = 0; j < k; ++j) {
      dout[j] = fmaxf(run_d[j * kTile + tid], 0.0f);
      iout[j] = run_i[j * kTile + tid];
    }
  }
  if (tested != nullptr && n_tested != 0) atomicAdd(tested, n_tested);
}

}  // namespace

extern "C" {

// The query tile of the plan, which the wrapper checks against its own.
int pasnl_knn_spatial_tile() { return kTile; }

int pasnl_knn_spatial(const void* query, const void* support, const void* ids,
                      const void* spheres, const void* order, const void* lower, void* dist,
                      void* idx, void* tested, int b, int n, int m, int k, int seg_w,
                      int n_seg, int n_tile, void* stream) {
  if (k < 1 || k > kMaxK || n < k || n > kMaxN || m < 1 || seg_w < 1 || seg_w > kMaxSeg ||
      n_seg != (n + seg_w - 1) / seg_w || n_seg > kMaxSegments ||
      n_tile != (m + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)seg_w * 4 * sizeof(float) + (size_t)k * kTile * 8;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_spatial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(n_tile, b);
  knn_spatial_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const float*)query, (const float*)support, (const int32_t*)ids, (const float4*)spheres,
      (const int32_t*)order, (const float*)lower, (float*)dist, (int32_t*)idx,
      (unsigned long long*)tested, n, m, k, seg_w, n_seg, n_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
