// Exact k-nearest-neighbour search, support resident in shared memory, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/knn.py:_knn_kernel_resident
// (reached through _knn_scan from knn_point).
//
// Contract: support (B, N, 3), query (B, M, 3) float32, contiguous ->
// dist2 (B, M, k) float32 ascending and clamped at >= 0, idx (B, M, k) int32.
// Distances are direct differences, (dx*dx + dy*dy) + dz*dz, each step
// rounded on its own. Equal distances go to the lower support index, so a
// query that lies in the support is its own first neighbour. When k > N the
// last valid neighbour fills the remaining slots (ops/geometry.py:167-170).
//
// What bounds it on the card: the selection. k rounds of min-extraction over
// N candidates cost k * N compares a query, against 8 * N flops for the
// distances, so the kernel is bound by shared-memory reads and compares, not
// by device memory (which it reads once and writes k * 8 bytes a query).
//
// What the design does about it: one warp per query, several warps a block,
// all of one cloud. The block stages the support once into shared memory as
// x, y, z rows; each warp writes its query's N distances into its own
// shared-memory row, then runs k rounds of warp argmin over (d2, index) with
// invalidation -- the TPU kernel's min-extraction, without a sort. Lane l owns
// the slots l, l + 32, ..., so it alone reads and invalidates them and the
// rounds need no barrier, only the shuffles. The warps a block holds follow
// from the shared memory that N leaves (8 at N <= 4096, 1 at N = 12288).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kSmemLimit = 227 * 1024;

__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void knn_kernel(const float* __restrict__ support,
                           const float* __restrict__ query,
                           float* __restrict__ dist_out, int32_t* __restrict__ idx_out,
                           int n, int m, int k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* d2 = sz + n + (size_t)warp * n;

  const int b = blockIdx.y;
  const float* s = support + (size_t)b * n * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = s[3 * i + 0];
    sy[i] = s[3 * i + 1];
    sz[i] = s[3 * i + 2];
  }
  __syncthreads();

  const int q = blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= m) return;  // no barrier follows
  const float* qp = query + ((size_t)b * m + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  for (int i = lane; i < n; i += 32) {
    const float dx = qx - sx[i], dy = qy - sy[i], dz = qz - sz[i];
    d2[i] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }

  float* dout = dist_out + ((size_t)b * m + q) * k;
  int32_t* iout = idx_out + ((size_t)b * m + q) * k;
  const int rounds = k < n ? k : n;
  float v = 0.0f;
  int i = 0;
  for (int r = 0; r < rounds; ++r) {
    v = __int_as_float(0x7f800000);  // +inf: taken slots hold +inf too
    i = n;
    for (int j = lane; j < n; j += 32) {
      const float d = d2[j];
      if (d < v || (d == v && j < i)) {
        v = d;
        i = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      argmin_merge(v, i, ov, oi);
    }
    if ((i & 31) == lane) d2[i] = __int_as_float(0x7f800000);
    if (lane == 0) {
      dout[r] = fmaxf(v, 0.0f);
      iout[r] = i;
    }
  }
  for (int r = rounds + lane; r < k; r += 32) {  // k > N: repeat the last neighbour
    dout[r] = fmaxf(v, 0.0f);
    iout[r] = i;
  }
}

int warps_for(int n) {
  const size_t stage = (size_t)3 * n * sizeof(float);
  const size_t row = (size_t)n * sizeof(float);
  if (stage + row > kSmemLimit) return 0;
  size_t w = (kSmemLimit - stage) / row;
  return w > (size_t)kMaxWarps ? kMaxWarps : (int)w;
}

}  // namespace

extern "C" {

// Largest N the kernel takes (knn.py:RESIDENT_MAX_N) and largest k.
int pasnl_knn_max_n() { return 12288; }
int pasnl_knn_max_k() { return 128; }

int pasnl_knn(const void* support, const void* query, void* dist, void* idx,
              int b, int n, int m, int k, void* stream) {
  const int warps = warps_for(n);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 + warps) * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + warps - 1) / warps, b);
  knn_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)support, (const float*)query, (float*)dist, (int32_t*)idx, n, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
