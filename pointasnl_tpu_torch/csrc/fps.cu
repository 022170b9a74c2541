// Farthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/fps.py:_fps_kernel
// (wrapper farthest_point_sample).
//
// Contract: xyz (B, N, 3) float32, contiguous -> idx (B, npoint) int32. The
// first pick is index 0. Each later pick is the argmax of the running minimum
// squared distance to the picked set, which starts at 1e38; equal values go
// to the lowest index. npoint == 1 gives a single 0.
//
// What bounds it on the card: the npoint - 1 picks form a dependent chain,
// and each pick needs every point of its cloud (a block-wide argmax). At the
// slice's sizes the arithmetic is tiny (N * 8 flops a pick), so the time is
// the latency of one pick -- a pass over shared memory, two warp-shuffle
// reductions and two block barriers -- times npoint.
//
// What the design does about it: one block per cloud, so the chain never
// leaves the SM. The cloud (as x, y, z rows) and the running minimum distance
// live in shared memory for the whole run; device memory is read once and the
// indices are written once. The argmax is a warp-shuffle reduction over
// (value, -index), then one warp reduces the per-warp winners. With B = 8
// only 8 SMs work; spreading a cloud over a cluster of blocks is later work.
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every step rounded
// on its own (__fmul_rn / __fadd_rn keep nvcc from contracting to fma), the
// formula of the plain PyTorch version and of the JAX oracle, so all pick
// the same indices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kFpsInf = 1e38f;

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out,
                           int n, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  float* md = sz + n;
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  __shared__ int pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  int32_t* o = out + (size_t)b * npoint;

  for (int i = tid; i < n; i += blockDim.x) {
    sx[i] = p[3 * i + 0];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
    md[i] = kFpsInf;
  }
  if (tid == 0) {
    o[0] = 0;
    pick = 0;
  }
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const int last = pick;
    const float px = sx[last], py = sy[last], pz = sz[last];
    float best_v = -1.0f;
    int best_i = n;
    for (int i = tid; i < n; i += blockDim.x) {
      const float dx = sx[i] - px, dy = sy[i] - py, dz = sz[i] - pz;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[i], d);
      md[i] = m;
      if (m > best_v) {  // strict: the lowest of this thread's indices wins ties
        best_v = m;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      argmax_merge(best_v, best_i, ov, oi);
    }
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();  // also orders every read of `pick` before its rewrite
    if (warp == 0) {
      float v = lane < nwarps ? warp_v[lane] : -1.0f;
      int i = lane < nwarps ? warp_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        argmax_merge(v, i, ov, oi);
      }
      if (lane == 0) {
        pick = i;
        o[j] = i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest N the kernel takes: four float rows of N in shared memory must fit
// the 227 KB a block may use.
int pasnl_fps_max_n() { return 10240; }

int pasnl_fps(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)4 * n * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_kernel<<<b, threads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (int32_t*)out, n, npoint);
  return (int)cudaGetLastError();
}

const char* pasnl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
