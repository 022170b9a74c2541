// Exact k-nearest-neighbour search with the support streamed through shared
// memory, for Hopper (sm_90a): every search the resident and spatial kernels
// do not take (N > 2^21, or k > 128 at any N).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/knn.py:_knn_kernel (the
// streaming kernel, reached through _knn_scan from knn_point).
//
// Contract: the plain knn_point's. support (B, N, 3), query (B, M, 3)
// float32, contiguous -> dist2 (B, M, k) float32 ascending and clamped at
// >= 0, idx (B, M, k) int32. Distances are direct differences,
// (dx*dx + dy*dy) + dz*dz, each step rounded on its own (__fmul_rn /
// __fadd_rn), the formula of the plain version and of csrc/knn.cu. Equal
// distances go to the lower support index, so a query that lies in the
// support is its own first neighbour. When k > N the last valid neighbour
// fills the remaining slots (ops/geometry.py:knn_point).
//
// What bounds it on the card: the operations. Every (query, support) pair
// costs 8 rounded float32 operations and a compare, B * M * N * 9 in all
// (0.67 s at 2228224 x 2228224 on the H100's 67 TFLOP/s); device memory is
// read once per block and chunk (from L2: a scene of 2^21 points is 27 MB)
// and the rows are written once. The TPU kernel's grid streams (128-query
// tile, 4096-point chunk) pairs and re-reads the support once per tile;
// that staging would be the cost here at 128 queries a block.
//
// What the design does about it: one thread per query and hundreds of
// queries a block, so each staged chunk of the support serves them all. The
// block stages kChunk points at a time, in ascending index order, into
// shared memory as float4 (one broadcast load a point); each thread keeps
// its running top-k sorted by (d2, id) in shared memory (slot j of thread t
// at j * T + t, so a warp's accesses never share a bank) and its kth entry
// in registers. A candidate is compared with the kth only: it enters, by
// insertion, about k * ln(N / k) times a query in all, so the loop is eight
// rounded operations and a compare a pair. Candidates are taken eight at a
// time and tested together, with one branch for the eight. The block size T
// follows from k: the largest number of resident threads an SM can hold
// with T * k * 8 bytes of lists a block. No atomics, no split of the
// support: each row is computed by one thread in index order, so the result
// does not depend on scheduling.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1024;          // support points staged a chunk (16 KB)
constexpr int kMaxK = 512;            // 32 threads' lists of 512 fit beside a chunk
constexpr int kMaxN = 1 << 28;        // indices and loop counters stay in int32
constexpr int kMaxThreads = 1024;
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

__global__ void knn_stream_kernel(const float* __restrict__ support,
                                  const float* __restrict__ query,
                                  float* __restrict__ dist_out, int32_t* __restrict__ idx_out,
                                  int n, int m, int k) {
  extern __shared__ float4 chunk[];  // kChunk points, then the lists
  float* run_d = reinterpret_cast<float*>(chunk + kChunk);  // [k][T]
  int* run_i = reinterpret_cast<int*>(run_d + (size_t)k * blockDim.x);

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int row = blockIdx.x * T + tid;
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
  // The row's kth entry. A thread past M holds -1, which no distance
  // precedes, so it never inserts.
  float kth_d = active ? inf : -1.0f;
  int kth_i = INT_MAX;

  const float* s = support + (size_t)b * n * 3;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cnt = min(kChunk, n - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int j = tid; j < cnt; j += T) {
      const float* p = s + (size_t)(c0 + j) * 3;
      chunk[j] = make_float4(p[0], p[1], p[2], 0.0f);
    }
    __syncthreads();
    int j = 0;
    for (; j + kUnroll <= cnt; j += kUnroll) {
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
          consider(d[u], c0 + j + u, run_d, run_i, k, T, tid, kth_d, kth_i);
      }
    }
    for (; j < cnt; ++j) {
      const float4 p = chunk[j];
      consider(sqdist(qx, qy, qz, p.x, p.y, p.z), c0 + j, run_d, run_i, k, T, tid, kth_d,
               kth_i);
    }
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
}

size_t smem_bytes(int threads, int k) {
  return (size_t)kChunk * sizeof(float4) + (size_t)threads * k * (sizeof(float) + sizeof(int));
}

}  // namespace

extern "C" {

// Largest N and k the kernel takes.
int pasnl_knn_streaming_max_n() { return kMaxN; }
int pasnl_knn_streaming_max_k() { return kMaxK; }

int pasnl_knn_streaming(const void* support, const void* query, void* dist, void* idx, int b,
                        int n, int m, int k, void* stream) {
  if (k < 1 || k > kMaxK || n < 1 || n > kMaxN || m < 1 || b < 1 || b > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(knn_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return (int)err;
  // The block size that keeps the most threads resident on an SM; on a tie
  // the smaller block, which leaves a shorter tail of blocks.
  int best_t = 0, best_threads = 0;
  for (int t = 32; t <= kMaxThreads; t += 32) {
    const size_t smem = smem_bytes(t, k);
    if (smem > (size_t)optin) break;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_stream_kernel, t, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks * t > best_threads) {
      best_threads = blocks * t;
      best_t = t;
    }
  }
  if (best_t == 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((m + best_t - 1) / best_t, b);
  knn_stream_kernel<<<grid, best_t, smem_bytes(best_t, k), (cudaStream_t)stream>>>(
      (const float*)support, (const float*)query, (float*)dist, (int32_t*)idx, n, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
