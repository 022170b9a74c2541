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
// What the design does about it, three designs routed by N:
//
// - N <= 10240 (fps_kernel): one block per cloud, so the chain never leaves
//   the SM. The cloud (as x, y, z rows) and the running minimum distance live
//   in shared memory for the whole run; device memory is read once and the
//   indices are written once. The argmax is a warp-shuffle reduction over
//   (value, -index), then one warp reduces the per-warp winners.
// - 10240 < N <= 131072 (fps_cluster_kernel, whole scenes): a cloud of
//   131072 points and its running minimum need 2 MB, past the 227 KB of one
//   block. So one cloud is spread over a thread-block cluster of 8 blocks on
//   8 SMs. Each block holds its eighth of the cloud in shared memory (up to
//   16384 points, 192 KB) and each thread the running minimum of its 16
//   points in registers. A pick is each block's argmax as above, written to
//   a slot in its shared memory; one cluster barrier; then warp 0 of every
//   block reads the 8 slots through distributed shared memory and reduces
//   them to the same winner, with its coordinates. The slots alternate
//   between two buffers, so one cluster barrier a pick suffices.
// - 131072 < N (fps_grid_kernel, scenes past 2^17 points): a cloud of
//   2228224 points is 26.7 MB of xyz, far past a cluster's 8 x 227 KB, and
//   reading it from device memory on every pick would move petabytes over a
//   chain of 278527 picks. So one cloud is spread over the whole card: a
//   cooperative grid of one block of 1024 threads per SM, launched with
//   cudaLaunchCooperativeKernel. Each block holds its 1/G of the cloud in
//   shared memory (16881 points, 198 KB, at 2228224 on 132 SMs) and each
//   thread the running minimum of its points in registers. A pick is each
//   block's argmax, packed with its index into one 64-bit key (the float's
//   bits above, the complement of the index below: a larger key is a larger
//   distance, then a lower index) and written with the point's coordinates
//   to the block's slot in device memory; one grid barrier (grid.sync()); then
//   warp 0 of every block reads the G slots past L1 and reduces them to the
//   same winner. The slots alternate between two buffers, so one barrier a
//   pick suffices. Clouds of a batch run one after another in the same
//   launch. The largest N is G times the points a block can hold, which
//   the card's SM count and shared memory decide (pasnl_fps_grid_max_n).
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every step rounded
// on its own (__fmul_rn / __fadd_rn keep nvcc from contracting to fma), the
// formula of the plain PyTorch version and of the JAX oracle, so all pick
// the same indices.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kFpsInf = 1e38f;
constexpr int kBlockMaxN = 10240;  // four float rows of N in 227 KB of shared memory
// The cluster design: 8 blocks (the portable cluster size) of 1024 threads,
// 16 points a thread.
constexpr int kCluster = 8;
constexpr int kClusterThreads = 1024;
constexpr int kPointsPerThread = 16;
constexpr int kClusterMaxN = kCluster * kClusterThreads * kPointsPerThread;  // 131072

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

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// A block's candidate for a pick: its running-minimum argmax and the point.
struct Pick {
  float v;
  int i;
  float x, y, z;
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kClusterThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n,
                   int npoint) {
  extern __shared__ float smem[];
  __shared__ Pick slot[2];
  __shared__ float warp_v[kClusterThreads / 32];
  __shared__ int warp_i[kClusterThreads / 32];
  __shared__ float pick[3];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_block = (n + kCluster - 1) / kCluster;
  const int base = rank * per_block;  // this block holds [base, base + count)
  const int count = max(0, min(per_block, n - base));
  float* sx = smem;
  float* sy = sx + per_block;
  float* sz = sy + per_block;
  const float* p = xyz + (size_t)b * n * 3;
  int32_t* o = out + (size_t)b * npoint;

  for (int i = tid; i < count; i += kClusterThreads) {
    sx[i] = p[3 * (base + i) + 0];
    sy[i] = p[3 * (base + i) + 1];
    sz[i] = p[3 * (base + i) + 2];
  }
  float md[kPointsPerThread];  // running minimum of points tid, tid + 1024, ...
#pragma unroll
  for (int r = 0; r < kPointsPerThread; ++r) md[r] = kFpsInf;
  if (rank == 0 && tid == 0) o[0] = 0;
  float px = p[0], py = p[1], pz = p[2];
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    float best_v = -1.0f;
    int best_i = INT_MAX;
#pragma unroll
    for (int r = 0; r < kPointsPerThread; ++r) {
      const int l = r * kClusterThreads + tid;
      if (l < count) {
        const float m = fminf(md[r], sqdist(sx[l] - px, sy[l] - py, sz[l] - pz));
        md[r] = m;
        if (m > best_v) {  // strict: the lowest of this thread's indices wins ties
          best_v = m;
          best_i = base + l;
        }
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
    __syncthreads();
    Pick* mine = &slot[j & 1];
    if (warp == 0) {
      float v = warp_v[lane];
      int i = warp_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        argmax_merge(v, i, ov, oi);
      }
      if (lane == 0) {
        const int l = i == INT_MAX ? 0 : i - base;
        *mine = Pick{v, i, sx[l], sy[l], sz[l]};
      }
    }
    cluster.sync();  // every block's slot is written and visible
    if (warp == 0) {
      Pick c{-1.0f, INT_MAX, 0.0f, 0.0f, 0.0f};
      if (lane < kCluster) c = *cluster.map_shared_rank(mine, lane);
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, c.v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, c.i, off);
        const float ox = __shfl_xor_sync(0xffffffffu, c.x, off);
        const float oy = __shfl_xor_sync(0xffffffffu, c.y, off);
        const float oz = __shfl_xor_sync(0xffffffffu, c.z, off);
        if (ov > c.v || (ov == c.v && oi < c.i)) c = Pick{ov, oi, ox, oy, oz};
      }
      if (lane == 0) {
        pick[0] = c.x;
        pick[1] = c.y;
        pick[2] = c.z;
        if (rank == 0) o[j] = c.i;
      }
    }
    __syncthreads();
    px = pick[0];
    py = pick[1];
    pz = pick[2];
  }
  cluster.sync();  // no block exits while another may still read its slots
}

// The grid design: one block of 1024 threads per SM, at most 20 points a
// thread.
constexpr int kGridThreads = 1024;
constexpr int kGridPointsPerThread = 20;

// A block's candidate for a pick, in device memory.
struct GridSlot {
  unsigned long long key;  // distance bits << 32 | ~index; 0 for no point
  float x, y, z, pad;
};

__device__ __forceinline__ unsigned long long pick_key(float v, int i) {
  return i == INT_MAX ? 0ull
                      : ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)(~(unsigned)i);
}

__global__ void __launch_bounds__(kGridThreads, 1)
fps_grid_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out,
                GridSlot* __restrict__ slots, int batch, int n, int npoint, int per_block) {
  extern __shared__ float smem[];
  __shared__ unsigned long long warp_key[kGridThreads / 32];
  __shared__ float pick[3];

  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = blk * per_block;  // this block holds [base, base + count)
  const int count = max(0, min(per_block, n - base));
  float* sx = smem;
  float* sy = sx + per_block;
  float* sz = sy + per_block;

  for (int b = 0; b < batch; ++b) {
    const float* p = xyz + (size_t)b * n * 3;
    int32_t* o = out + (size_t)b * npoint;
    __syncthreads();  // the last cloud's reads of sx, sy, sz and pick are done
    for (int i = tid; i < count; i += kGridThreads) {
      sx[i] = p[3 * (size_t)(base + i) + 0];
      sy[i] = p[3 * (size_t)(base + i) + 1];
      sz[i] = p[3 * (size_t)(base + i) + 2];
    }
    float md[kGridPointsPerThread];  // running minimum of points tid, tid + 1024, ...
#pragma unroll
    for (int r = 0; r < kGridPointsPerThread; ++r) md[r] = kFpsInf;
    if (blk == 0 && tid == 0) o[0] = 0;
    float px = p[0], py = p[1], pz = p[2];
    __syncthreads();

    for (int j = 1; j < npoint; ++j) {
      float best_v = -1.0f;
      int best_i = INT_MAX;
#pragma unroll
      for (int r = 0; r < kGridPointsPerThread; ++r) {
        const int l = r * kGridThreads + tid;
        if (l < count) {
          const float m = fminf(md[r], sqdist(sx[l] - px, sy[l] - py, sz[l] - pz));
          md[r] = m;
          if (m > best_v) {  // strict: the lowest of this thread's indices wins ties
            best_v = m;
            best_i = base + l;
          }
        }
      }
      unsigned long long key = pick_key(best_v, best_i);
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
      }
      if (lane == 0) warp_key[warp] = key;
      __syncthreads();
      GridSlot* buf = slots + (size_t)(j & 1) * G;
      if (warp == 0) {
        key = warp_key[lane];
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
          key = other > key ? other : key;
        }
        if (lane == 0) {
          const int l = key == 0 ? 0 : (int)(~(unsigned)key) - base;
          GridSlot s{key, sx[l], sy[l], sz[l], 0.0f};
          __stcg(&buf[blk].key, s.key);
          __stcg(&buf[blk].x, s.x);
          __stcg(&buf[blk].y, s.y);
          __stcg(&buf[blk].z, s.z);
        }
      }
      grid.sync();  // every block's slot is written and visible
      if (warp == 0) {
        unsigned long long best = 0;
        float bx = 0.0f, by = 0.0f, bz = 0.0f;
        for (int s = lane; s < G; s += 32) {  // past L1: the slots are rewritten
          const unsigned long long kk = __ldcg(&buf[s].key);
          if (kk > best) {
            best = kk;
            bx = __ldcg(&buf[s].x);
            by = __ldcg(&buf[s].y);
            bz = __ldcg(&buf[s].z);
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long ok = __shfl_xor_sync(0xffffffffu, best, off);
          const float ox = __shfl_xor_sync(0xffffffffu, bx, off);
          const float oy = __shfl_xor_sync(0xffffffffu, by, off);
          const float oz = __shfl_xor_sync(0xffffffffu, bz, off);
          if (ok > best) {
            best = ok;
            bx = ox;
            by = oy;
            bz = oz;
          }
        }
        if (lane == 0) {
          pick[0] = bx;
          pick[1] = by;
          pick[2] = bz;
          if (blk == 0) o[j] = (int32_t)(~(unsigned)best);
        }
      }
      __syncthreads();
      px = pick[0];
      py = pick[1];
      pz = pick[2];
    }
    grid.sync();  // no block rewrites a slot of this cloud's last pick while another reads it
  }
}

size_t grid_smem(int per_block) { return (size_t)3 * per_block * sizeof(float); }

// Blocks of the grid (one per SM) and the most points a block can hold, or a
// CUDA error.
cudaError_t grid_shape(int* blocks, int* per_block_max) {
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fps_grid_kernel);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int by_smem = (int)((optin - attr.sharedSizeBytes) / (3 * sizeof(float)));
  *blocks = sms;
  const int by_registers = kGridThreads * kGridPointsPerThread;
  *per_block_max = by_smem < by_registers ? by_smem : by_registers;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest N of each design; the grid design's depends on the card, and is
// negative (a CUDA error) where it cannot run.
int pasnl_fps_max_n() { return kBlockMaxN; }
int pasnl_fps_cluster_max_n() { return kClusterMaxN; }
int pasnl_fps_grid_blocks() {
  int blocks = 0, per_block = 0;
  const cudaError_t err = grid_shape(&blocks, &per_block);
  return err == cudaSuccess ? blocks : -(int)err;
}
int pasnl_fps_grid_max_n() {
  int blocks = 0, per_block = 0;
  const cudaError_t err = grid_shape(&blocks, &per_block);
  return err == cudaSuccess ? blocks * per_block : -(int)err;
}

// slots: 2 * pasnl_fps_grid_blocks() GridSlots (24 bytes each) of scratch.
int pasnl_fps_grid(const void* xyz, void* out, void* slots, int b, int n, int npoint,
                   void* stream) {
  int blocks = 0, per_block_max = 0;
  cudaError_t err = grid_shape(&blocks, &per_block_max);
  if (err != cudaSuccess) return (int)err;
  int per_block = (n + blocks - 1) / blocks;
  if (n < 1 || npoint < 1 || b < 1 || per_block > per_block_max)
    return (int)cudaErrorInvalidValue;
  const size_t smem = grid_smem(per_block);
  err = cudaFuncSetAttribute(fps_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fps_grid_kernel, kGridThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* xyz_p = (const float*)xyz;
  int32_t* out_p = (int32_t*)out;
  GridSlot* slots_p = (GridSlot*)slots;
  void* args[] = {(void*)&xyz_p, (void*)&out_p, (void*)&slots_p, (void*)&b, (void*)&n,
                  (void*)&npoint, (void*)&per_block};
  err = cudaLaunchCooperativeKernel((const void*)fps_grid_kernel, dim3(blocks),
                                    dim3(kGridThreads), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
int pasnl_fps_grid_slot_bytes() { return (int)sizeof(GridSlot); }

int pasnl_fps_cluster(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  if (n < 1 || n > kClusterMaxN || npoint < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * ((n + kCluster - 1) / kCluster) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fps_cluster_kernel<<<b * kCluster, kClusterThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (int32_t*)out, n, npoint);
  return (int)cudaGetLastError();
}

int pasnl_fps(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  if (n < 1 || n > kBlockMaxN || npoint < 1) return (int)cudaErrorInvalidValue;
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
