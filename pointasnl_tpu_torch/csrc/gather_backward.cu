// The backward of the point gathers, deterministic, for Hopper (sm_90a):
// dPoints (B, N, C) = sum over the rows m with idx[b, m] = n of dOut[b, m, :],
// for gather_point and for group_point (which flattens (M, K) into M * K).
//
// Replaces pointasnl_tpu/ops/scatter.py:onehot_scatter_add (with
// gather_point_mxu and group_point_mxu), the TPU package's gather VJP as
// chunked one-hot matmuls: a workaround for the TPU's serial scatter, not a
// Pallas kernel. The port had taken autograd's scatter-add for
// torch.gather, whose atomics add in an order that changes from run to run.
//
// Three kernels (the sum in two instantiations, float32 and bfloat16
// cotangents). The plan (gather_plan_kernel, then gather_rank_kernel)
// turns the indices idx (B, R) int32 into the segments: order (B * R) int32,
// the rows b * R + r sorted stably by their output row b * N + idx[b, r], and
// offsets (B * N + 1) int32, the segment of output row i being order[offsets[i]
// .. offsets[i + 1]), equal to ops/cuda/gather_backward.py:segments, its plain
// version. The wrapper makes one plan for each index tensor (plan), whatever
// gathers share it. The sum (gather_backward_kernel) then writes output row i
// as
//   ((0.0f + dout[order[s]]) + dout[order[s + 1]]) + ...
// each addition rounded on its own, in ascending r: the order in which CPU
// float32 index_add_ adds, so the two agree to the bit. The sum has no
// atomics: each output element is written by one thread, once. Bfloat16
// cotangents (a bfloat16 train step's) are added the same way in a float32
// accumulator, and the sum is rounded to bfloat16 once, to nearest even:
// float32 index_add_ of the widened rows, rounded, to the bit. (The TPU
// package adds bfloat16 cotangents in bfloat16 across its chunks; this is
// the more exact sum of the same rows.) A bfloat16 sum moves half the float32
// one's bytes.
//
// The plan is a counting sort. Its first launch takes one block a cloud (a
// segment never leaves its cloud: offsets[b * N] = b * R): the block counts
// each output row's hits with integer atomics, takes their exclusive scan
// into offsets, and drops each row into its segment at the slot an atomic on
// the segment's cursor hands it. Integer adds commute, so the counts and
// segments are deterministic; the slots within a segment are not. So each
// segment is then put in ascending r: a segment of more than long_len rows (a
// row gathered thousands of times) by the same block, walking the cloud's
// rows in order with a ballot and a block-wide prefix count a 1024 rows;
// every other one by ranking each of its rows against the others, in the same
// block where the cloud has at most kRankInBlock rows, else in a second
// launch, one thread a row of every cloud. The row ids are distinct integers,
// so the order is unique whatever the slots were.
//
// What bounds them on the card: bytes for the sum. Each dout row is read
// once, each output row written once, beside the 4-byte order and offsets
// entries: at the seg step's largest, level 1's grouping (B4, 40960 rows of
// 32 channels into 10240), that is 27 MB, 8 microseconds at 3.35 TB/s; the
// adds are one for every 4 bytes read. What the sum does about it: one thread
// an output element, and neighbouring threads on neighbouring channels of a
// row, so a warp reads a source row's channels in one coalesced pass; the
// segment's row ids are the same for the threads of an output row (one
// broadcast load). The plan moves far fewer bytes (the indices three times,
// three ints a row out); what bounds it is latency, with one SM a cloud, and
// the ranking's compares, a segment's length for each of its rows. What it
// does about that: kBatch rows a thread in flight; the counters and the
// slots in shared memory where n + R ints fit (a scattered 4-byte store to
// device memory costs one SM about a nanosecond a row on the H100, the
// slots' copy out is coalesced); the ranking of a larger cloud on every SM,
// a row a thread, neighbouring rows sharing their segment's reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanThreads = 1024;     // the count and fill: one block a cloud
constexpr int kRankThreads = 256;      // the ranking launch: one thread a row, all clouds
constexpr int kRankInBlock = 4096;     // rows a cloud up to which its block ranks them itself
constexpr int kLongList = 256;         // segments the walk in order takes, at most
constexpr int kLongMin = 512;          // rows of a segment ranked in place, at least
constexpr int kBatch = 8;              // rows a thread has in flight

// Rows of a segment ranked against each other; longer ones take the walk.
// At least R / kLongList, so at most kLongList segments are longer.
__host__ __device__ inline int long_len(int r) {
  const int spread = (r + kLongList - 1) / kLongList;
  return spread > kLongMin ? spread : kLongMin;
}

// An index outside [0, n), which the forward gather refuses, is clamped,
// so every access stays in bounds.
__device__ __forceinline__ int output_row(int k, int n) { return k < 0 ? 0 : k >= n ? n - 1 : k; }

// A counter after the atomics: in device memory the atomics ran in L2, so
// the read skips L1, which may hold the line as this SM last stored it.
template <bool kShared>
__device__ __forceinline__ int counter(const int* c) { return kShared ? *c : __ldcg(c); }

// The plan's first launch, one block a cloud: count each output row's hits,
// scan the counts into offsets, drop each row into its segment at the slot an
// atomic on the segment's cursor hands it (fill: the cloud's rows, grouped by
// segment, in no order within one), and put the longer segments in ascending
// r by walking the cloud's rows in order. With kShared the counters and the
// fill live in shared memory (dynamic, n + r ints) and the fill leaves for
// the ranking launch in one coalesced copy, or, up to kRankInBlock rows, the
// block ranks the short segments itself; else both live in scratch.
template <bool kShared>
__global__ void __launch_bounds__(kPlanThreads)
gather_plan_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ order,
                   int32_t* __restrict__ offsets, int32_t* __restrict__ scratch, int nb, int r,
                   int n) {
  extern __shared__ int s_dyn[];
  __shared__ int s_warp[2][32];
  __shared__ int s_long[kLongList];
  __shared__ int s_nlong;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int32_t* key = idx + (size_t)b * r;
  int* cnt = kShared ? s_dyn : scratch + (size_t)nb * r + (size_t)b * n;
  int* fill = kShared ? s_dyn + n : scratch + (size_t)b * r;
  const int base = b * r;  // B * R < 2^31: the wrapper checks
  const int longest = long_len(r);

  // Count each output row's hits, kBatch rows a thread in flight.
  for (int k = tid; k < n; k += kPlanThreads) cnt[k] = 0;
  if (tid == 0) s_nlong = 0;
  __syncthreads();
  for (int i0 = tid; i0 < r; i0 += kPlanThreads * kBatch) {
    int k[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kPlanThreads;
      k[j] = i < r ? output_row(key[i], n) : -1;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k[j] >= 0) atomicAdd(&cnt[k[j]], 1);
  }
  __syncthreads();

  // Exclusive scan: each thread a run of consecutive rows, the runs' sums
  // scanned across the block. cnt[k] becomes segment k's start, written to
  // offsets; the longer segments are listed.
  const int per = (n + kPlanThreads - 1) / kPlanThreads;
  const int k0 = min(n, tid * per), k1 = min(n, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += counter<kShared>(cnt + k);
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[0][warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[0][lane];
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += v;
    }
    s_warp[0][lane] = wi - w;
  }
  __syncthreads();
  int running = s_warp[0][warp] + incl - sum;
  for (int k = k0; k < k1; ++k) {
    const int c = counter<kShared>(cnt + k);
    if (c > longest) s_long[atomicAdd(&s_nlong, 1)] = k;
    cnt[k] = running;
    running += c;
  }
  __syncthreads();
  for (int k = tid; k < n; k += kPlanThreads)
    offsets[(size_t)b * n + k] = base + counter<kShared>(cnt + k);
  if (b == 0 && tid == 0) offsets[(size_t)nb * n] = nb * r;

  // Drop each row into its segment; cnt[k] ends at segment k's end.
  for (int i0 = tid; i0 < r; i0 += kPlanThreads * kBatch) {
    int k[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kPlanThreads;
      k[j] = i < r ? output_row(key[i], n) : -1;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k[j] >= 0) fill[atomicAdd(&cnt[k[j]], 1)] = i0 + j * kPlanThreads;
  }
  __syncthreads();

  if (kShared && r <= kRankInBlock) {
    // A short segment, here: each row's place is the rows of its segment
    // below it.
    for (int q = tid; q < r; q += kPlanThreads) {
      const int v = fill[q];
      const int k = output_row(key[v], n);
      const int s = k ? cnt[k - 1] : 0, e = cnt[k];
      if (e - s > longest) continue;
      int rank = 0;
      for (int j = s; j < e; ++j) rank += fill[j] < v;
      order[base + s + rank] = base + v;
    }
  } else if (kShared) {
    for (int q = tid; q < r; q += kPlanThreads) scratch[base + q] = fill[q];
  }

  // A long segment: the cloud's rows in order, kPlanThreads at a time, each
  // hit's place its count of hits before it.
  const int nlong = s_nlong;
  int buf = 0;
  for (int l = 0; l < nlong; ++l) {
    const int k = s_long[l];
    const int s = k ? counter<kShared>(cnt + k - 1) : 0, len = counter<kShared>(cnt + k) - s;
    int done = 0;
    for (int i0 = 0; i0 < r && done < len; i0 += kPlanThreads) {
      const int i = i0 + tid;
      const bool hit = i < r && output_row(key[i], n) == k;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[buf][warp] = __popc(mask);
      __syncthreads();  // s_warp[buf] is next written two rounds on, past another barrier
      int before = 0, all = 0;
      for (int w = 0; w < 32; ++w) {
        const int c = s_warp[buf][w];
        before += w < warp ? c : 0;
        all += c;
      }
      if (hit) order[base + s + done + before + __popc(mask & below)] = base + i;
      done += all;
      buf ^= 1;
    }
  }
}

// The plan's second launch, where a cloud has more than kRankInBlock rows or
// its counters pass shared memory, one thread a row of every cloud: a row in a
// segment of at most long_len(R) rows takes its place in ascending r, the
// rows of its segment below it. Neighbouring threads hold neighbouring slots,
// mostly of one segment, so its reads are shared.
__global__ void __launch_bounds__(kRankThreads)
gather_rank_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ fill, int32_t* __restrict__ order, int nb, int r,
                   int n) {
  const long long g = (long long)blockIdx.x * kRankThreads + threadIdx.x;
  if (g >= (long long)nb * r) return;
  const int b = (int)(g / r), q = (int)(g - (long long)b * r);
  const int base = b * r;
  const int32_t* cloud = fill + base;
  const int v = cloud[q];
  const int k = output_row(idx[base + v], n);
  const int s = offsets[(size_t)b * n + k] - base, e = offsets[(size_t)b * n + k + 1] - base;
  if (e - s > long_len(r)) return;
  int rank = 0;
  for (int j = s; j < e; ++j) rank += cloud[j] < v;
  order[base + s + rank] = base + v;
}

// The element types of the sum: float32 as it is, bfloat16 widened to float32
// exactly on the way in and rounded to nearest even once on the way out.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One instantiation a dtype, one order of additions for both: the float32
// accumulator starts at 0.0 and adds the segment's rows in ascending r.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_backward_kernel(const T* __restrict__ dout, const int32_t* __restrict__ order,
                       const int32_t* __restrict__ offsets, T* __restrict__ dpoints,
                       long long elements, int c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < elements;
       e += stride) {
    const long long row = e / c;
    const int ch = (int)(e - row * c);
    const int end = offsets[row + 1];
    float acc = 0.0f;
    for (int s = offsets[row]; s < end; ++s)
      acc = __fadd_rn(acc, widen(dout[(size_t)order[s] * c + ch]));
    dpoints[e] = narrow<T>(acc);
  }
}

}  // namespace

extern "C" {

// Ints of scratch a plan needs: the rows in their segments, and the counters
// where they pass shared memory.
long long pasnl_gather_plan_scratch(int b, int r, int n) {
  return (long long)b * r + (long long)b * n;
}

// Whether a cloud's counters and slots, n + r ints, fit a block's shared
// memory beside its static arrays (s_warp, s_long, s_nlong: 1284 bytes).
static cudaError_t plan_in_shared(int r, int n, bool& shared) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  shared = ((long long)n + r) * (long long)sizeof(int) + 2048 <= optin;
  return err;
}

// Kernels a plan launches: 1, or 2 with the ranking launch (past
// kRankInBlock rows a cloud, or where the counters and slots pass shared
// memory); -1 on an error.
int pasnl_gather_plan_launches(int b, int r, int n) {
  bool shared = false;
  if (b < 1 || r < 1 || n < 1 || plan_in_shared(r, n, shared) != cudaSuccess) return -1;
  return shared && r <= kRankInBlock ? 1 : 2;
}

// The plan: its count and fill, then, where pasnl_gather_plan_launches says
// 2, its ranking launch.
int pasnl_gather_plan(const void* idx, void* order, void* offsets, void* scratch, int b, int r,
                      int n, void* stream) {
  if (b < 1 || r < 1 || n < 1 || (long long)b * r > 0x7fffffffLL ||
      (long long)b * n >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  bool shared = false;
  cudaError_t err = plan_in_shared(r, n, shared);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)idx;
  int32_t *o = (int32_t*)order, *off = (int32_t*)offsets, *fill = (int32_t*)scratch;
  const long long bytes = ((long long)n + r) * (long long)sizeof(int);
  if (shared) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(gather_plan_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
    gather_plan_kernel<true><<<b, kPlanThreads, (size_t)bytes, s>>>(i, o, off, fill, b, r, n);
  } else {
    gather_plan_kernel<false><<<b, kPlanThreads, 0, s>>>(i, o, off, fill, b, r, n);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || (shared && r <= kRankInBlock)) return (int)err;
  const long long rows = (long long)b * r;
  gather_rank_kernel<<<(unsigned)((rows + kRankThreads - 1) / kRankThreads), kRankThreads, 0, s>>>(
      i, off, fill, o, b, r, n);
  return (int)cudaGetLastError();
}

}  // extern "C"

template <typename T>
static int launch_gather_backward(const void* dout, const void* order, const void* offsets,
                                  void* dpoints, long long rows, int c, void* stream) {
  if (rows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long elements = rows * c;
  const long long want = (elements + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  gather_backward_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)dout, (const int32_t*)order, (const int32_t*)offsets, (T*)dpoints, elements, c);
  return (int)cudaGetLastError();
}

extern "C" {

// The sum of float32 cotangents.
int pasnl_gather_backward(const void* dout, const void* order, const void* offsets,
                          void* dpoints, long long rows, int c, void* stream) {
  return launch_gather_backward<float>(dout, order, offsets, dpoints, rows, c, stream);
}

// The sum of bfloat16 cotangents: float32 additions in the same order, the
// result rounded to bfloat16 once.
int pasnl_gather_backward_bf16(const void* dout, const void* order, const void* offsets,
                               void* dpoints, long long rows, int c, void* stream) {
  return launch_gather_backward<__nv_bfloat16>(dout, order, offsets, dpoints, rows, c, stream);
}

}  // extern "C"
