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
// Contract: dout (B * R, C) float32 rows, contiguous; order (B * R) int32,
// the rows sorted stably by their output row b * N + idx[b, r]; offsets
// (B * N + 1) int32, the segment of output row i is order[offsets[i] ..
// offsets[i + 1]). Both come from plain tensor ops around the kernel
// (ops/cuda/gather_backward.py:segments, sorted once for each index tensor
// by plan, whatever gathers share it). Output row i is
//   ((0.0f + dout[order[s]]) + dout[order[s + 1]]) + ...
// each addition rounded on its own, in ascending r: the order in which CPU
// float32 index_add_ adds, so the two agree to the bit. No atomics: each
// output element is written by one thread, once.
//
// What bounds it on the card: bytes. Each dout row is read once, each
// output row written once, beside the 4-byte order and offsets entries: at
// the seg step's largest, level 1's grouping (B4, 40960 rows of 32 channels
// into 10240), that is 27 MB, 8 microseconds at 3.35 TB/s; the adds are one
// for every 4 bytes read. What the design does about it: one thread an
// output element, and neighbouring threads on neighbouring channels of a
// row, so a warp reads a source row's channels in one coalesced pass; the
// segment's row ids are the same for the threads of an output row (one
// broadcast load).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_backward_kernel(const float* __restrict__ dout, const int32_t* __restrict__ order,
                       const int32_t* __restrict__ offsets, float* __restrict__ dpoints,
                       long long elements, int c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < elements;
       e += stride) {
    const long long row = e / c;
    const int ch = (int)(e - row * c);
    const int end = offsets[row + 1];
    float acc = 0.0f;
    for (int s = offsets[row]; s < end; ++s)
      acc = __fadd_rn(acc, dout[(size_t)order[s] * c + ch]);
    dpoints[e] = acc;
  }
}

}  // namespace

extern "C" {

int pasnl_gather_backward(const void* dout, const void* order, const void* offsets,
                          void* dpoints, long long rows, int c, void* stream) {
  if (rows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  const long long elements = rows * c;
  const long long want = (elements + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  gather_backward_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dout, (const int32_t*)order, (const int32_t*)offsets, (float*)dpoints,
      elements, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
