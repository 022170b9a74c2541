// Fixed-radius ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/ball_query.py:_ball_kernel
// (wrapper query_ball_point).
//
// Contract: xyz (B, N, 3), new_xyz (B, M, 3) float32, contiguous ->
// idx (B, M, nsample) int32, cnt (B, M) int32. A support point is in the
// ball iff (dx*dx + dy*dy) + dz*dz < r2, strict, each step rounded on its
// own. idx holds the first nsample in-ball points in index order; the slots
// past the last hit repeat the first hit; an empty ball gives 0 everywhere.
// cnt is the number of in-ball points, capped at nsample.
//
// What bounds it on the card: device memory. A query costs 8 flops and one
// compare a support point it tests, and it stops as soon as nsample hits are
// in, so at the repulsion loss's shapes (1280 queries over 1280 points) it
// touches a few hundred points a query; the bytes that must move are the
// inputs once and nsample + 1 ints a query out.
//
// What the design does about it: one warp a query, eight queries a block.
// The warp walks the support in index order, 32 points a round, read
// straight from device memory (the cloud is small enough to stay in L1/L2,
// and the walk stops early). Each lane tests one point; __ballot_sync gives
// the round's hits and __popc of the hits below a lane gives that lane's
// slot, so the hits land in index order with no sort. The walk ends at the
// first round that fills nsample slots: only the first nsample hits are
// kept and the count is capped there anyway. The TPU kernel's nsample
// rounds of masked min over a (128, N) block exist because Mosaic has no
// ballot or prefix count; they have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__global__ void ball_query_kernel(const float* __restrict__ xyz,
                                  const float* __restrict__ new_xyz,
                                  int32_t* __restrict__ idx_out, int32_t* __restrict__ cnt_out,
                                  int n, int m, int nsample, float r2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blocks_per_cloud = (m + kWarps - 1) / kWarps;
  const int b = blockIdx.x / blocks_per_cloud;
  const int q = (blockIdx.x % blocks_per_cloud) * kWarps + warp;
  if (q >= m) return;  // no barrier in this kernel

  const float* s = xyz + (size_t)b * n * 3;
  const float* qp = new_xyz + ((size_t)b * m + q) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  int32_t* out = idx_out + ((size_t)b * m + q) * nsample;
  const unsigned below = (1u << lane) - 1u;

  int found = 0;  // hits so far, the same in every lane
  int first = 0;  // the first hit, 0 while there is none
  for (int base = 0; base < n && found < nsample; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < n) {
      const float dx = qx - s[3 * i + 0], dy = qy - s[3 * i + 1], dz = qz - s[3 * i + 2];
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      hit = d < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (found == 0) first = base + __ffs(mask) - 1;
    const int slot = found + __popc(mask & below);
    if (hit && slot < nsample) out[slot] = i;
    found += __popc(mask);
  }
  const int c = found < nsample ? found : nsample;
  for (int slot = c + lane; slot < nsample; slot += 32) out[slot] = first;
  if (lane == 0) cnt_out[(size_t)b * m + q] = c;
}

}  // namespace

extern "C" {

// Largest N and nsample the kernel takes. B and M are free as long as the
// B * ceil(M / 8) blocks fit the grid's x dimension (2^31 - 1).
int pasnl_ball_query_max_n() { return 1 << 20; }
int pasnl_ball_query_max_nsample() { return 128; }

int pasnl_ball_query(const void* xyz, const void* new_xyz, void* idx, void* cnt,
                     int b, int n, int m, int nsample, float r2, void* stream) {
  const long long blocks = (long long)b * ((m + kWarps - 1) / kWarps);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ball_query_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)new_xyz, (int32_t*)idx, (int32_t*)cnt, n, m, nsample,
      r2);
  return (int)cudaGetLastError();
}

}  // extern "C"
