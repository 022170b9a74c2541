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
// and each pick needs every point of its cloud (an argmax over all of them).
// The arithmetic is small (N * 10 operations a pick), so the time is the
// latency of one pick -- a pass over the points, an argmax inside each block
// and, where a cloud spans several blocks, an exchange of the blocks'
// candidates -- times npoint.
//
// What the design does about it, three designs routed by N (and, at the
// largest block-design N, by the batch: ops/cuda/fps.py:design):
//
// - N <= 10240 (fps_kernel): one block per cloud, so the chain never leaves
//   the SM, and the cloud never leaves the registers: each thread holds a
//   compile-time number of consecutive points (PPT), their coordinates and
//   running minima, so device memory is read once; shared memory keeps only
//   a copy of the cloud for the picks' coordinates. A pick's time is its
//   latency: a thread reduces its rows as a tree, and a warp's argmax is one
//   redux.sync and a ballot (a lower lane holds lower indices). Up to 256
//   points (the plan, kBlockPlanN / kBlockPlanPPT) one warp takes the cloud,
//   with no barrier at all. Past that, 5 to 20 warps: each warp's winner
//   goes to a shared slot (double-buffered by the pick's parity), and after
//   the one block barrier of the pick every warp reduces the slots itself,
//   so no second barrier follows. At 10240 points a pick is bound by the
//   update pass on one SM, so a batch of clouds of 8192 to 10240 points
//   that the card runs in one wave of clusters (pasnl_fps_cluster_slots: 7
//   on the H100) takes the cluster design below, 16 SMs a cloud: 1.025
//   against 1.215 ms at 10240 -> 1280 (they tie at 8192; at B8 the clusters
//   need two waves, 2.05 ms).
// - 10240 < N <= 278528 (fps_cluster_kernel, whole scenes): one cloud is
//   spread over a thread-block cluster of 16 blocks on 16 SMs, past the
//   portable cluster size of 8, launched with cudaLaunchKernelEx; the library
//   states the cap only where cudaOccupancyMaxActiveClusters finds room for
//   such a cluster (pasnl_fps_cluster_max_n), else a CUDA error, and the
//   wrapper then routes every N past 10240 to the grid design. Each block
//   holds its 1/16 of the cloud in shared memory (up to 17408 points, 204 KB)
//   and each thread the running minimum of its points in registers. A pick is
//   each block's argmax, then warp 0 pushes the block's candidate (distance
//   bits, index, coordinates) into every block's inbox with st.async, which
//   completes bytes on the receiver's mbarrier. Every warp waits on its own
//   block's mbarrier and reduces the 16 candidates itself: no cluster barrier
//   and no second block barrier a pick.
// - 278528 < N (fps_grid_kernel, scenes past 2^18 points): one cloud is
//   spread over the whole card, a cooperative grid of one block of 1024
//   threads per SM (cudaLaunchCooperativeKernel: every block is resident,
//   which polling between blocks needs), each block holding its 1/G of the
//   cloud in shared memory (16881 points, 198 KB, at 2228224 on 132 SMs). A
//   pick is each block's argmax, published as four 64-bit words in device
//   memory, each tagged with the pick's number -- a key (distance bits, then
//   the complement of the index, then the tag: a larger key is a larger
//   distance, then a lower index) and the three coordinates -- to each of 4
//   copies of the scratch, and counted on each copy's counter with one
//   relaxed red.add. No grid barrier: one thread of a block waits until its
//   copy's count reaches G picks' worth, then the first ceil(G / 32) warps
//   load one slot a lane, all at once, so the winner's coordinates come with
//   its key in one round trip; a word that lags its count still carries the
//   last tag and is loaded again. The copies spread the loads of G blocks
//   over 4 sets of lines. Clouds of a batch run one after another in the
//   same launch. The largest N is G times the points a block can hold
//   (pasnl_fps_grid_max_n).
//
// In both multi-block designs the candidates alternate between two buffers
// by the pick's parity. A block writes pick j + 2 into a buffer only after it
// has seen every block's pick j + 1, which each block sends only after it has
// read pick j, so no candidate is overwritten before every block has read it
// (in the grid, a fence.acq_rel.gpu after each pick's loads orders them
// before the block's next stores). An argmax inside a block is two warp
// reductions (redux.sync): the largest distance bits (non-negative floats
// order as unsigned integers), then the lowest index among the lanes that
// hold them; a lane with no point offers distance bits 0 and index
// 0xffffffff, which loses to a real point at distance 0. From 8 points a
// thread, a thread keeps its largest running minimum from pick to pick and
// scans its rows for it again only when the new pick came nearer to that
// point (RunningMin).
//
// Numerics: the distance is (dx*dx + dy*dy) + dz*dz with every step rounded
// on its own (__fmul_rn / __fadd_rn keep nvcc from contracting to fma), the
// formula of the plain PyTorch version and of the JAX oracle, so all pick
// the same indices.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// fps-probe: begin
// Built with -DFPS_PROBE (scripts/torch_fps_phases.py), the multi-block
// designs time the phases of a pick: thread 0 of each block sums the
// clock64() cycles from one mark to the next into its phase, over all its
// picks, and brackets its pick loops with clock64() and %globaltimer (which
// turn cycles into time). Phases: 0 the update pass (thread 0's), 1 the
// block's argmax (with the wait for the other warps' passes), 2 publishing
// the block's candidate, 3 waiting for and reducing the blocks' candidates
// (until warp 0 holds the pick), 4 the rest (a broadcast barrier, if any).
#ifdef FPS_PROBE
constexpr int kProbeBlocks = 1024;
constexpr int kProbePhases = 5;
// A block's row: the cycles of each phase, then picks, loop cycles, loop ns.
__device__ unsigned long long g_fps_probe[kProbeBlocks][kProbePhases + 3];

__device__ __forceinline__ unsigned long long fps_probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define FPS_PROBE_BEGIN()                                                              \
  __shared__ unsigned long long probe_acc[kProbePhases + 3];                           \
  long long probe_t = clock64();                                                       \
  const long long probe_c0 = probe_t;                                                  \
  const unsigned long long probe_ns0 = threadIdx.x == 0 ? fps_probe_ns() : 0ull;       \
  if (threadIdx.x == 0)                                                                \
    for (int k = 0; k < kProbePhases + 3; ++k) probe_acc[k] = 0
#define FPS_PROBE_MARK(k)                                                              \
  do {                                                                                 \
    if (threadIdx.x == 0) {                                                            \
      const long long now = clock64();                                                 \
      probe_acc[k] += now - probe_t;                                                   \
      probe_t = now;                                                                   \
    }                                                                                  \
  } while (0)
#define FPS_PROBE_PICK()                          \
  do {                                            \
    if (threadIdx.x == 0) ++probe_acc[kProbePhases]; \
  } while (0)
#define FPS_PROBE_END()                                                                \
  do {                                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {                               \
      unsigned long long* row = g_fps_probe[blockIdx.x];                               \
      for (int k = 0; k <= kProbePhases; ++k) row[k] += probe_acc[k];                  \
      row[kProbePhases + 1] += clock64() - probe_c0;                                   \
      row[kProbePhases + 2] += fps_probe_ns() - probe_ns0;                             \
    }                                                                                  \
  } while (0)

extern "C" int pasnl_fps_probe_rows() { return kProbeBlocks; }
extern "C" int pasnl_fps_probe_width() { return kProbePhases + 3; }
extern "C" int pasnl_fps_probe_reset() {
  static unsigned long long zeros[kProbeBlocks][kProbePhases + 3];
  return (int)cudaMemcpyToSymbol(g_fps_probe, zeros, sizeof(zeros));
}
extern "C" int pasnl_fps_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_fps_probe, sizeof(g_fps_probe));
}
#else
#define FPS_PROBE_BEGIN() \
  do {                    \
  } while (0)
#define FPS_PROBE_MARK(k) \
  do {                    \
  } while (0)
#define FPS_PROBE_PICK() \
  do {                   \
  } while (0)
#define FPS_PROBE_END() \
  do {                  \
  } while (0)
#endif
// fps-probe: end

namespace cg = cooperative_groups;

namespace {

constexpr float kFpsInf = 1e38f;
constexpr int kBlockMaxN = 10240;  // its copy of the cloud: 160 KB of shared memory
// The cluster design: 16 blocks (past the portable 8: the card states
// whether it fits) of 1024 threads, up to 17 points a thread.
constexpr int kCluster = 16;
constexpr int kClusterThreads = 1024;
constexpr int kPointsPerThread = 17;
constexpr int kClusterMaxN = kCluster * kClusterThreads * kPointsPerThread;  // 278528

__device__ __forceinline__ float sqdist(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// "No point" in an argmax: distance bits 0 and an index above every real one.
constexpr uint32_t kNoIndex = 0xffffffffu;

// From this many points a thread, a thread keeps its largest running minimum
// from pick to pick (RunningMin); with fewer, the distance to its largest
// costs more than the per-row tracking it saves.
constexpr int kKeepBestRows = 8;

// A thread's running minima md[r] of its points tid, tid + THREADS, ... of a
// block's rows, with their largest, `best`, and the lowest row that holds
// it, `best_r` (-1: the thread holds no point).
template <int PPT, int THREADS>
struct RunningMin {
  float md[PPT];
  float best;
  int best_r;

  __device__ __forceinline__ void init(int count, int tid) {
#pragma unroll
    for (int r = 0; r < PPT; ++r) md[r] = kFpsInf;
    best = kFpsInf;
    best_r = tid < count ? 0 : -1;
  }

  // f(r) for each row r that holds a point of this thread: bounds are
  // checked on the last row only, unless the block's share is ragged (the
  // last block's).
  template <class F>
  __device__ __forceinline__ void rows(int count, int tid, F f) {
    if (count >= (PPT - 1) * THREADS) {
#pragma unroll
      for (int r = 0; r < PPT - 1; ++r) f(r);
      if ((PPT - 1) * THREADS + tid < count) f(PPT - 1);
    } else {
#pragma unroll
      for (int r = 0; r < PPT; ++r)
        if (r * THREADS + tid < count) f(r);
    }
  }

  // One pick: lowers every md[r] by the distance to (px, py, pz), and
  // returns the largest as (distance bits, local index), the lowest index on
  // ties; (0, kNoIndex) if the thread holds no point.
  __device__ __forceinline__ void update(const float* sx, const float* sy, const float* sz,
                                         int count, int tid, float px, float py, float pz,
                                         uint32_t& v, uint32_t& i) {
    auto lower = [&](int r) {
      const int l = r * THREADS + tid;
      md[r] = fminf(md[r], sqdist(sx[l] - px, sy[l] - py, sz[l] - pz));
    };
    auto track = [&](int r) {
      if (md[r] > best) {  // strict: the lowest row wins ties
        best = md[r];
        best_r = r;
      }
    };
    if constexpr (PPT >= kKeepBestRows) {
      // A minimum only falls, so the largest stays at best_r unless the new
      // pick came nearer to that point; only then are the rows scanned
      // again, which late in a chain few threads need.
      rows(count, tid, lower);
      if (best_r >= 0) {
        const int l = best_r * THREADS + tid;
        if (sqdist(sx[l] - px, sy[l] - py, sz[l] - pz) < best) {  // md[best_r] fell
          best = -1.0f;
          rows(count, tid, track);
        }
      }
    } else {
      best = -1.0f;
      best_r = -1;
      rows(count, tid, [&](int r) {
        lower(r);
        track(r);
      });
    }
    v = best_r < 0 ? 0u : __float_as_uint(best);
    i = best_r < 0 ? kNoIndex : (uint32_t)(best_r * THREADS + tid);
  }
};

// Argmax over the warp of (distance bits v, index i): the largest v, then the
// lowest i among the lanes that hold it. Every lane gets the winner.
__device__ __forceinline__ void warp_argmax(uint32_t& v, uint32_t& i) {
  const uint32_t vmax = __reduce_max_sync(0xffffffffu, v);
  i = __reduce_min_sync(0xffffffffu, v == vmax ? i : kNoIndex);
  v = vmax;
}

// The block design's plan: a cloud of N points takes the first entry whose
// largest N holds it, that many points a thread (PPT), and the fewest warps
// that hold N at that PPT. Chosen by timing every variant at the paths'
// shapes (scripts/torch_kernel_turns.py --plans, PERF.md): one warp up to
// 256 points; past that 1, 4 or 16 points a thread, which puts 5 to 20 warps
// on a cloud (a single warp issues from one of the SM's four schedulers).
// The plan was the fastest variant at 7 of the 8 path shapes, and within
// 2.4 % of it at the eighth (B8 512 -> 128, where 2 points a thread did
// better).
// The wrapper mirrors the table (ops/cuda/fps.py:BLOCK_PLAN) and checks it
// against pasnl_fps_block_ppt and pasnl_fps_block_warps.
constexpr int kBlockPlanN[] = {32, 64, 128, 256, 512, 2048, kBlockMaxN};
constexpr int kBlockPlanPPT[] = {1, 2, 4, 8, 1, 4, 16};

// Threads a block of the PPT variant may have: as many warps as hold
// kBlockMaxN points at that PPT, at most 32. Its registers follow from it.
template <int PPT>
struct BlockThreads {
  static constexpr int kWarps = (kBlockMaxN + 32 * PPT - 1) / (32 * PPT);
  static constexpr int kMax = 32 * (kWarps < 32 ? kWarps : 32);
};

// A thread's share of a cloud in the block design, in registers: the PPT
// consecutive points tid * PPT + r and their running minima md. A row past N
// holds md = -1, which no pick lowers and no argmax takes, so the rows need
// no bounds checks.
template <int PPT>
struct RegisterCloud {
  float x[PPT], y[PPT], z[PPT], md[PPT];

  // Loads the thread's points, and copies them to `pts` for the picks'
  // coordinates.
  __device__ __forceinline__ void init(const float* p, float4* pts, int n, int tid) {
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      const int l = tid * PPT + r;
      const bool live = l < n;
      x[r] = live ? p[3 * l + 0] : 0.0f;
      y[r] = live ? p[3 * l + 1] : 0.0f;
      z[r] = live ? p[3 * l + 2] : 0.0f;
      md[r] = live ? kFpsInf : -1.0f;
      if (live) pts[l] = make_float4(x[r], y[r], z[r], 0.0f);
    }
  }

  // One pick at (px, py, pz): lowers every md[r], and returns the largest as
  // distance bits v (0 if the thread holds no point) and its lowest row. The
  // rows reduce as a tree, so the latency is log2(PPT) merges, not PPT.
  __device__ __forceinline__ void update(float px, float py, float pz, uint32_t& v, int& row) {
    float tv[PPT];
    int tr[PPT];
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      md[r] = fminf(md[r], sqdist(x[r] - px, y[r] - py, z[r] - pz));
      tv[r] = md[r];
      tr[r] = r;
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2)
#pragma unroll
      for (int a = 0; a + w < PPT; a += 2 * w)
        if (tv[a + w] > tv[a]) {  // strict: the lower rows win ties
          tv[a] = tv[a + w];
          tr[a] = tr[a + w];
        }
    v = tv[0] < 0.0f ? 0u : __float_as_uint(tv[0]);
    row = tr[0];
  }
};

// The block design: one block a cloud, PPT consecutive points a thread in
// registers, so a lower lane, and a lower warp, holds lower indices. A warp's
// argmax is then one redux.sync of the distance bits and a ballot: the lowest
// lane that holds the largest holds the lowest index among its ties (a lane
// with no point offers 0 and, lying above every point, loses to a point at
// 0). With one warp, the winning lane's index is shuffled to the others.
// With more, each warp's winning lane writes (distance bits, index) to the
// warp's slot of the pick's parity, and after one block barrier every warp
// reduces the slots the same way: a warp writes the slots of pick j + 2 only
// after the barrier of pick j + 1, which every warp passes only after reading
// those of pick j. The pick's point comes from the block's copy of the cloud
// in shared memory, one broadcast load.
template <int PPT>
__global__ void __launch_bounds__(BlockThreads<PPT>::kMax)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n, int npoint) {
  extern __shared__ float4 pts[];  // the cloud, for the picks' coordinates
  __shared__ uint32_t slot_v[2][32], slot_i[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const float* p = xyz + (size_t)blockIdx.x * n * 3;
  int32_t* o = out + (size_t)blockIdx.x * npoint;

  RegisterCloud<PPT> cloud;
  cloud.init(p, pts, n, tid);
  float px = p[0], py = p[1], pz = p[2];
  if (tid == 0) o[0] = 0;
  __syncthreads();
  for (int j = 1; j < npoint; ++j) {
    uint32_t v;
    int row;
    cloud.update(px, py, pz, v, row);
    const uint32_t own = (uint32_t)(tid * PPT + row);
    const uint32_t vmax = __reduce_max_sync(0xffffffffu, v);
    const int src = __ffs(__ballot_sync(0xffffffffu, v == vmax)) - 1;
    uint32_t i;
    if (warps == 1) {
      i = __shfl_sync(0xffffffffu, own, src);
    } else {
      const int par = j & 1;
      if (lane == src) {
        slot_v[par][warp] = vmax;
        slot_i[par][warp] = own;
      }
      __syncthreads();
      const bool live = lane < warps;
      const uint32_t sv = live ? slot_v[par][lane] : 0u;
      const uint32_t si = live ? slot_i[par][lane] : 0u;
      const uint32_t bmax = __reduce_max_sync(0xffffffffu, sv);
      i = __shfl_sync(0xffffffffu, si, __ffs(__ballot_sync(0xffffffffu, live && sv == bmax)) - 1);
    }
    const float4 q = pts[i];
    px = q.x;
    py = q.y;
    pz = q.z;
    if (tid == 0) o[j] = (int32_t)i;
  }
}

// Per-warp winners in shared memory, reduced by warp 0 to the block's.
struct WarpBest {
  uint32_t v[32];
  uint32_t i[32];
};

__device__ __forceinline__ void block_argmax(WarpBest& wb, int warp, int lane, uint32_t& v,
                                             uint32_t& i) {
  warp_argmax(v, i);
  if (lane == 0) {
    wb.v[warp] = v;
    wb.i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = wb.v[lane];  // 1024 threads: 32 warps
    i = wb.i[lane];
    warp_argmax(v, i);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A block's candidate for a pick, as st.async sends it into a peer's inbox.
struct alignas(16) Candidate {
  uint32_t v, i;
  float x, y, z, pad[3];
};
constexpr uint32_t kCandidateBytes = 20;  // v, i, x, y (16) and z (4)

template <int PPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
fps_cluster_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n,
                   int npoint) {
  extern __shared__ float smem[];
  __shared__ Candidate inbox[2][kCluster];  // by pick parity, then sender
  __shared__ unsigned long long full[2];  // mbarriers: every candidate arrived
  __shared__ WarpBest wb;

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
  RunningMin<PPT, kClusterThreads> run;
  run.init(count, tid);
  if (tid == 0) {
    if (rank == 0) o[0] = 0;
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  float px = p[0], py = p[1], pz = p[2];
  cluster.sync();  // every block's mbarriers are initialised before any send

  FPS_PROBE_BEGIN();
  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    uint32_t v, i;
    run.update(sx, sy, sz, count, tid, px, py, pz, v, i);
    if (i != kNoIndex) i += base;
    FPS_PROBE_MARK(0);
    block_argmax(wb, warp, lane, v, i);
    FPS_PROBE_MARK(1);
    const uint32_t bar = smem_u32(&full[par]);
    if (warp == 0) {
      // One arrival (this one) and the kCluster candidates' bytes complete the phase.
      if (lane == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                     "r"(kCluster * kCandidateBytes)
                     : "memory");
      if (lane < kCluster) {  // lane r sends to the block of rank r
        const int l = i == kNoIndex ? 0 : (int)i - base;
        uint32_t dst, dst_bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                     : "=r"(dst)
                     : "r"(smem_u32(&inbox[par][rank])), "r"(lane));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst_bar) : "r"(bar), "r"(lane));
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
            "[%5];" ::"r"(dst),
            "r"(v), "r"(i), "r"(__float_as_uint(sx[l])), "r"(__float_as_uint(sy[l])), "r"(dst_bar)
            : "memory");
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                dst + 16),
            "r"(__float_as_uint(sz[l])), "r"(dst_bar)
            : "memory");
      }
    }
    FPS_PROBE_MARK(2);
    // Every warp waits for the kCluster candidates of this pick and reduces them.
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar), "r"((uint32_t)(((j - 1) >> 1) & 1))  // its use of this mbarrier
          : "memory");
    } while (!done);
    const Candidate* c = inbox[par];
    v = lane < kCluster ? c[lane].v : 0u;
    i = lane < kCluster ? c[lane].i : kNoIndex;
    warp_argmax(v, i);
    const int src = __ffs(__ballot_sync(0xffffffffu, lane < kCluster && c[lane].i == i)) - 1;
    px = c[src].x;
    py = c[src].y;
    pz = c[src].z;
    if (rank == 0 && tid == 0) o[j] = (int32_t)i;
    FPS_PROBE_MARK(3);
    FPS_PROBE_PICK();
    FPS_PROBE_MARK(4);
  }
  FPS_PROBE_END();
  cluster.sync();  // no block exits while a peer's send to it may be in flight
}

// The grid design: one block of 1024 threads per SM, at most 20 points a
// thread.
constexpr int kGridThreads = 1024;
constexpr int kGridPointsPerThread = 20;
constexpr int kGridIndexBits = 22;  // a key: distance bits, ~index (22 bits), tag (10 bits)
constexpr uint32_t kGridIndexMask = (1u << kGridIndexBits) - 1;
constexpr uint32_t kGridTagMask = (1u << (32 - kGridIndexBits)) - 1;
// The complement of the largest index must not be 0, the "no point" key's.
constexpr int kGridMaxN = (int)kGridIndexMask;
constexpr int kGridMaxBlocks = 256;  // polling warps: ceil(G / 32) <= 8
// Every candidate goes to kGridReplicas copies of the scratch, and a block
// reads copy blockIdx % kGridReplicas, so each line of it is loaded by a
// quarter of the blocks (4 copies ran faster than 1, 2 and 8 on the H100).
constexpr int kGridReplicas = 4;
constexpr int kGridSlotBytes = 4 * 8;  // a key and three coordinates
constexpr int kGridCountBytes = 128;   // a count on a line of its own

// One copy of the grid's scratch in device memory: for each of two buffers
// (by the pick's parity), G keys (distance bits << 32 | (~index & 0x3fffff)
// << 10 | tag), then G candidates' coordinates (bits << 32 | t); and the
// count of candidates published to it. Every word carries the pick's number
// t (a key its low 10 bits), so a reader knows a fresh word from a stale one.
struct GridScratch {
  unsigned long long* keys;    // [2][G]
  unsigned long long* coords;  // [2][G][3]
  unsigned int* published;
};

__device__ __forceinline__ GridScratch grid_scratch(void* p, int G, int copy) {
  unsigned long long* words = (unsigned long long*)p;
  unsigned long long* w = words + (size_t)copy * 8 * G;
  unsigned int* counts = (unsigned int*)(words + (size_t)kGridReplicas * 8 * G);
  return GridScratch{w, w + 2 * G, counts + copy * (kGridCountBytes / 4)};
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long tagged(float f, uint32_t t) {
  return ((unsigned long long)__float_as_uint(f) << 32) | t;
}

// A polling warp's winner, merged by every warp after the block barrier.
struct alignas(16) GridCandidate {
  uint32_t v, i;
  float x, y, z, pad[3];
};

template <int PPT>
__global__ void __launch_bounds__(kGridThreads, 1)
fps_grid_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, void* scratch,
                int batch, int n, int npoint, int per_block) {
  extern __shared__ float smem[];
  __shared__ WarpBest wb;
  __shared__ GridCandidate cand[kGridMaxBlocks / 32];

  const int G = gridDim.x;
  const int pollers = (G + 31) / 32;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = blk * per_block;  // this block holds [base, base + count)
  const int count = max(0, min(per_block, n - base));
  float* sx = smem;
  float* sy = sx + per_block;
  float* sz = sy + per_block;
  const GridScratch mine = grid_scratch(scratch, G, blk % kGridReplicas);  // the copy it reads
  uint32_t t = 0;  // picks made in this launch, across clouds: the tag

  FPS_PROBE_BEGIN();
  for (int b = 0; b < batch; ++b) {
    const float* p = xyz + (size_t)b * n * 3;
    int32_t* o = out + (size_t)b * npoint;
    __syncthreads();  // the last cloud's reads of sx, sy, sz are done
    for (int i = tid; i < count; i += kGridThreads) {
      sx[i] = p[3 * (size_t)(base + i) + 0];
      sy[i] = p[3 * (size_t)(base + i) + 1];
      sz[i] = p[3 * (size_t)(base + i) + 2];
    }
    RunningMin<PPT, kGridThreads> run;
    run.init(count, tid);
    if (blk == 0 && tid == 0) o[0] = 0;
    float px = p[0], py = p[1], pz = p[2];
    __syncthreads();

    for (int j = 1; j < npoint; ++j) {
      ++t;
      const size_t buf = (size_t)(t & 1) * G;
      uint32_t v, i;
      run.update(sx, sy, sz, count, tid, px, py, pz, v, i);
      if (i != kNoIndex) i += base;
      FPS_PROBE_MARK(0);
      block_argmax(wb, warp, lane, v, i);
      FPS_PROBE_MARK(1);
      if (warp == 0 && lane < kGridReplicas) {  // lane r publishes to copy r
        const GridScratch copy = grid_scratch(scratch, G, lane);
        const bool none = i == kNoIndex;
        const int l = none ? 0 : (int)i - base;
        const uint32_t field = none ? 0u : kGridIndexMask - i;
        unsigned long long* c = copy.coords + 3 * (buf + blk);
        st_relaxed(c + 0, tagged(sx[l], t));
        st_relaxed(c + 1, tagged(sy[l], t));
        st_relaxed(c + 2, tagged(sz[l], t));
        st_relaxed(copy.keys + buf + blk,
                   ((unsigned long long)v << 32) |
                       ((unsigned long long)field << (32 - kGridIndexBits)) | (t & kGridTagMask));
        asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(copy.published) : "memory");
      }
      FPS_PROBE_MARK(2);
      if (warp < pollers) {
        // Lane 0 waits until G candidates of this pick are counted, then
        // every polling lane loads one slot, all at once; a word that lags
        // its count still carries the last tag, and is loaded again.
        if (warp == 0 && lane == 0) {
          const unsigned int target = t * (unsigned int)G;
          unsigned int seen;
          do {
            asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                         : "=r"(seen)
                         : "l"(mine.published)
                         : "memory");
          } while ((int)(seen - target) < 0);
        }
        asm volatile("bar.sync 1, %0;" ::"r"(pollers * 32) : "memory");
        const int s = warp * 32 + lane;
        unsigned long long key = 0, wx = 0, wy = 0, wz = 0;
        if (s < G) {
          const unsigned long long* c = mine.coords + 3 * (buf + s);
          bool fresh;
          do {
            key = ld_relaxed(mine.keys + buf + s);
            wx = ld_relaxed(c);
            wy = ld_relaxed(c + 1);
            wz = ld_relaxed(c + 2);
            fresh = ((uint32_t)key & kGridTagMask) == (t & kGridTagMask) && (uint32_t)wx == t &&
                    (uint32_t)wy == t && (uint32_t)wz == t;
          } while (!fresh);
        }
        // A slot with no point has field 0: index kGridIndexMask, above every real one.
        const uint32_t sv = s < G ? (uint32_t)(key >> 32) : 0u;
        const uint32_t si = s < G ? kGridIndexMask - ((uint32_t)key >> (32 - kGridIndexBits))
                                  : kNoIndex;
        v = sv;
        i = si;
        warp_argmax(v, i);
        const int src = __ffs(__ballot_sync(0xffffffffu, sv == v && si == i)) - 1;
        const float x = __uint_as_float((uint32_t)(__shfl_sync(0xffffffffu, wx, src) >> 32));
        const float y = __uint_as_float((uint32_t)(__shfl_sync(0xffffffffu, wy, src) >> 32));
        const float z = __uint_as_float((uint32_t)(__shfl_sync(0xffffffffu, wz, src) >> 32));
        if (lane == 0) cand[warp] = GridCandidate{v, i, x, y, z, {0.0f, 0.0f, 0.0f}};
      }
      FPS_PROBE_MARK(3);
      __syncthreads();
      // This pick's loads, every polling warp's, are ordered before the
      // publishing lanes' next stores, which a peer takes as "this block has
      // read pick t" before it reuses the buffer (the count and the words
      // are relaxed). The other warps start the update pass meanwhile, so
      // the fence stays off the pick's critical path.
      if (warp == 0 && lane < kGridReplicas) asm volatile("fence.acq_rel.gpu;" ::: "memory");
      // Every warp merges the pollers' winners.
      v = lane < pollers ? cand[lane].v : 0u;
      i = lane < pollers ? cand[lane].i : kNoIndex;
      warp_argmax(v, i);
      const int src = __ffs(__ballot_sync(0xffffffffu, lane < pollers && cand[lane].i == i)) - 1;
      px = cand[src].x;
      py = cand[src].y;
      pz = cand[src].z;
      if (blk == 0 && tid == 0) o[j] = (int32_t)i;
      FPS_PROBE_PICK();
      FPS_PROBE_MARK(4);
    }
  }
  FPS_PROBE_END();
}

// Points-a-thread variants of the multi-block kernels: the smallest that
// holds a block's share is launched. The cluster's are those of the
// whole-scene levels it takes (16384, 17408, 69632, 131072 and 278528 points:
// 1, 2, 5, 8 and 17 a thread) and the grid's those of its smallest share on
// the H100 (278529 points on 132 blocks: 3), of the B1 x 2228224 stem (17)
// and its cap (20).
template <int... P>
struct Variants {};
using ClusterVariants = Variants<1, 2, 6, 8, 17>;
using GridVariants = Variants<3, 8, 17, 20>;

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
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, fps_grid_kernel<kGridPointsPerThread>);
  if (err != cudaSuccess) return err;
  if (!coop || sms > kGridMaxBlocks) return cudaErrorNotSupported;
  const int by_smem = (int)((optin - attr.sharedSizeBytes) / (3 * sizeof(float)));
  const int by_registers = kGridThreads * kGridPointsPerThread;
  const int by_index = kGridMaxN / sms;
  *blocks = sms;
  *per_block_max = min(by_smem, min(by_registers, by_index));
  return cudaSuccess;
}

template <int P>
cudaError_t launch_grid(const float* xyz, int32_t* out, void* slots, int b, int n,
                        int npoint, int blocks, int per_block, cudaStream_t stream) {
  const size_t smem = grid_smem(per_block);
  cudaError_t err = cudaFuncSetAttribute(fps_grid_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fps_grid_kernel<P>,
                                                      kGridThreads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xyz, (void*)&out, (void*)&slots, (void*)&b, (void*)&n,
                  (void*)&npoint, (void*)&per_block};
  // Cooperative: every block is resident, which the polling needs.
  return cudaLaunchCooperativeKernel((const void*)fps_grid_kernel<P>, dim3(blocks),
                                     dim3(kGridThreads), args, smem, stream);
}

template <int P, int... Rest>
cudaError_t launch_grid_variant(Variants<P, Rest...>, int need, const float* xyz, int32_t* out,
                                void* slots, int b, int n, int npoint, int blocks,
                                int per_block, cudaStream_t stream) {
  if constexpr (sizeof...(Rest) > 0) {
    if (need > P)
      return launch_grid_variant(Variants<Rest...>{}, need, xyz, out, slots, b, n, npoint,
                                 blocks, per_block, stream);
  }
  if (need > P) return cudaErrorInvalidValue;
  return launch_grid<P>(xyz, out, slots, b, n, npoint, blocks, per_block, stream);
}

// A launch of clusters of kCluster blocks, one a cloud.
template <int P>
cudaLaunchConfig_t cluster_config(int b, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int P>
cudaError_t cluster_attributes(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fps_cluster_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && kCluster > 8)  // past the portable cluster size
    err = cudaFuncSetAttribute(fps_cluster_kernel<P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int P>
cudaError_t launch_cluster(const float* xyz, int32_t* out, int b, int n, int npoint,
                           cudaStream_t stream) {
  const size_t smem = (size_t)3 * ((n + kCluster - 1) / kCluster) * sizeof(float);
  cudaError_t err = cluster_attributes<P>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(b, smem, stream, &attr);
  return cudaLaunchKernelEx(&cfg, fps_cluster_kernel<P>, xyz, out, n, npoint);
}

// Whether the card can run a cluster at the design's largest N: 0, or a CUDA
// error.
cudaError_t cluster_fits() {
  constexpr int P = kPointsPerThread;
  const size_t smem = (size_t)3 * (kClusterMaxN / kCluster) * sizeof(float);
  cudaError_t err = cluster_attributes<P>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(1, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<P>, &cfg);
  if (err != cudaSuccess) return err;
  return clusters >= 1 ? cudaSuccess : cudaErrorNotSupported;
}

// Clusters the card runs at once at N = kBlockMaxN (a block holds 640
// points: the smallest variant), or a negative CUDA error.
int cluster_slots() {
  constexpr int P = 1;
  const size_t smem = (size_t)3 * (kBlockMaxN / kCluster) * sizeof(float);
  cudaError_t err = cluster_attributes<P>(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(1, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fps_cluster_kernel<P>, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

template <int P, int... Rest>
cudaError_t launch_cluster_variant(Variants<P, Rest...>, int need, const float* xyz,
                                   int32_t* out, int b, int n, int npoint, cudaStream_t stream) {
  if constexpr (sizeof...(Rest) > 0) {
    if (need > P)
      return launch_cluster_variant(Variants<Rest...>{}, need, xyz, out, b, n, npoint, stream);
  }
  if (need > P) return cudaErrorInvalidValue;
  return launch_cluster<P>(xyz, out, b, n, npoint, stream);
}

// The block design's plan for n points: (0, 0) past kBlockMaxN.
void block_plan(int n, int& ppt, int& warps) {
  ppt = warps = 0;
  if (n < 1) return;
  for (int e = 0; e < (int)(sizeof(kBlockPlanN) / sizeof(int)); ++e) {
    if (n <= kBlockPlanN[e]) {
      ppt = kBlockPlanPPT[e];
      warps = (n + 32 * ppt - 1) / (32 * ppt);
      return;
    }
  }
}

using BlockVariants = Variants<1, 2, 4, 8, 16>;

template <int P, int... Rest>
cudaError_t launch_block_variant(Variants<P, Rest...>, int ppt, int warps, const float* xyz,
                                 int32_t* out, int b, int n, int npoint, cudaStream_t stream) {
  if (ppt != P) {
    if constexpr (sizeof...(Rest) > 0)
      return launch_block_variant(Variants<Rest...>{}, ppt, warps, xyz, out, b, n, npoint,
                                  stream);
    return cudaErrorInvalidValue;
  }
  if (warps * 32 > BlockThreads<P>::kMax) return cudaErrorInvalidValue;
  // The copy of the cloud, which with the kernel's 512 bytes of slots may
  // pass the 48 KB a launch gets without asking.
  const size_t smem = (size_t)n * sizeof(float4);
  if (smem + 2 * 2 * 32 * sizeof(uint32_t) > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fps_kernel<P><<<b, warps * 32, smem, stream>>>(xyz, out, n, npoint);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N of each design; the grid design's depends on the card, and is
// negative (a CUDA error) where it cannot run.
int pasnl_fps_max_n() { return kBlockMaxN; }
int pasnl_fps_cluster_max_n() {
  const cudaError_t err = cluster_fits();
  if (err == cudaSuccess) return kClusterMaxN;
  cudaGetLastError();  // not sticky: cleared, so that no later launch reports it
  return -(int)err;
}
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

// slots: pasnl_fps_grid_scratch_bytes() of scratch, zeroed (tag 0, which no
// pick of a launch carries).
int pasnl_fps_grid(const void* xyz, void* out, void* slots, int b, int n, int npoint,
                   void* stream) {
  int blocks = 0, per_block_max = 0;
  cudaError_t err = grid_shape(&blocks, &per_block_max);
  if (err != cudaSuccess) return (int)err;
  const int per_block = (n + blocks - 1) / blocks;
  if (n < 1 || npoint < 1 || b < 1 || per_block > per_block_max)
    return (int)cudaErrorInvalidValue;
  const int need = (per_block + kGridThreads - 1) / kGridThreads;
  err = launch_grid_variant(GridVariants{}, need, (const float*)xyz, (int32_t*)out,
                            slots, b, n, npoint, blocks, per_block,
                            (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
int pasnl_fps_grid_scratch_bytes() {
  const int blocks = pasnl_fps_grid_blocks();
  return blocks < 0 ? blocks : kGridReplicas * (2 * blocks * kGridSlotBytes + kGridCountBytes);
}

int pasnl_fps_cluster(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  if (n < 1 || n > kClusterMaxN || npoint < 1) return (int)cudaErrorInvalidValue;
  const int per_block = (n + kCluster - 1) / kCluster;
  const int need = (per_block + kClusterThreads - 1) / kClusterThreads;
  return (int)launch_cluster_variant(ClusterVariants{}, need, (const float*)xyz, (int32_t*)out,
                                     b, n, npoint, (cudaStream_t)stream);
}

// The block design's plan for a cloud of n points (0 past kBlockMaxN).
int pasnl_fps_block_ppt(int n) {
  int ppt = 0, warps = 0;
  block_plan(n, ppt, warps);
  return ppt;
}
int pasnl_fps_block_warps(int n) {
  int ppt = 0, warps = 0;
  block_plan(n, ppt, warps);
  return warps;
}

// The block design, at its plan for n.
int pasnl_fps(const void* xyz, void* out, int b, int n, int npoint, void* stream) {
  int ppt = 0, warps = 0;
  block_plan(n, ppt, warps);
  if (ppt == 0 || npoint < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_block_variant(BlockVariants{}, ppt, warps, (const float*)xyz,
                                   (int32_t*)out, b, n, npoint, (cudaStream_t)stream);
}

// Clusters of the cluster design the card runs at once at a block-design
// N: a batch of clouds up to this many takes one wave of it (0 where the
// card runs none, or a negative CUDA error).
int pasnl_fps_cluster_slots() {
  const int clusters = cluster_slots();
  if (clusters < 0) cudaGetLastError();  // not sticky: cleared, as in pasnl_fps_cluster_max_n
  return clusters;
}

#ifdef FPS_PLAN_SWEEP
// Built with -DFPS_PLAN_SWEEP (scripts/torch_kernel_turns.py --plans): the
// block design at any plan, ppt one of the variants and warps * 32 * ppt >= n,
// to time the plans the library does not take.
int pasnl_fps_block_planned(const void* xyz, void* out, int b, int n, int npoint, int ppt,
                            int warps, void* stream) {
  if (n < 1 || n > kBlockMaxN || npoint < 1 || warps < 1 || (long long)warps * 32 * ppt < n)
    return (int)cudaErrorInvalidValue;
  return (int)launch_block_variant(BlockVariants{}, ppt, warps, (const float*)xyz,
                                   (int32_t*)out, b, n, npoint, (cudaStream_t)stream);
}
#endif

const char* pasnl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
