"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Indices must be exactly equal (ball-query counts too); kNN squared distances
within 1e-6 relative. The gather backward sums in the order of CPU float32
``index_add_``, so it must equal that and its plain version to the bit.
Flash attention: the kernels and the plain versions
are both float32 with sums in other orders, so o and lse must agree within
1e-5 of their scale and dq, dk, dv within 1e-4 of theirs, plus 10 times the
plain version's own distance from float64 dense attention (which the q x 30
case needs: its scores reach ~1e2, so their float32 rounding moves p by
~1e-5 relative).
"""

import numpy as np
import pytest
import torch

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.data import surface_scene
from pointasnl_tpu_torch.models import PointASNLCls, PointASNLSemSeg, PointASNLSemSegRes
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops import flash_attention as tf
from pointasnl_tpu_torch.ops.cuda import ball_query as cuda_ball
from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import gather_backward as cuda_gather
from pointasnl_tpu_torch.ops.cuda import knn as cuda_knn
from pointasnl_tpu_torch.ops.cuda import knn_spatial as cuda_spatial
from pointasnl_tpu_torch.ops.cuda import knn_streaming as cuda_streaming
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(seed, B, N, dup=0):
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:
        x[:, N - dup:] = x[:, :dup]
    return torch.from_numpy(x)


@pytest.mark.parametrize("B,N,npoint,dup", [
    (8, 1024, 512, 0),   # the slice's layer 1
    (8, 512, 128, 0),    # the slice's layer 2
    (2, 1000, 100, 0),   # N not a multiple of 32
    (2, 512, 200, 256),  # duplicate points
    (2, 300, 1, 0),      # npoint == 1
    (1, 10240, 1280, 0),  # the largest N of the one-block design
    (4, 10240, 1280, 0),  # the seg step's stem: 10240 -> 1280 at B4
    (2, 10241, 500, 0),   # the smallest N of the cluster design
    (2, 20000, 2000, 10000),  # duplicate points, across the cluster's blocks
    (1, 16384, 4096, 0),  # the whole scene's level 2
    (1, 131072, 16384, 0),  # the whole scene's level 1
    (1, 131073, 2000, 0),  # 2^17 + 1: a ragged 16-block split in the cluster design
    (2, 300000, 1000, 150000),  # grid design: duplicates, B2, N not a multiple of its blocks
    (1, 278528, 69632, 0),  # the 2^21 + 2^17 scene's level 2: the cluster design's largest N
    (1, 278529, 2000, 0),  # the grid design's smallest N
    (2, 131072, 2048, 0),  # B2 in the cluster design
    (2, 20000, 500, -1),  # all points equal, cluster design: every distance 0 after the first pick
    (1, 278529, 300, -1),  # all points equal, grid design (threads with no point)
    # From 8 points a thread a thread keeps its largest running minimum
    # between picks; ties and minima of 0 there:
    (1, 131072, 4096, 65536),  # cluster, 8 a thread: duplicates in other blocks
    (1, 131072, 4096, 126976),  # points 4096..8191 copy 0..4095: in one thread's rows
    (1, 278528, 500, -1),  # all points equal, cluster, 17 a thread
    (1, 1200000, 1000, 600000),  # grid, 9091 points a block: duplicates, 17 a thread
    (1, 1200000, 300, -1),  # all points equal, grid, 17 a thread
])
def test_fps_kernel_matches_plain(dev, B, N, npoint, dup):
    """dup > 0: the last dup points copy the first ones; dup = -1: every point
    is the same, so after the first pick every running minimum is 0 and a
    thread, warp or block with no point must lose to a real point at 0."""
    x = (_cloud(N + npoint, B, N, dup) if dup >= 0 else _cloud(N, B, 1).expand(B, N, 3)).to(dev)
    got = cuda_fps.farthest_point_sample(npoint, x)
    want = tg.farthest_point_sample(npoint, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, want)


@pytest.mark.parametrize("N", cuda_fps.block_plan_edges())
def test_fps_block_design_at_the_edges_of_its_plan(dev, N):
    """Index-exact on each side of every points-a-thread and warp-count
    boundary, every pick of the small clouds (npoint = N)."""
    npoint = N if N <= 1025 else 300
    x = _cloud(N + 7, 2, N).to(dev)
    assert cuda_fps.design(N) == "block"
    got = cuda_fps._sample("block", npoint, x)
    want = tg.farthest_point_sample(npoint, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _lattice_cloud(B, side):
    """An integer lattice of side**3 points: ties at every distance."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        g.astype(np.float32), (B,) + g.shape)))


@pytest.mark.parametrize("case,B,N,npoint", [
    ("equal", 4, 100, 100),      # one warp: every distance 0 after the first pick
    ("equal", 4, 5000, 200),     # several warps, warps with no point late in a row
    ("duplicates", 2, 700, 700),
    ("duplicates", 2, 10240, 2000),
    ("lattice", 2, 1000, 1000),   # 10^3
    ("lattice", 1, 9261, 1500),   # 21^3
    ("random", 1, 1280, 320),
    ("random", 8, 1280, 320),
    ("random", 16, 1280, 320),
    ("random", 16, 80, 40),
    ("random", 1, 10240, 10240),  # every pick of the largest cloud
])
def test_fps_block_design_edge_cases(dev, case, B, N, npoint):
    if case == "equal":
        x = _cloud(N, B, 1).expand(B, N, 3).contiguous()
    elif case == "lattice":
        x = _lattice_cloud(B, round(N ** (1 / 3)))
    else:
        x = _cloud(N + B, B, N, dup=N // 2 if case == "duplicates" else 0)
    x = x.to(dev)
    got = cuda_fps._sample("block", npoint, x)
    want = tg.farthest_point_sample(npoint, x)
    torch.cuda.synchronize()
    assert got.shape == (B, npoint) and torch.equal(got, want)
    if case == "equal":  # ties go to the lowest index: every pick is point 0
        assert not got.any()


@pytest.mark.parametrize("B", [1, 4, "slots", "slots + 1", 16])
@pytest.mark.parametrize("N", [cuda_fps.CLUSTER_FROM_N - 1, cuda_fps.CLUSTER_FROM_N, 10240])
def test_fps_routes_a_batch_of_large_clouds_by_the_cluster_slots(dev, B, N):
    """Up to the clusters the card runs at once, clouds of CLUSTER_FROM_N to
    10240 points take the cluster design; either design gives the plain
    version's indices."""
    slots = cuda_fps.stated_cluster_slots()
    B = {"slots": slots, "slots + 1": slots + 1}.get(B, B)
    if B < 1:
        pytest.skip("the card runs no cluster of the cluster design")
    x = _cloud(N + B, B, N).to(dev)
    routed = cuda_fps.design(N, cuda_fps.stated_cluster_max_n(), B, slots)
    assert routed == ("cluster" if N >= cuda_fps.CLUSTER_FROM_N and B <= slots else "block")
    want = tg.farthest_point_sample(N // 8, x)
    assert torch.equal(cuda_fps.farthest_point_sample(N // 8, x), want)
    other = "block" if routed == "cluster" else "cluster"
    assert torch.equal(cuda_fps._sample(other, N // 8, x), want)


def test_fps_block_design_states_the_wrappers_plan(dev):
    from pointasnl_tpu_torch.ops.cuda import _build

    lib = _build.library()
    for n in cuda_fps.block_plan_edges():
        assert (lib.pasnl_fps_block_ppt(n), lib.pasnl_fps_block_warps(n)) == cuda_fps.block_plan(n)
    assert lib.pasnl_fps_block_ppt(cuda_fps.BLOCK_MAX_N + 1) == 0


@pytest.mark.parametrize("B,N,M,k,case", [
    (8, 1024, 512, 32, "disjoint"),  # the slice's layer 1 shapes
    (8, 512, 128, 64, "disjoint"),   # the slice's layer 2 shapes
    (2, 1024, 256, 32, "subset"),
    (2, 600, 300, 16, "duplicates"),
    (2, 10, 7, 16, "disjoint"),      # k > N
    (1, 10240, 2560, 32, "subset"),
    (1, 12288, 64, 128, "disjoint"),  # the largest N and k the kernel takes
    (1, 10240, 10240, 32, "subset"),  # the seg step's stem self-kNN, one cloud
    (4, 1280, 10240, 3, "disjoint"),  # three_nn of the seg decoder's last level
    # The register list (csrc/knn_select.cuh) at its edges: equal points (the
    # indices 0 .. k-1), exact ties at several distances, k of 3, 64 and 128
    # (one, two and four entries a lane), k > N at every list size, N not a
    # multiple of the kernel's 1024-point tile, and copies of points on both
    # sides of a tile boundary.
    (2, 1000, 300, 32, "equal"),
    (1, 3000, 200, 128, "equal"),
    (2, 4096, 512, 32, "lattice"),
    (1, 4096, 300, 64, "lattice"),
    (1, 4096, 300, 128, "lattice"),
    (2, 2000, 400, 3, "lattice"),
    (2, 1000, 300, 3, "equal"),       # k <= 4: each lane's own list, merged at the end
    (2, 3, 50, 4, "disjoint"),        # k > N, lane lists
    (4, 1280, 10240, 1, "disjoint"),
    (2, 3000, 1000, 64, "subset"),
    (2, 12288, 500, 128, "subset"),
    (2, 40, 30, 64, "disjoint"),      # k > N, two entries a lane
    (2, 100, 30, 128, "disjoint"),    # k > N, four entries a lane
    (2, 1025, 300, 32, "subset"),     # a tile and one point
    (3, 2049, 700, 64, "disjoint"),   # two tiles and one point, B3
    (2, 2048, 300, 32, "straddle"),
    (1, 3072, 300, 128, "straddle"),
])
def test_knn_kernel_matches_plain(dev, B, N, M, k, case):
    support = _cloud(N + M, B, N, dup=N // 2 if case == "duplicates" else 0)
    if case == "equal":  # every distance the same: the indices 0 .. k-1
        support = _cloud(N, B, 1).expand(B, N, 3).contiguous()
    if case == "lattice":  # integer points: many exact ties at several distances
        g = np.stack(np.meshgrid(*[np.arange(16, dtype=np.float32)] * 3, indexing="ij"), -1)
        support = torch.from_numpy(np.ascontiguousarray(g.reshape(1, 4096, 3)[:, :N])).expand(
            B, N, 3).contiguous()
    if case == "straddle":  # copies of points 0..99 at 974..1073 and 2000..2099 (tiles of 1024)
        support[:, 974:1074] = support[:, :100]
        if N >= 2100:
            support[:, 2000:2100] = support[:, :100]
    query = (support[:, : N: N // M][:, :M].clone() if case not in ("disjoint", "straddle")
             else support[:, :M].clone() if case == "straddle" else _cloud(k, B, M))
    support, query = support.to(dev), query.to(dev)
    got_d, got_i = cuda_knn.knn_point(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-7)
    if case == "subset":  # each query is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(0, N, N // M, device=dev)[:M].expand(B, M))
    if case == "equal":
        assert torch.equal(got_i.long(), torch.arange(k, device=dev).expand(B, M, k))


def test_fps_cluster_design_is_stated_on_the_card(dev):
    """The H100 has room for the 16-block cluster, so whole-scene levels up
    to 278528 points take it; a card without states 0 and routes them to
    the grid design."""
    assert cuda_fps.stated_cluster_max_n() == cuda_fps.CLUSTER_MAX_N
    assert cuda_fps.design(278528, cuda_fps.stated_cluster_max_n()) == "cluster"


def test_fps_grid_design_matches_the_cluster_design(dev):
    """Where both take N, the grid design picks what the cluster design picks."""
    x = _scene(8, 1, 131072).to(dev)
    grid = cuda_fps._sample("grid", 16384, x)
    cluster = cuda_fps._sample("cluster", 16384, x)
    torch.cuda.synchronize()
    assert torch.equal(grid, cluster)
    assert torch.equal(cuda_fps._sample("grid", 300, x[:, :5000]),
                       tg.farthest_point_sample(300, x[:, :5000]))


@pytest.mark.parametrize("first,second,B,N,npoint,same", [
    ("block", "cluster", 2, 10240, 1280, False),  # the block design's largest N
    ("block", "grid", 2, 4096, 1024, False),
    ("cluster", "grid", 1, 10241, 2000, False),  # the cluster design's smallest N
    ("cluster", "grid", 1, 278528, 4096, False),  # its largest
    ("cluster", "grid", 2, 5, 5, True),  # blocks with no point, all points equal
    ("block", "grid", 1, 100, 50, True),
])
def test_fps_designs_agree_where_both_take_n(dev, first, second, B, N, npoint, same):
    x = (_cloud(N, B, 1).expand(B, N, 3) if same else _cloud(N + 1, B, N)).contiguous().to(dev)
    a = cuda_fps._sample(first, npoint, x)
    b = cuda_fps._sample(second, npoint, x)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, tg.farthest_point_sample(npoint, x))


def test_fps_grid_design_takes_the_whole_chain_of_a_scene_level(dev):
    """The 2^21 + 2^17 scene's level 2, which the cluster design now takes,
    in the grid design: all 69632 picks."""
    x = _scene(7, 1, 278528, extent=6.0 * 17 ** 0.5 / 8 ** 0.5).to(dev)
    got = cuda_fps._sample("grid", 69632, x)
    want = tg.farthest_point_sample(69632, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fps_grid_design_first_picks_of_a_scene_past_two_million_points(dev):
    x = _scene(9, 1, 2228224, extent=6.0 * 17 ** 0.5).to(dev)
    got = cuda_fps.farthest_point_sample(2048, x)
    want = tg.farthest_point_sample(2048, x)
    torch.cuda.synchronize()
    assert cuda_fps.design(x.shape[1]) == "grid" and torch.equal(got, want)


def streaming_case(case):
    """(support, query, k) of a named streaming-kNN case on the CPU; the
    query is the support itself for a self-query."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case.startswith("k"):  # "k<k>": a self-query over a ragged N
        x = torch.from_numpy(rng.randn(1, 3001, 3).astype(np.float32))
        return x, x, int(case[1:])
    if case == "more k than N":
        return _cloud(1, 2, 100), _cloud(2, 2, 37), 300
    if case == "duplicates":  # ties: the lower index first
        x = _cloud(3, 1, 4000, dup=2000)
        return x, x[:, 1000:3000].clone(), 32
    if case == "B3 disjoint":
        return _cloud(4, 3, 5000), _cloud(5, 3, 700), 16
    if case == "N one past a chunk":
        x = _cloud(6, 1, 1025)
        return x, x, 8
    if case == "scene 200000":  # past nothing, but several thousand chunks of queries
        x = _scene(10, 1, 200000, extent=6.0 * (200000 / 131072) ** 0.5)
        return x, x[:, ::50].contiguous(), 32
    raise ValueError(case)


STREAMING_CASES = ["k1", "k3", "k32", "k128", "k129", "k512", "more k than N", "duplicates",
                   "B3 disjoint", "N one past a chunk", "scene 200000"]


@pytest.mark.parametrize("case", STREAMING_CASES)
def test_streaming_knn_kernel_matches_plain(dev, case):
    support, query, k = streaming_case(case)
    self_query = query is support
    support = support.to(dev)
    query = support if self_query else query.to(dev)
    got_d, got_i = cuda_streaming.knn_point(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and got_i.shape == (*query.shape[:2], k)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-7)
    if self_query:  # each point is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(support.shape[1], device=dev)
                           .expand(support.shape[0], -1))


def test_streaming_knn_prunes_a_scene(dev):
    """On a surface scene the streaming kernel tests a small share of the
    pairs, as the spatial kernel does, and its result is the exact one."""
    x = _scene(13, 1, 65536, extent=6.0 / 2 ** 0.5).to(dev)
    tested = cuda_streaming.pairs_tested(32, x, x)
    assert 0 < tested < 0.1 * 65536 ** 2


def test_streaming_knn_matches_the_spatial_kernel_on_a_scene(dev):
    x = _scene(11, 1, 65536, extent=6.0 / 2 ** 0.5).to(dev)
    got = cuda_streaming.knn_point(32, x, x)
    want = cuda_spatial.knn_point(32, x, x)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def ball_case(case):
    """(xyz, new_xyz, radius, nsample) of a named ball-query case, as numpy."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "l1_xyz":  # the repulsion loss: 1280 points in a 0.5 m cube
        x = (rng.rand(4, 1280, 3) * 0.5).astype(np.float32)
        return x, x, 0.07, 20
    if case == "cluster":  # more than nsample hits: the cap applies
        x = (rng.rand(2, 500, 3) * 0.5).astype(np.float32)
        x[:, 100:200] = 0.25 + 0.01 * rng.rand(2, 100, 3)
        return x, x[:, 90:210].copy(), 0.07, 20
    if case == "empty":  # queries far from every point
        x = rng.rand(2, 300, 3).astype(np.float32)
        return x, np.full((2, 8, 3), 100.0, np.float32), 0.1, 8
    if case == "exactly_r":  # d^2 == r^2 stays out of the ball
        x = np.zeros((1, 40, 3), np.float32)
        x[0, :, 0] = np.linspace(0.2, 1.0, 40)
        x[0, 12] = (0.5, 0.0, 0.0)
        return x, np.zeros((1, 1, 3), np.float32), 0.5, 16
    if case == "ragged":  # N not a multiple of 32
        x = (rng.rand(2, 1000, 3) * 0.5).astype(np.float32)
        return x, x[:, ::7].copy(), 0.08, 32
    if case == "duplicates":
        x = (rng.rand(2, 600, 3) * 0.5).astype(np.float32)
        x[:, 300:] = x[:, :300]
        return x, x[:, 250:350].copy(), 0.06, 24
    if case == "n10240":
        x = (rng.rand(1, 10240, 3) * 0.5).astype(np.float32)
        return x, x[:, ::8].copy(), 0.07, 20
    if case == "three tiles":  # the kernel stages 3072 points at a time
        x = (rng.rand(2, 9001, 3) * 0.5).astype(np.float32)
        return x, x[:, ::13].copy(), 0.05, 32
    if case == "hits in the last tile":
        x = (rng.rand(1, 8192, 3) * 0.5).astype(np.float32)
        x[0, 8000:] = x[0, 4000]
        return x, x[:, 3990:4010].copy(), 0.02, 128
    if case == "nsample 128":
        x = (rng.rand(2, 700, 3) * 0.5).astype(np.float32)
        return x, x[:, ::3].copy(), 0.25, 128
    if case == "ragged M":  # M not a multiple of a block's queries
        x = (rng.rand(3, 700, 3) * 0.5).astype(np.float32)
        return x, x[:, :333].copy(), 0.1, 20
    if case == "every point":  # a ball that holds the whole cloud
        x = (rng.rand(2, 90, 3) * 0.5).astype(np.float32)
        return x, x[:, :41].copy(), 10.0, 128
    raise ValueError(case)


BALL_CASES = ["l1_xyz", "cluster", "empty", "exactly_r", "ragged", "duplicates", "n10240",
              "three tiles", "hits in the last tile", "nsample 128", "ragged M", "every point"]


@pytest.mark.parametrize("case", BALL_CASES)
def test_ball_query_kernel_matches_plain(dev, case):
    xyz, new_xyz, radius, nsample = ball_case(case)
    xyz, new_xyz = torch.from_numpy(xyz).to(dev), torch.from_numpy(new_xyz).to(dev)
    got_i, got_c = cuda_ball.query_ball_point(radius, nsample, xyz, new_xyz)
    want_i, want_c = tg.query_ball_point(radius, nsample, xyz, new_xyz)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and got_i.shape == (*new_xyz.shape[:2], nsample)
    assert torch.equal(got_i, want_i) and torch.equal(got_c, want_c)
    if case == "cluster":
        assert int(got_c.max()) == nsample
    if case == "empty":
        assert not bool(got_i.any()) and not bool(got_c.any())
    if case == "exactly_r":
        assert 12 not in got_i.tolist()[0][0]
    if case == "every point":
        assert bool((got_c == xyz.shape[1]).all())
        assert torch.equal(got_i[..., :xyz.shape[1]].long().cpu(),
                           torch.arange(xyz.shape[1]).expand(*got_i.shape[:2], -1))


def _scene(seed, B, N, extent=6.0):
    return torch.from_numpy(surface_scene(np.random.RandomState(seed), B, N, extent=extent))


def spatial_case(case):
    """(support, query, k) of a named spatial-kNN case on the CPU; the query
    is the support itself for a self-query."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "duplicates":  # ties: the lower index first
        x = torch.from_numpy(rng.randn(1, 20000, 3).astype(np.float32))
        x[:, 10000:] = x[:, :10000]
        return x, x, 16
    if case == "far from the origin":  # the bounds' cancellation needs the slack
        x = torch.from_numpy((rng.randn(1, 16484, 3) * 0.05 + 1000.0).astype(np.float32))
        return x, x, 32
    if case == "ragged N":  # N not a multiple of the segment width
        x = _scene(1, 1, 13001)
        return x, x, 32
    if case == "gaussian":  # the worst case for pruning
        x = torch.from_numpy(rng.randn(1, 32768, 3).astype(np.float32))
        return x, x, 32
    if case == "B2":
        x = _scene(2, 2, 20000)
        return x, x, 32
    if case == "disjoint":  # queries that are not support points
        return _scene(3, 1, 30000), _scene(4, 1, 5000), 32
    if case == "k3 over an eighth":  # three_nn's regime
        x = _scene(5, 1, 131072)
        return x[:, ::8].contiguous(), x, 3
    if case == "all equal":  # every distance 0: the indices 0 .. k-1, every segment visited
        x = torch.from_numpy(rng.randn(1, 1, 3).astype(np.float32)).expand(1, 20000, 3)
        x = x.contiguous()
        return x, x, 32
    if case == "lattice k64":  # integer points: exact ties at several distances
        g = np.stack(np.meshgrid(*[np.arange(24, dtype=np.float32)] * 3, indexing="ij"), -1)
        x = torch.from_numpy(np.ascontiguousarray(g.reshape(1, -1, 3)))
        return x, x, 64
    if case == "lattice k3, disjoint":
        g = np.stack(np.meshgrid(*[np.arange(24, dtype=np.float32)] * 3, indexing="ij"), -1)
        q = (rng.randint(0, 46, (1, 3000, 3)) / 2.0).astype(np.float32)  # on and between nodes
        return torch.from_numpy(np.ascontiguousarray(g.reshape(1, -1, 3))), torch.from_numpy(q), 3
    if case == "k128":  # four entries a lane
        x = _scene(6, 1, 20000)
        return x, x, 128
    if case == "triplicates":  # three copies of each point: copies on both sides of segments
        x = _scene(7, 1, 6001)
        x = torch.cat([x, x, x], dim=1)
        return x, x, 16
    raise ValueError(case)


SPATIAL_CASES = ["duplicates", "far from the origin", "ragged N", "gaussian", "B2", "disjoint",
                 "k3 over an eighth", "all equal", "lattice k64", "lattice k3, disjoint", "k128",
                 "triplicates"]


@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_spatial_knn_kernel_matches_plain(dev, case):
    support, query, k = spatial_case(case)
    self_query = query is support
    support = support.to(dev)
    query = support if self_query else query.to(dev)
    got_d, got_i = cuda_spatial.knn_point(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    torch.cuda.synchronize()
    assert got_i.dtype == torch.int32 and got_i.shape == (*query.shape[:2], k)
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-7)
    if case in ("ragged N", "gaussian", "B2", "lattice k64", "k128"):  # self-queries without
        # duplicates: each point is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(support.shape[1], device=dev)
                           .expand(support.shape[0], -1))
    if case == "all equal":
        assert torch.equal(got_i.long(), torch.arange(k, device=dev).expand(*got_i.shape))


def test_spatial_knn_prunes_a_scene(dev):
    """On a surface scene the kernel tests a small share of the pairs; on
    the same scene it tests every pair it must (the exact result)."""
    x = _scene(6, 1, 65536, extent=6.0 / 2 ** 0.5).to(dev)
    tested = cuda_spatial.pairs_tested(32, x, x)
    assert 0 < tested < 0.1 * 65536 ** 2


@pytest.mark.parametrize("k", [3, 16])
def test_spatial_knn_tests_the_pairs_of_its_visit_rule(dev, k):
    """The kernel tests exactly the pairs that knn_spatial.emulate's walk
    (by warp for k = 16, by lane for k = 3) tests on the CPU, and returns
    its rows."""
    x = _scene(9, 1, 4096, extent=1.5)
    d, i, tested = cuda_spatial.emulate(k, x, x)
    xd = x.to(dev)
    got_d, got_i = cuda_spatial.knn_point(k, xd, xd)
    torch.cuda.synchronize()
    assert cuda_spatial.pairs_tested(k, xd, xd) == tested
    assert torch.equal(got_i.cpu(), i) and torch.equal(got_d.cpu(), d)


def test_kernels_refuse_sizes_beyond_their_limits(dev):
    from pointasnl_tpu_torch.ops.cuda import _build

    grid_max = _build.library().pasnl_fps_grid_max_n()
    assert grid_max >= 2228224
    with pytest.raises(ValueError, match=f"N <= {grid_max}"):
        cuda_fps.farthest_point_sample(8, torch.empty(1, grid_max + 1, 3, device=dev))
    with pytest.raises(ValueError, match="N <= 278528"):
        cuda_fps._sample("cluster", 8, torch.zeros(1, 278529, 3, device=dev))
    with pytest.raises(ValueError, match="N <= 12288"):
        cuda_knn.knn_point(8, torch.zeros(1, 12289, 3, device=dev), torch.zeros(1, 4, 3, device=dev))
    with pytest.raises(ValueError, match="k <= 128"):
        cuda_knn.knn_point(129, torch.zeros(1, 200, 3, device=dev), torch.zeros(1, 4, 3, device=dev))
    with pytest.raises(ValueError, match="nsample <= 128"):
        cuda_ball.query_ball_point(0.1, 129, torch.zeros(1, 200, 3, device=dev),
                                   torch.zeros(1, 4, 3, device=dev))
    big = torch.zeros(1, 2 ** 21 + 1, 3, device=dev)
    with pytest.raises(ValueError, match="k <= 128"):
        cuda_spatial.knn_point(129, big[:, :20000], big[:, :4])
    with pytest.raises(ValueError, match=r"N <= 2097152"):
        cuda_spatial.knn_point(8, big, big[:, :4])
    # Past the spatial kernel's range the streaming kernel takes a search; it
    # raises only past its own caps, k <= 512 and N <= 2^28.
    with pytest.raises(ValueError, match="k <= 512"):
        cuda_streaming.knn_point(513, big[:, :20000], big[:, :4])
    with pytest.raises(ValueError, match="k <= 512"):
        ops.knn_point(513, big[:, :20000], big[:, :4])
    huge = torch.empty(1, 2 ** 28 + 1, 3, device=dev)
    with pytest.raises(ValueError, match=r"N <= 268435456"):
        cuda_streaming.knn_point(8, huge, big[:, :4])
    with pytest.raises(ValueError, match=r"N <= 268435456"):
        ops.knn_point(8, huge, big[:, :4])


# Gather backwards a seg train step launches: 22 gathers take a gradient,
# 3 of them (the FPS samples that adaptive sampling replaces) feed no loss
# (tests/test_torch_gather.py counts both on the CPU).
SEG_GATHER_BACKWARDS = 19
SEG_GATHER_PLANS = 12  # one an index tensor: gathers that share indices share it

# (B, n points, R gathered rows, C) of the gather-backward checks: the seg
# step's shapes at B4 x 10240, then edge cases.
GATHER_CASES = {
    "level 1 grouping C32": (4, 10240, 1280 * 32, 32),
    "level 2 grouping xyz": (4, 1280, 320 * 32, 3),
    "level 2 FPS gather": (4, 1280, 320, 3),
    "three_interpolate C512": (4, 40, 80 * 3, 512),
    "a row gathered 3000 times": (2, 5, 3000, 7),
    "most rows never gathered": (1, 1000, 10, 16),
    "one row": (1, 1, 4, 1),
}


def gather_case(case, dev):
    B, n, R, C = GATHER_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    dout = torch.from_numpy(rng.randn(B, R, C).astype(np.float32))
    if case.startswith("a row gathered"):
        idx = torch.from_numpy(rng.randint(0, 2, (B, R)) * 3)  # rows 0 and 3 only
    else:
        idx = torch.from_numpy(rng.randint(0, n, (B, R)).astype(np.int32))
    return dout.to(dev), idx.to(dev), n


@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_gather_backward_kernel_matches_plain_and_index_add(dev, case):
    dout, idx, n = gather_case(case, dev)
    B, R, C = dout.shape
    before = cuda_gather.launches
    got = cuda_gather.gather_backward(dout, idx, n)
    again = cuda_gather.gather_backward(dout, idx, n)
    want = cuda_gather.gather_backward_reference(dout, idx, n)
    torch.cuda.synchronize()
    assert cuda_gather.launches - before == 2
    assert got.shape == (B, n, C) and torch.equal(got, again) and torch.equal(got, want)
    flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1).cpu()
    cpu = torch.zeros(B * n, C).index_add_(0, flat, dout.reshape(B * R, C).cpu())
    assert torch.equal(got.cpu(), cpu.view(B, n, C))


# (B, n, R, the output rows the indices take or None for all) of plans checked
# beside GATHER_CASES': the B16 x 10240 recipe's level 1, counters and slots
# past a block's shared memory (n + R ints), segments long enough for the
# plan's walk in order.
PLAN_CASES = {
    "B16 level 1 grouping": (16, 10240, 1280 * 32, None),
    "counters past shared memory": (2, 60000, 5000, None),
    "long and short segments": (2, 9, 5000, None),
}


@pytest.mark.parametrize("case", list(GATHER_CASES) + list(PLAN_CASES))
def test_gather_plan_kernel_equals_segments(dev, case):
    if case in PLAN_CASES:
        B, n, R, _ = PLAN_CASES[case]
        rng = np.random.RandomState(sum(map(ord, case)))
        idx = torch.from_numpy(rng.randint(0, n, (B, R)).astype(np.int32)).to(dev)
    else:
        _, idx, n = gather_case(case, dev)
    before = cuda_gather.plan_launches
    got = cuda_gather.plan_kernel(idx, n)
    again = cuda_gather.plan_kernel(idx, n)
    want = cuda_gather.segments(idx, n)
    torch.cuda.synchronize()
    assert cuda_gather.plan_launches - before == 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.int32 and torch.equal(g, w) and torch.equal(a, w)
    if case in ("a row gathered 3000 times", "long and short segments"):
        assert int(torch.diff(want[1].long()).max()) > cuda_gather.long_len(idx.shape[1])


def test_gather_backward_on_the_card_never_calls_segments(dev, monkeypatch):
    def refuse(idx, n):
        raise AssertionError("a gather backward on the card called segments")

    monkeypatch.setattr(cuda_gather, "segments", refuse)
    dout, idx, n = gather_case("level 2 grouping xyz", dev)
    points = torch.zeros(dout.shape[0], n, dout.shape[2], device=dev, requires_grad=True)
    before = (cuda_gather.plan_launches, cuda_gather.launches)
    ops.gather_point(points, idx).backward(dout)
    torch.cuda.synchronize()
    assert (cuda_gather.plan_launches - before[0], cuda_gather.launches - before[1]) == (1, 1)
    flat = (idx.long() + torch.arange(idx.shape[0], device=dev)[:, None] * n).reshape(-1).cpu()
    cpu = torch.zeros(idx.shape[0] * n, dout.shape[2]).index_add_(
        0, flat, dout.reshape(-1, dout.shape[2]).cpu())
    assert torch.equal(points.grad.cpu(), cpu.view_as(points))


def test_gathers_with_a_gradient_take_the_kernel(dev):
    rng = np.random.RandomState(3)
    points = torch.from_numpy(rng.randn(2, 50, 5).astype(np.float32)).to(dev).requires_grad_()
    idx = torch.from_numpy(rng.randint(0, 50, (2, 9, 4)).astype(np.int32)).to(dev)
    before = cuda_gather.launches
    out = ops.group_point(points, idx)
    assert torch.equal(out, tg.group_point(points.detach(), idx))
    out.backward(torch.ones_like(out))
    assert cuda_gather.launches - before == 1
    flat = (idx.long() + torch.arange(2, device=dev)[:, None, None] * 50).reshape(-1).cpu()
    want = torch.zeros(100, 5).index_add_(0, flat, torch.ones(72, 5)).view(2, 50, 5)
    assert torch.equal(points.grad.cpu(), want)
    with torch.no_grad():
        ops.gather_point(points, idx[..., 0])
    ops.gather_point(torch.arange(100, device=dev).view(2, 50, 1), idx[..., 0])  # integers
    assert cuda_gather.launches - before == 1


# (B, n points, R gathered rows, C) of the bfloat16 sum's checks: a row
# gathered 3000 times, the seg step's level-1 grouping at B4 and at the
# B16 x 10240 recipe, the decoder's widest.
BF16_GATHER_CASES = {
    "a row gathered 3000 times": (2, 5, 3000, 32),
    "level 1 grouping C32": (4, 10240, 1280 * 32, 32),
    "B16 level 1 grouping C32": (16, 10240, 1280 * 32, 32),
    "three_interpolate C512": (4, 40, 80 * 3, 512),
}


@pytest.mark.parametrize("case", list(BF16_GATHER_CASES))
def test_bf16_gather_backward_kernel_equals_plain(dev, case):
    """The bfloat16 sum: float32 additions in the plan's order, rounded once,
    equal to the bit to its plain version and to CPU float32 index_add_ of
    the widened rows, rounded; counted apart from the float32 sum."""
    B, n, R, C = BF16_GATHER_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    rows = rng.randint(0, 2, (B, R)) * 3 if case.startswith("a row") else rng.randint(0, n, (B, R))
    idx = torch.from_numpy(rows.astype(np.int32)).to(dev)
    dout = torch.from_numpy(rng.randn(B, R, C).astype(np.float32)).to(dev).bfloat16()
    before = (cuda_gather.launches, cuda_gather.bf16_launches)
    got = cuda_gather.gather_backward(dout, idx, n)
    again = cuda_gather.gather_backward(dout, idx, n)
    want = cuda_gather.gather_backward_reference(dout, idx, n)
    torch.cuda.synchronize()
    assert (cuda_gather.launches - before[0], cuda_gather.bf16_launches - before[1]) == (0, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (B, n, C)
    assert torch.equal(got, again) and torch.equal(got, want)
    flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1).cpu()
    cpu = torch.zeros(B * n, C).index_add_(0, flat, dout.float().reshape(B * R, C).cpu())
    assert torch.equal(got.cpu(), cpu.bfloat16().view(B, n, C))


def test_float32_gather_backward_keeps_its_bits_beside_bf16(dev):
    """The float32 sum after a bfloat16 one on the same plan: still CPU
    index_add_ to the bit, and counted as float32."""
    dout, idx, n = gather_case("level 1 grouping C32", dev)
    B, R, C = dout.shape
    cuda_gather.gather_backward(dout.bfloat16(), idx, n)
    before = (cuda_gather.launches, cuda_gather.bf16_launches)
    got = cuda_gather.gather_backward(dout, idx, n)
    torch.cuda.synchronize()
    assert (cuda_gather.launches - before[0], cuda_gather.bf16_launches - before[1]) == (1, 0)
    flat = (idx.long() + torch.arange(B, device=dev)[:, None] * n).reshape(-1).cpu()
    cpu = torch.zeros(B * n, C).index_add_(0, flat, dout.reshape(B * R, C).cpu())
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), cpu.view(B, n, C))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gather.gather_backward(dout.half(), idx, n)


def test_bf16_gathers_with_a_gradient_take_the_bf16_kernel(dev):
    rng = np.random.RandomState(4)
    points = torch.from_numpy(rng.randn(2, 50, 5).astype(np.float32)).to(dev).bfloat16()
    points.requires_grad_()
    idx = torch.from_numpy(rng.randint(0, 50, (2, 9, 4)).astype(np.int32)).to(dev)
    before = cuda_gather.bf16_launches
    out = ops.group_point(points, idx)
    out.backward(torch.ones_like(out))
    assert cuda_gather.bf16_launches - before == 1 and points.grad.dtype == torch.bfloat16
    flat = (idx.long() + torch.arange(2, device=dev)[:, None, None] * 50).reshape(-1).cpu()
    want = torch.zeros(100, 5).index_add_(0, flat, torch.ones(72, 5)).view(2, 50, 5)
    assert torch.equal(points.grad.cpu(), want.bfloat16())


def _counts():
    return (cuda_fps.launches, cuda_knn.launches, cuda_spatial.launches, cuda_ball.launches,
            cuda_streaming.launches)


def _launched(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def test_dispatch_sends_cuda_tensors_to_the_kernels(dev):
    x = _cloud(1, 2, 256).to(dev)
    before = _counts()
    ops.farthest_point_sample(16, x)
    ops.knn_point(8, x, x[:, :16])
    ops.query_ball_point(0.2, 8, x, x[:, :16])
    assert _launched(before) == (1, 1, 0, 1, 0)
    big = _cloud(2, 1, 12289).to(dev)  # past the resident kernel's N
    before = _counts()
    got = ops.knn_point(8, big, big)  # a self-query
    assert _launched(before) == (0, 0, 1, 0, 0)
    for g, w in zip(got, tg.knn_point(8, big, big)):
        assert torch.equal(g, w)


def test_dispatch_sends_large_n_and_large_k_to_the_streaming_kernel(dev):
    scene = _scene(12, 1, 2 ** 21 + 256, extent=6.0 * 16 ** 0.5).to(dev)
    queries = scene[:, ::4096].contiguous()
    small = _cloud(3, 2, 500).to(dev)
    for k, support, query in ((32, scene, queries), (129, small, small),
                              (200, small, small[:, :50])):
        before = _counts()
        got = ops.knn_point(k, support, query)
        assert _launched(before) == (0, 0, 0, 0, 1), (k, support.shape)
        for g, w in zip(got, tg.knn_point(k, support, query)):
            assert torch.equal(g, w)


def test_cls_forward_launches_each_kernel_twice_a_request(dev):
    model = PointASNLCls(40, adaptive_sample=True,
                         generator=torch.Generator().manual_seed(0), device=dev)
    infer = make_inference_fn(model)
    x = _cloud(2, 2, 1024).to(dev)
    fps0, knn0 = cuda_fps.launches, cuda_knn.launches
    logits = infer(x)
    torch.cuda.synchronize()
    assert logits.shape == (2, 40) and bool(torch.isfinite(logits).all())
    assert (cuda_fps.launches - fps0, cuda_knn.launches - knn0) == (2, 2)


def test_seg_train_step_and_forward_launch_counts(dev, monkeypatch):
    """A seg train step launches FPS 4, kNN 7 + 4 (three_nn) and the ball
    query 1 time, the gather backward 19 times on 12 plans, and never calls
    segments (a stub raises); the serve forward the same minus the ball
    query and the gathers' kernels."""

    def refuse(idx, n):
        raise AssertionError("a gather backward on the card called segments")

    monkeypatch.setattr(cuda_gather, "segments", refuse)
    model = PointASNLSemSegRes(21, generator=torch.Generator().manual_seed(0), device=dev)
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(0)
    batch = {"points": torch.from_numpy((rng.rand(2, 2048, 3) * 0.5).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 21, (2, 2048))).to(dev),
             "smpw": torch.ones(2, 2048, device=dev)}
    before, g0, p0 = _counts(), cuda_gather.launches, cuda_gather.plan_launches
    metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert _launched(before) == (4, 11, 0, 1, 0)
    assert cuda_gather.launches - g0 == SEG_GATHER_BACKWARDS
    assert cuda_gather.plan_launches - p0 == SEG_GATHER_PLANS
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    before, g0 = _counts(), cuda_gather.launches
    logits = make_inference_fn(model)(batch["points"])
    torch.cuda.synchronize()
    assert _launched(before) == (4, 11, 0, 0, 0) and cuda_gather.launches == g0
    assert logits.shape == (2, 2048, 21) and bool(torch.isfinite(logits).all())


def test_encdec_train_step_and_forward_launch_counts(dev, monkeypatch):
    """The encoder-decoder's train step on a crop drawn with replacement
    (duplicate points) launches FPS 4, kNN 4 + 4 (self-kNN) + 4 (three_nn)
    and the ball query 1 time, the gather backward 18 times on 12 plans
    (tests/test_torch_sem_seg.py counts them on the CPU), and never calls
    segments; the serve forward the same minus the ball query and the
    gathers' kernels."""

    def refuse(idx, n):
        raise AssertionError("a gather backward on the card called segments")

    monkeypatch.setattr(cuda_gather, "segments", refuse)
    model = PointASNLSemSeg(21, 3, generator=torch.Generator().manual_seed(0), device=dev)
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(1)
    base = rng.rand(2, 1500, 6).astype(np.float32)
    crop = np.stack([b[rng.randint(0, 1500, 2048)] for b in base])
    batch = {"points": torch.from_numpy(crop).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 21, (2, 2048))).to(dev),
             "smpw": torch.ones(2, 2048, device=dev)}
    before, g0, p0 = _counts(), cuda_gather.launches, cuda_gather.plan_launches
    metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert _launched(before) == (4, 12, 0, 1, 0)
    assert (cuda_gather.launches - g0, cuda_gather.plan_launches - p0) == (18, 12)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    before, g0 = _counts(), cuda_gather.launches
    logits = make_inference_fn(model)(batch["points"])
    torch.cuda.synchronize()
    assert _launched(before) == (4, 12, 0, 0, 0) and cuda_gather.launches == g0
    assert logits.shape == (2, 2048, 21) and bool(torch.isfinite(logits).all())


def test_whole_scene_forward_launch_counts(dev):
    """At B1 x 24576 the stem's self-kNN takes the spatial kernel and the
    level-1 FPS the cluster design: FPS 4, spatial 1, resident 6 + 4
    (three_nn), no ball query."""
    model = PointASNLSemSegRes(21, nl_kv_block_size=4096,
                               generator=torch.Generator().manual_seed(0), device=dev)
    x = _scene(7, 1, 24576, extent=6.0 * (24576 / 131072) ** 0.5).to(dev)
    before = _counts()
    logits = make_inference_fn(model)(x)
    torch.cuda.synchronize()
    assert _launched(before) == (4, 10, 1, 0, 0)
    assert logits.shape == (1, 24576, 21) and bool(torch.isfinite(logits).all())


# (B, M, N, C, D, scaled, q multiplier) of the flash checks: the seg step's
# four non-local levels, cls's two layers, then edge cases.
FLASH_CASES = {
    "seg level 1": (4, 1280, 10240, 32, 32, True, 1.0),
    "seg level 2": (4, 320, 1280, 32, 32, True, 1.0),
    "seg level 3": (4, 80, 320, 64, 64, True, 1.0),
    "seg level 4": (4, 40, 80, 128, 128, True, 1.0),
    "cls layer 1": (8, 512, 1024, 32, 32, True, 1.0),
    "cls layer 2": (8, 128, 512, 64, 64, True, 1.0),
    "N 1": (2, 50, 1, 32, 32, True, 1.0),
    "N 1025": (2, 100, 1025, 32, 32, True, 1.0),
    "N 2049": (2, 100, 2049, 32, 32, True, 1.0),
    "M 1": (2, 1, 300, 32, 32, True, 1.0),
    "M 77": (2, 77, 300, 64, 64, True, 1.0),
    "C 128 N 10240": (1, 64, 10240, 128, 128, True, 1.0),
    "unscaled": (2, 100, 500, 32, 32, False, 1.0),
    "q x 30": (2, 100, 3000, 32, 32, True, 30.0),
    "B 1": (1, 300, 700, 32, 32, True, 1.0),
    "C 8 D 12": (2, 60, 200, 8, 12, True, 1.0),
    # The forward's tile (64 query rows), chunk (64 keys at P <= 64, 32 at
    # 128, 16 at 256) and key ranges (B1 M64 N 1025: 17 chunks in 9 ranges,
    # the last of one key), and widths off its padding:
    "M 63": (2, 63, 300, 32, 32, True, 1.0),
    "M 65": (2, 65, 300, 32, 32, True, 1.0),
    "N 63": (2, 100, 63, 32, 32, True, 1.0),
    "N 65": (2, 100, 65, 32, 32, True, 1.0),
    "N 1025 B1 M64": (1, 64, 1025, 32, 32, True, 1.0),
    "N 33 C 128": (2, 70, 33, 128, 128, True, 1.0),
    "C 1": (2, 50, 300, 1, 1, True, 1.0),
    "C 32 D 64": (2, 90, 700, 32, 64, True, 1.0),
    "C 64 D 20": (2, 90, 700, 64, 20, True, 1.0),
    "C 256": (2, 100, 300, 256, 256, True, 1.0),
    "C 256 N 17": (1, 130, 17, 256, 256, True, 1.0),
}


def flash_inputs(case, dev):
    B, M, N, C, D, scaled, qmul = FLASH_CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
                   for shape in ((B, M, C), (B, N, C), (B, N, D), (B, M, D)))
    return q * qmul, k, v, do, tf.flash_scale(C, scaled)


def _dense64(q, k, v, do, scale):
    """Dense float64 attention, its logsumexp and its gradients."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bmc,bnc->bmn", q, k) * scale
    o = torch.einsum("bmn,bnd->bmd", torch.softmax(s, dim=-1), v)
    grads = torch.autograd.grad(o, (q, k, v), do.double())
    return o.detach(), torch.logsumexp(s, dim=-1).detach(), grads


def _flash_close(what, got, plain, ref64, rtol):
    scale = float(ref64.abs().max())
    limit = rtol * scale + 10 * float((plain.double() - ref64).abs().max())
    err = float((got.double() - plain.double()).abs().max())
    assert err <= limit, f"{what}: |kernel - plain| {err:.3e} over {limit:.3e}"


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(dev, case):
    q, k, v, do, scale = flash_inputs(case, dev)
    o, lse = cuda_flash.flash_forward(q, k, v, scale)
    dq, dk, dv = cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
    po, plse = tf.flash_forward_reference(q, k, v, scale)
    pdq, pdk, pdv = tf.flash_backward_reference(q, k, v, po, plse, do, scale)
    torch.cuda.synchronize()
    o64, lse64, grads64 = _dense64(q, k, v, do, scale)
    assert o.shape == po.shape and lse.shape == plse.shape == q.shape[:2]
    _flash_close("o", o, po, o64, 1e-5)
    _flash_close("lse", lse, plse, lse64, 1e-5)
    for name, got, plain, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), (pdq, pdk, pdv), grads64):
        assert got.shape == plain.shape
        _flash_close(name, got, plain, ref, 1e-4)


def test_flash_backward_is_deterministic(dev):
    q, k, v, do, scale = flash_inputs("seg level 2", dev)
    o, lse = cuda_flash.flash_forward(q, k, v, scale)
    first = cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
    again = cuda_flash.flash_backward(q, k, v, o, lse, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("case", ["seg level 1", "seg level 4", "M 77", "C 256"])
def test_flash_forward_is_deterministic(dev, case):
    """Two launches give the same bits, ranges merged in order."""
    q, k, v, _, scale = flash_inputs(case, dev)
    first = cuda_flash.flash_forward(q, k, v, scale)
    again = cuda_flash.flash_forward(q, k, v, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("splits,B,M,N", [
    (1, 1, 84480, 300),     # 1320 tiles fill the card: one range
    (2, 1, 44800, 1280),    # 700 tiles: two ranges
    (3, 1, 32000, 1280),    # 500 tiles
    (16, 1, 64, 2048),      # one tile: the most ranges
    (2, 1, 84480, 65600),   # 1320 tiles, but a range holds at most 65536 keys
])
def test_flash_forward_holds_at_any_split(dev, splits, B, M, N):
    """The forward at shapes where the library splits a tile's keys into
    1, 2, 3 and 16 ranges (its scratch says how many): the plain version's
    function at each."""
    from pointasnl_tpu_torch.ops.cuda import _build

    assert _build.library().pasnl_flash_fwd_scratch(B, M, N, 32, 32) == (
        splits * B * M * 34 if splits > 1 else 0)
    rng = np.random.RandomState(splits + N)
    q, k, v = (torch.from_numpy(rng.randn(B, n, 32).astype(np.float32)).to(dev)
               for n in (M, N, N))
    scale = tf.flash_scale(32)
    o, lse = cuda_flash.flash_forward(q, k, v, scale)
    po, plse = tf.flash_forward_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert float((o - po).abs().max()) <= 1e-5 * float(po.abs().max())
    assert float((lse - plse).abs().max()) <= 1e-5 * float(plse.abs().max())


def test_flash_past_the_tpu_envelope_forward(dev):
    """N = 131072 at C = D = 32: past the TPU kernel's VMEM cap, which the
    port does not keep."""
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(1, n, 32).astype(np.float32)).to(dev)
               for n in (512, 131072, 131072))
    scale = tf.flash_scale(32)
    o, lse = cuda_flash.flash_forward(q, k, v, scale)
    po, plse = tf.flash_forward_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert float((o - po).abs().max()) <= 1e-5 * float(po.abs().max())
    assert float((lse - plse).abs().max()) <= 1e-5 * float(plse.abs().max())


def test_flash_attention_routes_cuda_tensors_to_the_kernels(dev):
    q, k, v, do, _ = flash_inputs("M 77", dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f0, b0 = cuda_flash.fwd_launches, cuda_flash.bwd_launches
    o = tf.flash_attention(q, k, v)
    o.backward(do)
    torch.cuda.synchronize()
    assert (cuda_flash.fwd_launches - f0, cuda_flash.bwd_launches - b0) == (1, 1)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape and v.grad.shape == v.shape
    with pytest.raises(ValueError, match="float32"):
        tf.flash_attention(q.detach().double(), k.detach().double(), v.detach().double())
    with pytest.raises(ValueError, match="C, D <= 256"):
        cuda_flash.flash_forward(torch.zeros(1, 4, 257, device=dev),
                                 torch.zeros(1, 8, 257, device=dev),
                                 torch.zeros(1, 8, 32, device=dev), 1.0)


def test_flash_seg_train_step_and_forward_launch_counts(dev):
    """Under nl_use_flash a seg train step launches the flash forward and
    backward once for each of the four non-local levels; the serve forward
    launches the forward 4 times and no backward."""
    model = PointASNLSemSegRes(21, nl_use_flash=True, generator=torch.Generator().manual_seed(0),
                               device=dev)
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(1)
    batch = {"points": torch.from_numpy((rng.rand(2, 2048, 3) * 0.5).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 21, (2, 2048))).to(dev),
             "smpw": torch.ones(2, 2048, device=dev)}
    f0, b0, before = cuda_flash.fwd_launches, cuda_flash.bwd_launches, _counts()
    g0 = cuda_gather.launches
    metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert (cuda_flash.fwd_launches - f0, cuda_flash.bwd_launches - b0) == (4, 4)
    assert _launched(before) == (4, 11, 0, 1, 0)
    assert cuda_gather.launches - g0 == SEG_GATHER_BACKWARDS
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    f0, b0 = cuda_flash.fwd_launches, cuda_flash.bwd_launches
    logits = make_inference_fn(model)(batch["points"])
    torch.cuda.synchronize()
    assert (cuda_flash.fwd_launches - f0, cuda_flash.bwd_launches - b0) == (4, 0)
    assert logits.shape == (2, 2048, 21) and bool(torch.isfinite(logits).all())


def test_cls_train_step_launch_counts_in_float32_and_bf16(dev):
    """A cls train step launches FPS 2 and the resident kNN 2 times in
    float32 and in bfloat16; in bfloat16 the gather backwards (float32 and
    bfloat16 sums together) and the plans are those of the float32 step,
    some of them bfloat16. Parameters and BN statistics stay float32."""
    from pointasnl_tpu_torch.nn import precision

    launched = {}
    for dtype in ("float32", "bfloat16"):
        model = PointASNLCls(40, adaptive_sample=True, generator=torch.Generator().manual_seed(0),
                             device=dev)
        state = TrainState(model, make_optimizer(
            "adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7), model.parameters()))
        step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="cls")
        batch = {"points": _cloud(5, 2, 1024).to(dev),
                 "labels": torch.from_numpy(np.random.RandomState(5).randint(0, 40, 2)).to(dev)}
        before = (_counts(), cuda_gather.launches, cuda_gather.bf16_launches,
                  cuda_gather.plan_launches)
        with precision.compute_dtype(dtype):
            metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        assert _launched(before[0]) == (2, 2, 0, 0, 0)
        launched[dtype] = (cuda_gather.launches - before[1], cuda_gather.bf16_launches - before[2],
                           cuda_gather.plan_launches - before[3])
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    (f32, f32_bf16, f32_plans), (g32, g16, plans) = launched["float32"], launched["bfloat16"]
    assert f32 > 0 and f32_bf16 == 0 and g16 > 0
    assert g32 + g16 == f32 and plans == f32_plans


def test_seg_bf16_train_step_launch_counts(dev):
    """A bfloat16 seg step launches the float32 step's kernels: FPS 4, kNN
    11, the ball query 1, the gather backward 19 times (float32 and bfloat16
    sums together) on 12 plans."""
    from pointasnl_tpu_torch.nn import precision

    model = PointASNLSemSegRes(21, generator=torch.Generator().manual_seed(0), device=dev)
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(0)
    batch = {"points": torch.from_numpy((rng.rand(2, 2048, 3) * 0.5).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 21, (2, 2048))).to(dev),
             "smpw": torch.ones(2, 2048, device=dev)}
    before = (_counts(), cuda_gather.launches, cuda_gather.bf16_launches,
              cuda_gather.plan_launches)
    with precision.compute_dtype("bfloat16"):
        metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    assert _launched(before[0]) == (4, 11, 0, 1, 0)
    g32, g16 = cuda_gather.launches - before[1], cuda_gather.bf16_launches - before[2]
    assert g16 > 0 and g32 + g16 == SEG_GATHER_BACKWARDS
    assert cuda_gather.plan_launches - before[3] == SEG_GATHER_PLANS
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
