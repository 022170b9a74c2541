"""The port's plain geometry ops against the JAX package (oracle and Pallas
kernels in interpret mode), and the routing of ``ops.dispatch``.

Indices must be exactly equal (ball-query counts too); squared distances
within 1e-6 relative (both sides compute (dx*dx + dy*dy) + dz*dz in float32,
so they agree to the bit in practice). Interpolated features and the
repulsion loss and its gradient within 1e-5 relative: float32 with the same
operation order, different reduction and sqrt/exp implementations. The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.ops.pallas import ball_query as pball
from pointasnl_tpu.ops.pallas import fps as pfps
from pointasnl_tpu.ops.pallas import knn as pknn
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import ball_query as cuda_ball
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as cuda_knn
from pointasnl_tpu_torch.ops.cuda import knn_spatial as cuda_spatial

torch.set_num_threads(1)


def _cloud(seed, B, N, dup=0):
    """Random (B, N, 3) float32 cloud; with `dup`, its last `dup` points copy
    the first ones, so distances tie."""
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:
        x[:, N - dup:] = x[:, :dup]
    return x


def _assert_dist(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_pairwise_sqdist_matches_jax():
    q, s = _cloud(0, 2, 40), _cloud(1, 2, 70)
    got = tg.pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    want = np.asarray(jg.pairwise_sqdist(jnp.asarray(q), jnp.asarray(s)))
    _assert_dist(got, want)


@pytest.mark.parametrize("B,N,npoint,dup", [
    (2, 256, 64, 0),
    (1, 300, 50, 0),   # N not a multiple of 32 or 128
    (3, 128, 128, 0),  # npoint == N
    (2, 200, 60, 100),  # duplicate points: ties in the running min distance
    (2, 64, 1, 0),     # npoint == 1
])
def test_fps_matches_jax_oracle_and_pallas(B, N, npoint, dup):
    x = _cloud(B * N + npoint, B, N, dup)
    got = tg.farthest_point_sample(npoint, torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    want = np.asarray(jg.farthest_point_sample(npoint, jnp.asarray(x)))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(pfps.farthest_point_sample(npoint, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("n,cluster_max_n,name", [
    (10240, cuda_fps.CLUSTER_MAX_N, "block"), (10241, cuda_fps.CLUSTER_MAX_N, "cluster"),
    (131072, cuda_fps.CLUSTER_MAX_N, "cluster"), (131073, cuda_fps.CLUSTER_MAX_N, "cluster"),
    (278528, cuda_fps.CLUSTER_MAX_N, "cluster"), (278529, cuda_fps.CLUSTER_MAX_N, "grid"),
    (2228224, cuda_fps.CLUSTER_MAX_N, "grid"),
    # a card that states no room for the 16-block cluster
    (10240, 0, "block"), (10241, 0, "grid"), (278528, 0, "grid")])
def test_fps_design_routes_each_n_to_the_smallest_design_that_holds_it(n, cluster_max_n, name):
    caps = {"block": cuda_fps.BLOCK_MAX_N, "cluster": cluster_max_n}
    assert cuda_fps.design(n, cluster_max_n) == name
    assert n <= caps.get(name, float("inf"))
    assert all(n > caps[d] for d in cuda_fps.DESIGNS[:cuda_fps.DESIGNS.index(name)])


@pytest.mark.parametrize("stated,cap", [(cuda_fps.CLUSTER_MAX_N, cuda_fps.CLUSTER_MAX_N),
                                        (-801, 0)])  # -cudaErrorNotSupported: no room
def test_fps_routes_by_the_cluster_cap_the_library_states(monkeypatch, stated, cap):
    class Library:
        calls = 0

        def pasnl_fps_cluster_max_n(self):
            Library.calls += 1
            return stated

    monkeypatch.setattr(cuda_fps, "_cluster_caps", {})
    lib = Library()
    assert cuda_fps.stated_cluster_max_n(lib, device=0) == cap
    assert cuda_fps.stated_cluster_max_n(lib, device=0) == cap and Library.calls == 1
    assert cuda_fps.design(131072, cuda_fps.stated_cluster_max_n(lib, device=0)) == (
        "cluster" if cap else "grid")


@pytest.mark.parametrize("n", [131073, 278529])
def test_fps_matches_jax_oracle_at_the_cluster_design_caps(n):
    """At 2^17 + 1 and at the grid design's smallest N (278529), with
    duplicates, 64 picks."""
    x = _cloud(n, 1, n, dup=n // 2)
    got = tg.farthest_point_sample(64, torch.from_numpy(x))
    want = np.asarray(jg.farthest_point_sample(64, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)


def _knn_case(case):
    """(support, query, k) for the named kNN case."""
    if case == "disjoint":
        return _cloud(0, 2, 200), _cloud(1, 2, 70), 12
    if case == "subset":  # query ⊂ support, like the SA layers
        s = _cloud(2, 2, 256)
        return s, s[:, ::4].copy(), 32
    if case == "duplicates":
        s = _cloud(3, 1, 300, dup=150)
        return s, s[:, 100:200].copy(), 16
    if case == "k_gt_n":
        return _cloud(4, 2, 10), _cloud(5, 2, 7), 16
    if case == "lattice":  # integer points: many exact ties at several distances
        g = np.stack(np.meshgrid(*[np.arange(8, dtype=np.float32)] * 3, indexing="ij"), -1)
        s = np.ascontiguousarray(g.reshape(1, 512, 3))
        return s, s[:, ::5].copy(), 64
    if case == "all_equal":  # every distance 0: the indices 0 .. k-1
        s = np.repeat(_cloud(6, 2, 1), 300, axis=1)
        return s, s[:, :40].copy(), 32
    raise ValueError(case)


@pytest.mark.parametrize("case", ["disjoint", "subset", "duplicates", "k_gt_n", "lattice",
                                  "all_equal"])
def test_knn_matches_jax_oracle_and_pallas(case):
    support, query, k = _knn_case(case)
    got_d, got_i = tg.knn_point(k, torch.from_numpy(support), torch.from_numpy(query))
    assert got_i.dtype == torch.int32 and got_i.shape == query.shape[:2] + (k,)
    want_d, want_i = jg.knn_point(k, jnp.asarray(support), jnp.asarray(query))
    with pltpu.force_tpu_interpret_mode():
        pal_d, pal_i = pknn.knn_point(k, jnp.asarray(support), jnp.asarray(query))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))
    _assert_dist(got_d.numpy(), np.asarray(want_d))
    _assert_dist(got_d.numpy(), np.asarray(pal_d))
    if case == "subset":  # each query is its own first neighbour
        np.testing.assert_array_equal(got_i[..., 0].numpy(), np.arange(0, 256, 4)[None].repeat(2, 0))
    if case == "all_equal":
        np.testing.assert_array_equal(got_i.numpy(), np.broadcast_to(np.arange(k), got_i.shape))


def test_gather_and_group_match_jax():
    rng = np.random.RandomState(7)
    pts = rng.randn(2, 50, 5).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 9, 4)).astype(np.int32)
    got = tg.gather_point(torch.from_numpy(pts), torch.from_numpy(idx[..., 0])).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.gather_point(jnp.asarray(pts), jnp.asarray(idx[..., 0]))))
    got = tg.group_point(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.group_point(jnp.asarray(pts), jnp.asarray(idx))))


def test_sampling_and_grouping_match_jax():
    x = _cloud(8, 2, 128)
    feat = np.random.RandomState(9).randn(2, 128, 6).astype(np.float32)
    new_xyz, new_feat = ops.sampling(32, torch.from_numpy(x), torch.from_numpy(feat))
    want_xyz, want_feat = jg.sampling(32, jnp.asarray(x), jnp.asarray(feat))
    np.testing.assert_array_equal(new_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_array_equal(new_feat.numpy(), np.asarray(want_feat))
    for use_xyz in (True, False):
        got = ops.grouping(torch.from_numpy(feat), 8, torch.from_numpy(x), new_xyz, use_xyz=use_xyz)
        want = jg.grouping(jnp.asarray(feat), 8, jnp.asarray(x), want_xyz, use_xyz=use_xyz)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _ball_case(case):
    """(xyz, new_xyz, radius, nsample) of a named ball-query case, at the
    sizes of the CPU tests; test_torch_cuda has them at the card's."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "self_query":  # the repulsion loss: a cloud against itself
        x = (rng.rand(2, 256, 3) * 0.2).astype(np.float32)
        return x, x, 0.07, 20
    if case == "cluster":  # more than nsample hits: the count is capped
        x = (rng.rand(2, 300, 3) * 0.5).astype(np.float32)
        x[:, 100:160] = 0.25 + 0.01 * rng.rand(2, 60, 3)
        return x, x[:, 90:170].copy(), 0.07, 20
    if case == "empty":  # queries far from every point
        return rng.rand(2, 130, 3).astype(np.float32), np.full((2, 8, 3), 100.0, np.float32), 0.1, 8
    if case == "exactly_r":  # d^2 == r^2 exactly stays out of the ball
        x = np.zeros((1, 40, 3), np.float32)
        x[0, :, 0] = np.linspace(0.2, 1.0, 40)
        x[0, 12] = (0.5, 0.0, 0.0)
        return x, np.zeros((1, 1, 3), np.float32), 0.5, 16
    if case == "ragged":  # N not a multiple of 32 or 128
        x = (rng.rand(2, 300, 3) * 0.5).astype(np.float32)
        return x, x[:, ::7].copy(), 0.1, 32
    if case == "duplicates":
        x = (rng.rand(2, 200, 3) * 0.5).astype(np.float32)
        x[:, 100:] = x[:, :100]
        return x, x[:, 80:120].copy(), 0.1, 24
    if case == "nsample_gt_n":  # more slots than support points
        x = (rng.rand(1, 12, 3) * 0.1).astype(np.float32)
        return x, x[:, :5].copy(), 0.2, 16
    raise ValueError(case)


# The Pallas kernel in interpret mode (~1.5 s a call) on the cases its own
# tests (tests/test_pallas_kernels.py: random balls, an empty ball) do not cover.
PALLAS_BALL_CASES = ("self_query", "cluster", "exactly_r", "duplicates")


@pytest.mark.parametrize("case", ["self_query", "cluster", "empty", "exactly_r", "ragged",
                                  "duplicates", "nsample_gt_n"])
def test_ball_query_matches_jax_oracle_and_pallas(case):
    xyz, new_xyz, radius, nsample = _ball_case(case)
    got_i, got_c = tg.query_ball_point(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
    assert got_i.dtype == torch.int32 and got_i.shape == new_xyz.shape[:2] + (nsample,)
    assert got_c.dtype == torch.int32 and got_c.shape == new_xyz.shape[:2]
    want_i, want_c = jg.query_ball_point(radius, nsample, jnp.asarray(xyz), jnp.asarray(new_xyz))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    if case in PALLAS_BALL_CASES:
        with pltpu.force_tpu_interpret_mode():
            pal_i, pal_c = pball.query_ball_point(radius, nsample, jnp.asarray(xyz),
                                                  jnp.asarray(new_xyz))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(pal_c))
    if case == "cluster":
        assert int(got_c.max()) == nsample
    if case == "empty":
        assert not bool(got_i.any()) and not bool(got_c.any())
    if case == "exactly_r":
        assert 12 not in got_i[0, 0].tolist() and int(got_c[0, 0]) < nsample


@pytest.mark.parametrize("N", [40, 2, 1])
def test_three_nn_matches_jax(N):
    """N < 3 pads the missing slots with distance 1e38 and index 0."""
    xyz1, xyz2 = _cloud(20, 2, 50), _cloud(21, 2, N)
    got_d, got_i = tg.three_nn(torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    want_d, want_i = jg.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    assert got_i.shape == (2, 50, 3) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    _assert_dist(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("N", [40, 2])
def test_three_interpolate_idw_matches_jax(N):
    xyz1, xyz2 = _cloud(22, 2, 60), _cloud(23, 2, N)
    xyz1[:, :5] = xyz2[:, :5] if N >= 5 else xyz1[:, :5]  # queries on the support: d^2 = 0
    feats = np.random.RandomState(24).randn(2, N, 6).astype(np.float32)
    pts = torch.from_numpy(feats).requires_grad_()
    got = tg.three_interpolate_idw(torch.from_numpy(xyz1), torch.from_numpy(xyz2), pts)
    got.square().sum().backward()
    want, vjp = jax.vjp(lambda p: jg.three_interpolate_idw(jnp.asarray(xyz1), jnp.asarray(xyz2), p),
                        jnp.asarray(feats))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pts.grad.numpy(), np.asarray(vjp(2 * want)[0]), rtol=1e-5, atol=1e-5)


def test_repulsion_loss_value_and_gradient_match_jax():
    """On clustered points, so the balls hold several neighbours and the
    top-5 and its gradient see real distances, not only the point itself."""
    rng = np.random.RandomState(25)
    centres = rng.rand(2, 8, 1, 3) * 0.5
    x = (centres + 0.03 * rng.randn(2, 8, 16, 3)).reshape(2, 128, 3).astype(np.float32)
    pred = torch.from_numpy(x).requires_grad_()
    loss = tg.repulsion_loss(pred, nsample=20, radius=0.07)
    loss.backward()
    want, grad = jax.value_and_grad(lambda p: jg.repulsion_loss(p, nsample=20, radius=0.07))(
        jnp.asarray(x))
    _, cnt = tg.query_ball_point(0.07, 20, pred.detach(), pred.detach())
    assert float(cnt.float().mean()) > 4.0
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    scale = float(np.abs(np.asarray(grad)).max())
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(grad), rtol=0, atol=1e-5 * scale)
    assert scale > 0


def test_grouping_ball_branch_and_idx_hint_match_jax():
    x = (np.random.RandomState(26).rand(2, 128, 3) * 0.4).astype(np.float32)
    feat = np.random.RandomState(27).randn(2, 128, 5).astype(np.float32)
    q = x[:, ::4].copy()
    got = ops.grouping(torch.from_numpy(feat), 16, torch.from_numpy(x), torch.from_numpy(q),
                       use_knn=False, radius=0.15)
    want = jg.grouping(jnp.asarray(feat), 16, jnp.asarray(x), jnp.asarray(q), use_knn=False,
                       radius=0.15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hinted = ops.grouping(torch.from_numpy(feat), 16, torch.from_numpy(x), torch.from_numpy(q),
                          idx=got[2])  # the hint short-circuits the (kNN) search
    for g, h in zip(got, hinted):
        np.testing.assert_array_equal(g.numpy(), h.numpy())


def test_dispatch_routes_cpu_tensors_to_plain_versions():
    x = torch.from_numpy(_cloud(10, 2, 64))
    before = (cuda_fps.launches, cuda_knn.launches, cuda_ball.launches)
    np.testing.assert_array_equal(ops.farthest_point_sample(16, x).numpy(),
                                  tg.farthest_point_sample(16, x).numpy())
    for g, w in zip(ops.knn_point(8, x, x[:, :16]), tg.knn_point(8, x, x[:, :16])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(ops.query_ball_point(0.5, 8, x, x[:, :16]),
                    tg.query_ball_point(0.5, 8, x, x[:, :16])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(ops.three_nn(x[:, :16], x), tg.three_nn(x[:, :16], x)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert float(ops.repulsion_loss(x)) == float(tg.repulsion_loss(x))
    assert (cuda_fps.launches, cuda_knn.launches, cuda_ball.launches) == before


def test_dispatch_raises_on_other_devices():
    x = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.farthest_point_sample(8, x)
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.knn_point(4, x, x)
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.query_ball_point(0.1, 4, x, x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version in its stead."""
    x = torch.from_numpy(_cloud(11, 1, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fps.farthest_point_sample(4, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_knn.knn_point(4, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_ball.query_ball_point(0.1, 4, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spatial.knn_point(4, x, x)
