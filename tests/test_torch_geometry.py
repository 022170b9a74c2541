"""The port's plain geometry ops against the JAX package (oracle and Pallas
kernels in interpret mode), and the routing of ``ops.dispatch``.

Indices must be exactly equal; squared distances within 1e-6 relative (both
sides compute (dx*dx + dy*dy) + dz*dz in float32, so they agree to the bit in
practice). The kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.ops.pallas import fps as pfps
from pointasnl_tpu.ops.pallas import knn as pknn
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as cuda_knn

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
    raise ValueError(case)


@pytest.mark.parametrize("case", ["disjoint", "subset", "duplicates", "k_gt_n"])
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


def test_dispatch_routes_cpu_tensors_to_plain_versions():
    x = torch.from_numpy(_cloud(10, 2, 64))
    fps_before, knn_before = cuda_fps.launches, cuda_knn.launches
    np.testing.assert_array_equal(ops.farthest_point_sample(16, x).numpy(),
                                  tg.farthest_point_sample(16, x).numpy())
    for g, w in zip(ops.knn_point(8, x, x[:, :16]), tg.knn_point(8, x, x[:, :16])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert (cuda_fps.launches, cuda_knn.launches) == (fps_before, knn_before)


def test_dispatch_raises_on_other_devices():
    x = torch.empty(1, 64, 3, device="meta")
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.farthest_point_sample(8, x)
    with pytest.raises(ValueError, match="no implementation for device"):
        ops.knn_point(4, x, x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version in its stead."""
    x = torch.from_numpy(_cloud(11, 1, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fps.farthest_point_sample(4, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_knn.knn_point(4, x, x)
