"""The port's PointASNL and PointNet++ cells against ``pointasnl_tpu.nn`` at
narrow widths, with converted (randomized) flax weights.

Tolerance: |port - jax| <= 1e-5 * max(|jax|, 1), as in test_torch_layers.
Neighbour indices inside the SA cell come from the plain geometry ops, which
test_torch_geometry holds to the JAX oracle exactly. Train mode runs in
float64 on both sides: BN then divides by batch deviations of a few dozen
points, which amplifies float32 rounding of two frameworks' reductions past
this tolerance; in float64 the same tolerance holds with room to spare.
"""

import numpy as np
import pytest
import torch
from test_torch_layers import assert_close, run_both

from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.nn import pointnet as jpn
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn import pointnet as tpn
from pointasnl_tpu_torch.ops import geometry as tg

torch.set_num_threads(1)


def _group(seed, B=2, M=6, K=8, C=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, M, K, C).astype(np.float32),
            rng.randn(B, M, K, 3).astype(np.float32))


@pytest.mark.parametrize("training", [False, True])
def test_sample_weights_matches_jax(training):
    feat, xyz = _group(0)
    jout, tout, _, _ = run_both(jp.SampleWeights([32, 6]), tp.SampleWeights(5, [32, 6]),
                                [feat, xyz], training=training)
    assert_close(tout, jout)
    np.testing.assert_allclose(tout.sum(dim=2).numpy(), 1.0, rtol=1e-5)  # softmax over neighbours


@pytest.mark.parametrize("num_neighbor", [4, 0])
def test_adaptive_sampling_matches_jax(num_neighbor):
    feat, xyz = _group(1)
    jout, tout, _, state = run_both(jp.AdaptiveSampling(num_neighbor),
                                    tp.AdaptiveSampling(5, num_neighbor), [xyz, feat],
                                    training=False)
    for t, j in zip(tout, jout):
        assert_close(t, j)
    assert bool(state) == bool(num_neighbor)  # num_neighbor 0 holds no parameters


def test_nonlocal_cell_matches_jax():
    rng = np.random.RandomState(2)
    feature = rng.randn(2, 40, 6).astype(np.float32)
    query = rng.randn(2, 12, 9).astype(np.float32)
    jout, tout, _, _ = run_both(jp.PointNonLocalCell(bottleneck=32, out_channels=16),
                                tp.PointNonLocalCell(6, 9, 32, 16), [feature, query],
                                training=False)
    assert_close(tout, jout)


@pytest.mark.parametrize("C,as_neighbor,NL", [(3, 4, True), (7, 4, True), (3, 0, True), (7, 4, False)])
def test_set_abstraction_matches_jax(C, as_neighbor, NL):
    """Eval mode, as the slice runs it. (In train mode BN divides by batch
    deviations of a 2 x 32-point batch, which amplifies the float32 rounding
    of two frameworks' reductions past this tolerance; BN's train branch is
    held to JAX on its own in test_torch_layers.)"""
    rng = np.random.RandomState(3 + C)
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    feature = xyz.copy() if C == 3 else rng.randn(2, 64, C).astype(np.float32)
    jout, tout, _, _ = run_both(
        jp.PointASNLSetAbstraction(npoint=32, nsample=8, mlp=(16, 16, 32), as_neighbor=as_neighbor,
                                   NL=NL),
        tp.PointASNLSetAbstraction(C, 32, 8, (16, 16, 32), as_neighbor=as_neighbor, NL=NL),
        [xyz, feature], training=False)
    for t, j in zip(tout, jout):
        assert_close(t, j)
    assert tout[1].shape == (2, 32, 32)


@pytest.mark.parametrize("pooling,mlp2,C,use_xyz", [
    ("max", None, 10, True), ("avg", None, 10, True), ("weighted_avg", None, 10, True),
    ("max_and_avg", (8,), 10, True),
    ("max", None, 10, False),  # features alone
    ("max", None, 0, True),    # no features: the xyz alone
])
def test_group_all_pointnet_sa_matches_jax(pooling, mlp2, C, use_xyz):
    rng = np.random.RandomState(4)
    xyz = rng.randn(2, 48, 3).astype(np.float32)
    points = rng.randn(2, 48, C).astype(np.float32) if C else None
    jout, tout, _, _ = run_both(
        jpn.PointNetSAModule(mlp=(16, 24), group_all=True, pooling=pooling, mlp2=mlp2,
                             use_xyz=use_xyz),
        tpn.PointNetSAModule(C, (16, 24), group_all=True, pooling=pooling, mlp2=mlp2,
                             use_xyz=use_xyz),
        [xyz, points], training=False)
    for t, j in zip(tout, jout):
        assert_close(t, j)


def _assert_bn_stats(state, stats, prefix=""):
    """Every running statistic of the port equals the JAX update."""
    for name, value in stats.items():
        if isinstance(value, dict):
            _assert_bn_stats(state, value, f"{prefix}{name}.")
        else:
            assert_close(state[f"{prefix}{name}"], value)


@pytest.mark.parametrize("NL,training", [(False, False), (False, True), (True, True)])
def test_set_abstraction_same_resolution_matches_jax(NL, training):
    """N == npoint: no FPS, no adaptive sampling, non-local queries are the
    input features; in train mode the BN statistics move as in JAX."""
    rng = np.random.RandomState(5)
    xyz = rng.rand(2, 48, 3).astype(np.float32)
    feature = rng.randn(2, 48, 6).astype(np.float32)
    jout, tout, stats, state = run_both(
        jp.PointASNLSetAbstraction(npoint=48, nsample=8, mlp=(16, 16, 32), as_neighbor=0, NL=NL),
        tp.PointASNLSetAbstraction(6, None, 8, (16, 16, 32), as_neighbor=0, NL=NL,
                                   downsample=False),
        [xyz, feature], training=training, momentum=0.5, x64=training)
    for t, j in zip(tout, jout):
        assert_close(t, j)
    np.testing.assert_array_equal(tout[0].numpy(), xyz.astype(tout[0].numpy().dtype))
    if training:
        _assert_bn_stats(state, stats)


def test_set_abstraction_hints_match_jax():
    """fps_idx / knn_idx hints: the same cell output as JAX given the same
    hints, and as the port's own searches."""
    rng = np.random.RandomState(6)
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    feature = rng.randn(2, 64, 4).astype(np.float32)
    fps_idx = tg.farthest_point_sample(16, torch.from_numpy(xyz))
    _, knn_idx = tg.knn_point(8, torch.from_numpy(xyz), tg.gather_point(torch.from_numpy(xyz), fps_idx))
    hints = {"fps_idx": fps_idx.numpy(), "knn_idx": knn_idx.numpy()}
    cell = tp.PointASNLSetAbstraction(4, 16, 8, (16, 32), as_neighbor=4)
    jout, tout, _, _ = run_both(
        jp.PointASNLSetAbstraction(npoint=16, nsample=8, mlp=(16, 32), as_neighbor=4), cell,
        [xyz, feature], training=False, kwargs=hints)
    for t, j in zip(tout, jout):
        assert_close(t, j)
    with torch.no_grad():
        unhinted = cell(torch.from_numpy(xyz), torch.from_numpy(feature))
    for t, u in zip(tout, unhinted):
        torch.testing.assert_close(t, u, rtol=0, atol=0)


def test_set_abstraction_ball_grouping_matches_jax():
    rng = np.random.RandomState(7)
    xyz = (rng.rand(2, 64, 3) * 0.5).astype(np.float32)
    jout, tout, _, _ = run_both(
        jp.PointASNLSetAbstraction(npoint=16, nsample=8, mlp=(16, 32), as_neighbor=4,
                                   use_knn=False, radius=0.2),
        tp.PointASNLSetAbstraction(3, 16, 8, (16, 32), as_neighbor=4, use_knn=False, radius=0.2),
        [xyz, xyz.copy()], training=False)
    for t, j in zip(tout, jout):
        assert_close(t, j)


def test_set_abstraction_refuses_a_call_of_the_other_kind():
    cell = tp.PointASNLSetAbstraction(3, None, 4, (8, 8), downsample=False)
    x = torch.randn(1, 16, 3)
    with pytest.raises(ValueError, match="downsample=False"):
        cell(x, x, npoint=8)
    with pytest.raises(ValueError, match="downsample=True"):
        tp.PointASNLSetAbstraction(3, None, 4, (8, 8))(x, x)


@pytest.mark.parametrize("training,with_points1", [(True, True), (False, False)])
def test_fp_module_matches_jax(training, with_points1):
    rng = np.random.RandomState(8)
    xyz1, xyz2 = rng.randn(2, 40, 3).astype(np.float32), rng.randn(2, 10, 3).astype(np.float32)
    points1 = rng.randn(2, 40, 5).astype(np.float32) if with_points1 else None
    points2 = rng.randn(2, 10, 7).astype(np.float32)
    jout, tout, stats, state = run_both(
        jpn.PointNetFPModule(mlp=(16, 8)),
        tpn.PointNetFPModule(7 + (5 if with_points1 else 0), (16, 8)),
        [xyz1, xyz2, points1, points2], training=training, momentum=0.5, x64=training)
    assert_close(tout, jout)
    assert sorted(state) == sorted(f"conv_{i}.{k}" for i in range(2)
                                   for k in ("conv.weight", "bn.scale", "bn.bias", "bn.mean", "bn.var"))
    if training:
        _assert_bn_stats(state, stats)
