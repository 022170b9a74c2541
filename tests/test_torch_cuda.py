"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Indices must be exactly equal (ball-query counts too); kNN squared distances
within 1e-6 relative. Flash attention: the kernels and the plain versions
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
from pointasnl_tpu_torch.models import PointASNLCls, PointASNLSemSegRes
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops import flash_attention as tf
from pointasnl_tpu_torch.ops.cuda import ball_query as cuda_ball
from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as cuda_knn
from pointasnl_tpu_torch.ops.cuda import knn_spatial as cuda_spatial
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
    (1, 131072, 16384, 0),  # the whole scene's level 1: the largest N
])
def test_fps_kernel_matches_plain(dev, B, N, npoint, dup):
    x = _cloud(N + npoint, B, N, dup).to(dev)
    got = cuda_fps.farthest_point_sample(npoint, x)
    want = tg.farthest_point_sample(npoint, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, want)


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
])
def test_knn_kernel_matches_plain(dev, B, N, M, k, case):
    support = _cloud(N + M, B, N, dup=N // 2 if case == "duplicates" else 0)
    query = support[:, : N: N // M][:, :M].clone() if case != "disjoint" else _cloud(k, B, M)
    support, query = support.to(dev), query.to(dev)
    got_d, got_i = cuda_knn.knn_point(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-7)
    if case == "subset":  # each query is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(0, N, N // M, device=dev)[:M].expand(B, M))


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
    raise ValueError(case)


BALL_CASES = ["l1_xyz", "cluster", "empty", "exactly_r", "ragged", "duplicates", "n10240"]


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
    raise ValueError(case)


SPATIAL_CASES = ["duplicates", "far from the origin", "ragged N", "gaussian", "B2", "disjoint",
                 "k3 over an eighth"]


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
    if case in ("ragged N", "gaussian", "B2"):  # self-queries without duplicates:
        # each point is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(support.shape[1], device=dev)
                           .expand(support.shape[0], -1))


def test_spatial_knn_prunes_a_scene(dev):
    """On a surface scene the kernel tests a small share of the pairs; on
    the same scene it tests every pair it must (the exact result)."""
    x = _scene(6, 1, 65536, extent=6.0 / 2 ** 0.5).to(dev)
    tested = cuda_spatial.pairs_tested(32, x, x)
    assert 0 < tested < 0.1 * 65536 ** 2


def test_kernels_refuse_sizes_beyond_their_limits(dev):
    with pytest.raises(ValueError, match="N <= 131072"):
        cuda_fps.farthest_point_sample(8, torch.zeros(1, 131073, 3, device=dev))
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
    # Past the spatial kernel's range a search needs the streaming kernel.
    for k, support in ((8, big), (129, big[:, :20000])):
        with pytest.raises(ValueError, match="streaming kNN kernel"):
            ops.knn_point(k, support, big[:, :4])


def _counts():
    return cuda_fps.launches, cuda_knn.launches, cuda_spatial.launches, cuda_ball.launches


def _launched(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def test_dispatch_sends_cuda_tensors_to_the_kernels(dev):
    x = _cloud(1, 2, 256).to(dev)
    before = _counts()
    ops.farthest_point_sample(16, x)
    ops.knn_point(8, x, x[:, :16])
    ops.query_ball_point(0.2, 8, x, x[:, :16])
    assert _launched(before) == (1, 1, 0, 1)
    big = _cloud(2, 1, 12289).to(dev)  # past the resident kernel's N
    before = _counts()
    got = ops.knn_point(8, big, big)  # a self-query
    assert _launched(before) == (0, 0, 1, 0)
    for g, w in zip(got, tg.knn_point(8, big, big)):
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


def test_seg_train_step_and_forward_launch_counts(dev):
    """A seg train step launches FPS 4, kNN 7 + 4 (three_nn) and the ball
    query 1 time; the serve forward the same minus the ball query."""
    model = PointASNLSemSegRes(21, generator=torch.Generator().manual_seed(0), device=dev)
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 2, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(0)
    batch = {"points": torch.from_numpy((rng.rand(2, 2048, 3) * 0.5).astype(np.float32)).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 21, (2, 2048))).to(dev),
             "smpw": torch.ones(2, 2048, device=dev)}
    before = _counts()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert _launched(before) == (4, 11, 0, 1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    before = _counts()
    logits = make_inference_fn(model)(batch["points"])
    torch.cuda.synchronize()
    assert _launched(before) == (4, 11, 0, 0)
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
    assert _launched(before) == (4, 10, 1, 0)
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
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (cuda_flash.fwd_launches - f0, cuda_flash.bwd_launches - b0) == (4, 4)
    assert _launched(before) == (4, 11, 0, 1)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    f0, b0 = cuda_flash.fwd_launches, cuda_flash.bwd_launches
    logits = make_inference_fn(model)(batch["points"])
    torch.cuda.synchronize()
    assert (cuda_flash.fwd_launches - f0, cuda_flash.bwd_launches - b0) == (4, 0)
    assert logits.shape == (2, 2048, 21) and bool(torch.isfinite(logits).all())
