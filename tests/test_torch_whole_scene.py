"""Whole-scene serving (slice 3) against the JAX package, on the CPU.

- ``knn_point_chunked`` and the dense/chunked switch of ``knn_point``:
  indices equal, squared distances within 1e-6 relative (both sides compute
  (dx*dx + dy*dy) + dz*dz in float32).
- The spatial kNN's plan: Morton codes equal to the bit, bounding spheres
  within 1e-6. The kernel's visit rule, run by ``knn_spatial.emulate`` on the
  plan, gives the plain kNN's indices exactly (and its distances to the bit),
  on the cases of ``tests/test_pallas_kernels.py:121-216``; one case is also
  held against the Pallas kernel in interpret mode.
- ``blockwise_attention`` and the non-local cell with ``kv_block_size``:
  within 1e-5 * max(|jax|, 1) of JAX, and of the port's dense attention.
- The slice: ``PointASNLSemSegRes(21, nl_kv_block_size=768)``, eval forward
  at B1 x 2048, full width, float32, weights carried across by
  ``utils.convert``: within 1e-4 * max(|jax|, 1) of JAX with the same argmax
  (the tolerance of test_torch_seg), and within 1e-5 * max(|dense|, 1) of the
  port's dense model. Level 1 streams its 2048 keys in blocks of 768, 768 and
  a ragged 512; level 2 takes the dense branch.
- ``surface_scene`` gives the JAX package's array to the bit.

The forward here also holds whole-scene serving past 2^21 points (B1 x
2228224 on the card) to JAX: the modules are the same at that size, and
only the card's routing differs (the stem's kNN takes the streaming kernel,
the first FPS the grid design), which ``tests/test_torch_streaming.py``
holds to JAX's routing and ``tests/test_torch_cuda.py`` checks on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_layers import assert_close, run_both
from test_torch_seg import flax_variables, port_state_dict

from pointasnl_tpu.data.synthetic import surface_scene as jax_surface_scene
from pointasnl_tpu.models import PointASNLSemSegRes as JaxSegRes
from pointasnl_tpu.nn import blockwise as jb
from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.ops.pallas import knn_spatial as pks
from pointasnl_tpu_torch.data import surface_scene
from pointasnl_tpu_torch.models import PointASNLSemSegRes
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn.blockwise import blockwise_attention
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import knn_spatial as ks
from pointasnl_tpu_torch.serve import make_inference_fn

torch.set_num_threads(1)


def _cloud(seed, B, N):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)


def _assert_knn(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("M,k", [(300, 16), (1000, 3)])
def test_knn_point_chunked_matches_jax(M, k):
    """Ragged blocks on both axes: 1000 support points in chunks of 128."""
    s, q = _cloud(1, 2, 1000), _cloud(2, 2, M)
    got = tg.knn_point_chunked(k, torch.from_numpy(s), torch.from_numpy(q), query_block=64,
                               support_block=128)
    want = jg.knn_point_chunked(k, jnp.asarray(s), jnp.asarray(q), query_block=64,
                                support_block=128)
    _assert_knn([t.numpy() for t in got], want)


def test_knn_point_switches_to_chunked_past_the_dense_limit(monkeypatch):
    """Past DENSE_KNN_MAX_ELEMENTS distances knn_point never builds the
    matrix, and gives the dense result; duplicates keep their tie order."""
    s = _cloud(3, 1, 4000)
    s[:, 2000:] = s[:, :2000]
    q = s[:, ::4].copy()
    want = jg.knn_point(8, jnp.asarray(s), jnp.asarray(q))  # 4e6 elements: dense in JAX
    calls = []
    chunked = tg.knn_point_chunked
    monkeypatch.setattr(tg, "knn_point_chunked",
                        lambda *a, **kw: calls.append(1) or chunked(*a, **kw))
    monkeypatch.setattr(tg, "DENSE_KNN_MAX_ELEMENTS", 2 ** 20)
    _assert_knn([t.numpy() for t in tg.knn_point(8, torch.from_numpy(s), torch.from_numpy(q))],
                want)
    assert calls == [1]


@pytest.mark.parametrize("offset", [0.0, 1000.0])
def test_morton_codes_and_spheres_match_jax(offset):
    x = np.random.RandomState(4).rand(2, 700, 3).astype(np.float32) + np.float32(offset)
    if offset:
        x = (offset + 0.01 * (x - offset)).astype(np.float32)  # a dense cluster far out
    lo, hi = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
    got = ks.morton_codes(torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(hi))
    want = pks._morton_codes(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 500  # the grid resolves the cloud
    segs = x[:, :640].reshape(2, 5, 128, 3)
    c, r = ks.sphere(torch.from_numpy(segs))
    jc, jr = pks._sphere(jnp.asarray(segs))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


def _spatial_case(case):
    """(support, query or None for a self-query, k, seg_w, tile_m) as numpy."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "self 600 k8":
        return rng.randn(2, 600, 3).astype(np.float32), None, 8, 128, 128
    if case == "disjoint 170q/600 k16":
        return (rng.randn(2, 600, 3).astype(np.float32), rng.randn(2, 170, 3).astype(np.float32),
                16, 128, 64)
    if case == "self 1024 k32":
        return rng.randn(1, 1024, 3).astype(np.float32), None, 32, 128, 128
    if case == "disjoint 50q/300 k3":
        return (rng.randn(1, 300, 3).astype(np.float32), rng.randn(1, 50, 3).astype(np.float32),
                3, 64, 32)
    if case == "duplicates":  # coincident points: ties everywhere
        pts = rng.randn(1, 100, 3).astype(np.float32)
        return np.concatenate([pts, pts[:, :60], pts[:, :40]], axis=1), None, 8, 32, 32
    if case == "far from the origin":  # the bounds' cancellation needs the absolute slack
        return (rng.randn(1, 400, 3) * 0.01 + 1000.0).astype(np.float32), None, 8, 64, 32
    if case == "surface scene, k3 over its eighth":
        x = surface_scene(rng, 1, 2048, extent=1.5)
        return x[:, :256].copy(), x, 3, 64, 128
    if case == "surface scene 4096 k16":  # the kernel's own segment width
        return surface_scene(rng, 1, 4096, extent=1.5), None, 16, None, 128
    raise ValueError(case)


SPATIAL_CASES = ["self 600 k8", "disjoint 170q/600 k16", "self 1024 k32", "disjoint 50q/300 k3",
                 "duplicates", "far from the origin", "surface scene, k3 over its eighth",
                 "surface scene 4096 k16"]


@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_spatial_visit_rule_is_exact(case):
    s, q, k, seg_w, tile_m = _spatial_case(case)
    support = torch.from_numpy(s)
    query = support if q is None else torch.from_numpy(q)
    d, i, tested = ks.emulate(k, support, query, seg_w=seg_w, tile_m=tile_m)
    want_d, want_i = tg.knn_point(k, support, query)
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    assert 0 < tested <= s.shape[0] * s.shape[1] * query.shape[1]
    if case == "far from the origin":  # and the float32 ranking is the float64 one
        x = s[0].astype(np.float64)
        d64 = ((x[:, None] - x[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(i[0].numpy(), np.argsort(d64, axis=1, kind="stable")[:, :k])
    if case == "surface scene 4096 k16":  # a scan prunes: most pairs are never tested
        assert tested < 0.5 * 4096 * 4096


def test_spatial_visit_rule_matches_the_pallas_kernel():
    s, _, k, seg_w, tile_m = _spatial_case("disjoint 170q/600 k16")
    q = np.random.RandomState(9).randn(2, 170, 3).astype(np.float32)
    d, i, _ = ks.emulate(k, torch.from_numpy(s), torch.from_numpy(q), seg_w=seg_w, tile_m=tile_m)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = pks.knn_point(k, jnp.asarray(s), jnp.asarray(q), seg_w=seg_w, tile_m=tile_m)
    _assert_knn((d.numpy(), i.numpy()), (jd, ji))


@pytest.mark.parametrize("N,block,scaled", [(1000, 300, True), (1000, 300, False),
                                            (600, 600, True), (400, 1024, False)])
def test_blockwise_attention_matches_jax(N, block, scaled):
    rng = np.random.RandomState(N + block)
    q, k = rng.randn(2, 50, 32).astype(np.float32), rng.randn(2, N, 32).astype(np.float32)
    v = rng.randn(2, N, 16).astype(np.float32)
    got = blockwise_attention(*map(torch.from_numpy, (q, k, v)), block_size=block, scaled=scaled)
    want = jb.blockwise_attention(*map(jnp.asarray, (q, k, v)), block_size=block, scaled=scaled)
    assert_close(got.numpy(), want)
    dense = blockwise_attention(*map(torch.from_numpy, (q, k, v)), block_size=N, scaled=scaled)
    assert_close(got.numpy(), dense.numpy())


def test_nonlocal_cell_with_kv_blocks_matches_jax_and_its_dense_path():
    rng = np.random.RandomState(5)
    feature = rng.randn(2, 100, 6).astype(np.float32)
    query = rng.randn(2, 12, 9).astype(np.float32)
    cell = tp.PointNonLocalCell(6, 9, 32, 16, kv_block_size=32)
    jout, tout, _, sd = run_both(
        jp.PointNonLocalCell(bottleneck=32, out_channels=16, kv_block_size=32), cell,
        [feature, query], training=False)
    assert_close(tout, jout)
    dense = tp.PointNonLocalCell(6, 9, 32, 16).eval()
    dense.load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert_close(tout, dense(torch.from_numpy(feature), torch.from_numpy(query)))


@pytest.mark.parametrize("seed", [0, 3])
def test_surface_scene_matches_jax_bit_for_bit(seed):
    got = surface_scene(np.random.RandomState(seed), 2, 5000, extent=6.0)
    want = jax_surface_scene(np.random.RandomState(seed), 2, 5000, extent=6.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


BLOCK, SCENE_N, NUM_CLASS = 768, 2048, 21


@pytest.fixture(scope="module")
def scene_reference():
    """Weights, a surface scene of 2048 points, and JAX's blockwise forward."""
    x = surface_scene(np.random.RandomState(0), 1, SCENE_N, extent=1.5)
    sd = port_state_dict()
    jmodel = JaxSegRes(num_class=NUM_CLASS, nl_kv_block_size=BLOCK, dropout_keep=1.0)
    variables = flax_variables(jmodel, x, sd)
    logits, _ = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(variables, jnp.asarray(x))
    return sd, x, np.asarray(logits)


def test_whole_scene_forward_matches_jax_and_the_dense_model(scene_reference):
    sd, x, ref = scene_reference
    points = torch.from_numpy(x)
    model = PointASNLSemSegRes(NUM_CLASS, nl_kv_block_size=BLOCK, dropout_keep=1.0, device="cpu")
    model.load_state_dict(sd, strict=True)  # the block size adds no parameters
    logits = make_inference_fn(model)(points).numpy()
    assert logits.shape == (1, SCENE_N, NUM_CLASS) and np.isfinite(logits).all()
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(logits - ref).max())
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))

    dense = PointASNLSemSegRes(NUM_CLASS, dropout_keep=1.0, device="cpu")
    dense.load_state_dict(sd, strict=True)
    assert_close(logits, make_inference_fn(dense)(points).numpy())
