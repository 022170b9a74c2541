"""The streaming kNN slice (whole-scene serving past 2^21 points) against the
JAX package, on the CPU.

- The port's plain kNN (``ops.geometry.knn_point``, which the streaming CUDA
  kernel is held against on the card) against JAX's streaming Pallas kernel
  (``pointasnl_tpu/ops/pallas/knn.py:_knn_kernel``) in interpret mode,
  forced as ``tests/test_pallas_kernels.py`` forces it: no resident scan,
  support chunks of 128, no spatial kernel. Indices equal, squared
  distances within 1e-6 relative (test_torch_geometry's tolerance). Each
  case has shapes of its own, so that no cached trace of the jitted
  ``_knn_scan`` with the default tile can stand in for it; the test checks
  that the streaming kernel was traced.
- ``ops.dispatch.knn_route`` against the JAX package's routing, read by
  tracing ``pointasnl_tpu.ops.pallas.knn.knn_point`` with ``jax.eval_shape``
  at each (N, k) around every boundary (12288, 65536, 2^21; k 128/129):
  every search JAX runs has a route in the port, and that route's kernel
  takes it under the same contract.
- FPS's choice of design by N, and the streaming wrapper's refusal of CPU
  tensors.
- The streaming kernel's visit rule (nearest segments first, a segment
  skipped when its bound exceeds every row's kth), which
  ``knn_streaming.emulate`` runs in plain PyTorch on the kernel's plan
  because the kernel cannot run on the CPU: indices equal to the plain kNN's
  and distances equal to the bit, with ties, duplicates, k > N, k > 128,
  B > 1 and disjoint queries; and its tile and segment width, which keep the
  plan of a B1 x 2228224 stem within PLAN_ELEMENTS.

The slice's model path on the CPU is held to JAX by
``tests/test_torch_whole_scene.py`` (the whole-scene forward at B1 x 2048):
the modules are the same at B1 x 2228224, only the card's routing of the
kNN and FPS differs, and that is what this file and the card tests
(``tests/test_torch_cuda.py``) check. No CPU run at 2 M points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.ops.pallas import knn as pknn
from pointasnl_tpu.ops.pallas import knn_spatial as pks
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.ops import dispatch
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn_spatial as cuda_spatial
from pointasnl_tpu_torch.ops.cuda import knn_streaming as cuda_streaming

torch.set_num_threads(1)


def _cloud(seed, B, N, dup=0):
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:
        x[:, N - dup:] = x[:, :dup]
    return x


def _streaming_case(case):
    """(support, query, k) of a named case; shapes differ between cases."""
    if case == "self k3 B2 N301":  # N not a multiple of the 128-point chunk
        s = _cloud(40, 2, 301)
        return s, s, 3
    if case == "disjoint k32 N437 M150":
        return _cloud(41, 1, 437), _cloud(42, 1, 150), 32
    if case == "duplicates k32 N402":  # ties: the lower index first
        s = _cloud(43, 1, 402, dup=201)
        return s, s[:, 100:300].copy(), 32
    if case == "self k129 N519":
        s = _cloud(44, 1, 519)
        return s, s, 129
    if case == "disjoint k129 B2 N262 M90":
        return _cloud(45, 2, 262), _cloud(46, 2, 90), 129
    if case == "disjoint k3 B2 N1003 M77":  # eight chunks
        return _cloud(47, 2, 1003), _cloud(48, 2, 77), 3
    raise ValueError(case)


STREAMING_CASES = ["self k3 B2 N301", "disjoint k32 N437 M150", "duplicates k32 N402",
                   "self k129 N519", "disjoint k129 B2 N262 M90", "disjoint k3 B2 N1003 M77"]


@pytest.mark.parametrize("case", STREAMING_CASES)
def test_plain_knn_matches_jax_streaming_kernel(case, monkeypatch):
    support, query, k = _streaming_case(case)
    monkeypatch.setenv("POINTASNL_KNN_SPATIAL", "never")
    monkeypatch.setattr(pknn, "RESIDENT_MAX_N", 0)
    monkeypatch.setattr(pknn, "RESIDENT_RAISED_MAX_N", 0)
    monkeypatch.setattr(pknn, "TILE_N", 128)
    traced = []
    kernel = pknn._knn_kernel
    monkeypatch.setattr(pknn, "_knn_kernel", lambda *a, **kw: (traced.append(1), kernel(*a, **kw))[1])
    with pltpu.force_tpu_interpret_mode():
        jax_d, jax_i = pknn.knn_point(k, jnp.asarray(support), jnp.asarray(query))
    assert traced, "JAX ran another kernel than the streaming one"
    got_d, got_i = tg.knn_point(k, torch.from_numpy(support), torch.from_numpy(query))
    assert got_i.dtype == torch.int32 and got_i.shape == query.shape[:2] + (k,)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(jax_d), rtol=1e-6, atol=1e-7)
    if case.startswith("self"):  # each point is its own first neighbour
        np.testing.assert_array_equal(got_i[..., 0].numpy(),
                                      np.arange(support.shape[1])[None].repeat(len(support), 0))


def _jax_route(n, k, monkeypatch):
    """The kernel JAX's knn_point takes for k neighbours over n points:
    "resident" or "streaming" (``_knn_scan``'s two kernels), "spatial", or
    "oracle" (its plain version, for k > n). Read by tracing it abstractly,
    with the spatial kernel and the oracle replaced by stubs that record
    their call; the scan's kernels record being traced."""
    taken = []

    def stub(name):
        def f(k, support, query, *args, **kwargs):
            taken.append(name)
            out = query.shape[:2] + (k,)
            return jnp.zeros(out, jnp.float32), jnp.zeros(out, jnp.int32)
        return f

    monkeypatch.setattr(pks, "knn_point", stub("spatial"))
    monkeypatch.setattr(jg, "knn_point", stub("oracle"))
    for name, label in (("_knn_kernel", "streaming"), ("_knn_kernel_resident", "resident")):
        kernel = getattr(pknn, name)
        monkeypatch.setattr(pknn, name, lambda *a, _k=kernel, _l=label, **kw: (taken.append(_l),
                                                                                _k(*a, **kw))[1])
    # Five queries: a query count no other test traces _knn_scan with.
    jax.eval_shape(lambda s, q: pknn.knn_point(k, s, q),
                   jax.ShapeDtypeStruct((1, n, 3), jnp.float32),
                   jax.ShapeDtypeStruct((1, 5, 3), jnp.float32))
    assert len(taken) == 1, (n, k, taken)
    return taken[0]


def _takes(route, n, k):
    """Whether the port's kernel `route` takes a search of k over n points,
    k > n included (all three repeat the last neighbour then)."""
    if route == "resident":
        return n <= dispatch.RESIDENT_MAX_N and k <= dispatch.RESIDENT_MAX_K
    if route == "spatial":
        return k <= cuda_spatial.MAX_K and k <= n <= cuda_spatial.MAX_N
    return n <= cuda_streaming.MAX_N and k <= cuda_streaming.MAX_K


ROUTE_N = [1, 100, 12287, 12288, 12289, 65535, 65536, 65537, 2 ** 21 - 1, 2 ** 21, 2 ** 21 + 1,
           2228224, 2 ** 23]
ROUTE_K = [1, 3, 32, 128, 129, 512]


@pytest.mark.parametrize("n", ROUTE_N)
def test_knn_route_follows_jax_routing(n, monkeypatch):
    monkeypatch.delenv("POINTASNL_KNN_SPATIAL", raising=False)
    for k in ROUTE_K:
        jax_route = _jax_route(n, k, monkeypatch)
        route = dispatch.knn_route(n, k)
        assert _takes(route, n, k), (n, k, route)
        if jax_route in ("spatial", "streaming"):  # the same kernel in both packages
            assert route == jax_route, (n, k, jax_route, route)
        elif jax_route == "resident":  # the port's resident kernel stops at k = 128
            assert route == ("resident" if k <= dispatch.RESIDENT_MAX_K else "streaming")
        else:  # k > n: JAX's oracle; the port's kernel pads as the oracle does
            assert jax_route == "oracle" and k > n and route in ("resident", "streaming")


def test_knn_route_bounds_are_jax_bounds():
    assert dispatch.RESIDENT_MAX_N == pknn.RESIDENT_MAX_N
    assert cuda_spatial.MAX_N == pks.MAX_SPATIAL_HBM_N and cuda_spatial.MAX_K == pks.KP


@pytest.mark.parametrize("n,k", [(2 ** 28 + 1, 32), (100, 513), (0, 3), (100, 0)])
def test_knn_route_raises_past_the_streaming_caps(n, k):
    with pytest.raises(ValueError, match=r"1 <= N <= 268435456 and 1 <= k <= 512"):
        dispatch.knn_route(n, k)


def test_fps_design_follows_n():
    assert [cuda_fps.design(n) for n in (1, 10240, 10241, 131072, 131073, 278528, 278529,
                                         2228224)] == [
        "block", "block", "cluster", "cluster", "cluster", "cluster", "grid", "grid"]


def test_streaming_wrapper_refuses_cpu_tensors_and_dispatch_keeps_them():
    x = torch.from_numpy(_cloud(49, 1, 200))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_streaming.knn_point(129, x, x)
    before = cuda_streaming.launches
    for g, w in zip(ops.knn_point(129, x, x[:, :20]), tg.knn_point(129, x, x[:, :20])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert cuda_streaming.launches == before


def _emulate_case(case):
    """(support, query, k) of a named emulate case, as tensors; the query is
    the support itself for a self-query."""
    if case == "self k32 B2 N700":
        s = torch.from_numpy(_cloud(50, 2, 700))
        return s, s, 32
    if case == "duplicates k16":  # ties: the lower index first
        s = torch.from_numpy(_cloud(51, 1, 600, dup=300))
        return s, s[:, 100:400].clone(), 16
    if case == "a grid, ties everywhere k24":  # many equal distances at once
        g = np.stack(np.meshgrid(*[np.arange(8, dtype=np.float32)] * 3, indexing="ij"), -1)
        s = torch.from_numpy(g.reshape(1, 512, 3))
        return s, s, 24
    if case == "k > N, B2 k100 N40":
        return torch.from_numpy(_cloud(52, 2, 40)), torch.from_numpy(_cloud(53, 2, 37)), 100
    if case == "k > 128, self k200 N500":
        s = torch.from_numpy(_cloud(54, 1, 500))
        return s, s, 200
    if case == "k 512, disjoint B3 N600 M90":
        return torch.from_numpy(_cloud(55, 3, 600)), torch.from_numpy(_cloud(56, 3, 90)), 512
    if case == "surface scene k32 N3000":  # a scan prunes
        from pointasnl_tpu_torch.data import surface_scene
        s = torch.from_numpy(surface_scene(np.random.RandomState(57), 1, 3000, extent=1.0))
        return s, s, 32
    raise ValueError(case)


EMULATE_CASES = ["self k32 B2 N700", "duplicates k16", "a grid, ties everywhere k24",
                 "k > N, B2 k100 N40", "k > 128, self k200 N500", "k 512, disjoint B3 N600 M90",
                 "surface scene k32 N3000"]


@pytest.mark.parametrize("case", EMULATE_CASES)
def test_streaming_visit_rule_is_exact(case):
    support, query, k = _emulate_case(case)
    d, i, tested = cuda_streaming.emulate(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    assert i.dtype == torch.int32 and i.shape == want_i.shape
    np.testing.assert_array_equal(i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    pairs = support.shape[0] * support.shape[1] * query.shape[1]
    assert 0 < tested <= pairs
    if case.startswith("surface scene"):
        assert tested < 0.5 * pairs


def test_streaming_tile_and_segments_bound_the_plan():
    assert [cuda_streaming.tile_for(k) for k in (1, 128, 129, 256, 257, 512)] == [
        128, 128, 64, 64, 32, 32]
    # The B1 x 2228224 stem: 17408 tiles of 128 over 2176 segments of 1024.
    assert cuda_streaming.segment_width(2228224, 2228224, 32) == 1024
    for n, m, k, b in ((2228224, 2228224, 32, 1), (2 ** 28, 2 ** 28, 512, 1), (500, 500, 3, 4),
                       (2 ** 22, 7, 32, 2)):
        seg_w = cuda_streaming.segment_width(n, m, k, b)
        plan = b * -(-m // cuda_streaming.tile_for(k)) * -(-n // seg_w)
        assert seg_w >= cuda_streaming.MIN_SEG_W and (plan <= cuda_streaming.PLAN_ELEMENTS
                                                      or seg_w >= n)
