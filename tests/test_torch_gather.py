"""The deterministic gather backward (``ops/cuda/gather_backward.py``) and
its wiring, on the CPU.

- The plain version, ``gather_backward_reference``, for ``gather_point`` and
  ``group_point``: equal to the bit to CPU float32 ``index_add_`` (both add a
  row's gradients in ascending order from 0, the order the CUDA kernel keeps)
  and to ``jax.vjp`` of ``pointasnl_tpu/ops/geometry.py``'s gathers (XLA's CPU
  scatter-add adds the updates in the same order); within 1e-4 of the scale
  of ``pointasnl_tpu/ops/scatter.py``'s one-hot-matmul VJP, whose default
  "split2" precision is ~1.5e-5 relative (tests/test_scatter.py's bound).
- The plan kernel's algorithm (``ops/cuda/gather_backward.py:emulate``: counts,
  their scan, a fill in the order the atomics hand out slots, each segment
  put in ascending row order) equal to ``segments``, its plain version, in
  any fill order: on every case, a row gathered 3000 times and rows never
  gathered.
- The wiring: in a small seg train step every gather of a tensor that needs
  a gradient goes through ``ops.dispatch.gather_point``, which sends it to
  the kernel on the card: a counting stub in its place sees all 22, and no
  differentiable ``torch.gather`` runs outside it.

The kernels themselves are held against the plain versions and
``index_add_`` on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.ops import scatter as jscatter
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models import PointASNLSemSegRes
from pointasnl_tpu_torch.ops import dispatch
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import gather_backward as cuda_gather
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)

torch.set_num_threads(1)

SEG_STEP_SORTS = 12  # index tensors the gather backwards of a seg train step sort

# (B, n points, idx shape after B, C) of a gather: (M,) is gather_point, (M, K)
# group_point.
CASES = {
    "gather_point": (2, 80, (33,), 4),
    "group_point": (2, 64, (48, 8), 6),
    "group_point, 500 gathers of 3 rows": (1, 3, (100, 5), 5),
    "gather_point, most rows never gathered": (2, 500, (7,), 3),
}


def _case(name):
    B, n, shape, C = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    points = rng.randn(B, n, C).astype(np.float32)
    idx = rng.randint(0, n, (B, *shape)).astype(np.int32)
    dout = rng.randn(B, *shape, C).astype(np.float32)
    return points, idx, dout


def _plain(idx, dout, n):
    B, C = dout.shape[0], dout.shape[-1]
    rows = torch.from_numpy(dout).reshape(B, -1, C)
    return cuda_gather.gather_backward_reference(rows, torch.from_numpy(idx).reshape(B, -1), n)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_gather_backward_matches_jax_and_index_add(name):
    points, idx, dout = _case(name)
    B, n, C = points.shape
    got = _plain(idx, dout, n).numpy()
    gather = jg.gather_point if idx.ndim == 2 else jg.group_point
    mxu = jscatter.gather_point_mxu if idx.ndim == 2 else jscatter.group_point_mxu
    _, vjp = jax.vjp(lambda p: gather(p, jnp.asarray(idx)), jnp.asarray(points))
    np.testing.assert_array_equal(got, np.asarray(vjp(jnp.asarray(dout))[0]))
    _, vjp = jax.vjp(lambda p: mxu(p, jnp.asarray(idx)), jnp.asarray(points))
    want = np.asarray(vjp(jnp.asarray(dout))[0])
    assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)
    flat = torch.from_numpy(idx).reshape(B, -1).long() + torch.arange(B)[:, None] * n
    index_add = torch.zeros(B * n, C).index_add_(0, flat.reshape(-1),
                                                  torch.from_numpy(dout).reshape(-1, C))
    np.testing.assert_array_equal(got, index_add.view(B, n, C).numpy())


def test_segments_sort_each_output_row_s_sources_in_order():
    idx = torch.tensor([[2, 0, 2, 1, 2], [0, 0, 3, 3, 0]])
    order, offsets = cuda_gather.segments(idx, 4)
    assert order.dtype == offsets.dtype == torch.int32
    assert order.tolist() == [1, 3, 0, 2, 4, 5, 6, 9, 7, 8]
    assert offsets.tolist() == [0, 1, 2, 5, 5, 8, 8, 8, 10]


# (B, n, R, output rows the indices take) of the plan's cases beside CASES:
# long segments take the plan kernel's walk in order (past long_len rows).
PLAN_CASES = {
    "a row gathered 3000 times": (2, 5, 3000, (0, 3)),
    "rows never gathered": (3, 40, 30, (2, 5, 7, 39)),
    "long and short segments, R 5000": (2, 9, 5000, tuple(range(9))),
}
WALKED = {"a row gathered 3000 times", "long and short segments, R 5000"}


def _plan_case(name):
    if name in CASES:
        _, idx, _ = _case(name)
        return torch.from_numpy(idx).reshape(idx.shape[0], -1), CASES[name][1]
    B, n, R, rows = PLAN_CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return torch.from_numpy(np.asarray(rows, np.int32)[rng.randint(0, len(rows), (B, R))]), n


@pytest.mark.parametrize("name", list(CASES) + list(PLAN_CASES))
def test_plan_kernel_algorithm_equals_segments_in_any_fill_order(name):
    idx, n = _plan_case(name)
    B, R = idx.shape
    want = cuda_gather.segments(idx, n)
    if name in WALKED:
        assert int(torch.diff(want[1].long()).max()) > cuda_gather.long_len(R)
    for slots in (None, torch.arange(R).repeat(B, 1), torch.arange(R - 1, -1, -1).repeat(B, 1)):
        got = cuda_gather.emulate(idx, n, slots)
        assert got[0].dtype == got[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plan_constants_mirror_the_kernel():
    src = (Path(cuda_gather.__file__).parents[2] / "csrc" / "gather_backward.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kLongList"]) == cuda_gather.PLAN_LONG_LIST
    assert int(consts["kLongMin"]) == cuda_gather.PLAN_LONG_MIN
    assert int(consts["kPlanThreads"]) == cuda_gather.PLAN_THREADS
    assert cuda_gather.long_len(40960) == 512 and cuda_gather.long_len(2 ** 20) == 4096


def test_plan_sorts_an_index_tensor_once_for_all_its_views():
    idx = torch.tensor([[[2, 0], [2, 1]], [[2, 0], [3, 3]]])
    first = cuda_gather.plan(idx.reshape(2, 4), 4)
    assert cuda_gather.plan(idx.reshape(2, 4), 4) is first  # another view, one sort
    for got, want in zip(first, cuda_gather.segments(idx.reshape(2, 4), 4)):
        assert torch.equal(got, want)
    assert cuda_gather.plan(idx.reshape(2, 4), 5) is not first  # other output rows
    assert cuda_gather.plan(idx[:1].reshape(1, 4), 4) is not first  # another view
    idx[0, 0, 0] = 1  # changed in place: sorted again
    again = cuda_gather.plan(idx.reshape(2, 4), 4)
    assert again is not first and again[0].tolist() == [1, 0, 3, 2, 5, 4, 6, 7]
    assert all(key[-1] == idx._version for key in idx._gather_backward_plans)


def test_cpu_gathers_stay_plain_and_the_kernel_refuses_cpu_tensors():
    points, idx, dout = _case("group_point")
    p = torch.from_numpy(points).requires_grad_()
    out = ops.group_point(p, torch.from_numpy(idx))
    assert out.grad_fn is not None and not isinstance(out.grad_fn, dispatch.GatherPoint)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_array_equal(p.grad.numpy(), _plain(idx, dout, points.shape[1]).numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gather.gather_backward(torch.from_numpy(dout).reshape(2, -1, 6),
                                    torch.from_numpy(idx).reshape(2, -1), points.shape[1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gather.plan_kernel(torch.from_numpy(idx).reshape(2, -1), points.shape[1])


def test_every_differentiable_gather_of_a_seg_step_goes_through_dispatch(monkeypatch):
    """A counting stub in place of the routed gather_point (which group_point,
    sampling, grouping, three_interpolate and repulsion_loss call) sees every
    gather of a tensor with a gradient in a seg train step; no other
    torch.gather with a gradient runs. 19 of its 22 gathers feed the loss,
    so the card launches the backward kernel 19 times a step, on the plans
    of SEG_STEP_SORTS index tensors."""
    routed, stray, backward, alive = [], [], [], []
    depth = [0]
    gather, route = torch.gather, dispatch.gather_point

    def watched_gather(inp, *args, **kwargs):
        if inp.requires_grad and torch.is_grad_enabled() and not depth[0]:
            stray.append(tuple(inp.shape))
        return gather(inp, *args, **kwargs)

    class Backward(torch.autograd.Function):  # counts the gradients that reach a gather
        @staticmethod
        def forward(ctx, x, plan):
            ctx.plan = plan
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            backward.append(ctx.plan)
            return g, None

    def stub(points, idx):
        if points.requires_grad and torch.is_grad_enabled():
            routed.append((tuple(points.shape), tuple(idx.shape)))
            base = idx if idx._base is None else idx._base  # what plan() keys on
            alive.append(base)  # the plain gather saves a copy: keep each id() unique
            points = Backward.apply(points, (id(base), points.shape[1], tuple(idx.shape),
                                             idx.stride(), idx.storage_offset()))
        depth[0] += 1
        try:
            return route(points, idx)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(torch, "gather", watched_gather)
    monkeypatch.setattr(dispatch, "gather_point", stub)
    monkeypatch.setattr(ops, "gather_point", stub)
    model = PointASNLSemSegRes(21, dropout_keep=1.0, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 1, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(1, 200000), task="seg",
                           uniform_weight=0.01)
    rng = np.random.RandomState(0)
    batch = {"points": torch.from_numpy((rng.rand(1, 512, 3) * 0.5).astype(np.float32)),
             "labels": torch.from_numpy(rng.randint(0, 21, (1, 512))),
             "smpw": torch.ones(1, 512)}
    metrics = step(state, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert stray == []
    assert len(routed) == 22 and len(backward) == 19
    # On the card the 19 backwards sort 12 index tensors: a grouping's xyz and
    # features, and a sampling's points and features, share theirs.
    assert len(set(backward)) == SEG_STEP_SORTS
    # The stem's grouping of level 1 and the repulsion loss's grouping of l1_xyz.
    assert routed[0] == ((1, 512, 32), (1, 2048)) and routed[-1] == ((1, 64, 3), (1, 1280))
