"""The port's mixed precision (``nn/precision.py``) against the JAX package's.

- the policy's API (names, scoping, the environment default), as JAX's;
- the layer gate of ``tests/test_precision.py:19-34``: bfloat16 out, float32
  parameters, within 2e-2 of the float32 output;
- the cells whose attention promotes (``SampleWeights``, the non-local cell,
  the SA cell): in bfloat16 the input and output dtypes of every dense layer
  inside, and the outputs, are JAX's: bfloat16 scores divided by a float32
  scale become float32, so the softmax and ``attn @ v`` run in float32 in
  both packages (the port promotes explicitly: ``nn.blockwise.scale_scores``);
  under ``use_flash`` the non-local cell's flash attention (JAX's Pallas
  kernels interpreted) returns its bfloat16 inputs' dtype instead, so its
  projection takes bfloat16 in both;
- the bfloat16 plain gather backward: float32 ``index_add_`` of the widened
  rows, rounded to bfloat16 once, to the bit; near JAX's one-hot VJP;
- one seg train step in bfloat16 against JAX's (``seg_gate``, below).

How the step-level gate is taken. JAX's own gate (``test_precision.py:57-94``:
the bfloat16 step's loss within 2e-2 of the float32 step's, and each
parameter's update norm within max(0.1 a, 1e-2 max)) holds for its small
``SmallCls``, but on the full models JAX's bfloat16 step fails it against
JAX's own float32 step, for two reasons. (1) Level 2 runs FPS and kNN on
l1_xyz, a float32 sum weighted by bfloat16 attention weights, so the two
dtypes pick different points from there on (one changed FPS pick changes
the rest). (2) With the points held equal, train-mode BN over small batches
makes the gradients ill-conditioned: float32 rounding alone moves them by a
few percent between the two packages, and bfloat16 rounding moves JAX's own
by ~30 % at the median parameter (seg B2 x 2048, measured on the CPU). So:

- the searches' results (FPS, kNN, ball query) are recorded in the port's
  float32 step and replayed in every other run (``GeometryTape``), as the
  dropout masks are injected: the runs differ in their arithmetic only;
- the loss gate is JAX's, 2e-2;
- the updates are compared as one vector of the per-parameter update norms
  that JAX's gate reads, by its relative distance D(x, ref) =
  |n_x - n_ref| / |n_ref|, against JAX's own bfloat16 distance
  D(jax bf16, jax f32): the port's bfloat16 step must be no further from
  JAX's bfloat16 step than that, and no further from the port's float32 step
  than BF16_DRIFT times that; the two float32 steps within F32_SHARE of it.

SGD with momentum, as JAX's gate takes it, so an update is lr x gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax.experimental.pallas import tpu as pltpu

from pointasnl_tpu import ops as jops
from pointasnl_tpu.nn import layers as jl
from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.nn import precision as jprec
from pointasnl_tpu.ops import dispatch as jdispatch
from pointasnl_tpu.ops import geometry as jgeometry
from pointasnl_tpu.ops import scatter as jscatter
from pointasnl_tpu.train import schedules as jsched
from pointasnl_tpu.train.state import TrainState as JaxTrainState
from pointasnl_tpu.train.state import make_optimizer as jax_make_optimizer
from pointasnl_tpu.train.steps import make_train_step as jax_make_train_step
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.nn import layers as tl
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn import precision
from pointasnl_tpu_torch.ops import dispatch
from pointasnl_tpu_torch.ops.cuda import gather_backward as gb
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)
from pointasnl_tpu_torch.utils import flax_to_state_dict
from test_torch_layers import randomized, run_both

torch.set_num_threads(1)

LOSS_RTOL = 2e-2  # JAX's gate, test_precision.py:91
BF16_DRIFT = 1.5  # the port's bf16-vs-f32 distance, at most this times JAX's
F32_SHARE = 0.2  # the two packages' float32 steps, at most this share of it
GATE_LR = 1e-2  # JAX's gate: SGD with momentum at 1e-2


# -- the policy --------------------------------------------------------------

def test_precision_api_mirrors_jax(monkeypatch):
    monkeypatch.delenv("POINTASNL_COMPUTE_DTYPE", raising=False)
    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
    for name in ("float32", "f32", "bfloat16", "bf16"):
        got, want = precision._NAMES[name], jprec._NAMES[name]
        assert (got, want) in pairs
    assert precision.current_compute_dtype() is None is jprec.current_compute_dtype()
    with precision.compute_dtype("bf16"), jprec.compute_dtype("bf16"):
        assert precision.current_compute_dtype() is torch.bfloat16
        with precision.compute_dtype("float32"):  # nested scopes restore their outer value
            assert precision.current_compute_dtype() is torch.float32
        assert precision.current_compute_dtype() is torch.bfloat16
    assert precision.current_compute_dtype() is None
    for env, want in (("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                      ("float32", None), ("float64", None)):
        monkeypatch.setenv("POINTASNL_COMPUTE_DTYPE", env)
        assert precision.current_compute_dtype() is want
        assert (jprec.current_compute_dtype() is None) == (want is None)
    monkeypatch.setenv("POINTASNL_COMPUTE_DTYPE", "bfloat16")
    with precision.compute_dtype("float32"):  # an explicit setting wins over the environment
        assert precision.current_compute_dtype() is torch.float32
    precision.set_compute_dtype(torch.float32)
    try:
        assert precision.current_compute_dtype() is torch.float32
    finally:
        precision.set_compute_dtype(None)
    assert precision.current_compute_dtype() is torch.bfloat16  # the environment again


def test_policy_controls_compute_dtype():
    """test_precision.py:19-34 on the port, and the port's bfloat16 output
    against JAX's."""
    x = np.random.RandomState(0).randn(2, 8, 4).astype(np.float32)
    layer = tl.PointConv(4, 16, bn=False, generator=torch.Generator().manual_seed(0))
    out_f32 = layer(torch.from_numpy(x))
    assert out_f32.dtype == torch.float32
    with precision.compute_dtype("bfloat16"):
        out_bf16 = layer(torch.from_numpy(x))
    assert out_bf16.dtype == torch.bfloat16
    assert layer.conv.weight.dtype == torch.float32  # parameters stay float32
    torch.testing.assert_close(out_bf16.float(), out_f32.detach(), rtol=2e-2, atol=2e-2)
    with precision.compute_dtype("bfloat16"), jprec.compute_dtype("bfloat16"):
        jout, tout, _, _ = run_both(jl.PointConv(16, bn=True), tl.PointConv(4, 16), [x],
                                    training=True)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_dense_dtype_follows_flax():
    """As flax's Dense(dtype=...) with the policy's dtype: bfloat16 under the
    policy, whatever the input's dtype; without it, the input's and the
    weight's dtypes promote (flax's dtype=None)."""
    dense = tl.Dense(3, 5, generator=torch.Generator().manual_seed(1))
    assert dense(torch.ones(2, 3, dtype=torch.bfloat16)).dtype == torch.float32
    assert dense(torch.ones(2, 3)).dtype == torch.float32
    with precision.compute_dtype("bf16"):
        assert dense(torch.ones(2, 3)).dtype == torch.bfloat16
        assert dense(torch.ones(2, 3, dtype=torch.float64)).dtype == torch.bfloat16
    assert dense.double()(torch.ones(2, 3, dtype=torch.float64)).dtype == torch.float64


# -- cells: dtypes inside and out ----------------------------------------------

def _jax_dense_dtypes(jmodule, args, variables):
    """{PointConv path: (input dtype, output dtype)} of a JAX apply in train mode."""
    seen = {}

    def intercept(next_fun, fargs, kwargs, context):
        out = next_fun(*fargs, **kwargs)
        if isinstance(context.module, jl.PointConv) and context.method_name == "__call__":
            seen[".".join(context.module.path)] = (str(fargs[0].dtype), str(out.dtype))
        return out

    with fnn.intercept_methods(intercept):  # at trace time
        out, _ = jax.jit(lambda v, *a: jmodule.apply(v, *a, training=True,
                                                     mutable=["batch_stats"]))(variables, *args)
    return out, seen


def _port_dense_dtypes(tmodule, args):
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=name: seen.__setitem__(n, (str(i[0].dtype)[6:], str(o.dtype)[6:])))
        for name, m in tmodule.named_modules() if isinstance(m, tl.PointConv)]
    try:
        with torch.no_grad():
            out = tmodule(*args)
    finally:
        for h in hooks:
            h.remove()
    return out, seen


CELLS = {
    "sample_weights": (lambda: jp.SampleWeights([32, 6]), lambda: tp.SampleWeights(5, [32, 6]),
                       [(2, 6, 8, 5), (2, 6, 8, 3)]),
    "nonlocal": (lambda: jp.PointNonLocalCell(bottleneck=32, out_channels=16),
                 lambda: tp.PointNonLocalCell(6, 9, 32, 16), [(2, 40, 6), (2, 12, 9)]),
    "nonlocal_flash": (lambda: jp.PointNonLocalCell(bottleneck=32, out_channels=16,
                                                    use_flash=True),
                       lambda: tp.PointNonLocalCell(6, 9, 32, 16, use_flash=True),
                       [(2, 40, 6), (2, 12, 9)]),
    "set_abstraction": (lambda: jp.PointASNLSetAbstraction(npoint=32, nsample=8, mlp=(16, 16, 32),
                                                           as_neighbor=4),
                        lambda: tp.PointASNLSetAbstraction(3, 32, 8, (16, 16, 32), as_neighbor=4),
                        [(2, 64, 3), None]),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_dtypes_match_jax_in_bf16(cell):
    make_jax, make_port, shapes = CELLS[cell]
    rng = np.random.RandomState(7)
    args = [rng.randn(*s).astype(np.float32) for s in shapes if s is not None]
    if shapes[-1] is None:  # the SA cell's features are its xyz
        args.append(args[0].copy())
    jmodule, tmodule = make_jax(), make_port()
    jargs = [jnp.asarray(a) for a in args]
    variables = randomized(jax.jit(lambda *a: jmodule.init({"params": jax.random.PRNGKey(0)}, *a,
                                                           training=False))(*jargs), 0)
    tmodule.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmodule.train()
    # JAX's flash cell reaches its Pallas kernels: interpreted on the CPU.
    with precision.compute_dtype("bfloat16"), jprec.compute_dtype("bfloat16"), \
            pltpu.force_tpu_interpret_mode():
        jout, jseen = _jax_dense_dtypes(jmodule, jargs, variables)
        tout, tseen = _port_dense_dtypes(tmodule, [torch.from_numpy(a) for a in args])
    assert tseen == jseen and len(tseen) >= 3
    # The trap: the product after a softmax of promoted scores is float32;
    # the flash kernels return their bfloat16 inputs' dtype instead.
    promoted, dtype_in = {"sample_weights": ("mlp2_0", "float32"),
                          "nonlocal": ("conv_back_project", "float32"),
                          "nonlocal_flash": ("conv_back_project", "bfloat16"),
                          "set_abstraction": ("nonlocal.conv_back_project", "float32")}[cell]
    assert tseen[promoted] == (dtype_in, "bfloat16")
    jouts, touts = ((jout,), (tout,)) if cell != "set_abstraction" else (jout, tout)
    for t, j in zip(touts, jouts):
        assert str(t.dtype)[6:] == str(j.dtype)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=3e-2,
                                   atol=3e-2 * float(np.abs(np.asarray(j, np.float32)).max()))
    for p in tmodule.parameters():
        assert p.dtype == torch.float32


# -- the bfloat16 gather backward ---------------------------------------------

@pytest.mark.parametrize("B,R,n,C", [(2, 3000, 5, 8), (2, 4096, 512, 35), (1, 10, 1000, 3)])
def test_bf16_gather_backward_reference(B, R, n, C):
    rng = np.random.RandomState(R)
    idx = torch.from_numpy(rng.randint(0, n, (B, R)).astype(np.int32))
    dout = torch.from_numpy(rng.randn(B, R, C).astype(np.float32)).bfloat16()
    got = gb.gather_backward_reference(dout, idx, n)
    assert got.dtype == torch.bfloat16 and got.shape == (B, n, C)
    flat = (idx.long() + torch.arange(B)[:, None] * n).reshape(-1)
    f32 = torch.zeros(B * n, C).index_add_(0, flat, dout.float().reshape(B * R, C))
    assert torch.equal(got, f32.bfloat16().view(B, n, C))  # float32 sum, rounded once
    # JAX's one-hot VJP adds in bfloat16 (2048-row chunks): the same sum
    # to bfloat16's rounding of the partial sums.
    want = jscatter.onehot_scatter_add(jnp.asarray(dout.float().numpy(), jnp.bfloat16),
                                       jnp.asarray(idx.numpy()), n)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2 * float(f32.abs().max()))
    # float32 keeps its sum as it was: index_add_'s, to the bit
    assert torch.equal(gb.gather_backward_reference(dout.float(), idx, n), f32.view(B, n, C))


# -- step-level gate ----------------------------------------------------------

class GeometryTape:
    """The searches' results of one run, replayed into others.

    ``record(mp)`` wraps the port's FPS, kNN and ball query to keep their
    outputs, each op's in its call order; ``replay(mp, "port" or "jax")``
    makes that package's searches return them in the same order, checking
    each call's sizes and shapes against the recording. ``mp`` is a
    ``pytest.MonkeyPatch``, which undoes it all."""

    OPS = ("farthest_point_sample", "knn_point", "query_ball_point")

    def __init__(self):
        self.calls = {op: [] for op in self.OPS}
        self.pos = {}

    @staticmethod
    def _signature(args):
        return tuple(a if isinstance(a, (int, float)) else tuple(a.shape) for a in args)

    def record(self, mp):
        for op in self.OPS:
            def wrapped(*args, op=op, inner=getattr(dispatch, op)):
                out = inner(*args)
                self.calls[op].append((self._signature(args),
                                       tuple(o.detach().numpy() for o in out)
                                       if isinstance(out, tuple) else out.detach().numpy()))
                return out

            for module in (dispatch, ops):
                mp.setattr(module, op, wrapped)

    def replay(self, mp, which):
        self.pos = {op: 0 for op in self.OPS}
        convert = torch.from_numpy if which == "port" else jnp.asarray

        def replayed(*args, op):
            sig, out = self.calls[op][self.pos[op]]
            assert sig == self._signature(args), (op, self.pos[op], sig)
            self.pos[op] += 1
            return tuple(convert(o) for o in out) if isinstance(out, tuple) else convert(out)

        # JAX's three_nn on the CPU calls geometry.knn_point.
        modules = (dispatch, ops) if which == "port" else (jdispatch, jops, jgeometry)
        for op in self.OPS:
            for module in modules:
                mp.setattr(module, op, lambda *args, op=op: replayed(*args, op=op))

    def done(self):
        assert self.pos == {op: len(c) for op, c in self.calls.items()}, self.pos


def port_gate_step(model, batch, dtype, task, *, tape_mode, tape, lr=GATE_LR, **step_kw):
    """One SGD-with-momentum step of the port: (loss, {name: update norm})."""
    before = {k: v.detach().double().clone() for k, v in model.named_parameters()}
    B = batch["points"].shape[0]
    state = TrainState(model, make_optimizer("momentum", staircase_lr_schedule(lr, B, 1e9, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(B, 1e9), task=task, **step_kw)
    with pytest.MonkeyPatch.context() as mp, precision.compute_dtype(dtype):
        if tape_mode == "record":
            tape.record(mp)
        else:
            tape.replay(mp, "port")
        metrics = step(state, batch, torch.Generator().manual_seed(0))
        if tape_mode == "replay":
            tape.done()
    for p in model.parameters():
        assert p.dtype == torch.float32  # master weights
    for b in model.buffers():
        assert b.dtype == torch.float32  # BN statistics
    return float(metrics["loss"]), {k: float((v.detach().double() - before[k]).norm())
                                    for k, v in model.named_parameters()}


def jax_gate_step(jmodel, variables, batch, dtype, task, *, tape, lr=GATE_LR, **step_kw):
    B = batch["points"].shape[0]
    with pytest.MonkeyPatch.context() as mp, jprec.compute_dtype(dtype):
        tape.replay(mp, "jax")
        tx = jax_make_optimizer("momentum", jsched.staircase_lr_schedule(lr, B, 1e9, 0.7))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]), tx=tx,
                              apply_fn=jmodel.apply)
        step = jax_make_train_step(bn_schedule=jsched.bn_momentum_schedule(B, 1e9), task=task,
                                   donate=False, **step_kw)
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(0))
        tape.done()
    update = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        new_state.params, state.params)
    norms = {k: float(np.linalg.norm(v.numpy()))
             for k, v in flax_to_state_dict({"params": update}, np.float64).items()}
    return float(metrics["loss"]), norms


def update_distance(runs, x, ref):
    """|n_x - n_ref| / |n_ref| over the per-parameter update norms."""
    nx, nref = runs[x][1], runs[ref][1]
    assert sorted(nx) == sorted(nref)
    return float(np.sqrt(sum((nx[k] - nref[k]) ** 2 for k in nref)
                         / sum(v ** 2 for v in nref.values())))


def jax_gate_worst(runs, x, ref):
    """The worst parameter of JAX's own per-parameter gate, as the ratio of
    |n_x - n_ref| to max(0.1 n_ref, 1e-2 max n_ref) (over 1 fails it)."""
    nx, nref = runs[x][1], runs[ref][1]
    floor = 1e-2 * max(nref.values())
    return max(abs(nx[k] - n) / max(0.1 * n, floor) for k, n in nref.items())


def check_gate(runs):
    """The bfloat16 gate of the module docstring over the four runs of
    seg_gate_runs / cls_gate_runs; returns the distances."""
    for x, ref in (("port_bf16", "jax_bf16"), ("port_bf16", "port_f32"),
                   ("jax_bf16", "jax_f32")):
        loss_x, loss_ref = runs[x][0], runs[ref][0]
        assert abs(loss_x - loss_ref) / abs(loss_ref) < LOSS_RTOL, (x, ref, loss_x, loss_ref)
    assert abs(runs["port_f32"][0] - runs["jax_f32"][0]) <= 1e-5 * abs(runs["jax_f32"][0])
    jax_d = update_distance(runs, "jax_bf16", "jax_f32")
    d = {"port_f32 vs jax_f32": update_distance(runs, "port_f32", "jax_f32"),
         "port_bf16 vs jax_bf16": update_distance(runs, "port_bf16", "jax_bf16"),
         "port_bf16 vs port_f32": update_distance(runs, "port_bf16", "port_f32")}
    assert d["port_f32 vs jax_f32"] <= F32_SHARE * jax_d, (d, jax_d)
    assert d["port_bf16 vs jax_bf16"] <= jax_d, (d, jax_d)
    assert d["port_bf16 vs port_f32"] <= BF16_DRIFT * jax_d, (d, jax_d)
    return jax_d, d


def seg_gate_runs(**model_kw):
    """The seg step (PointASNLSemSegRes(21), dropout off, uniform weight
    0.01, and `model_kw` such as nl_use_flash in both packages) at B2 x 2048
    in a 0.2 m cube in four runs: the port's float32 step (its searches
    recorded), and with those searches replayed, the port's bfloat16 step
    and JAX's float32 and bfloat16 steps."""
    from pointasnl_tpu.models import PointASNLSemSegRes as JaxSegRes
    from pointasnl_tpu_torch.models import PointASNLSemSegRes
    from test_torch_seg import flax_variables

    rng = np.random.RandomState(0)
    B, N = 2, 2048
    batch = {"points": (rng.rand(B, N, 3) * 0.2).astype(np.float32),
             "labels": rng.randint(0, 21, (B, N)).astype(np.int32),
             "smpw": np.ones((B, N), np.float32)}
    sd = PointASNLSemSegRes(21, dropout_keep=1.0, generator=torch.Generator().manual_seed(0),
                            device="cpu").state_dict()
    tape = GeometryTape()
    runs = {}
    for name, dtype in (("port_f32", "float32"), ("port_bf16", "bfloat16")):
        model = PointASNLSemSegRes(21, dropout_keep=1.0, device="cpu", **model_kw)
        model.load_state_dict(sd)
        runs[name] = port_gate_step(
            model, {k: torch.from_numpy(v) for k, v in batch.items()}, dtype, "seg",
            tape_mode="record" if name == "port_f32" else "replay", tape=tape, uniform_weight=0.01)
    jmodel = JaxSegRes(num_class=21, dropout_keep=1.0, **model_kw)
    variables = flax_variables(jmodel, batch["points"], sd)
    for name, dtype in (("jax_f32", "float32"), ("jax_bf16", "bfloat16")):
        runs[name] = jax_gate_step(jmodel, variables, batch, dtype, "seg", tape=tape,
                                   uniform_weight=0.01)
    return runs


@pytest.fixture(scope="module")
def seg_gate():
    return seg_gate_runs()


def test_seg_bf16_step_passes_the_gate(seg_gate):
    """The port's bfloat16 seg step against JAX's and against its own
    float32 step; JAX's bfloat16 step fails JAX's per-parameter gate here
    (the module docstring), which is why the gate is taken as it is."""
    assert jax_gate_worst(seg_gate, "jax_bf16", "jax_f32") > 1.0
    check_gate(seg_gate)
