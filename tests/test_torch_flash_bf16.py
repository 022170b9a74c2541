"""The port's flash attention in bfloat16 against the JAX package's bfloat16
Pallas kernels, run here in interpret mode (``pltpu.force_tpu_interpret_mode()``,
as ``tests/test_torch_flash.py`` runs them).

JAX's kernels take bfloat16 q, k, v and dO when the compute dtype is
bfloat16 (the non-local cell's PointConv and BN return it) and round where
their bfloat16 refs round: o once; delta = bf16(sum_f32(bf16(dO * o))); dK
and dV once a 128-query tile, added in bfloat16 tile by tile. The plain
versions (``ops.flash_attention``), which the card's kernels are held to,
round at the same points.

Tolerances, each beside its assert:
  - o within 2^-8 of max|o| (bfloat16's half ulp at the top binade, as both
    round one float32 result), lse within 1e-6 of max(|lse|, 1) (float32 on
    both sides);
  - dq, dk, dv within 2^-7 of each gradient's max|value| (a bfloat16 ulp);
  - dk and dv equal to JAX's to the bit on at least 90 % of their elements
    (BITS_EQUAL_MIN): rounded where JAX rounds, only the float32 sums' order
    differs (measured: dk 94.6-96.7 %, dv 99.99-100 % at SHAPES). A backward
    that takes delta in float32 and rounds dK and dV once, at the end, as
    this port's plain version did before it rounded where JAX rounds, fails
    it: dk 54.9, 63.1 and 70.7 %, dv 53.8, 63.3 and 71.4 % at SHAPES, max
    errors 4.0e-3 to 5.5e-3 of max|dk| and max|dv|, which the tolerance
    alone would let through;
  - the non-local cell in train mode in bfloat16: its output and every
    gradient within CELL_YARDSTICK (2) times how far bfloat16 moves JAX's
    own cell from its float32 cell, the largest |difference| of each. Both
    packages round at the same points, but PyTorch's and XLA's float32 sums
    (BN's moments, the dense layers' backward) add in other orders, which
    moves a bfloat16 rounding by an ulp here and there, and train-mode BN
    over 24 query points amplifies it: measured on three seeds, the worst
    quantity reached 1.22 times that distance (the dense cell, without
    flash, 3.9 times).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_layers import randomized

from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.nn import precision as jprec
from pointasnl_tpu.ops.pallas import flash_attention as jfa
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn import precision
from pointasnl_tpu_torch.ops import flash_attention as tf
from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)

BITS_EQUAL_MIN = 0.90
CELL_YARDSTICK = 2.0
# (B, M, N, C): M off the 128-query tile, N past the 1024-key chunk and
# ragged, C = D of 32 and 64.
SHAPES = {"M300 N1500 C32": (2, 300, 1500, 32), "M200 N1100 C64": (2, 200, 1100, 64),
          "M130 N2049 C32": (1, 130, 2049, 32)}


def _bf16(a):
    """A float32 array rounded to bfloat16: the same values in both packages."""
    return torch.from_numpy(a).bfloat16()


def _np(t):
    """A float32 numpy copy of a torch or JAX array."""
    return np.array(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _inputs(name):
    B, M, N, C = SHAPES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return tuple(_bf16(rng.randn(*shape).astype(np.float32))
                 for shape in ((B, M, C), (B, N, C), (B, N, C), (B, M, C)))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's interpreted bfloat16 kernels at each shape, once a module:
    the forward's (o, lse) and the backward kernel's (dq, dk, dv) on that o
    and lse, which is what jax.vjp of its flash_attention computes."""
    runs = {}
    with pltpu.force_tpu_interpret_mode():
        for name in SHAPES:
            q, k, v, do = (jnp.asarray(_np(t), jnp.bfloat16) for t in _inputs(name))
            M = q.shape[1]
            scale = 1.0 / math.sqrt(q.shape[-1])  # flash_attention.py's scale
            o_pad, stats = jfa._flash_forward_with_stats(q, k, v, scale)
            grads = jfa._flash_backward(q, k, v, o_pad, stats, do, scale)
            runs[name] = {"o": o_pad[:, :M], "lse": stats[:, :M, 0], "grads": grads}
    for run in runs.values():
        assert run["o"].dtype == jnp.bfloat16 and run["lse"].dtype == jnp.float32
        assert all(g.dtype == jnp.bfloat16 for g in run["grads"])
    return runs


def _within(got, want, rtol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    limit = rtol * float(np.abs(want).max())
    assert err <= limit, f"{what}: max|port - jax| {err:.3e} over {limit:.3e}"


def _bits_equal(got, want) -> float:
    return float(np.mean(_np(got) == _np(want)))


@pytest.mark.parametrize("name", list(SHAPES))
def test_bf16_flash_forward_reference_matches_jax(jax_runs, name):
    q, k, v, _ = _inputs(name)
    o, lse = tf.flash_forward_reference(q, k, v, tf.flash_scale(q.shape[-1]))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _within(o, jax_runs[name]["o"], 2.0 ** -8, "o")  # one rounding of a float32 result each
    want = _np(jax_runs[name]["lse"])
    assert float(np.abs(lse.numpy() - want).max()) <= 1e-6 * max(float(np.abs(want).max()), 1.0)


@pytest.mark.parametrize("name", list(SHAPES))
def test_bf16_flash_backward_reference_rounds_where_jax_rounds(jax_runs, name):
    """On JAX's own o and lse, the plain backward against JAX's backward
    kernel: within a bfloat16 ulp, and dk and dv equal to the bit on at
    least BITS_EQUAL_MIN of their elements."""
    q, k, v, do = _inputs(name)
    run = jax_runs[name]
    o, lse = _bf16(_np(run["o"])), torch.from_numpy(_np(run["lse"]))
    got = tf.flash_backward_reference(q, k, v, o, lse, do, tf.flash_scale(q.shape[-1]))
    assert all(g.dtype == torch.bfloat16 for g in got)
    N = k.shape[1]
    want = (run["grads"][0][:, :q.shape[1]], run["grads"][1][:, :N], run["grads"][2][:, :N])
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        _within(g, w, 2.0 ** -7, what)
    for what, g, w in zip(("dk", "dv"), got[1:], want[1:]):
        share = _bits_equal(g, w)
        assert share >= BITS_EQUAL_MIN, f"{what}: {100 * share:.2f} % equal to the bit"


@pytest.mark.parametrize("name", list(SHAPES))
def test_bf16_flash_attention_autograd_matches_jax_vjp(jax_runs, name):
    """The public call on the CPU (the plain versions through autograd)
    against JAX's flash_attention and its vjp (the kernels of jax_runs)."""
    q, k, v, do = _inputs(name)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out = tf.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    out.backward(do)
    _within(out.detach(), jax_runs[name]["o"], 2.0 ** -8, "o")
    for what, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jax_runs[name]["grads"]):
        assert g.dtype == torch.bfloat16
        _within(g, w[:, :g.shape[1]], 2.0 ** -7, what)


def test_bf16_cpu_tensors_never_reach_the_kernels():
    q, k, v, do = _inputs("M130 N2049 C32")
    names = ("fwd_launches", "bwd_launches", "fwd_launches_bf16", "bwd_launches_bf16")
    before = [getattr(cuda_flash, n) for n in names]
    tq = q.clone().requires_grad_()
    tf.flash_attention(tq, k, v).backward(do)
    assert [getattr(cuda_flash, n) for n in names] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash.flash_forward(q, k, v, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash.flash_backward(q, k, v, q, torch.zeros(q.shape[:2]), do, 1.0)


def _cell_inputs():
    rng = np.random.RandomState(2)
    return rng.randn(2, 40, 6).astype(np.float32), rng.randn(2, 12, 9).astype(np.float32)


def test_nonlocal_cell_with_flash_matches_jax_in_bf16_train_mode():
    """The cell under use_flash in train mode with the compute dtype
    bfloat16 in both packages: q, k, v reach the flash function in bfloat16,
    the output is bfloat16, and the output, the inputs' and every
    parameter's gradients are within CELL_YARDSTICK times the distance that
    bfloat16 puts JAX's own cell from its float32 cell."""
    feature, query = _cell_inputs()
    ct = np.random.RandomState(6).randn(2, 12, 16).astype(np.float32)
    jcell = jp.PointNonLocalCell(bottleneck=32, out_channels=16, use_flash=True)
    init = jp.PointNonLocalCell(bottleneck=32, out_channels=16).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feature), jnp.asarray(query),
        training=False)
    variables = randomized(init, 0)

    def loss(params, f, q):
        out, _ = jcell.apply({"params": params, "batch_stats": variables["batch_stats"]}, f, q,
                             training=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * ct), out

    jax_runs = {}
    for dtype in ("float32", "bfloat16"):
        with pltpu.force_tpu_interpret_mode(), jprec.compute_dtype(dtype):
            (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                           has_aux=True))(
                variables["params"], jnp.asarray(feature), jnp.asarray(query))
        jax_runs[dtype] = {"out": jout, "d feature": jgrads[1], "d query": jgrads[2],
                           **flax_to_state_dict({"params": jgrads[0]})}
    assert jax_runs["bfloat16"]["out"].dtype == jnp.bfloat16
    cell = tp.PointNonLocalCell(6, 9, 32, 16, use_flash=True)
    cell.load_state_dict(flax_to_state_dict(variables), strict=True)
    cell.train()
    seen = []
    real = tp.flash_attention

    def spy(q, k, v, scaled=True):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, scaled)

    tfeat, tquery = (torch.from_numpy(a).requires_grad_() for a in (feature, query))
    with pytest.MonkeyPatch.context() as mp, precision.compute_dtype("bfloat16"):
        mp.setattr(tp, "flash_attention", spy)
        out = cell(tfeat, tquery)
        (out.float() * torch.from_numpy(ct)).sum().backward()
    assert seen == [(torch.bfloat16,) * 3]
    assert out.dtype == torch.bfloat16
    port = {"out": out.detach(), "d feature": tfeat.grad, "d query": tquery.grad,
            **{name: p.grad for name, p in cell.named_parameters()}}
    assert sorted(port) == sorted(jax_runs["bfloat16"])
    for what, got in port.items():
        want, f32 = _np(jax_runs["bfloat16"][what]), _np(jax_runs["float32"][what])
        err = float(np.abs(_np(got) - want).max())
        limit = CELL_YARDSTICK * float(np.abs(want - f32).max())
        assert err <= limit, f"{what}: max|port - jax| {err:.3e} over {limit:.3e}"
