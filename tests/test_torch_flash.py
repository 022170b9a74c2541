"""The port's flash attention (the plain versions of the two flash kernels,
the non-local cell and the models under ``nl_use_flash``) against the JAX
package's, whose Pallas kernels run here in interpret mode
(``pltpu.force_tpu_interpret_mode()``, as ``tests/test_flash_attention.py``
runs them).

Tolerances, each beside its assert:
  - the kernels' functions: both sides are float32 inside with sums in other
    orders: o and lse within 1e-6 of max(|jax|, 1), gradients within 1e-5
    of each gradient's largest |value|;
  - float64 inputs: both return float64 at float32 precision, within 1e-6;
  - cells and models: the tolerances of ``test_torch_pointasnl``,
    ``test_torch_seg``, ``test_torch_cls`` and ``test_torch_train``; the
    float64 train step under the flag adds the yardstick its fixture states.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_layers import assert_close, randomized
from test_torch_seg import NUM_CLASS, flax_variables, port_state_dict, seg_batch
from test_torch_train import (
    check_bn_stats_and_params,
    check_gradients,
    check_loss_terms,
    jax_step,
    port_step,
    shared_jax_step,
)

from pointasnl_tpu.models import PointASNLCls as JaxCls
from pointasnl_tpu.models import PointASNLSemSegRes as JaxSegRes
from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.ops.pallas import flash_attention as jfa
from pointasnl_tpu_torch.models import PointASNLCls, PointASNLSemSegRes
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn.blockwise import attention_scale
from pointasnl_tpu_torch.ops import flash_attention as tf
from pointasnl_tpu_torch.ops.cuda import flash_attention as cuda_flash
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)


@contextlib.contextmanager
def x64_everywhere():
    """float64 for the interpreted Pallas kernels: ``jax.enable_x64()`` is
    thread-local, and the TPU interpreter's callbacks run on another thread,
    where the kernels' float64 buffers would come back float32. So the flag
    is set globally for the block, and restored."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _qkv(seed, B, M, N, C, D, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(dtype) for shape in ((B, M, C), (B, N, C), (B, N, D)))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1.0)


def test_flash_scale_is_the_jax_flash_scale():
    """float32(1 / sqrt(C)) that multiplies, as flash_attention.py:286,105;
    the dense cell divides by float32(sqrt(C)) and blockwise multiplies by
    1 / that, which differ from it in the last bit at some C (C = 6 here)."""
    for C in range(1, 1025):
        assert tf.flash_scale(C) == float(np.float32(1.0 / math.sqrt(C)))
    assert tf.flash_scale(6) != float(np.float32(1.0) / np.float32(attention_scale(6)))
    assert tf.flash_scale(32) == float(np.float32(1.0) / np.float32(attention_scale(32)))
    assert tf.flash_scale(7, scaled=False) == 1.0


@pytest.mark.parametrize("B,M,N,C,D,scaled", [
    (2, 16, 256, 8, 12, True),
    (2, 100, 1500, 8, 8, True),  # crosses a 1024-key chunk; M pads to 128 in JAX
    (2, 16, 256, 8, 12, False),
])
def test_flash_forward_matches_jax(B, M, N, C, D, scaled):
    q, k, v = _qkv(M + N, B, M, N, C, D)
    jscale = 1.0 / math.sqrt(C) if scaled else 1.0  # flash_attention.py:286
    with pltpu.force_tpu_interpret_mode():
        jo, jstats = jfa._flash_forward_with_stats(*map(jnp.asarray, (q, k, v)), jscale)
        jout = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scaled)
    o, lse = tf.flash_forward_reference(*map(torch.from_numpy, (q, k, v)), tf.flash_scale(C, scaled))
    assert o.dtype == lse.dtype == torch.float32 and lse.shape == (B, M)
    assert _rel_err(o, np.asarray(jo)[:, :M]) <= 1e-6  # float32, other sum orders
    assert _rel_err(lse, np.asarray(jstats)[:, :M, 0]) <= 1e-6
    out = tf.flash_attention(*map(torch.from_numpy, (q, k, v)), scaled)
    assert torch.equal(out, o)  # the public call is the plain forward on the CPU
    assert _rel_err(out, jout) <= 1e-6


@pytest.mark.parametrize("M,N", [(200, 300), (100, 1500)])
def test_flash_backward_matches_jax(M, N):
    """(200, 300) pads M to 256 in JAX (zero dO rows); (100, 1500) crosses a
    KV chunk."""
    q, k, v = _qkv(M * N, 2, M, N, 8, 12)
    ct = np.random.RandomState(3).randn(2, M, 12).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v), *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tf.flash_attention(tq, tk, tv).backward(torch.from_numpy(ct))
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), f"d{name}: {err:.3e}"  # float32 sums


def test_flash_in_float64_returns_float64_at_float32_precision():
    q, k, v = _qkv(9, 2, 100, 1500, 8, 8, np.float64)
    ct = np.random.RandomState(4).randn(2, 100, 8)
    with x64_everywhere(), pltpu.force_tpu_interpret_mode():
        jout, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v), *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(ct))
    assert jout.dtype == jnp.float64
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(ct))
    assert out.dtype == tq.grad.dtype == tk.grad.dtype == tv.grad.dtype == torch.float64
    assert _rel_err(out.detach(), jout) <= 1e-6  # both float32 inside
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert _rel_err(got, want) <= 1e-6
    # float32 precision, not float64: the dense float64 result is ~1e-8 away.
    s = torch.einsum("bmc,bnc->bmn", tq.detach(), tk.detach()) * tf.flash_scale(8)
    dense = torch.einsum("bmn,bnd->bmd", torch.softmax(s, dim=-1), tv.detach())
    assert 1e-10 < _rel_err(out.detach(), dense) < 1e-6


@pytest.mark.parametrize("B,M,N,C,D", [
    (2, 1, 300, 32, 32),     # one query row
    (2, 65, 63, 32, 32),     # a row past the kernel's 64-row tile, keys short of its chunk
    (1, 64, 1025, 32, 32),   # one key past the plain version's 1024-key chunk
    (2, 50, 300, 1, 1),      # C = D = 1
    (2, 90, 700, 32, 64),    # C != D
    (1, 30, 200, 256, 256),  # the widest the kernel takes
])
def test_flash_forward_reference_holds_at_the_kernels_edges(B, M, N, C, D):
    """The plain forward, which the card's kernel is held to, against dense
    float64 attention where the kernel's tiles, chunks and widths end."""
    q, k, v = map(torch.from_numpy, _qkv(M + N + C, B, M, N, C, D))
    scale = tf.flash_scale(C)
    o, lse = tf.flash_forward_reference(q, k, v, scale)
    assert o.dtype == lse.dtype == torch.float32 and o.shape == (B, M, D) and lse.shape == (B, M)
    s = torch.einsum("bmc,bnc->bmn", q.double(), k.double()) * scale
    assert _rel_err(o, torch.einsum("bmn,bnd->bmd", torch.softmax(s, -1), v.double())) <= 1e-6
    assert _rel_err(lse, torch.logsumexp(s, -1)) <= 1e-6


def test_flash_attention_keeps_cpu_tensors_off_the_kernel():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 4, 9, 8, 8))
    launches = cuda_flash.fwd_launches, cuda_flash.bwd_launches
    qg = q.clone().requires_grad_()
    tf.flash_attention(qg, k, v).sum().backward()
    assert (cuda_flash.fwd_launches, cuda_flash.bwd_launches) == launches
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        cuda_flash.flash_forward(q, k, v, 1.0)


def _cell_inputs():
    rng = np.random.RandomState(2)
    return rng.randn(2, 40, 6).astype(np.float32), rng.randn(2, 12, 9).astype(np.float32)


def test_nonlocal_cell_with_flash_matches_jax_in_train_mode():
    """Forward, batch statistics and gradients (of the inputs and of every
    parameter) in train mode, float64 on both sides as in
    test_torch_pointasnl: 1e-5 of max(|jax|, 1)."""
    feature, query = _cell_inputs()
    ct = np.random.RandomState(6).randn(2, 12, 16)
    jcell = jp.PointNonLocalCell(bottleneck=32, out_channels=16, use_flash=True)
    # The flag adds no parameters: the dense cell's init gives the tree.
    init = jp.PointNonLocalCell(bottleneck=32, out_channels=16).init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(feature), jnp.asarray(query),
        training=False)
    variables = randomized(init, 0)
    with pltpu.force_tpu_interpret_mode(), x64_everywhere():
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def loss(params, f, q):
            out, upd = jcell.apply({"params": params, "batch_stats": jv["batch_stats"]}, f, q,
                                   training=True, mutable=["batch_stats"])
            return jnp.sum(out * ct), (out, upd)

        (_, (jout, jupd)), jgrads = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            jv["params"], jnp.asarray(feature, jnp.float64), jnp.asarray(query, jnp.float64))
    cell = tp.PointNonLocalCell(6, 9, 32, 16, use_flash=True)
    cell.load_state_dict(flax_to_state_dict(variables), strict=True)
    cell.double().train()
    tfeat, tquery = (torch.from_numpy(a).double().requires_grad_() for a in (feature, query))
    out = cell(tfeat, tquery)
    out.backward(torch.from_numpy(ct))
    assert_close(out.detach(), jout)
    assert_close(tfeat.grad, jgrads[1])
    assert_close(tquery.grad, jgrads[2])
    want = flax_to_state_dict({"params": jgrads[0]}, np.float64)
    for name, p in cell.named_parameters():
        assert_close(p.grad, want[name])
    stats = flax_to_state_dict({"batch_stats": jupd["batch_stats"]}, np.float64)
    for name, buf in cell.named_buffers():
        assert_close(buf, stats[name])


def test_kv_blocks_take_precedence_over_flash_in_both(monkeypatch):
    """kv_block_size with use_flash takes blockwise in both packages: the
    flash function of either would raise if it were called."""
    def refuse(*args, **kwargs):
        raise AssertionError("flash attention called")

    monkeypatch.setattr(jfa, "flash_attention", refuse)
    monkeypatch.setattr(tp, "flash_attention", refuse)
    feature, query = _cell_inputs()
    jcell = jp.PointNonLocalCell(bottleneck=32, out_channels=16, kv_block_size=16, use_flash=True)
    init = jcell.init({"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, (feature, query)),
                      training=False)
    variables = randomized(init, 0)
    jout = jcell.apply(variables, *map(jnp.asarray, (feature, query)), training=False)
    cell = tp.PointNonLocalCell(6, 9, 32, 16, kv_block_size=16, use_flash=True).eval()
    cell.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        out = cell(*map(torch.from_numpy, (feature, query)))
        blockwise = tp.PointNonLocalCell(6, 9, 32, 16, kv_block_size=16).eval()
        blockwise.load_state_dict(cell.state_dict(), strict=True)
        assert torch.equal(out, blockwise(*map(torch.from_numpy, (feature, query))))
    assert_close(out, jout)  # 1e-5 of max(|jax|, 1)


def test_seg_eval_forward_with_flash_matches_jax():
    """The same converted weights drive the flash model in both packages
    (the flag adds no parameters); logits within 1e-4 * max(|jax|, 1) and
    the same argmax, as test_torch_seg."""
    x, _, _ = seg_batch(0)
    sd = port_state_dict()
    jmodel = JaxSegRes(num_class=NUM_CLASS, dropout_keep=1.0, nl_use_flash=True)
    variables = flax_variables(jmodel, x, sd)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, training=False)[0])(
            variables, jnp.asarray(x)))
    model = PointASNLSemSegRes(NUM_CLASS, dropout_keep=1.0, nl_use_flash=True, device="cpu")
    assert sorted(model.state_dict()) == sorted(sd) == sorted(flax_to_state_dict(variables))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    logits = make_inference_fn(model)(torch.from_numpy(x)).numpy()
    assert logits.shape == ref.shape and np.isfinite(logits).all()
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(logits - ref).max())
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))


@pytest.fixture(scope="module")
def flash_steps(tmp_path_factory):
    """One float64 seg train step under nl_use_flash in both packages, JAX's
    traced inside the interpret-mode context (a jitted trace outside it
    fails on the CPU, so the step ran the Pallas kernels interpreted), and
    JAX's dense float64 step as the yardstick.

    test_torch_train's tolerances do not hold here: the flash attention is
    float32 inside on both sides, and train-mode BN over the 4 and 2 points
    of levels 3 and 4 amplifies its rounding (port vs JAX: loss 5e-5, some
    gradients a few % of their leaf's scale). So each limit also admits 10
    times how far the flash path's float32 attention moves JAX's own step
    from its dense float64 step, and updated parameters are compared where
    |g| is above check_gradients' limit, where its sign is not noise."""
    q = jnp.ones((1, 8, 8))
    with pytest.raises(ValueError, match="interpret mode"):
        jax.jit(jfa.flash_attention)(q, q, q)
    with pltpu.force_tpu_interpret_mode():
        jax.jit(jfa.flash_attention)(q, q, q)  # the context reaches a jitted trace
        with x64_everywhere():
            flash = jax_step(nl_use_flash=True)
    return (flash, *port_step(nl_use_flash=True)), shared_jax_step(tmp_path_factory)


def test_seg_flash_train_step_loss_terms_match_jax(flash_steps):
    steps, dense = flash_steps
    check_loss_terms(steps, ref=dense)  # 1e-6 relative + 10 x |jax flash - jax dense|


def test_seg_flash_train_step_gradients_match_jax(flash_steps):
    steps, dense = flash_steps
    check_gradients(steps, ref=dense)  # 1e-5 of each leaf's scale + 10 x the same distance


def test_seg_flash_train_step_bn_stats_and_params_match_jax(flash_steps):
    steps, dense = flash_steps
    check_bn_stats_and_params(steps, ref=dense)  # 1e-6 of |stat|, 1e-6 absolute, + the same


@pytest.mark.parametrize("flags", [{"nl_use_flash": True}, {"nl_kv_block_size": 256}],
                         ids=["flash", "kv_blocks"])
def test_cls_eval_forward_with_nl_flags_matches_jax(flags):
    """Both flags thread into layer1 and layer2 (K/V of 1024 and 512 keys);
    logits within 1e-4 * max(|jax|, 1), same argmax, as test_torch_cls."""
    jmodel = JaxCls(num_class=40, adaptive_sample=True, **flags)
    x = np.random.RandomState(1).randn(2, 1024, 3).astype(np.float32)
    model = PointASNLCls(40, adaptive_sample=True, device="cpu",
                         generator=torch.Generator().manual_seed(2), **flags)
    # The port's seeded weights carried into the flax tree (no flax init runs).
    variables = flax_variables(jmodel, x[:1], model.state_dict())
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, training=False)[0])(
            variables, jnp.asarray(x)))
    logits = make_inference_fn(model)(torch.from_numpy(x)).numpy()
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(logits - ref).max())
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref.argmax(-1))
