"""The port's base layers against ``pointasnl_tpu.nn.layers`` with converted
flax weights.

Every flax leaf is replaced by random values before conversion (BN variances
positive), so scale, bias and the running statistics all matter. Tolerance:
|port - jax| <= 1e-5 * max(|jax|, 1) — float32 with the same operation order
on both sides, but different matmul and rsqrt implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointasnl_tpu.nn import layers as jl
from pointasnl_tpu_torch.nn import layers as tl
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"


def randomized(variables, seed):
    """The flax variables with every leaf redrawn (variances kept positive)."""
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        shape = np.shape(leaf)
        if path[-1].key == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        return (0.5 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(np.asarray, variables))


def run_both(jmodule, tmodule, args, *, training, momentum=0.9, seed=0, kwargs=None,
             x64=False):
    """Apply the flax module and the port module to the same numpy inputs
    with the same (randomized) weights.

    Returns (jax output, port output, jax updated batch_stats, port state_dict).
    An argument of None is passed as None to both; `kwargs` (numpy arrays)
    go to both by name. With `x64` both run in float64 (floating inputs and
    weights), under ``jax.enable_x64``.
    """
    mkw = {"momentum": momentum} if isinstance(tmodule, tl.BatchNorm) else {"bn_momentum": momentum}
    kwargs = kwargs or {}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    init = jmodule.init({"params": jax.random.PRNGKey(0)}, *jargs, training=False, **jkw, **mkw)
    variables = randomized(init, seed)
    tmodule.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmodule.train(training)

    def wide(a):
        return a.astype(np.float64) if x64 and np.issubdtype(a.dtype, np.floating) else a

    with jax.enable_x64(x64):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(wide(a)), variables)
        jargs = [None if a is None else jnp.asarray(wide(a)) for a in args]
        jout, updates = jmodule.apply(jvars, *jargs, training=training, mutable=["batch_stats"],
                                      **jkw, **mkw)
    if x64:
        tmodule.double()
    with torch.no_grad():
        tout = tmodule(*[None if a is None else torch.from_numpy(wide(a)) for a in args],
                       **{k: torch.from_numpy(v) for k, v in kwargs.items()}, **mkw)
    return jout, tout, updates.get("batch_stats", {}), tmodule.state_dict()


@pytest.mark.parametrize("training", [False, True])
def test_batchnorm_matches_jax(training):
    x = (np.random.RandomState(1).randn(4, 10, 6) * 3 + 2).astype(np.float32)
    jout, tout, stats, state = run_both(jl.BatchNorm(), tl.BatchNorm(6), [x], training=training,
                                        momentum=0.7)
    assert_close(tout, jout)
    if training:  # the running statistics moved by the reference's EMA rule
        assert_close(state["mean"], stats["mean"])
        assert_close(state["var"], stats["var"])


def test_batchnorm_uses_biased_variance_and_eps_1e3():
    x = torch.tensor([[0.0], [2.0]])
    bn = tl.BatchNorm(1).train()
    y = bn(x, momentum=0.0)
    torch.testing.assert_close(bn.var, torch.tensor([1.0]))  # biased: mean(x^2) - mean(x)^2
    torch.testing.assert_close(y, torch.tensor([[-1.0], [1.0]]) / np.sqrt(1.0 + 1e-3))


@pytest.mark.parametrize("bn,act,training", [
    (True, "relu", False), (True, "relu", True), (False, "relu", False), (True, None, True),
])
def test_pointconv_matches_jax(bn, act, training):
    x = np.random.RandomState(2).randn(2, 8, 5, 7).astype(np.float32)
    jact = jax.nn.relu if act else None
    tact = torch.relu if act else None
    jout, tout, stats, state = run_both(jl.PointConv(12, bn=bn, activation=jact),
                                        tl.PointConv(7, 12, bn=bn, activation=tact),
                                        [x], training=training)
    assert_close(tout, jout)
    if bn and training:
        assert_close(state["bn.var"], stats["bn"]["var"])


@pytest.mark.parametrize("bn", [True, False])
def test_fully_connected_matches_jax(bn):
    x = np.random.RandomState(3).randn(6, 20).astype(np.float32)
    jout, tout, _, state = run_both(jl.FullyConnected(9, bn=bn), tl.FullyConnected(20, 9, bn=bn),
                                    [x], training=False)
    assert_close(tout, jout)
    assert ("dense.bias" in state) == (not bn)  # the bias is dropped when BN follows


def test_dropout_keep_prob_convention():
    drop = tl.Dropout(keep_prob=0.4)
    x = torch.ones(20000)
    assert torch.equal(drop.eval()(x), x)
    y = drop.train()(x, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.4) < 0.02
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.4))


def test_dense_xavier_init_from_generator():
    a = tl.Dense(64, 32, generator=torch.Generator().manual_seed(5))
    b = tl.Dense(64, 32, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.weight, b.weight) and a.weight.shape == (32, 64)
    limit = np.sqrt(6.0 / (64 + 32))
    top = float(a.weight.detach().abs().max())
    assert 0.9 * limit < top <= limit
    assert torch.equal(a.bias, torch.zeros(32))
