"""One segmentation train step of the port against the JAX package's
``make_train_step(task="seg", uniform_weight=0.01)``, with the same weights
and batch: ``PointASNLSemSegRes(21, dropout_keep=1.0)`` at B=2 x 512, full
width, Adam with the staircase LR and the BN-momentum schedule.

Both sides run in float64 (``jax.enable_x64`` and ``model.double()``). In
float32, train-mode BN over the 4 and 2 points of levels 3 and 4 leaves
either framework's logits ~1e-2 (relative) away from a float64 run of the
same step, and the two float32 runs as far from each other; in float64 the
two agree to ~1e-8, so a fault stands out. Both packages still compute the
cross-entropy and the L2 term in float32 and the distances behind FPS, kNN,
the ball query and the IDW weights in float32, so the tolerances are:

- loss terms: 1e-6 relative (float32 reductions, in two orders, over
  19.8 M squared weights and 1024 cross-entropies);
- gradients, per leaf: 1e-5 of the leaf's largest |g|, or of 1e-9 of the
  largest |g| of the model where the leaf's own gradient is rounding noise
  (the BN biases under a softmax over neighbours, zero in exact arithmetic,
  ~1e-15 here). The gradients are read from Adam's first moment, 0.1 g
  after one step, on both sides;
- BN statistics after the step: 1e-6 * max(|stat|, 1);
- updated parameters, where |g| > 1e-6 (Adam's step lr * g / (|g| + 1e-8)
  is flat in g there; below it a gradient's last bits move the step by up to
  1e5 times their size): 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_seg import NUM_CLASS, flax_variables, port_state_dict, seg_batch

from pointasnl_tpu.models import PointASNLSemSegRes as JaxSegRes
from pointasnl_tpu.nn import losses as jlosses
from pointasnl_tpu.train import schedules as jsched
from pointasnl_tpu.train.state import TrainState as JaxTrainState
from pointasnl_tpu.train.state import make_optimizer as jax_make_optimizer
from pointasnl_tpu.train.steps import make_train_step as jax_make_train_step
from pointasnl_tpu_torch.models import PointASNLSemSegRes
from pointasnl_tpu_torch.nn import losses
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_eval_step,
    make_optimizer,
    make_predict_step,
    make_train_step,
    staircase_lr_schedule,
)
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)

BATCH, LR = 2, 1e-3
DECAY_STEP, DECAY_RATE = 200000, 0.7


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def jax_step(**model_kwargs):
    """One float64 step of the JAX package: its metrics, its gradients (as
    Adam's first moment) and its variables after the step, as state_dicts."""
    x, labels, smpw = seg_batch(1)
    sd = port_state_dict()
    jmodel = JaxSegRes(num_class=NUM_CLASS, dropout_keep=1.0, **model_kwargs)
    variables = flax_variables(jmodel, x, sd)
    with jax.enable_x64():
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jax_make_optimizer("adam", jsched.staircase_lr_schedule(LR, BATCH, DECAY_STEP,
                                                                     DECAY_RATE))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]), tx=tx,
                              apply_fn=jmodel.apply)
        step = jax_make_train_step(bn_schedule=jsched.bn_momentum_schedule(BATCH, DECAY_STEP),
                                   task="seg", uniform_weight=0.01, donate=False)
        batch = {"points": jnp.asarray(x, jnp.float64), "labels": jnp.asarray(labels),
                 "smpw": jnp.asarray(smpw, jnp.float64)}
        new_state, jmetrics = step(state, batch, jax.random.PRNGKey(0))
        jax_out = {
            "metrics": {k: float(v) for k, v in jmetrics.items()},
            "mu": flax_to_state_dict({"params": _to64(new_state.opt_state[0].mu)}, np.float64),
            "after": flax_to_state_dict(_to64({"params": new_state.params,
                                               "batch_stats": new_state.batch_stats}),
                                        np.float64),
        }
    return jax_out


def port_step(**model_kwargs):
    """The port's float64 step from the same weights and batch: (port state
    after its step, port metrics, port batch, state_dict)."""
    x, labels, smpw = seg_batch(1)
    sd = port_state_dict()
    model = PointASNLSemSegRes(NUM_CLASS, dropout_keep=1.0, device="cpu", **model_kwargs)
    model.load_state_dict(sd, strict=True)
    model.double()
    tstate = TrainState(model, make_optimizer(
        "adam", staircase_lr_schedule(LR, BATCH, DECAY_STEP, DECAY_RATE), model.parameters()))
    tstep = make_train_step(bn_schedule=bn_momentum_schedule(BATCH, DECAY_STEP), task="seg",
                            uniform_weight=0.01)
    tbatch = {"points": torch.from_numpy(x).double(), "labels": torch.from_numpy(labels),
              "smpw": torch.from_numpy(smpw).double()}
    tmetrics = tstep(tstate, tbatch)
    return tstate, tmetrics, tbatch, sd


@pytest.fixture(scope="module")
def steps():
    """The JAX step's outputs and the port's state after its step."""
    return (jax_step(), *port_step())


# With a second JAX run `ref` (its outputs as jax_step returns them), each
# limit below also admits YARDSTICK times the distance between the two JAX
# runs in the quantity compared.
YARDSTICK = 10.0


def _far(jax_out, ref, group, name):
    if ref is None:
        return 0.0
    return YARDSTICK * float(np.max(np.abs(np.asarray(jax_out[group][name])
                                           - np.asarray(ref[group][name]))))


def check_loss_terms(steps, rtol=1e-6, ref=None):
    jax_out, tstate, tmetrics, _, _ = steps
    assert tstate.step == 1 and tstate.optimizer.param_groups[0]["update_count"] == 1
    for name in ("loss", "classify_loss", "uniform_loss", "reg_loss", "accuracy"):
        want, got = jax_out["metrics"][name], float(tmetrics[name])
        limit = rtol * abs(want) + _far(jax_out, ref, "metrics", name)
        assert abs(got - want) <= limit, f"{name}: port {got!r}, jax {want!r}"
    assert 0.0 < jax_out["metrics"]["uniform_loss"] < 0.069  # the balls hold neighbours


def check_gradients(steps, rtol=1e-5, ref=None):
    jax_out, tstate, _, _, _ = steps
    mu = jax_out["mu"]
    named = dict(tstate.model.named_parameters())
    assert sorted(mu) == sorted(named)
    gmax = max(float(m.abs().max()) for m in mu.values())
    for name, p in named.items():
        exp_avg = tstate.optimizer.state[p]["exp_avg"]
        # One step: exp_avg = (1 - b1) * g, with 1 - b1 rounded in float64.
        torch.testing.assert_close(exp_avg, 0.1 * p.grad, rtol=1e-12, atol=0.0)
        err = float((exp_avg - mu[name]).abs().max())
        limit = _grad_limit(jax_out, ref, name, gmax, rtol)
        assert err <= limit, f"{name}: max|port-jax| {err:.3e}, limit {limit:.3e}"


def _grad_limit(jax_out, ref, name, gmax, rtol=1e-5):
    mu = jax_out["mu"][name]
    scale = max(float(mu.abs().max()), 1e-9 * gmax)
    return rtol * scale + _far(jax_out, ref, "mu", name)


def check_bn_stats_and_params(steps, stat_rtol=1e-6, param_atol=1e-6, ref=None):
    jax_out, tstate, _, _, sd = steps
    after, mu = jax_out["after"], jax_out["mu"]
    gmax = max(float(m.abs().max()) for m in mu.values())
    port = tstate.model.state_dict()
    assert sorted(after) == sorted(port)
    moved = 0
    for name, want in after.items():
        got = port[name]
        if name.endswith((".mean", ".var")):
            err = float((got - want).abs().max())
            limit = stat_rtol * max(float(want.abs().max()), 1.0) + _far(jax_out, ref, "after", name)
            assert err <= limit, f"{name}: {err:.3e}"
            moved += not torch.equal(want.float(), sd[name])
        else:
            above = mu[name].abs() > 0.1 * 1e-6  # |g| > 1e-6
            if ref is not None:
                # Where |g| is within check_gradients' limit of the leaf, its
                # sign, and with it Adam's first step lr * g / (|g| + 1e-8),
                # is rounding noise.
                above &= mu[name].abs() > _grad_limit(jax_out, ref, name, gmax)
            err = float((got - want).abs()[above].max()) if bool(above.any()) else 0.0
            limit = param_atol + _far(jax_out, ref, "after", name)
            assert err <= limit, f"{name}: max|port-jax| {err:.3e} where |g| > 1e-6"
    assert moved > 100  # the step updated the running statistics


def test_seg_train_step_loss_terms_match_jax(steps):
    check_loss_terms(steps)  # 1e-6 relative


def test_seg_train_step_gradients_match_jax(steps):
    check_gradients(steps)  # 1e-5 of each leaf's scale


def test_seg_train_step_bn_stats_and_params_match_jax(steps):
    check_bn_stats_and_params(steps)  # 1e-6 of |stat|, 1e-6 absolute


def test_seg_eval_and_predict_steps(steps):
    _, tstate, _, tbatch, _ = steps
    logits, metrics = make_eval_step()(tstate, tbatch)
    assert logits.shape == (BATCH, 512, NUM_CLASS) and not tstate.model.training
    assert torch.equal(make_predict_step()(tstate, tbatch["points"]), logits)
    want = (logits.argmax(-1) == tbatch["labels"]).double().mean()
    assert float(metrics["accuracy"]) == float(want)


def test_losses_match_jax(steps):
    sd = steps[4]
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 50, 7).astype(np.float32)
    labels = rng.randint(0, 7, (3, 50)).astype(np.int32)
    w = (rng.rand(3, 50) * (rng.rand(3, 50) > 0.3)).astype(np.float32)
    got = losses.weighted_softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(w))
    want = jlosses.weighted_softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                                  jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = losses.weighted_softmax_cross_entropy(torch.from_numpy(logits),
                                                 torch.from_numpy(labels), torch.zeros(3, 50))
    assert float(zero) == 0.0  # divides by max(count_nonzero(w), 1)
    got = losses.softmax_cross_entropy(torch.from_numpy(logits[:, 0]), torch.from_numpy(labels[:, 0]))
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits[:, 0]), jnp.asarray(labels[:, 0]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # L2 over Dense weights only: never a BN scale or a bias.
    model = PointASNLSemSegRes(NUM_CLASS, device="cpu")
    model.load_state_dict(sd)
    want = 0.5 * sum(float(v.double().square().sum()) for k, v in sd.items()
                     if k.endswith(".weight"))
    np.testing.assert_allclose(float(losses.l2_regularization(model).detach()), want, rtol=1e-6)


def test_schedules_and_optimizer_follow_the_jax_package():
    lr = staircase_lr_schedule(LR, 16, 1000, 0.5)
    jlr = jsched.staircase_lr_schedule(LR, 16, 1000, 0.5)
    bn = bn_momentum_schedule(16, 1000)
    jbn = jsched.bn_momentum_schedule(16, 1000)
    for step in (0, 62, 63, 500, 10**6):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6)
        np.testing.assert_allclose(bn(step), float(jbn(step)), rtol=1e-6)
    # The LR of update t is the schedule at t, read before the count moves on.
    p = torch.nn.Parameter(torch.zeros(1))
    opt = make_optimizer("momentum", lambda t: 10.0 ** -t, [p], momentum=0.0)
    for _ in range(3):
        p.grad = torch.ones(1)
        opt.step()
    torch.testing.assert_close(p.detach(), torch.tensor([-1.11]))
    assert opt.state_dict()["param_groups"][0]["update_count"] == 3
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("rmsprop", lr, [p])
