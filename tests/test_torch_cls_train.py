"""The cls train step of the port against the JAX package's
``make_train_step(task="cls")``: ``PointASNLCls(40, adaptive_sample=True)``
at its own widths, Adam with the staircase LR and the BN-momentum schedule.

The two dropouts' masks are drawn once from numpy and injected into both
packages (JAX's ``Dropout`` in ``models/cls.py`` is replaced by one that reads
them; the port's ``Dropout.keep_mask`` of ``dp1`` and ``dp2`` returns them),
so the same units are dropped on both sides.

- float64, B2 x 1024, as the seg step is held (``test_torch_train.py``):
  loss terms 1e-6 relative, accuracy equal; gradients (Adam's first moment)
  1e-5 of each leaf's scale; BN statistics 1e-6 * max(|stat|, 1); updated
  parameters 1e-6 absolute where |g| > 1e-6. Both packages take the
  cross-entropy in float32 and the searches' distances in float32, so the
  limits are those of the seg step.
- bfloat16, B16 x 1024 (the recipe's batch): the gate of
  ``test_torch_precision.py`` (``check_gate``: searches replayed, JAX's loss
  gate, the update norms against JAX's own bfloat16 distance).

Also: ``make_eval_step`` with and without ``task``, the port's ``Dropout``
and ``fold_in``, and no global-RNG draw on the port's train path.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_precision import (
    GeometryTape,
    check_gate,
    jax_gate_step,
    jax_gate_worst,
    port_gate_step,
)
from test_torch_seg import flax_variables
from test_torch_train import _to64, check_bn_stats_and_params, check_gradients

import pointasnl_tpu.models.cls as jax_cls_module
from pointasnl_tpu.models import PointASNLCls as JaxCls
from pointasnl_tpu.nn import layers as jl
from pointasnl_tpu.train import schedules as jsched
from pointasnl_tpu.train.state import TrainState as JaxTrainState
from pointasnl_tpu.train.state import make_optimizer as jax_make_optimizer
from pointasnl_tpu.train.steps import make_train_step as jax_make_train_step
from pointasnl_tpu_torch.models import PointASNLCls
from pointasnl_tpu_torch.nn.layers import Dropout
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_eval_step,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)
from pointasnl_tpu_torch.train.steps import fold_in
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)

NUM_CLASS, LR, DECAY_STEP, DECAY_RATE = 40, 1e-3, 200000, 0.7
KEEP = 0.4
MASKS = {}  # name -> (B, width) bool, read by both packages' dropouts


class InjectedDropout(jl.Dropout):
    """JAX's Dropout with the mask of MASKS[name] in place of flax's draw;
    the same arithmetic: where kept, x / keep_prob, else 0."""

    @fnn.compact
    def __call__(self, x, *, training):
        if not training:
            return x
        keep = 1.0 - (1.0 - self.keep_prob)
        return jnp.where(jnp.asarray(MASKS[self.name]), x / keep, jnp.zeros_like(x))


def inject_masks(mp, B, seed, port_models=()):
    """Draw dp1's and dp2's masks from numpy into MASKS, put JAX's
    InjectedDropout in models/cls.py and point the port models' keep_mask
    at the same masks."""
    rng = np.random.RandomState(seed)
    MASKS.clear()
    MASKS.update(dp1=rng.rand(B, 512) < KEEP, dp2=rng.rand(B, 256) < KEEP)
    mp.setattr(jax_cls_module, "Dropout", InjectedDropout)
    for model in port_models:
        for name in ("dp1", "dp2"):
            def keep_mask(shape, generator, name=name):
                assert tuple(shape) == MASKS[name].shape
                return torch.from_numpy(MASKS[name]).to(generator.device)

            mp.setattr(getattr(model, name), "keep_mask", keep_mask)


def cls_state_dict(seed=0):
    """The port's seeded init, with every BN leaf redrawn from numpy."""
    sd = PointASNLCls(NUM_CLASS, adaptive_sample=True,
                      generator=torch.Generator().manual_seed(seed), device="cpu").state_dict()
    rng = np.random.RandomState(seed)
    draw = {"mean": lambda n: 0.1 * rng.randn(n), "var": lambda n: 0.5 + rng.rand(n),
            "scale": lambda n: 1.0 + 0.1 * rng.randn(n), "bias": lambda n: 0.1 * rng.randn(n)}
    for key in sorted(sd):
        module, leaf = key.rsplit(".", 2)[-2:]
        if module == "bn":
            sd[key] = torch.from_numpy(draw[leaf](sd[key].numel()).astype(np.float32))
    return sd


def cls_batch(B, seed=0):
    rng = np.random.RandomState(seed)
    return {"points": rng.randn(B, 1024, 3).astype(np.float32),
            "labels": rng.randint(0, NUM_CLASS, B).astype(np.int32)}


@pytest.fixture(scope="module")
def f64_steps():
    """One float64 Adam step of each package from the same weights, batch
    and masks: (jax outputs, port state, port metrics, port batch, sd)."""
    B = 2
    batch, sd = cls_batch(B), cls_state_dict()
    model = PointASNLCls(NUM_CLASS, adaptive_sample=True, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.double()
    with pytest.MonkeyPatch.context() as mp:
        inject_masks(mp, B, seed=1, port_models=[model])
        jmodel = JaxCls(num_class=NUM_CLASS, adaptive_sample=True)
        variables = flax_variables(jmodel, batch["points"], sd)
        with jax.enable_x64():
            variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
            tx = jax_make_optimizer("adam", jsched.staircase_lr_schedule(LR, B, DECAY_STEP,
                                                                         DECAY_RATE))
            state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx,
                                  apply_fn=jmodel.apply)
            step = jax_make_train_step(bn_schedule=jsched.bn_momentum_schedule(B, DECAY_STEP),
                                       task="cls", donate=False)
            new_state, jmetrics = step(state, {"points": jnp.asarray(batch["points"], jnp.float64),
                                               "labels": jnp.asarray(batch["labels"])},
                                       jax.random.PRNGKey(0))
            jax_out = {
                "metrics": {k: float(v) for k, v in jmetrics.items()},
                "mu": flax_to_state_dict({"params": _to64(new_state.opt_state[0].mu)}, np.float64),
                "after": flax_to_state_dict(_to64({"params": new_state.params,
                                                   "batch_stats": new_state.batch_stats}),
                                            np.float64),
            }
        tstate = TrainState(model, make_optimizer(
            "adam", staircase_lr_schedule(LR, B, DECAY_STEP, DECAY_RATE), model.parameters()))
        tstep = make_train_step(bn_schedule=bn_momentum_schedule(B, DECAY_STEP), task="cls")
        tbatch = {"points": torch.from_numpy(batch["points"]).double(),
                  "labels": torch.from_numpy(batch["labels"])}
        tmetrics = tstep(tstate, tbatch, torch.Generator().manual_seed(0))
    return jax_out, tstate, tmetrics, tbatch, sd


def test_cls_train_step_loss_terms_match_jax(f64_steps):
    jax_out, tstate, tmetrics, _, _ = f64_steps
    assert tstate.step == 1 and tstate.optimizer.param_groups[0]["update_count"] == 1
    for name in ("loss", "classify_loss", "uniform_loss", "reg_loss"):
        want, got = jax_out["metrics"][name], float(tmetrics[name])
        assert abs(got - want) <= 1e-6 * abs(want), f"{name}: port {got!r}, jax {want!r}"
    assert float(tmetrics["accuracy"]) == jax_out["metrics"]["accuracy"]
    # uniform_weight 0: the reference's placeholder stands in the metric
    assert float(tmetrics["uniform_loss"]) == float(tmetrics["classify_loss"])


def test_cls_train_step_gradients_match_jax(f64_steps):
    check_gradients(f64_steps)  # 1e-5 of each leaf's scale


def test_cls_train_step_bn_stats_and_params_match_jax(f64_steps):
    check_bn_stats_and_params(f64_steps, min_moved=60)  # 36 BN layers, 72 statistics


@pytest.mark.parametrize("task", [None, "cls", "seg"])
def test_eval_step_takes_a_task(f64_steps, task):
    _, tstate, _, tbatch, _ = f64_steps
    eval_step = make_eval_step() if task is None else make_eval_step(task=task)
    logits, metrics = eval_step(tstate, tbatch)
    assert logits.shape == (2, NUM_CLASS) and not tstate.model.training
    want = (logits.argmax(-1) == tbatch["labels"]).float().mean()
    assert float(metrics["accuracy"]) == float(want)
    with pytest.raises(ValueError, match="unknown task"):
        make_eval_step(task="detection")


def test_serve_forward_is_eval_mode_after_a_train_step(f64_steps):
    """A request after a train step runs in eval mode: BN's running
    statistics, no dropout (which would need a generator in train mode)."""
    _, tstate, _, tbatch, _ = f64_steps
    model = tstate.model
    infer = make_inference_fn(model)
    model.train()  # as a train step leaves it
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    logits = infer(tbatch["points"])
    assert not model.training
    with torch.no_grad():
        want, _ = model(tbatch["points"])
    assert torch.equal(logits, want)
    assert all(torch.equal(v, stats[k]) for k, v in model.state_dict().items())


# -- the port's dropout -------------------------------------------------------

def test_dropout_draws_from_the_generator_it_is_given():
    drop = Dropout(keep_prob=KEEP).train()
    x = torch.ones(200000, dtype=torch.float64)
    a = drop(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).double().mean().item()
    assert abs(kept - KEEP) < 0.005
    assert torch.equal(a[a != 0], torch.full_like(a[a != 0], 1.0 / KEEP))
    assert torch.equal(drop.eval()(x), x)  # eval mode: no draw, no generator needed
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x)
    assert torch.equal(Dropout(keep_prob=1.0).train()(x), x)
    assert drop.train()(x.bfloat16(), torch.Generator().manual_seed(5)).dtype == torch.bfloat16


def test_fold_in_depends_on_the_seed_and_the_step_only():
    g = torch.Generator().manual_seed(123)
    drop = Dropout(keep_prob=KEEP).train()
    x = torch.ones(4096)
    first = drop(x, fold_in(g, 7))
    torch.rand(10, generator=g)  # draws from g change nothing
    assert torch.equal(drop(x, fold_in(g, 7)), first)
    assert not torch.equal(drop(x, fold_in(g, 8)), first)  # the next step draws anew
    assert not torch.equal(drop(x, fold_in(torch.Generator().manual_seed(124), 7)), first)
    assert fold_in(g, 7).device == g.device


def test_no_global_rng_on_the_train_path():
    """The port draws randomness only from generators it is handed: no
    F.dropout, no global-RNG draw, no global seed."""
    root = Path(__file__).resolve().parents[1] / "pointasnl_tpu_torch"
    banned = re.compile(r"F\.dropout|functional\.dropout|torch\.manual_seed|\.bernoulli\(|"
                        r"torch\.(rand|randn|randint|randperm)\((?![^)]*generator)")
    found = [f"{p.relative_to(root)}:{i}" for p in sorted(root.rglob("*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1) if banned.search(line)]
    assert not found, found


# -- bfloat16 -----------------------------------------------------------------

def cls_gate_runs(B=16):
    """The cls step at B x 1024 in four runs, the masks injected in all: the
    port's float32 step (its searches recorded), and with those searches
    replayed, the port's bfloat16 step and JAX's float32 and bfloat16 steps
    (SGD with momentum, as test_torch_precision's seg gate)."""
    batch, sd = cls_batch(B, seed=3), cls_state_dict()
    tape, runs = GeometryTape(), {}
    with pytest.MonkeyPatch.context() as mp:
        models = {}
        for name in ("port_f32", "port_bf16"):
            models[name] = PointASNLCls(NUM_CLASS, adaptive_sample=True, device="cpu")
            models[name].load_state_dict(sd, strict=True)
        inject_masks(mp, B, seed=4, port_models=list(models.values()))
        for name, dtype in (("port_f32", "float32"), ("port_bf16", "bfloat16")):
            runs[name] = port_gate_step(
                models[name], {k: torch.from_numpy(v) for k, v in batch.items()}, dtype, "cls",
                tape_mode="record" if name == "port_f32" else "replay", tape=tape)
        jmodel = JaxCls(num_class=NUM_CLASS, adaptive_sample=True)
        variables = flax_variables(jmodel, batch["points"], sd)
        for name, dtype in (("jax_f32", "float32"), ("jax_bf16", "bfloat16")):
            runs[name] = jax_gate_step(jmodel, variables, batch, dtype, "cls", tape=tape)
    return runs


def test_cls_bf16_step_passes_the_gate():
    """The port's bfloat16 cls step against JAX's and against its own
    float32 step, as test_torch_precision holds the seg step; JAX's
    bfloat16 step fails JAX's per-parameter gate here too."""
    runs = cls_gate_runs()
    assert jax_gate_worst(runs, "jax_bf16", "jax_f32") > 1.0
    check_gate(runs)
