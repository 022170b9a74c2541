"""The encoder-decoder segmentation model, ``pointasnl_sem_seg``, and the cells
it adds to the port, against the JAX package on the CPU.

- Cells (``MLP``, ``PointNonLocalCell`` in both modes, ``PointASNLDecodingLayer``
  with and without its non-local refinement, the sampled ``PointNetSAModule``
  with ball and kNN grouping) through ``run_jit``, ``test_torch_layers.run_both``
  with the flax module jitted: the same randomized flax weights on both
  sides, |port - jax| <= 1e-5 * max(|jax|, 1),
  train mode in float64 (BN over a few dozen points amplifies float32
  rounding of two frameworks' reductions), neighbour indices exact.
- Goldens: the decoding layer and the SA cell against the independent numpy
  mirrors of ``tests/test_golden_decode.py`` and ``tests/test_golden_sa.py``
  (their tolerance, 1e-3, train mode).
- ``PointASNLSemSeg`` eval forward at B2 x 512: 21 classes with
  ``feature_channel`` 0 and 3, and SemanticKITTI's remission model (20
  classes, ``feature_channel`` 1),
  on batches drawn with replacement as ``data/scannet.py`` draws a crop, so
  they hold exact duplicate points: the level-1 FPS and kNN and the last
  decoding layer's self-kNN and ``three_nn`` (inputs alone) index-exact,
  logits within 1e-4 * max(|jax|, 1) with the same argmax (test_torch_seg's
  tolerance).
- One float64 train step of ``make_train_step(task="seg")`` against JAX's
  with the head dropout's masks injected into both packages: loss terms
  1e-6 relative, gradients 1e-5 of each leaf's scale, BN statistics and
  parameters 1e-6 (``test_torch_train``'s checks).
- The weights: ``flax_to_state_dict`` of the flax tree fills every key of the
  port's ``state_dict`` under a strict load.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_layers import assert_close, randomized
from test_torch_seg import flax_variables
from test_torch_train import _to64, check_bn_stats_and_params, check_gradients

import pointasnl_tpu.models.sem_seg as jax_sem_seg_module
from pointasnl_tpu.models import PointASNLSemSeg as JaxSemSeg
from pointasnl_tpu.nn import layers as jl
from pointasnl_tpu.nn import pointasnl as jp
from pointasnl_tpu.nn import pointnet as jpn
from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu.train import schedules as jsched
from pointasnl_tpu.train.state import TrainState as JaxTrainState
from pointasnl_tpu.train.state import make_optimizer as jax_make_optimizer
from pointasnl_tpu.train.steps import make_train_step as jax_make_train_step
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models import PointASNLSemSeg, get_model_class
from pointasnl_tpu_torch.nn import layers as tl
from pointasnl_tpu_torch.nn import pointasnl as tp
from pointasnl_tpu_torch.nn import pointnet as tpn
from pointasnl_tpu_torch.ops import dispatch
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.train import (
    TrainState,
    bn_momentum_schedule,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)
from pointasnl_tpu_torch.utils import flax_to_state_dict
from tests.test_golden_decode import np_decode_forward
from tests.test_golden_sa import np_sa_forward

torch.set_num_threads(1)

B, N, NUM_CLASS, SIDE = 2, 512, 21, 0.2
LR, DECAY_STEP, DECAY_RATE, KEEP = 1e-3, 200000, 0.7, 0.5
# Gather backwards a B2 x 512 encoder-decoder train step makes (every gather
# of a tensor with a gradient that feeds the loss), and the index tensors
# they plan: chip_smoke.py asserts the same counts on the card at B6 x 8192.
ENCDEC_GATHER_BWD, ENCDEC_GATHER_PLANS = 18, 12


# -- the cells ----------------------------------------------------------------

def run_jit(jmodule, tmodule, args, *, training, momentum=0.9, seed=0, x64=False):
    """test_torch_layers.run_both with the flax module's init traced by
    jax.eval_shape and its apply jitted (eagerly, each new shape of each
    primitive compiles on its own): the same randomized weights on both
    sides. Returns (jax output, port output, jax batch_stats, port
    state_dict)."""
    mkw = {"bn_momentum": momentum}
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    shapes = jax.eval_shape(lambda *a: jmodule.init({"params": jax.random.PRNGKey(0)}, *a,
                                                    training=False, **mkw), *jargs)
    variables = randomized(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           seed)
    tmodule.load_state_dict(flax_to_state_dict(variables), strict=True)
    tmodule.train(training)

    def wide(a):
        return a.astype(np.float64) if x64 and np.issubdtype(a.dtype, np.floating) else a

    with jax.enable_x64(x64):
        jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(wide(a)), variables)
        apply = jax.jit(functools.partial(jmodule.apply, training=training,
                                          mutable=["batch_stats"], **mkw))
        jout, updates = apply(jvars, *[None if a is None else jnp.asarray(wide(a)) for a in args])
    if x64:
        tmodule.double()
    with torch.no_grad():
        tout = tmodule(*[None if a is None else torch.from_numpy(wide(a)) for a in args], **mkw)
    return jout, tout, updates.get("batch_stats", {}), tmodule.state_dict()


@pytest.mark.parametrize("last_activation,last_bn", [("relu", True), (None, False)])
def test_mlp_matches_jax(last_activation, last_bn):
    x = np.random.RandomState(10).randn(2, 12, 5, 7).astype(np.float32)
    act = {"relu": (jax.nn.relu, torch.relu), None: (None, None)}[last_activation]
    jout, tout, _, state = run_jit(
        jl.MLP(features=(16, 8, 4), last_activation=act[0], last_bn=last_bn),
        tl.MLP(7, (16, 8, 4), last_activation=act[1], last_bn=last_bn), [x], training=False)
    assert_close(tout, jout)
    assert ("conv2.bn.scale" in state) == last_bn and ("conv2.conv.bias" in state) != last_bn


@pytest.mark.parametrize("mode,training", [("concat", False), ("concat", True), ("dot", True)])
def test_nonlocal_cell_modes_match_jax(mode, training):
    """The decoding layer's shapes: queries of one width over keys of another."""
    rng = np.random.RandomState(11)
    feature = rng.randn(2, 40, 6).astype(np.float32)
    query = rng.randn(2, 12, 9).astype(np.float32)
    jout, tout, stats, state = run_jit(
        jp.PointNonLocalCell(bottleneck=32, out_channels=16, mode=mode),
        tp.PointNonLocalCell(6, 9, 32, 16, mode=mode), [feature, query], training=training,
        momentum=0.5, x64=training)
    assert_close(tout, jout)
    assert ("conv_attention_map.bn.mean" in state) == (mode == "concat")
    if training and mode == "concat":  # BN over the B * M * N pairs
        assert_close(state["conv_attention_map.bn.mean"], stats["conv_attention_map"]["bn"]["mean"])
        assert_close(state["conv_attention_map.bn.var"], stats["conv_attention_map"]["bn"]["var"])


def test_concat_mode_ignores_blockwise_and_flash_and_unknown_modes_raise():
    """JAX routes kv_block_size and use_flash only in mode "dot": a concat
    cell asked for either computes the dense concat scores."""
    rng = np.random.RandomState(12)
    feature, query = rng.randn(2, 40, 6).astype(np.float32), rng.randn(2, 12, 9).astype(np.float32)
    dense = tp.PointNonLocalCell(6, 9, 32, 16, mode="concat",
                                 generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = dense(torch.from_numpy(feature), torch.from_numpy(query))
        for kw in ({"kv_block_size": 8}, {"use_flash": True}):
            cell = tp.PointNonLocalCell(6, 9, 32, 16, mode="concat", **kw).eval()
            cell.load_state_dict(dense.state_dict(), strict=True)
            assert torch.equal(cell(torch.from_numpy(feature), torch.from_numpy(query)), want)
    with pytest.raises(ValueError, match="unknown non-local mode"):
        tp.PointNonLocalCell(6, 9, 32, 16, mode="bilinear")


def _decode_inputs(seed, N1=40, N2=10, C1=5, C2=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, N1, 3).astype(np.float32), rng.randn(2, N2, 3).astype(np.float32),
            rng.randn(2, N1, C1).astype(np.float32), rng.randn(2, N2, C2).astype(np.float32))


@pytest.mark.parametrize("NL,mode,training", [(False, "concat", False), (False, "concat", True),
                                               (True, "concat", True), (True, "dot", False)])
def test_decoding_layer_matches_jax(NL, mode, training):
    xyz1, xyz2, points1, points2 = _decode_inputs(13)
    jout, tout, stats, state = run_jit(
        jp.PointASNLDecodingLayer(nsample=6, mlp=(24, 16, 8), NL=NL, mode=mode),
        tp.PointASNLDecodingLayer(5, 7, 6, (24, 16, 8), NL=NL, mode=mode),
        [xyz1, xyz2, points1, points2], training=training, momentum=0.5, x64=training)
    assert_close(tout, jout)
    assert tout.shape == (2, 40, 8)
    if training:
        flat = {}

        def walk(tree, prefix=""):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}.") if isinstance(v, dict) else flat.update({prefix + k: v})

        walk(stats)
        assert sorted(flat) == sorted(k for k in state if k.endswith((".mean", ".var")))
        for k, v in flat.items():
            assert_close(state[k], v)


def test_decoding_layer_with_fewer_points_than_its_searches_matches_jax():
    """B2 x 512's fa_layer1: three_nn over 2 points and a k16 self-kNN among 4."""
    xyz1, xyz2, points1, points2 = _decode_inputs(14, N1=4, N2=2)
    jout, tout, _, _ = run_jit(jp.PointASNLDecodingLayer(nsample=16, mlp=(24, 16)),
                                tp.PointASNLDecodingLayer(5, 7, 16, (24, 16)),
                                [xyz1, xyz2, points1, points2], training=False)
    assert_close(tout, jout)


@pytest.mark.parametrize("knn,pooling", [(False, "max"), (True, "max"), (False, "weighted_avg"),
                                         (True, "max_and_avg")])
def test_sampled_pointnet_sa_matches_jax(knn, pooling):
    rng = np.random.RandomState(15)
    xyz = (rng.rand(2, 64, 3) * 0.6).astype(np.float32)
    points = rng.randn(2, 64, 5).astype(np.float32)
    jout, tout, _, _ = run_jit(
        jpn.PointNetSAModule(mlp=(16, 24), npoint=16, radius=0.25, nsample=8, knn=knn,
                             pooling=pooling),
        tpn.PointNetSAModule(5, (16, 24), npoint=16, radius=0.25, nsample=8, knn=knn,
                             pooling=pooling),
        [xyz, points], training=False)
    assert_close(tout[0], jout[0])
    assert_close(tout[1], jout[1])
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))  # indices exact


def test_sample_and_group_matches_jax_without_features():
    rng = np.random.RandomState(16)
    xyz = (rng.rand(2, 50, 3) * 0.5).astype(np.float32)
    for knn in (False, True):
        got = tpn.sample_and_group(12, 0.2, 8, torch.from_numpy(xyz), None, knn=knn)
        want = jpn.sample_and_group(12, 0.2, 8, jnp.asarray(xyz), None, knn=knn)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="group_all"):
        tpn.PointNetSAModule(5, (16,))


# -- the goldens --------------------------------------------------------------

def _flax_params(state_dict):
    """The port's state_dict as the nested flax params the mirrors read."""
    tree = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf in ("mean", "var"):
            continue
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = value.numpy().T
        else:
            node[leaf] = value.numpy()
    return tree


def test_decoding_layer_matches_the_golden_mirror():
    rng = np.random.RandomState(0)
    Bg, N1, N2, C1, C2, nsample, mlp = 2, 48, 12, 8, 16, 6, (24, 20)
    xyz1, xyz2 = rng.randn(Bg, N1, 3).astype(np.float32), rng.randn(Bg, N2, 3).astype(np.float32)
    p1, p2 = rng.randn(Bg, N1, C1).astype(np.float32), rng.randn(Bg, N2, C2).astype(np.float32)
    cell = tp.PointASNLDecodingLayer(C1, C2, nsample, mlp,
                                     generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        got = cell(*(torch.from_numpy(a) for a in (xyz1, xyz2, p1, p2)))
    want = np_decode_forward(_flax_params(cell.state_dict()), xyz1, xyz2, p1, p2, nsample, mlp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_sa_cell_matches_the_golden_mirror():
    rng = np.random.RandomState(0)
    Bg, Ng, C, npoint, nsample, as_nb, mlp = 2, 64, 6, 16, 8, 4, (16, 16, 32)
    xyz, feats = rng.randn(Bg, Ng, 3).astype(np.float32), rng.randn(Bg, Ng, C).astype(np.float32)
    cell = tp.PointASNLSetAbstraction(C, npoint, nsample, mlp, as_neighbor=as_nb,
                                      generator=torch.Generator().manual_seed(0)).train()
    with torch.no_grad():
        got_xyz, got = cell(torch.from_numpy(xyz), torch.from_numpy(feats))
    want_xyz, want = np_sa_forward(_flax_params(cell.state_dict()), xyz, feats, npoint, nsample,
                                   mlp, as_nb)
    np.testing.assert_allclose(got_xyz.numpy(), want_xyz, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


# -- the model ----------------------------------------------------------------

def crop_batch(seed, feature_channel=0, B=B, N=N, distinct=384):
    """B clouds of N points drawn with replacement from `distinct` points
    uniform in a SIDE cube (as ScannetDataset draws a crop, so exact
    duplicates), RGB-like features in [0, 1], labels and smpw of ones."""
    rng = np.random.RandomState(seed)
    base = rng.rand(B, distinct, 3 + feature_channel)
    base[..., :3] *= SIDE
    choice = rng.randint(0, distinct, (B, N))
    points = np.stack([base[b, choice[b]] for b in range(B)]).astype(np.float32)
    return (points, rng.randint(0, NUM_CLASS, (B, N)).astype(np.int32),
            np.ones((B, N), np.float32))


def state_dict(feature_channel=0, seed=0, num_class=NUM_CLASS):
    """The port's seeded init, with every BN leaf redrawn from numpy."""
    sd = PointASNLSemSeg(num_class, feature_channel, generator=torch.Generator().manual_seed(seed),
                         device="cpu").state_dict()
    rng = np.random.RandomState(seed)
    draw = {"mean": lambda n: 0.1 * rng.randn(n), "var": lambda n: 0.5 + rng.rand(n),
            "scale": lambda n: 1.0 + 0.1 * rng.randn(n), "bias": lambda n: 0.1 * rng.randn(n)}
    for key in sorted(sd):
        module, leaf = key.rsplit(".", 2)[-2:]
        if module == "bn":
            sd[key] = torch.from_numpy(draw[leaf](sd[key].numel()).astype(np.float32))
    return sd


@pytest.fixture(scope="module", params=[(NUM_CLASS, 0), (NUM_CLASS, 3), (20, 1)],
                ids=["xyz", "rgb", "remission"])
def forward(request):
    """(feature_channel, input, sd, flax variables, JAX logits and l1_xyz);
    the logits' last axis is the model's class count."""
    num_class, fc = request.param
    x = crop_batch(30 + fc, fc)[0]
    sd = state_dict(fc, num_class=num_class)
    jmodel = JaxSemSeg(num_class=num_class, feature_channel=fc)
    variables = flax_variables(jmodel, x, sd)
    logits, end_points = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(
        variables, jnp.asarray(x))
    return fc, x, sd, variables, np.asarray(logits), np.asarray(end_points["l1_xyz"])


def test_batches_hold_duplicate_points(forward):
    x = forward[1]
    for cloud in x:
        assert len(np.unique(cloud[:, :3], axis=0)) < 0.8 * N


def test_weights_convert_under_a_strict_load(forward):
    fc, _, sd, variables = forward[:4]
    back = flax_to_state_dict(variables)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    model = PointASNLSemSeg(forward[4].shape[-1], fc, device="cpu")
    model.load_state_dict(back, strict=True)
    n_params = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(variables["params"]))
    assert n_params == sum(p.numel() for p in model.parameters())


def test_sem_seg_eval_forward_matches_jax(forward):
    fc, x, sd, _, ref_logits, ref_l1_xyz = forward
    num_class = ref_logits.shape[-1]
    model = PointASNLSemSeg(num_class, fc, device="cpu")
    model.load_state_dict(sd, strict=True)
    points = torch.from_numpy(x)
    logits = make_inference_fn(model)(points).numpy()
    with torch.inference_mode():
        _, end_points = model(points)

    # The searches on the input alone: layer 1's FPS and kNN, the last
    # decoding layer's self-kNN (k16) and three_nn, index-exact.
    xyz, jxyz = points[..., :3].contiguous(), jnp.asarray(x[..., :3])
    fps1, jfps1 = ops.farthest_point_sample(N // 8, xyz), jg.farthest_point_sample(N // 8, jxyz)
    np.testing.assert_array_equal(fps1.numpy(), np.asarray(jfps1))
    new_xyz = ops.gather_point(xyz, fps1)
    _, knn1 = ops.knn_point(32, xyz, new_xyz)
    np.testing.assert_array_equal(knn1.numpy(), np.asarray(jg.knn_point(32, jxyz, jnp.asarray(
        new_xyz.numpy()))[1]))
    np.testing.assert_array_equal(ops.knn_point(16, xyz, xyz)[1].numpy(),
                                  np.asarray(jg.knn_point(16, jxyz, jxyz)[1]))
    l1 = end_points["l1_xyz"]
    np.testing.assert_allclose(l1.numpy(), ref_l1_xyz, atol=1e-5)
    d2, idx = ops.three_nn(xyz, l1)
    jd2, jidx = jg.three_nn(jxyz, jnp.asarray(l1.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6, atol=0)

    scale = max(float(np.abs(ref_logits).max()), 1.0)
    err = float(np.abs(logits - ref_logits).max())
    assert logits.shape == (B, N, num_class) and np.isfinite(logits).all()
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref_logits.argmax(-1))


def test_registry_and_default_device():
    assert get_model_class("pointasnl_sem_seg") is PointASNLSemSeg
    model = PointASNLSemSeg(NUM_CLASS, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


# -- one float64 train step against JAX's --------------------------------------

MASKS = {}  # name -> (B, N, 128) bool, read by both packages' dropouts


class InjectedDropout(jl.Dropout):
    """JAX's Dropout with the mask of MASKS[name] in place of flax's draw;
    the same arithmetic: where kept, x / keep_prob, else 0."""

    @fnn.compact
    def __call__(self, x, *, training):
        if not training:
            return x
        keep = 1.0 - (1.0 - self.keep_prob)
        return jnp.where(jnp.asarray(MASKS[self.name]), x / keep, jnp.zeros_like(x))


@pytest.fixture(scope="module")
def steps():
    """One float64 Adam step of each package from the same weights, batch and
    dp1 mask: (jax outputs, port state, port metrics, port batch, sd)."""
    x, labels, smpw = crop_batch(40)
    sd = state_dict()
    model = PointASNLSemSeg(NUM_CLASS, device="cpu")
    model.load_state_dict(sd, strict=True)
    model.double()
    MASKS.clear()
    MASKS["dp1"] = np.random.RandomState(41).rand(B, N, 128) < KEEP
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sem_seg_module, "Dropout", InjectedDropout)
        mp.setattr(model.dp1, "keep_mask",
                   lambda shape, generator: torch.from_numpy(MASKS["dp1"]).to(generator.device))
        jmodel = JaxSemSeg(num_class=NUM_CLASS)
        variables = flax_variables(jmodel, x, sd)
        with jax.enable_x64():
            variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
            tx = jax_make_optimizer("adam", jsched.staircase_lr_schedule(LR, B, DECAY_STEP,
                                                                         DECAY_RATE))
            state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx,
                                  apply_fn=jmodel.apply)
            step = jax_make_train_step(bn_schedule=jsched.bn_momentum_schedule(B, DECAY_STEP),
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
        tstate = TrainState(model, make_optimizer(
            "adam", staircase_lr_schedule(LR, B, DECAY_STEP, DECAY_RATE), model.parameters()))
        tstep = make_train_step(bn_schedule=bn_momentum_schedule(B, DECAY_STEP), task="seg",
                                uniform_weight=0.01)
        tbatch = {"points": torch.from_numpy(x).double(), "labels": torch.from_numpy(labels),
                  "smpw": torch.from_numpy(smpw).double()}
        tmetrics = tstep(tstate, tbatch, torch.Generator().manual_seed(0))
    return jax_out, tstate, tmetrics, tbatch, sd


def test_sem_seg_train_step_loss_terms_match_jax(steps):
    jax_out, tstate, tmetrics, _, _ = steps
    assert tstate.step == 1
    for name in ("loss", "classify_loss", "uniform_loss", "reg_loss", "accuracy"):
        want, got = jax_out["metrics"][name], float(tmetrics[name])
        assert abs(got - want) <= 1e-6 * abs(want), f"{name}: port {got!r}, jax {want!r}"
    assert 0.0 < jax_out["metrics"]["uniform_loss"] < 0.069  # the balls hold neighbours


def test_sem_seg_train_step_gradients_match_jax(steps):
    check_gradients(steps)  # 1e-5 of each leaf's scale


def test_sem_seg_train_step_bn_stats_and_params_match_jax(steps):
    check_bn_stats_and_params(steps)  # 1e-6 of |stat|, 1e-6 absolute


def test_every_differentiable_gather_of_an_encdec_step_goes_through_dispatch(monkeypatch):
    """A counting stub in place of the routed gather_point sees each gather
    of a tensor with a gradient in a train step (21; three of them, the FPS
    samples of levels 2-4, feed only the searches): the card launches the
    gather backward ENCDEC_GATHER_BWD times a step, on ENCDEC_GATHER_PLANS
    plans (gathers of one index tensor share one)."""
    routed, backward = [], []
    # The plain gather saves a copy of idx, not idx: the index tensors are
    # kept alive for the step, so no id() below is reused by a later one.
    alive = []
    route = dispatch.gather_point

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
            alive.append(base)
            points = Backward.apply(points, (id(base), points.shape[1], tuple(idx.shape),
                                             idx.stride(), idx.storage_offset()))
        return route(points, idx)

    monkeypatch.setattr(dispatch, "gather_point", stub)
    monkeypatch.setattr(ops, "gather_point", stub)
    model = PointASNLSemSeg(NUM_CLASS, 3, generator=torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(model, make_optimizer("adam", staircase_lr_schedule(1e-3, 1, 200000, 0.7),
                                             model.parameters()))
    step = make_train_step(bn_schedule=bn_momentum_schedule(1, 200000), task="seg",
                           uniform_weight=0.01)
    x, labels, smpw = crop_batch(50, 3, B=1)
    metrics = step(state, {"points": torch.from_numpy(x), "labels": torch.from_numpy(labels),
                           "smpw": torch.from_numpy(smpw)}, torch.Generator().manual_seed(1))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert len(routed) == 21 and len(backward) == ENCDEC_GATHER_BWD
    assert len(set(backward)) == ENCDEC_GATHER_PLANS
