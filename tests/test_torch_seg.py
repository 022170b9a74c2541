"""The slice's model: the port's ``PointASNLSemSegRes(21)`` eval forward
against the JAX package's, at B=2 x 512 and full width, with the same weights.

The weights are the port's seeded initialisation with BN statistics, scales
and biases redrawn from a seeded numpy generator, carried into the flax
variable tree that ``jax.eval_shape`` of ``init`` describes (the inverse of
``utils.convert``), so no flax ``init`` runs. The JAX model is
``dropout_keep=1.0``, the port's likewise, so no dropout mask is matched.

Points are uniform in a 0.2 m cube: FPS then spaces the 64 points of l1_xyz
so that the repulsion loss's balls (r = 0.07) hold a few neighbours each.

Tolerance of the logits: |port - jax| <= 1e-4 * max(|jax|, 1) with the same
argmax, for float32 rounding of two frameworks' matmuls and reductions over
~40 layers (measured ~1e-6). The stem and level-1 FPS and kNN indices are
exact; they are computed from the input alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointasnl_tpu.models import PointASNLSemSegRes as JaxSegRes
from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models import PointASNLSemSegRes, get_model_class
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)

B, N, NUM_CLASS, SIDE = 2, 512, 21, 0.2


def seg_batch(seed, B=B, N=N):
    """Points uniform in a SIDE cube, labels, and smpw of ones, as numpy."""
    rng = np.random.RandomState(seed)
    return ((rng.rand(B, N, 3) * SIDE).astype(np.float32),
            rng.randint(0, NUM_CLASS, (B, N)).astype(np.int32),
            np.ones((B, N), np.float32))


def port_state_dict(seed=0):
    """The port's seeded init, with every BN leaf redrawn from numpy."""
    sd = PointASNLSemSegRes(NUM_CLASS, generator=torch.Generator().manual_seed(seed),
                            device="cpu").state_dict()
    rng = np.random.RandomState(seed)
    draw = {"mean": lambda n: 0.1 * rng.randn(n), "var": lambda n: 0.5 + rng.rand(n),
            "scale": lambda n: 1.0 + 0.1 * rng.randn(n), "bias": lambda n: 0.1 * rng.randn(n)}
    for key in sorted(sd):
        module, leaf = key.rsplit(".", 2)[-2:]
        if module == "bn":
            sd[key] = torch.from_numpy(draw[leaf](sd[key].numel()).astype(np.float32))
    return sd


def flax_variables(jmodel, x, sd):
    """The flax variables of `jmodel` holding the port's state_dict `sd`:
    the tree comes from jax.eval_shape of init, each leaf from `sd` by the
    inverse of utils.convert."""
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x, training=False),
        jnp.asarray(x))

    def fill(path, leaf):
        names = [p.key for p in path][1:]  # drop the collection
        if names[-1] == "kernel":
            value = sd[".".join(names[:-1] + ["weight"])].numpy().T
        else:
            value = sd[".".join(names)].numpy()
        assert value.shape == leaf.shape, names
        return np.ascontiguousarray(value)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def reference():
    """Weights, input, and the JAX eval forward."""
    x, _, _ = seg_batch(0)
    sd = port_state_dict()
    jmodel = JaxSegRes(num_class=NUM_CLASS, dropout_keep=1.0)
    variables = flax_variables(jmodel, x, sd)
    logits, end_points = jax.jit(lambda v, x: jmodel.apply(v, x, training=False))(
        variables, jnp.asarray(x))
    return sd, variables, x, np.asarray(logits), np.asarray(end_points["l1_xyz"])


@pytest.fixture(scope="module")
def port(reference):
    model = PointASNLSemSegRes(NUM_CLASS, dropout_keep=1.0, device="cpu")
    model.load_state_dict(reference[0], strict=True)
    return model


def test_state_dict_and_flax_tree_map_one_to_one(reference):
    sd, variables = reference[0], reference[1]
    back = flax_to_state_dict(variables)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    n_params = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(variables["params"]))
    assert n_params == 19_821_421


def test_seg_eval_forward_matches_jax(reference, port):
    _, _, x, ref_logits, ref_l1_xyz = reference
    points = torch.from_numpy(x)
    logits = make_inference_fn(port)(points).numpy()
    with torch.inference_mode():
        _, end_points = port(points)

    # The stem graph and the level-1 samples and rows, from the input alone.
    _, knn0 = ops.knn_point(32, points, points)
    _, jknn0 = jg.knn_point(32, jnp.asarray(x), jnp.asarray(x))
    np.testing.assert_array_equal(knn0.numpy(), np.asarray(jknn0))
    fps1 = ops.farthest_point_sample(N // 8, points)
    jfps1 = jg.farthest_point_sample(N // 8, jnp.asarray(x))
    np.testing.assert_array_equal(fps1.numpy(), np.asarray(jfps1))
    np.testing.assert_array_equal(ops.gather_point(knn0, fps1).numpy(),
                                  np.asarray(jg.gather_point(jknn0, jfps1)))

    np.testing.assert_allclose(end_points["l1_xyz"].numpy(), ref_l1_xyz, atol=1e-5)
    scale = max(float(np.abs(ref_logits).max()), 1.0)
    err = float(np.abs(logits - ref_logits).max())
    assert logits.shape == (B, N, NUM_CLASS) and np.isfinite(logits).all()
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref_logits.argmax(-1))


def test_reuse_geometry_is_exact(reference, port):
    """The hoisted stem graph gives the output of the searches it replaces."""
    off = PointASNLSemSegRes(NUM_CLASS, dropout_keep=1.0, reuse_geometry=False, device="cpu")
    off.load_state_dict(port.state_dict(), strict=True)
    points = torch.from_numpy(reference[2])
    torch.testing.assert_close(make_inference_fn(port)(points), make_inference_fn(off)(points),
                               rtol=1e-6, atol=1e-6)


def test_repulsion_term_sees_neighbours(reference):
    """On the test cloud the balls of l1_xyz are not just the point itself,
    so the repulsion term and its gradient exercise the ball query."""
    l1_xyz = torch.from_numpy(np.array(reference[4]))
    _, cnt = tg.query_ball_point(0.07, 20, l1_xyz, l1_xyz)
    mean = float(cnt.float().mean())
    print(f"mean in-ball count on l1_xyz: {mean:.2f}")
    assert 2.0 < mean < 20.0


def test_registry_and_feature_channel_variant():
    assert get_model_class("pointasnl_sem_seg_res") is PointASNLSemSegRes
    model = PointASNLSemSegRes(5, feature_channel=3, generator=torch.Generator().manual_seed(1),
                               device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).rand(1, 512, 6).astype(np.float32))
    logits = make_inference_fn(model)(x)
    assert logits.shape == (1, 512, 5) and bool(torch.isfinite(logits).all())
