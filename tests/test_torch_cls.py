"""The slice end to end: the port's ``PointASNLCls(40, adaptive_sample=True)``
eval forward against the JAX package's, with flax-init weights converted.

At B=2 x 1024 and full width (the model has no width knobs). Layer-1 and
layer-2 FPS and kNN indices must be exactly equal; the logits within
1e-4 * max(|ref|, 1) with the same argmax. The 1e-4 covers float32 rounding
of two frameworks' matmuls and reductions accumulated over ~20 layers; it is
not a cover for neighbour flips, which the index checks would catch first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointasnl_tpu.models import PointASNLCls as JaxCls
from pointasnl_tpu.ops import geometry as jg
from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models import PointASNLCls, get_model_class
from pointasnl_tpu_torch.serve import make_inference_fn
from pointasnl_tpu_torch.utils import flax_to_state_dict

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    """Flax-init variables (as numpy), the input cloud, and JAX's forward."""
    model = JaxCls(num_class=40, adaptive_sample=True)
    x = np.random.RandomState(0).randn(2, 1024, 3).astype(np.float32)
    # Parameter shapes do not depend on the batch, so init on one cloud.
    variables = jax.jit(lambda key, x: model.init({"params": key}, x, training=False))(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    logits, end_points = jax.jit(lambda v, x: model.apply(v, x, training=False))(
        variables, jnp.asarray(x))
    return variables, x, np.asarray(logits), np.asarray(end_points["l1_xyz"])


@pytest.fixture(scope="module")
def port(reference):
    variables = reference[0]
    model = PointASNLCls(40, adaptive_sample=True, device="cpu")
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def test_converter_maps_every_flax_leaf_to_one_entry(reference):
    variables = reference[0]
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    sd = flax_to_state_dict(variables)
    expected = PointASNLCls(40, adaptive_sample=True, device="cpu").state_dict()
    assert len(sd) == len(leaves) == len(expected)
    assert sorted(sd) == sorted(expected)
    for key, value in sd.items():
        assert value.shape == expected[key].shape, key
    n_params = sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(variables["params"]))
    assert n_params == sum(p.numel() for p in PointASNLCls(40, adaptive_sample=True,
                                                          device="cpu").parameters())


def test_cls_eval_forward_matches_jax(reference, port):
    _, x, ref_logits, ref_l1_xyz = reference
    points = torch.from_numpy(x)
    logits = make_inference_fn(port)(points).numpy()
    with torch.inference_mode():
        _, end_points = port(points)
    l1_xyz = end_points["l1_xyz"].numpy()

    # Layer 1: FPS on the input cloud, kNN of the samples over it.
    fps1 = ops.farthest_point_sample(512, points)
    np.testing.assert_array_equal(fps1.numpy(), np.asarray(jg.farthest_point_sample(512, jnp.asarray(x))))
    new_xyz = ops.gather_point(points, fps1)
    _, knn1 = ops.knn_point(32, points, new_xyz)
    _, jknn1 = jg.knn_point(32, jnp.asarray(x), jnp.asarray(new_xyz.numpy()))
    np.testing.assert_array_equal(knn1.numpy(), np.asarray(jknn1))

    # Layer 2 runs on the adaptively sampled l1_xyz, a float output.
    np.testing.assert_allclose(l1_xyz, ref_l1_xyz, atol=1e-5)
    fps2 = ops.farthest_point_sample(128, end_points["l1_xyz"]).numpy()
    jfps2 = np.asarray(jg.farthest_point_sample(128, jnp.asarray(ref_l1_xyz)))
    assert (fps2 != jfps2).sum() == 0, f"{(fps2 != jfps2).sum()} layer-2 FPS indices differ"

    scale = max(float(np.abs(ref_logits).max()), 1.0)
    err = float(np.abs(logits - ref_logits).max())
    assert logits.shape == (2, 40) and np.isfinite(logits).all()
    assert err <= 1e-4 * scale, f"max|port-jax|={err:.3e}, scale {scale:.3e}"
    np.testing.assert_array_equal(logits.argmax(-1), ref_logits.argmax(-1))


def test_inference_fn_is_eval_mode_without_grad(port):
    port.train()
    infer = make_inference_fn(port)
    assert not port.training
    out = infer(torch.randn(1, 1024, 3, generator=torch.Generator().manual_seed(1)))
    assert not out.requires_grad and out.shape == (1, 40)


def test_generator_init_is_deterministic():
    a = PointASNLCls(40, adaptive_sample=True, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    b = PointASNLCls(40, adaptive_sample=True, generator=torch.Generator().manual_seed(3),
                     device="cpu")
    c = PointASNLCls(40, adaptive_sample=True, generator=torch.Generator().manual_seed(4),
                     device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["fc1.dense.weight"], sc["fc1.dense.weight"])


def test_registry_and_normals_variant():
    assert get_model_class("pointasnl_cls") is PointASNLCls
    with pytest.raises(KeyError, match="unknown model"):
        get_model_class("nope")
    model = PointASNLCls(10, use_normal=True, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    logits = make_inference_fn(model)(torch.randn(1, 600, 6, generator=torch.Generator().manual_seed(2)))
    assert logits.shape == (1, 10) and bool(torch.isfinite(logits).all())
