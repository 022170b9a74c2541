"""Structure of the port: it imports no JAX, its models run on the card unless
asked for the CPU, and the flax -> state_dict converter is one-to-one."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import pointasnl_tpu_torch
from pointasnl_tpu_torch.nn import PointConv
from pointasnl_tpu_torch.utils import flax_to_state_dict

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pointasnl_tpu", "sklearn")
# The grid pipelines' modules: the card's machine has no scikit-learn and no
# PyYAML, so none of them may import either when it is imported.
GRID_MODULES = ("data.ply", "data.mesh", "data.grid_subsampling", "data.grid_pipeline",
                "data.scannet_grid", "data.semantic_kitti_config", "data.semantic_kitti_grid",
                "cli.train_scannet_grid", "cli.test_scannet_grid",
                "cli.train_semantic_kitti_grid", "cli.test_semantic_kitti_grid")
# The dataset drivers' data modules: the card's machine has no h5py and no
# matplotlib, so none of them may import either (nor scikit-learn or PyYAML)
# when it is imported; the functions that need one import it.
DATA_MODULES = ("data.provider", "data.pc_util", "data.laserscan_vis", "data.modelnet",
                "data.semantic_kitti", "data.laserscan", "data.prepare_scannet", "data.augment")
DRIVER_MODULES = ("cli.train_semantic_kitti", "cli.test_semantic_kitti", "cli.train_modelnet",
                  "cli.test_modelnet", "cli.visualize_semantic_kitti")
PKG = Path(pointasnl_tpu_torch.__file__).parent


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _port_sources():
    return (sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
            + sorted((PKG.parent / "scripts").glob("torch_*.py")))


def test_port_sources_found():
    names = {p.relative_to(PKG.parent).as_posix() for p in _port_sources()}
    assert {"pointasnl_tpu_torch/ops/dispatch.py", "pointasnl_tpu_torch/models/cls.py",
            "pointasnl_tpu_torch/ops/cuda/knn_streaming.py", "chip_smoke.py",
            "scripts/torch_step_turns.py", "scripts/torch_flash_tf32_passes.py",
            "pointasnl_tpu_torch/models/sem_seg.py", "pointasnl_tpu_torch/cli/train_scannet.py",
            "pointasnl_tpu_torch/cli/test_scannet.py", "pointasnl_tpu_torch/cli/seg_common.py",
            "pointasnl_tpu_torch/data/scannet.py", "pointasnl_tpu_torch/data/provider.py",
            "pointasnl_tpu_torch/utils/config.py", "pointasnl_tpu_torch/utils/logging.py",
            *(f"pointasnl_tpu_torch/{m.replace('.', '/')}.py"
              for m in GRID_MODULES + DATA_MODULES + DRIVER_MODULES)} <= names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.relative_to(PKG.parent).as_posix())
def test_port_module_imports_no_jax(path):
    """A static scan: the test process itself has JAX loaded (conftest), so
    sys.modules cannot tell what the port imports."""
    roots = set(_imported_roots(ast.parse(path.read_text(), filename=str(path))))
    assert not roots & set(FORBIDDEN), f"{path} imports {sorted(roots & set(FORBIDDEN))}"


def test_grid_modules_import_without_sklearn_yaml_or_jax():
    """Each grid module imports in a process where ``sklearn``, ``yaml``,
    ``jax`` and ``pointasnl_tpu`` cannot be imported (their ``sys.modules``
    entries set to None)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for name in ('sklearn', 'yaml', 'jax', 'pointasnl_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {GRID_MODULES!r}:\n"
            "    importlib.import_module('pointasnl_tpu_torch.' + m)\n"
            "from pointasnl_tpu_torch.data.semantic_kitti_config import load_config\n"
            "assert load_config()['learning_map'][252] == 1\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_data_modules_import_without_h5py_matplotlib_sklearn_yaml_or_jax():
    """Each dataset driver's data module, and the drivers, import in a
    process where ``h5py``, ``matplotlib``, ``sklearn``, ``yaml``, ``jax`` and
    ``pointasnl_tpu`` cannot be imported (their ``sys.modules`` entries set
    to None); a numpy-only function of each runs there."""
    import subprocess
    import sys

    code = ("import sys\n"
            "for name in ('h5py', 'matplotlib', 'sklearn', 'yaml', 'jax', 'pointasnl_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {DATA_MODULES + DRIVER_MODULES!r}:\n"
            "    importlib.import_module('pointasnl_tpu_torch.' + m)\n"
            "import numpy as np\n"
            "from pointasnl_tpu_torch.data import pc_util, provider, modelnet\n"
            "x = np.random.RandomState(0).rand(2, 32, 3)\n"
            "assert pc_util.point_cloud_three_views(x[0]).shape == (1500, 500)\n"
            "assert provider.shuffle_points(x, np.random.RandomState(0)).shape == x.shape\n"
            "assert modelnet.pc_normalize(x[0]).shape == (32, 3)\n"
            "print('imported', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_import_scan_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom flax import linen\nimport importlib\nimportlib.import_module('optax')\n"
    assert {"jax", "flax", "optax"} <= set(_imported_roots(ast.parse(src)))


def test_kernel_build_is_keyed_on_sources_and_raises_without_nvcc(monkeypatch):
    """The build covers every csrc/*.cu, keys on them and the headers they
    share, lands in the checkout's gitignored build/ directory, and fails
    loudly, with nothing built, where there is no CUDA toolkit."""
    import torch.utils.cpp_extension as cpp_extension

    from pointasnl_tpu_torch.ops.cuda import _build

    sources = _build._sources()
    assert [p.name for p in sources] == ["ball_query.cu", "flash_attention.cu",
                                         "flash_attention_bf16.cu", "fps.cu",
                                         "gather_backward.cu", "knn.cu", "knn_spatial.cu",
                                         "knn_streaming.cu"]
    assert [p.name for p in _build._inputs()] == ["ball_query.cu", "flash_attention.cu",
                                                  "flash_attention.cuh",
                                                  "flash_attention_bf16.cu", "fps.cu",
                                                  "gather_backward.cu", "knn.cu",
                                                  "knn_select.cuh", "knn_spatial.cu",
                                                  "knn_streaming.cu"]
    assert _build.BUILD_ROOT == PKG.parent / "build" / "pointasnl_tpu_torch"
    assert _build._digest(sources) == _build._digest(sources)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.LINK_FLAGS and "-shared" in _build.LINK_FLAGS
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_kernel_build_key_changes_with_a_shared_header(tmp_path, monkeypatch):
    """An edit to a header that two kernels include builds anew: the key of
    the build directory hashes csrc/*.cuh beside csrc/*.cu."""
    import shutil

    from pointasnl_tpu_torch.ops.cuda import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._digest(_build._inputs())
    header = csrc / "knn_select.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build._digest(_build._inputs()) != before
    assert [p.name for p in _build._sources()] == [p.name for p in sorted(_build.CSRC.glob("*.cu"))]


@pytest.mark.parametrize("name", ["pointasnl_cls", "pointasnl_sem_seg", "pointasnl_sem_seg_res"])
def test_models_default_to_the_card(name, monkeypatch):
    """Without a card, a model built with no device raises; it never stays on
    the CPU. device="cpu" is the explicit request."""
    from pointasnl_tpu_torch.models import get_model_class

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = get_model_class(name)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cls()
    model = cls(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_converter_maps_pointconv_leaves_one_to_one():
    rng = np.random.RandomState(0)
    variables = {
        "params": {"conv": {"kernel": rng.randn(5, 7)},
                   "bn": {"scale": rng.rand(7), "bias": rng.randn(7)}},
        "batch_stats": {"bn": {"mean": rng.randn(7), "var": rng.rand(7)}},
    }
    sd = flax_to_state_dict(variables)
    assert sorted(sd) == sorted(PointConv(5, 7).state_dict())
    np.testing.assert_array_equal(sd["conv.weight"].numpy(), variables["params"]["conv"]["kernel"].T.astype(np.float32))
    assert all(t.dtype == torch.float32 for t in sd.values())


def test_converter_refuses_unknown_collections():
    with pytest.raises(ValueError, match="unexpected variable collections"):
        flax_to_state_dict({"params": {}, "cache": {}})
