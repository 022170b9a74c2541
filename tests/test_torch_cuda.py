"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Indices must be exactly equal; kNN squared distances within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from pointasnl_tpu_torch import ops
from pointasnl_tpu_torch.models import PointASNLCls
from pointasnl_tpu_torch.ops import geometry as tg
from pointasnl_tpu_torch.ops.cuda import fps as cuda_fps
from pointasnl_tpu_torch.ops.cuda import knn as cuda_knn
from pointasnl_tpu_torch.serve import make_inference_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(seed, B, N, dup=0):
    x = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    if dup:
        x[:, N - dup:] = x[:, :dup]
    return torch.from_numpy(x)


@pytest.mark.parametrize("B,N,npoint,dup", [
    (8, 1024, 512, 0),   # the slice's layer 1
    (8, 512, 128, 0),    # the slice's layer 2
    (2, 1000, 100, 0),   # N not a multiple of 32
    (2, 512, 200, 256),  # duplicate points
    (2, 300, 1, 0),      # npoint == 1
    (1, 10240, 1280, 0),  # the largest N the kernel takes
])
def test_fps_kernel_matches_plain(dev, B, N, npoint, dup):
    x = _cloud(N + npoint, B, N, dup).to(dev)
    got = cuda_fps.farthest_point_sample(npoint, x)
    want = tg.farthest_point_sample(npoint, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,N,M,k,case", [
    (8, 1024, 512, 32, "disjoint"),  # the slice's layer 1 shapes
    (8, 512, 128, 64, "disjoint"),   # the slice's layer 2 shapes
    (2, 1024, 256, 32, "subset"),
    (2, 600, 300, 16, "duplicates"),
    (2, 10, 7, 16, "disjoint"),      # k > N
    (1, 10240, 2560, 32, "subset"),
    (1, 12288, 64, 128, "disjoint"),  # the largest N and k the kernel takes
])
def test_knn_kernel_matches_plain(dev, B, N, M, k, case):
    support = _cloud(N + M, B, N, dup=N // 2 if case == "duplicates" else 0)
    query = support[:, : N: N // M][:, :M].clone() if case != "disjoint" else _cloud(k, B, M)
    support, query = support.to(dev), query.to(dev)
    got_d, got_i = cuda_knn.knn_point(k, support, query)
    want_d, want_i = tg.knn_point(k, support, query)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i)
    torch.testing.assert_close(got_d, want_d, rtol=1e-6, atol=1e-7)
    if case == "subset":  # each query is its own first neighbour
        assert torch.equal(got_i[..., 0].long(), torch.arange(0, N, N // M, device=dev)[:M].expand(B, M))


def test_kernels_refuse_sizes_beyond_their_limits(dev):
    with pytest.raises(ValueError, match="N <= 10240"):
        cuda_fps.farthest_point_sample(8, torch.zeros(1, 10241, 3, device=dev))
    with pytest.raises(ValueError, match="N <= 12288"):
        cuda_knn.knn_point(8, torch.zeros(1, 12289, 3, device=dev), torch.zeros(1, 4, 3, device=dev))
    with pytest.raises(ValueError, match="k <= 128"):
        cuda_knn.knn_point(129, torch.zeros(1, 200, 3, device=dev), torch.zeros(1, 4, 3, device=dev))


def test_dispatch_sends_cuda_tensors_to_the_kernels(dev):
    x = _cloud(1, 2, 256).to(dev)
    fps0, knn0 = cuda_fps.launches, cuda_knn.launches
    ops.farthest_point_sample(16, x)
    ops.knn_point(8, x, x[:, :16])
    assert (cuda_fps.launches - fps0, cuda_knn.launches - knn0) == (1, 1)


def test_cls_forward_launches_each_kernel_twice_a_request(dev):
    model = PointASNLCls(40, adaptive_sample=True,
                         generator=torch.Generator().manual_seed(0), device=dev)
    infer = make_inference_fn(model)
    x = _cloud(2, 2, 1024).to(dev)
    fps0, knn0 = cuda_fps.launches, cuda_knn.launches
    logits = infer(x)
    torch.cuda.synchronize()
    assert logits.shape == (2, 40) and bool(torch.isfinite(logits).all())
    assert (cuda_fps.launches - fps0, cuda_knn.launches - knn0) == (2, 2)
