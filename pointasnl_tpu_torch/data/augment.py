"""Augmentations on the batch's device: the port's counterpart of
``pointasnl_tpu/data/augment_jax.py`` (jax.random variants of the provider
pipeline), in torch.

The host numpy pipeline (``data/provider.py``) is the parity path; these
run where the batch lies, so that the augmentation needs no trip through the
host. Each function draws from an explicit ``torch.Generator`` on the
batch's device, where the JAX package takes a PRNG key: the same generator
state gives the same output, but the draws are not ``jax.random``'s bits.
"""

from __future__ import annotations

import math

import torch


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 3, 3) rotations about the up (y) axis, reference layout."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def _rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, s, z], -1), torch.stack([-s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _uniform(generator: torch.Generator, shape, like: torch.Tensor, low=0.0, high=1.0):
    u = torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    return low + (high - low) * u


def _angles(generator: torch.Generator, batch_data: torch.Tensor) -> torch.Tensor:
    return _uniform(generator, (batch_data.shape[0],), batch_data) * 2 * math.pi


def rotate_point_cloud(generator: torch.Generator, batch_data: torch.Tensor) -> torch.Tensor:
    """Per-cloud random up-axis (y) rotation."""
    return torch.einsum("bnc,bcd->bnd", batch_data, _rot_y(_angles(generator, batch_data)))


def rotate_point_cloud_z(generator: torch.Generator, batch_data: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bnc,bcd->bnd", batch_data, _rot_z(_angles(generator, batch_data)))


def _small_rotations(generator: torch.Generator, batch_data: torch.Tensor, angle_sigma: float,
                     angle_clip: float) -> torch.Tensor:
    """(B, 3, 3) products Rz @ Ry @ Rx of clipped normal angles."""
    B = batch_data.shape[0]
    shape = (B, 3)
    angles = torch.randn(shape, generator=generator, device=batch_data.device,
                         dtype=batch_data.dtype)
    angles = torch.clamp(angle_sigma * angles, -angle_clip, angle_clip)
    c, s = torch.cos(angles), torch.sin(angles)
    z = torch.zeros(B, device=batch_data.device, dtype=batch_data.dtype)
    o = torch.ones_like(z)
    Rx = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c[:, 0], -s[:, 0]], -1),
                      torch.stack([z, s[:, 0], c[:, 0]], -1)], -2)
    Ry = torch.stack([torch.stack([c[:, 1], z, s[:, 1]], -1), torch.stack([z, o, z], -1),
                      torch.stack([-s[:, 1], z, c[:, 1]], -1)], -2)
    Rz = torch.stack([torch.stack([c[:, 2], -s[:, 2], z], -1),
                      torch.stack([s[:, 2], c[:, 2], z], -1), torch.stack([z, z, o], -1)], -2)
    return torch.einsum("bij,bjk,bkl->bil", Rz, Ry, Rx)


def rotate_perturbation_point_cloud(generator: torch.Generator, batch_data: torch.Tensor,
                                    angle_sigma=0.06, angle_clip=0.18) -> torch.Tensor:
    R = _small_rotations(generator, batch_data, angle_sigma, angle_clip)
    return torch.einsum("bnc,bcd->bnd", batch_data, R)


def rotate_perturbation_with_normal(generator: torch.Generator, batch_data: torch.Tensor,
                                    angle_sigma=0.06, angle_clip=0.18) -> torch.Tensor:
    """The same small rotation of each cloud's xyz and normals (columns 0-5)."""
    R = _small_rotations(generator, batch_data, angle_sigma, angle_clip)
    return torch.cat([torch.einsum("bnc,bcd->bnd", batch_data[..., :3], R),
                      torch.einsum("bnc,bcd->bnd", batch_data[..., 3:6], R)], -1)


def jitter_point_cloud(generator: torch.Generator, batch_data: torch.Tensor, sigma=0.01,
                       clip=0.05) -> torch.Tensor:
    noise = torch.randn(batch_data.shape, generator=generator, device=batch_data.device,
                        dtype=batch_data.dtype)
    return batch_data + torch.clamp(sigma * noise, -clip, clip)


def shift_point_cloud(generator: torch.Generator, batch_data: torch.Tensor,
                      shift_range=0.1) -> torch.Tensor:
    B = batch_data.shape[0]
    return batch_data + _uniform(generator, (B, 1, 3), batch_data, -shift_range, shift_range)


def random_scale_point_cloud(generator: torch.Generator, batch_data: torch.Tensor,
                             scale_low=0.8, scale_high=1.25) -> torch.Tensor:
    B = batch_data.shape[0]
    return batch_data * _uniform(generator, (B, 1, 1), batch_data, scale_low, scale_high)


def shuffle_points(generator: torch.Generator, batch_data: torch.Tensor) -> torch.Tensor:
    """One shared permutation of the point axis (re-seeds the models' FPS)."""
    perm = torch.randperm(batch_data.shape[1], generator=generator, device=batch_data.device)
    return batch_data[:, perm, :]


def random_point_dropout(generator: torch.Generator, batch_data: torch.Tensor,
                         max_dropout_ratio=0.875) -> torch.Tensor:
    """Collapse a random fraction of points onto the first point, per cloud."""
    B, N, _ = batch_data.shape
    ratios = _uniform(generator, (B, 1), batch_data) * max_dropout_ratio
    drop = _uniform(generator, (B, N), batch_data) <= ratios
    return torch.where(drop[..., None], batch_data[:, :1, :], batch_data)


def augment_cls_batch(generator: torch.Generator, batch_data: torch.Tensor, *,
                      rotation: bool = False, with_normal: bool = False) -> torch.Tensor:
    """The ModelNet train-time pipeline (train.py:226-237): rotation (with its
    perturbation) where asked, scale, shift, one shared shuffle, dropout."""
    xyz, rest = batch_data[..., :3], batch_data[..., 3:]
    if rotation:
        if with_normal:
            R = _rot_y(_angles(generator, batch_data))
            data = torch.cat([torch.einsum("bnc,bcd->bnd", xyz, R),
                              torch.einsum("bnc,bcd->bnd", rest, R)], -1)
            data = rotate_perturbation_with_normal(generator, data)
            xyz, rest = data[..., :3], data[..., 3:]
        else:
            xyz = rotate_perturbation_point_cloud(generator, rotate_point_cloud(generator, xyz))
    xyz = shift_point_cloud(generator, random_scale_point_cloud(generator, xyz))
    data = torch.cat([xyz, rest], -1) if rest.shape[-1] else xyz
    return random_point_dropout(generator, shuffle_points(generator, data))
