"""Uniform sphere / hemisphere directions and their pdfs.

Port of ``elaina_tpu/solver/sampling.py`` (reference: util/sampling.h).
Samplers take a ``torch.Generator``; the 2D "sphere" is the unit circle
and the hemisphere the half circle around local +y, the 3D hemisphere is
around local +z.
"""

from __future__ import annotations

import math

import torch

M_2PI = 2.0 * math.pi
M_4PI = 4.0 * math.pi


def _uniform(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device)


def uniform_sample_sphere(gen: torch.Generator, n: int,
                          dim: int) -> torch.Tensor:
    if dim == 2:
        theta = _uniform(gen, n) * M_2PI
        return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    z = 1.0 - 2.0 * _uniform(gen, n)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = M_2PI * _uniform(gen, n)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_sphere_pdf(dim: int) -> float:
    return 1.0 / M_2PI if dim == 2 else 1.0 / M_4PI


def uniform_sample_hemisphere(gen: torch.Generator, n: int,
                              dim: int) -> torch.Tensor:
    if dim == 2:
        phi = math.pi * _uniform(gen, n)
        return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    z = _uniform(gen, n)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = M_2PI * _uniform(gen, n)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_hemisphere_pdf(dim: int) -> float:
    return 1.0 / math.pi if dim == 2 else 1.0 / M_2PI


def sphere_measure(dim: int) -> float:
    """|S^{dim-1}|."""
    return M_2PI if dim == 2 else M_4PI
