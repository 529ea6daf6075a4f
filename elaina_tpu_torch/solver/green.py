"""Harmonic Green's functions on balls (2D disk / 3D ball).

Port of ``elaina_tpu/solver/green.py`` (reference: util/green.h).  Radii
are sampled in closed form: 2D r = R sqrt(u1 u2), 3D r/R = median of three
uniforms; the post-sample clamps match green.h.
"""

from __future__ import annotations

import math

import torch

GREEN_R_CLAMP = 1e-4
M_2PI = 2.0 * math.pi
M_4PI = 4.0 * math.pi


def green_eval(r, R, dim: int):
    """G(r; R) of the ball."""
    if dim == 2:
        return torch.log(R / r) / M_2PI
    return (1.0 / r - 1.0 / R) / M_4PI


def green_norm(R, dim: int):
    """Integral of G over the ball."""
    if dim == 2:
        return R * R / 4.0
    return R * R / 6.0


def green_pdf_radius(r, R, dim: int):
    """Normalized radial density of G."""
    if dim == 2:
        return 4.0 * r * torch.log(R / r) / (R * R)
    return 6.0 * r * (R - r) / (R * R * R)


def green_sample_radius(u: torch.Tensor, R: torch.Tensor, dim: int):
    """Sample the radial density from uniforms ``u`` (..., 3) -> (r, pdf)."""
    if dim == 2:
        r = R * torch.sqrt(u[..., 0] * u[..., 1])
    else:
        r = R * torch.median(u[..., :3], dim=-1).values
    r = torch.clamp(r, min=GREEN_R_CLAMP)
    r = torch.where(r > R, R / 2.0, r)
    return r, green_pdf_radius(r, R, dim)
