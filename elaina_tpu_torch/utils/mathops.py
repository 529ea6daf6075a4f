"""Frames, normalization and interpolation on (..., D) tensors.

Port of ``elaina_tpu/utils/mathops.py`` (reference: util/transformation.h,
util/math_utils.h, krrmath/functors.h).  2D local coordinates are
(tangent, normal); 3D are (T, B, N) with the normal last.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=eps)


def perp2(v: torch.Tensor) -> torch.Tensor:
    """Counter-clockwise unit perpendicular of a 2D vector."""
    return normalize(torch.stack([-v[..., 1], v[..., 0]], dim=-1))


def perp3(u: torch.Tensor) -> torch.Tensor:
    """A unit vector perpendicular to ``u``: cross with the canonical axis
    of its smallest absolute component."""
    a = u.abs()
    xm = (a[..., 0] <= a[..., 1]) & (a[..., 0] <= a[..., 2])
    ym = (~xm) & (a[..., 1] <= a[..., 2])
    zm = ~(xm | ym)
    axis = torch.stack([xm, ym, zm], dim=-1).to(u.dtype)
    return normalize(torch.linalg.cross(u, axis, dim=-1))


def frame_from_normal(dim: int, n: torch.Tensor):
    """(N, T) in 2D with T = -perp(n); (N, T, B) in 3D."""
    if dim == 2:
        return n, -perp2(n)
    t = perp3(n)
    b = normalize(torch.linalg.cross(n, t, dim=-1))
    return n, t, b


def frame_from_tangent_2d(t: torch.Tensor):
    """(N, T) from a 2D tangent, N = perp(t) (util/transformation.h:47-50)."""
    return perp2(t), t


def to_world(dim: int, frame, v_local: torch.Tensor) -> torch.Tensor:
    if dim == 2:
        n, t = frame
        return t * v_local[..., 0:1] + n * v_local[..., 1:2]
    n, t, b = frame
    return (t * v_local[..., 0:1] + b * v_local[..., 1:2]
            + n * v_local[..., 2:3])


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror ``v`` across the plane of normal ``n``
    (util/transformation.h:69-72)."""
    return v - 2.0 * torch.sum(v * n, dim=-1, keepdim=True) * n


def geometric_interpolate(dim: int, values, uv: torch.Tensor):
    """Edge lerp (2D, ``uv`` (...,)) or barycentric blend (3D, (..., 2))."""
    if dim == 2:
        a, b = values
        return a + (b - a) * uv[..., None]
    a, b, c = values
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    return a * (1.0 - u - v) + b * u + c * v
