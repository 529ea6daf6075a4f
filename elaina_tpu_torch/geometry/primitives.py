"""2D segment math on (..., 2) tensors.

Port of the segment half of ``elaina_tpu/geometry/primitives.py``.
Conventions as there: segment (a, b) has normal normalize(-(b-a).y,
(b-a).x); ``side(q) = sign(cross(b - a, q - a))``, +1 on the normal side
(the "left" color of the two-sided vertex-color pairs).  ``verts`` is a
tuple (a, b) of (..., 2) tensors.
"""

from __future__ import annotations

import torch


def seg_project_ratio(q, a, b):
    """Unclamped projection parameter of q onto line(a, b)."""
    e = b - a
    den = torch.clamp(torch.sum(e * e, dim=-1), min=1e-30)
    return torch.sum((q - a) * e, dim=-1) / den


def seg_closest_point(q, a, b):
    """(distance, clamped t) from q to segment ab."""
    t = torch.clamp(seg_project_ratio(q, a, b), 0.0, 1.0)
    p = a + t[..., None] * (b - a)
    return torch.linalg.norm(q - p, dim=-1), t


def seg_side(q, a, b):
    e = b - a
    w = q - a
    return torch.sign(e[..., 0] * w[..., 1] - e[..., 1] * w[..., 0])


def ray_seg_intersect(o, d, a, b, tmax):
    """Ray o + t d against segment ab -> (hit, t); t in (1e-6, tmax],
    segment parameter in [0, 1]; t is inf on a miss."""
    e = b - a
    denom = d[..., 0] * (-e[..., 1]) - d[..., 1] * (-e[..., 0])
    ok = torch.abs(denom) > 1e-12
    safe = torch.where(ok, denom, torch.ones_like(denom))
    ao = a - o
    t = (ao[..., 0] * (-e[..., 1]) - ao[..., 1] * (-e[..., 0])) / safe
    s = (d[..., 0] * ao[..., 1] - d[..., 1] * ao[..., 0]) / safe
    hit = ok & (t > 1e-6) & (t <= tmax) & (s >= 0.0) & (s <= 1.0)
    return hit, torch.where(hit, t, torch.full_like(t, float("inf")))


def prim_closest_point(dim: int, q, verts):
    _check_2d(dim)
    return seg_closest_point(q, verts[0], verts[1])


def prim_project(dim: int, q, verts):
    _check_2d(dim)
    return seg_project_ratio(q, verts[0], verts[1])


def prim_side(dim: int, q, verts):
    _check_2d(dim)
    return seg_side(q, verts[0], verts[1])


def prim_ray_intersect(dim: int, o, d, verts, tmax):
    _check_2d(dim)
    return ray_seg_intersect(o, d, verts[0], verts[1], tmax)


def prim_sample_point(dim: int, verts, u1, u2):
    """Uniform point on the segment (``u2`` is unused in 2D)."""
    _check_2d(dim)
    return verts[0] + u1[..., None] * (verts[1] - verts[0])


def _check_2d(dim: int):
    if dim != 2:
        raise NotImplementedError(
            "triangle primitives arrive with ROADMAP Queue 1 item 11 "
            "(3D Dirichlet)")
