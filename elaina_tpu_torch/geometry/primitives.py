"""Segment (2D) and triangle (3D) math on (..., D) tensors.

Port of ``elaina_tpu/geometry/primitives.py``.  Conventions as there:
segment (a, b) has normal normalize(-(b-a).y, (b-a).x) and
``side(q) = sign(cross(b - a, q - a))``, +1 on the normal side (the "left"
color of the two-sided vertex-color pairs); triangle (a, b, c) has normal
normalize(cross(b - a, c - a)).  ``verts`` is a tuple of ``dim`` corner
tensors (..., D).
"""

from __future__ import annotations

import torch

from ..utils.mathops import normalize


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


# --------------------------------------------------------------------------- #
# 2D segments
# --------------------------------------------------------------------------- #


def seg_project_ratio(q, a, b):
    """Unclamped projection parameter of q onto line(a, b)."""
    e = b - a
    den = torch.clamp(_dot(e, e), min=1e-30)
    return _dot(q - a, e) / den


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


# --------------------------------------------------------------------------- #
# 3D triangles
# --------------------------------------------------------------------------- #


def tri_normal(a, b, c):
    return normalize(torch.linalg.cross(b - a, c - a, dim=-1))


def tri_project_bary(q, a, b, c):
    """Unclamped barycentrics (u, v) of q projected onto the triangle's
    plane, p = a + u (b - a) + v (c - a); the interior is u > 0, v > 0,
    u + v < 1."""
    e1 = b - a
    e2 = c - a
    w = q - a
    d11 = _dot(e1, e1)
    d12 = _dot(e1, e2)
    d22 = _dot(e2, e2)
    w1 = _dot(w, e1)
    w2 = _dot(w, e2)
    den = torch.clamp(d11 * d22 - d12 * d12, min=1e-30)
    return (d22 * w1 - d12 * w2) / den, (d11 * w2 - d12 * w1) / den


def tri_closest_point(q, a, b, c):
    """(distance, (u, v) of the closest point): the interior projection
    where it lies inside, else the closest of the three edge points."""
    u, v = tri_project_bary(q, a, b, c)
    w = 1.0 - u - v

    def edge_pt(p0, p1):
        e = p1 - p0
        t = torch.clamp(_dot(q - p0, e) / torch.clamp(_dot(e, e), min=1e-30),
                        0.0, 1.0)
        return p0 + t[..., None] * e

    inside = (u >= 0.0) & (v >= 0.0) & (w >= 0.0)
    p_in = a + u[..., None] * (b - a) + v[..., None] * (c - a)
    cands = torch.stack([edge_pt(a, b), edge_pt(b, c), edge_pt(c, a)],
                        dim=-2)
    d_cands = torch.linalg.norm(q[..., None, :] - cands, dim=-1)
    i_min = torch.argmin(d_cands, dim=-1)
    pick = i_min[..., None, None].expand(*i_min.shape, 1, 3)
    p_edge = torch.gather(cands, -2, pick)[..., 0, :]
    p = torch.where(inside[..., None], p_in, p_edge)
    uc, vc = tri_project_bary(p, a, b, c)
    return torch.linalg.norm(q - p, dim=-1), (uc, vc)


def tri_side(q, a, b, c):
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    return torch.sign(_dot(q - a, n))


def ray_tri_intersect(o, d, a, b, c, tmax):
    """Moller-Trumbore: (hit, t), t in (1e-6, tmax] with |det| > 1e-12;
    t is inf on a miss."""
    e1 = b - a
    e2 = c - a
    p = torch.linalg.cross(d, e2, dim=-1)
    det = _dot(e1, p)
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    tvec = o - a
    u = _dot(tvec, p) / safe
    qv = torch.linalg.cross(tvec, e1, dim=-1)
    v = _dot(d, qv) / safe
    t = _dot(e2, qv) / safe
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & (t <= tmax))
    return hit, torch.where(hit, t, torch.full_like(t, float("inf")))


def tri_area(a, b, c):
    return 0.5 * torch.linalg.norm(torch.linalg.cross(b - a, c - a, dim=-1),
                                   dim=-1)


# --------------------------------------------------------------------------- #
# dimension dispatch over gathered corners
# --------------------------------------------------------------------------- #


def prim_closest_point(dim: int, q, verts):
    """(distance, uv): t (2D) or (u, v) stacked on the last axis (3D)."""
    if dim == 2:
        return seg_closest_point(q, verts[0], verts[1])
    d, (u, v) = tri_closest_point(q, *verts)
    return d, torch.stack([u, v], dim=-1)


def prim_project(dim: int, q, verts):
    if dim == 2:
        return seg_project_ratio(q, verts[0], verts[1])
    return torch.stack(tri_project_bary(q, *verts), dim=-1)


def prim_side(dim: int, q, verts):
    if dim == 2:
        return seg_side(q, verts[0], verts[1])
    return tri_side(q, *verts)


def prim_ray_intersect(dim: int, o, d, verts, tmax):
    if dim == 2:
        return ray_seg_intersect(o, d, verts[0], verts[1], tmax)
    return ray_tri_intersect(o, d, *verts, tmax)


def prim_measure(dim: int, verts):
    if dim == 2:
        return torch.linalg.norm(verts[1] - verts[0], dim=-1)
    return tri_area(*verts)


def prim_sample_point(dim: int, verts, u1, u2):
    """Uniform point on the prim (``u2`` is unused in 2D)."""
    if dim == 2:
        return verts[0] + u1[..., None] * (verts[1] - verts[0])
    su = torch.sqrt(u1)
    b0 = 1.0 - su
    b1 = u2 * su
    return (verts[0] * b0[..., None] + verts[1] * b1[..., None]
            + verts[2] * (1.0 - b0 - b1)[..., None])
