"""Dense queries over a small boundary set (lanes x prims sweeps).

Port of the dense branches of ``elaina_tpu/geometry/queries.py`` that a
Neumann set of at most ``BRUTE_FORCE_MAX`` prims takes: closest
silhouette, ray intersection and Green-weighted in-ball sampling.  The
reference's ``small_gather`` one-hot matmuls become plain indexing.
Larger Neumann sets need the band grids (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import torch

from ..solver.green import GREEN_R_CLAMP, green_eval
from .geomset import GeomSet
from .primitives import prim_closest_point, prim_ray_intersect

BRUTE_FORCE_MAX = 64
_INF = float("inf")


def check_dense(gs: GeomSet):
    if gs.n_prims > BRUTE_FORCE_MAX:
        raise NotImplementedError(
            f"Neumann set of {gs.n_prims} prims: sets above "
            f"{BRUTE_FORCE_MAX} need the band grids of ROADMAP Queue 1 "
            f"item 12 (3D Neumann-heavy path)")


def _prim_verts_all(gs: GeomSet):
    """Corner tuple of (1, P, D) tensors, broadcasting against (N, 1, D)."""
    return tuple(gs.verts[gs.indices[:, k]][None] for k in range(gs.dim))


def closest_silhouette(gs: GeomSet, q: torch.Tensor) -> torch.Tensor:
    """Distance (N,) to the nearest silhouette entity: in 2D a vertex
    whose two adjacent normals straddle the view vector, or that borders
    an open end."""
    if gs.sil_p0.shape[0] == 0:
        return torch.full(q.shape[:1], _INF, device=q.device)
    if gs.dim != 2:
        raise NotImplementedError(
            "3D silhouettes arrive with ROADMAP Queue 1 item 12")
    v = q[:, None, :] - gs.sil_p0[None]                  # (N, E, 2)
    d = torch.linalg.norm(v, dim=-1)
    s1 = torch.sum(gs.sil_n1[None] * v, dim=-1)
    s2 = torch.sum(gs.sil_n2[None] * v, dim=-1)
    is_sil = gs.sil_always[None] | (s1 * s2 <= 0.0)
    return torch.where(is_sil, d, torch.full_like(d, _INF)).min(dim=-1).values


def ray_intersect(gs: GeomSet, o, d, tmax):
    """(N, D) rays -> (hit (N,), t (N,) inf on a miss, prim id (N,))."""
    check_dense(gs)
    hit, t = prim_ray_intersect(gs.dim, o[:, None, :], d[:, None, :],
                                _prim_verts_all(gs), tmax[:, None])
    t_best, i = torch.min(t, dim=-1)
    return hit.any(dim=-1), t_best, i


def sample_in_ball(gs: GeomSet, q, R, u):
    """Importance-sample a prim inside ball(q, R) with weights
    measure x G_R(distance); returns (prim id, pdf per unit boundary
    measure), with id -1 and pdf 0 when nothing overlaps."""
    check_dense(gs)
    d, _ = prim_closest_point(gs.dim, q[:, None, :], _prim_verts_all(gs))
    inside = d < R[:, None]
    gw = green_eval(torch.clamp(d, min=GREEN_R_CLAMP), R[:, None], gs.dim)
    w = torch.where(inside, gs.prim_measure[None] * torch.clamp(gw, min=0.0),
                    torch.zeros_like(d))
    total = torch.sum(w, dim=-1)
    # scan the short prim axis as the outer axis of a (P, N) copy: PyTorch's
    # innermost-axis scan kernel takes ~6 ms on 1M x 4 on an H100 (PERF.md)
    cdf = torch.cumsum(w.t().contiguous(), dim=0).t()
    target = u * total
    idx = torch.sum((target[:, None] >= cdf).to(torch.int64), dim=-1)
    idx = torch.clamp(idx, max=gs.n_prims - 1)
    w_sel = w.gather(1, idx[:, None])[:, 0]
    m_sel = gs.prim_measure[idx]
    pdf = torch.where(
        total > 0,
        w_sel / (torch.clamp(total, min=1e-30) * torch.clamp(m_sel,
                                                              min=1e-30)),
        torch.zeros_like(total))
    idx = torch.where((total > 0) & (w_sel > 0), idx, torch.full_like(idx, -1))
    return idx, pdf
