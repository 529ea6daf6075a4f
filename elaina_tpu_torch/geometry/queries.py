"""Boundary-set queries: closest point, the Neumann sweeps, the BVH
traversals and the band-grid queries.

Port of ``elaina_tpu/geometry/queries.py``, with its dispatch by size:

* a set that carries its trees (the BVH route, ``GeomSet.has_tree``)
  above ``CHUNKED_DENSE_MAX`` prims takes the traversals of
  ``ops/bvh.py`` for the closest point (B1, 2D and 3D), the ray (B2,
  closest hit and any hit) and, with its subtree measures, the in-ball
  sample (B3); above ``CHUNKED_DENSE_MAX`` silhouette entities, with
  their tree, the coned silhouette descent (B4);
* otherwise ``closest_point`` / ``closest_point_detail`` of a set without
  a candidate grid: in 2D the dense sweep of kernel K13 over every
  segment (exact at every P, so equal up to ties to the reference's
  dense, chunked and BVH branches); in 3D the reference's dense and
  chunked sweeps in PyTorch (exact at every P);
* the branches of a Neumann set without band grids or trees: closest
  silhouette, ray intersection and Green-weighted in-ball sampling, dense
  up to ``BRUTE_FORCE_MAX`` prims and chunked (64 prims a chunk, as the
  reference) above (the reference's ``small_gather`` one-hot matmuls are
  plain indexing);
* the exact silhouette distance of the NEUMANN_SDF channel without the
  entities' tree, a dense sweep over the entities (chunked over lanes
  and, above ``CHUNKED_DENSE_MAX`` entities, over entities too), in 2D
  and 3D;
* the band-grid queries of a Neumann set: the silhouette distance over
  the SilGrid (kernel K9, 3D and 2D), one depth step's in-ball sample,
  visibility ray and walk ray over the 3D prim-band grid fused (kernel
  K6), and the unfused closest-hit ray (K7) and in-ball sample (K8) that
  the source term and the unfused step take; a 2D prim-band grid takes
  the reference's gather forms of the last two.  On the grid route a 3D
  set always takes the band grids in the solve, a 2D one above
  ``CHUNKED_DENSE_MAX``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import bvh as B
from ..ops import queries as K
from ..solver.green import GREEN_R_CLAMP, green_eval
from .geomset import CHUNKED_DENSE_MAX, GeomSet
from .grid import BandGrid
from .primitives import (prim_closest_point, prim_project, prim_ray_intersect,
                         prim_side, seg_closest_point)

BRUTE_FORCE_MAX = 64
_SWEEP_ELEMS = 1 << 24     # lanes x entities per chunk of the dense sweep
_CHUNK_LANES = 1 << 18     # lanes per chunk of the band gather forms
_INF = float("inf")


def _traverses(gs: GeomSet) -> bool:
    """The prim queries of this set descend its tree (B1-B3)."""
    return gs.has_tree and gs.n_prims > CHUNKED_DENSE_MAX


def _prim_verts_all(gs: GeomSet):
    """Corner tuple of (1, P, D) tensors, broadcasting against (N, 1, D)."""
    return tuple(gs.verts[gs.indices[:, k]][None] for k in range(gs.dim))


def _lane_chunks(n: int, width: int):
    """Slices of at most _SWEEP_ELEMS // width of n lanes."""
    m = max(1, _SWEEP_ELEMS // max(width, 1))
    return [slice(n0, n0 + m) for n0 in range(0, n, m)]


# --------------------------------------------------------------------------- #
# closest point
# --------------------------------------------------------------------------- #


def _closest_point_3d(gs: GeomSet, q):
    """The reference's 3D dense (<= BRUTE_FORCE_MAX prims) and chunked
    sweeps: the exact distance over every prim and the first prim on a
    tie (its running min over 64-prim chunks on a strict < gives the
    same), in lane chunks."""
    n = q.shape[0]
    pv = _prim_verts_all(gs)
    best_d = torch.empty((n,), device=q.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=q.device)
    for sl in _lane_chunks(n, gs.n_prims):
        d, _ = prim_closest_point(3, q[sl, None, :], pv)
        best_d[sl], i = torch.min(d, dim=-1)                # first minimum
        best_i[sl] = i.to(torch.int32)
    return best_d, best_i


def closest_point(gs: GeomSet, q, active=None):
    """q (N, D) -> (distance (N,), prim id (N,) int32): the exact closest
    prim of a set without a candidate grid.  A set with its tree above
    CHUNKED_DENSE_MAX prims: the traversal B1 (the first prim reached on
    equal distance).  Otherwise 2D: kernel K13 over every segment (the
    smallest id on equal distance); 3D: the dense and chunked sweeps.
    ``active`` (N,) bool, where given, names the lanes the caller reads:
    B1 descends and K13 sweeps only those (K13's lane-list form) and give
    the others distance +inf and prim 0; the 3D sweep sweeps every
    lane."""
    if _traverses(gs):
        return B.closest_point_bvh(gs, q.contiguous(), active)
    if gs.dim == 3:
        return _closest_point_3d(gs, q)
    return K.closest_point_dense(q.contiguous(),
                                 gs.verts[gs.indices[:, 0]].contiguous(),
                                 gs.verts[gs.indices[:, 1]].contiguous(),
                                 active)


def closest_point_detail(gs: GeomSet, q, active=None):
    """closest_point plus the unclamped projection (t in 2D, (u, v) in
    3D) and the side of q against the winner: (d, pid, uv, side)."""
    d, pid = closest_point(gs, q, active)
    pv = gs.prim_verts(pid)
    return d, pid, prim_project(gs.dim, q, pv), prim_side(gs.dim, q, pv)


def _silhouette_sweep(gs: GeomSet, q, e0: int, e1: int):
    """Distance (N,) from q to the nearest silhouette among entities
    [e0, e1): in 2D a vertex, in 3D an edge, that counts when its two
    adjacent normals straddle the view vector (s1 s2 <= 0) or it borders
    an open end."""
    p0 = gs.sil_p0[None, e0:e1]
    if gs.dim == 2:
        v = q[:, None, :] - p0
        d = torch.linalg.norm(v, dim=-1)
    else:
        p1 = gs.sil_p1[None, e0:e1]
        d, t = seg_closest_point(q[:, None, :], p0, p1)
        v = q[:, None, :] - (p0 + t[..., None] * (p1 - p0))
    s1 = torch.sum(gs.sil_n1[None, e0:e1] * v, dim=-1)
    s2 = torch.sum(gs.sil_n2[None, e0:e1] * v, dim=-1)
    is_sil = gs.sil_always[None, e0:e1] | (s1 * s2 <= 0.0)
    return torch.where(is_sil, d, torch.full_like(d, _INF)).min(dim=-1).values


def closest_silhouette(gs: GeomSet, q: torch.Tensor,
                       live=None) -> torch.Tensor:
    """Distance (N,) to the nearest silhouette entity, exact: above
    CHUNKED_DENSE_MAX entities with their tree, the coned descent B4 (on
    the lanes that ``live`` (N,) bool names, +inf on the others);
    otherwise the dense sweep on every lane, over chunks of
    ``CHUNKED_DENSE_MAX`` entities above that count (the reference's
    dense and chunked sweeps) and over chunks of lanes to bound
    memory."""
    E = gs.sil_p0.shape[0]
    if E > CHUNKED_DENSE_MAX and gs.sil_left is not None:
        return B.closest_silhouette_bvh(gs, q.contiguous(), live)
    out = torch.full(q.shape[:1], _INF, device=q.device)
    if E == 0:
        return out
    chunk_e = min(E, CHUNKED_DENSE_MAX)
    chunk_n = max(1, _SWEEP_ELEMS // chunk_e)
    for n0 in range(0, q.shape[0], chunk_n):
        qc = q[n0:n0 + chunk_n]
        for e0 in range(0, E, chunk_e):
            out[n0:n0 + chunk_n] = torch.minimum(
                out[n0:n0 + chunk_n],
                _silhouette_sweep(gs, qc, e0, min(E, e0 + chunk_e)))
    return out


def _ray_chunked(gs: GeomSet, o, d, tmax):
    """The reference's ``_ray_dense_chunked``: the closest hit over every
    prim and the first prim on equal t (its running min over 64-prim
    chunks on a strict < gives the same), in lane chunks.  Misses give t
    = inf and prim 0."""
    n = o.shape[0]
    pv = _prim_verts_all(gs)
    best_t = torch.empty((n,), device=o.device)
    best_i = torch.empty((n,), dtype=torch.int32, device=o.device)
    for sl in _lane_chunks(n, gs.n_prims):
        hit, t = prim_ray_intersect(gs.dim, o[sl, None, :], d[sl, None, :],
                                    pv, tmax[sl, None])
        best_t[sl], i = torch.min(torch.where(hit, t, _INF), dim=-1)
        best_i[sl] = i.to(torch.int32)
    hit = torch.isfinite(best_t) & (best_t <= tmax)
    return hit, torch.where(hit, best_t, _INF), best_i


def ray_intersect(gs: GeomSet, o, d, tmax, any_hit: bool = False,
                  live=None):
    """(N, D) rays -> (hit (N,), t (N,) inf on a miss, prim id (N,)):
    the dense sweep up to BRUTE_FORCE_MAX prims, the traversal B2 above
    CHUNKED_DENSE_MAX with the set's tree (``any_hit``: the first hit
    found, which is all an occlusion test reads; the lanes that ``live``
    (N,) bool leaves out miss), the chunked sweep otherwise (the closest
    hit on every lane, whatever ``any_hit`` and ``live`` say)."""
    if _traverses(gs):
        return B.ray_bvh(gs, o.contiguous(), d.contiguous(),
                         tmax.contiguous(), any_hit, live)
    if gs.n_prims > BRUTE_FORCE_MAX:
        return _ray_chunked(gs, o, d, tmax)
    hit, t = prim_ray_intersect(gs.dim, o[:, None, :], d[:, None, :],
                                _prim_verts_all(gs), tmax[:, None])
    t_best, i = torch.min(t, dim=-1)
    return hit.any(dim=-1), t_best, i


def _sample_in_ball_chunked(gs: GeomSet, q, R, u):
    """The reference's ``_sample_in_ball_chunked`` with its sums: the
    weights of 64-prim chunks (the last one padded with zero weights),
    the total accumulated chunk by chunk, and the CDF walk that takes the
    first prim with target < cum + cumsum(chunk) and a positive weight (the
    dense form counts target >= cdf instead).  All chunks at once, in lane
    chunks."""
    P = gs.n_prims
    chunk = BRUTE_FORCE_MAX
    Pp = -(-P // chunk) * chunk
    pids = torch.arange(Pp, device=q.device).clamp(max=P - 1)
    pv = tuple(gs.verts[gs.indices[pids, k]][None] for k in range(gs.dim))
    valid = torch.arange(Pp, device=q.device) < P
    meas = gs.prim_measure[pids]
    n = q.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=q.device)
    pdf = torch.empty((n,), device=q.device)
    for sl in _lane_chunks(n, Pp):
        Rc = R[sl, None]
        dd, _ = prim_closest_point(gs.dim, q[sl, None, :], pv)   # (m, Pp)
        gw = green_eval(torch.clamp(dd, min=GREEN_R_CLAMP), Rc, gs.dim)
        w = torch.where((dd < Rc) & valid, meas * torch.clamp(gw, min=0.0),
                        0.0)
        m = w.shape[0]
        w = w.view(m, Pp // chunk, chunk)
        # the running sum over the chunks, in the reference's order
        run = torch.cumsum(w.sum(dim=-1).t().contiguous(), dim=0).t()
        total = run[:, -1]
        cum = torch.cat([torch.zeros_like(run[:, :1]), run[:, :-1]], dim=1)
        cdf = cum[:, :, None] + torch.cumsum(w, dim=-1)
        hits = ((u[sl, None, None] * total[:, None, None] < cdf)
                & (w > 0)).view(m, Pp)
        j = torch.argmax(hits.to(torch.uint8), dim=-1)      # first hit
        ok = (total > 0) & hits.any(dim=-1)
        w_sel = w.view(m, Pp).gather(1, j[:, None])[:, 0]
        m_sel = meas[j]
        pdf[sl] = torch.where(
            ok, w_sel / (torch.clamp(total, min=1e-30)
                         * torch.clamp(m_sel, min=1e-30)), 0.0)
        idx[sl] = torch.where(ok, j, -1).to(torch.int32)
    return idx, pdf


def sample_in_ball(gs: GeomSet, q, R, u, live=None):
    """Importance-sample a prim inside ball(q, R) with weights
    measure x G_R(distance); returns (prim id, pdf per unit boundary
    measure), with id -1 and pdf 0 when nothing overlaps.  Dense up to
    BRUTE_FORCE_MAX prims; the descent B3 where the set has its subtree
    measures (its tree above CHUNKED_DENSE_MAX prims: -1 and 0 on the
    lanes that ``live`` (N,) bool leaves out), an exact pdf of its own
    proposal; chunked otherwise (every lane)."""
    if gs.n_prims > BRUTE_FORCE_MAX:
        if gs.node_measure is not None:
            return B.sample_in_ball_bvh(gs, q.contiguous(), R.contiguous(),
                                        u.contiguous(), live)
        return _sample_in_ball_chunked(gs, q, R, u)
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


# --------------------------------------------------------------------------- #
# band-grid queries
# --------------------------------------------------------------------------- #


def band_cell(bg: BandGrid, q: torch.Tensor):
    """(lin int64, outside): the grid cell of each query point (N, D),
    out-of-grid points clamped to a border cell (by the grid's own bound
    tensors: no host copy, so no wait for the device)."""
    rel = (q - bg.origin) * bg.inv_cell
    outside = ((rel < 0.0) | (rel >= bg.res_f)).any(dim=-1)
    idx = torch.minimum(rel.to(torch.int32).clamp(min=0), bg.res_hi)
    lin = idx[..., 0].long()
    for d in range(1, len(bg.res)):
        lin = lin * bg.res[d] + idx[..., d]
    return lin, outside


def _box_distance(bg: BandGrid, q):
    delta = (torch.clamp(bg.ent_lo - q, min=0.0)
             + torch.clamp(q - bg.ent_hi, min=0.0))
    return torch.linalg.norm(delta, dim=-1)


def band_r_cap(bg: BandGrid, q):
    """Completeness radius at q: the cell's r_cap inside the grid, the
    distance to the set's bbox outside it (the grid covers the scene box,
    so an out-of-grid point is outside every prim's box)."""
    lin, outside = band_cell(bg, q)
    return torch.where(outside, _box_distance(bg, q), bg.r_cap[lin])


def _kernel_cell(bg: BandGrid, q):
    lin, outside = band_cell(bg, q)
    return lin, outside, torch.where(outside, -1, lin).to(torch.int32)


def grid_closest_silhouette(sg: BandGrid, q, live=None):
    """Distance (N,) to the nearest silhouette through the SilGrid:
    min(nearest kept entity, the cell's r_cap), exact below r_cap and a
    lower bound above it, either way a valid star radius; the bbox
    distance outside the grid.  Kernel K9 (``sil_band_2d`` in 2D).  In 2D
    the lanes that ``live`` (N,) bool leaves out read no row: their
    nearest entity is +inf (so their distance is the cap); the 3D kernel
    sweeps every lane."""
    lin, outside, cell = _kernel_cell(sg, q)
    if q.shape[1] == 3:
        d2 = K.sil_band(cell, q.contiguous(), sg.coords)
    else:
        d2 = K.sil_band_2d(cell, q.contiguous(), sg.coords,
                           None if live is None else live.contiguous())
    # padded slots pass the sign test at ~1e18: a cell whose kept
    # entities all fail it finds nothing
    found = torch.where(d2 >= 1e17, float("inf"), torch.sqrt(d2))
    capped = torch.minimum(found, sg.r_cap[lin])
    capped = torch.where(capped >= 1e29, float("inf"), capped)
    return torch.where(outside, _box_distance(sg, q), capped)


@dataclass
class NeumannWalkOut:
    """One depth step's Neumann band results (``band_neumann_walk``)."""

    pid: torch.Tensor         # (N,) sampled prim, -1 when none
    pdf_area: torch.Tensor    # (N,) area pdf of sample_pt
    sample_pt: torch.Tensor   # (N, 3)
    side: torch.Tensor        # (N,) sign of q against the sampled plane
    plane_n: torch.Tensor     # (N, 3) unnormalized, prim_normal's way
    occluded: torch.Tensor    # (N,) bool origin -> sample_pt blocked
    whit: torch.Tensor        # (N,) bool walk ray hit
    wt: torch.Tensor          # (N,) walk hit distance (inf on a miss)
    wnormal: torch.Tensor     # (N, 3) walk hit's unit normal (0 on a miss)


def band_neumann_walk(bg: BandGrid, gs: GeomSet, q, R, on_n, n_normal,
                      u_sel, u_pt, d_walk, eps: float,
                      live=None) -> NeumannWalkOut:
    """The in-ball sample, its visibility ray and the walk ray of one
    depth step over the prim band of q's cell (kernel K6).  Exact when R
    (and the eps offset of the ray origins) stays within the cell's
    r_cap, which ``_separate`` guarantees.  A lane that ``live`` (N,)
    bool leaves out, or whose ball and rays cannot reach its row (R + oe
    below ``bg.skip_r``), gets no selection and no hit without a sweep;
    on the live lanes every field but the masked ones of a lane without a
    selection (sample_pt, side, plane_n, occluded) is then as without the
    skip."""
    lin, outside, cell = _kernel_cell(bg, q)
    out, slot = K.band_neumann_walk(
        cell, q.contiguous(), R.contiguous(), on_n.contiguous(),
        n_normal.contiguous(), u_sel.contiguous(), u_pt.contiguous(),
        d_walk.contiguous(), eps, bg.coords, bg.skip_r,
        None if live is None else live.contiguous())
    K_row = bg.rows.shape[1]
    w_sel, total = out[:, 0], out[:, 1]
    pid = torch.clamp(bg.rows[lin, slot.long().clamp(max=K_row - 1)], min=0)
    m_sel = gs.prim_measure[pid]
    ok = (slot < K_row) & (total > 0) & (w_sel > 0) & ~outside
    pdf_area = torch.where(
        ok, w_sel / (torch.clamp(total, min=1e-30)
                     * torch.clamp(m_sel, min=1e-30)),
        torch.zeros_like(total))
    return NeumannWalkOut(
        pid=torch.where(ok, pid, -1).to(torch.int32),
        pdf_area=pdf_area,
        sample_pt=out[:, 2:5],
        side=out[:, 5],
        plane_n=out[:, 6:9],
        occluded=(out[:, 9] > 0) & ~outside,
        whit=(out[:, 10] > 0) & ~outside,
        wt=torch.where(outside, float("inf"), out[:, 11]),
        wnormal=torch.where(outside[:, None], 0.0, out[:, 12:15]))


def _band_rows(bg: BandGrid, q):
    """(rows (N, K), valid (N, K)): the prim ids of each point's band
    row; out-of-grid points get no valid slot."""
    lin, outside = band_cell(bg, q)
    rows = bg.rows[torch.where(outside, 0, lin)]
    return rows, (rows >= 0) & ~outside[:, None]


def _band_ray_gather(bg: BandGrid, gs: GeomSet, o, d, tmax, refp):
    """band_ray_intersect on the rows' gathered corners (the reference's
    form for a grid without a corner table), in lane chunks."""
    n = o.shape[0]
    t = torch.empty((n,), device=o.device)
    pid = torch.empty((n,), dtype=torch.int32, device=o.device)
    for n0 in range(0, n, _CHUNK_LANES):
        sl = slice(n0, n0 + _CHUNK_LANES)
        rows, valid = _band_rows(bg, refp[sl])
        safe = rows.clamp(min=0)
        pv = gs.prim_verts(safe)                           # (m, K, D) each
        hit_k, t_k = prim_ray_intersect(gs.dim, o[sl, None, :],
                                        d[sl, None, :], pv, tmax[sl, None])
        t_k = torch.where(hit_k & valid, t_k, torch.full_like(t_k, _INF))
        j = torch.argmin(t_k, dim=-1, keepdim=True)        # first minimum
        t[sl] = t_k.gather(-1, j)[:, 0]
        pid[sl] = safe.gather(-1, j)[:, 0]
    hit = torch.isfinite(t) & (t <= tmax)
    return hit, torch.where(hit, t, _INF), torch.where(hit, pid, 0)


def band_ray_intersect(bg: BandGrid, gs: GeomSet, o, d, tmax, ref=None,
                       live=None, offset: float | None = None):
    """(hit, t, pid): the closest hit of the rays o + t d, t in (1e-6,
    tmax], over the prim band of ``ref``'s cell (default: the origin's),
    kernel K7 in 3D and the gather form in 2D.  ``ref`` matters when the
    origin is an eps offset off a boundary: the offset point can sit in a
    neighbouring cell, whose r_cap the ray's length was not clamped to.
    Misses give t = inf and pid 0.  In 3D, K7 sweeps no row for the lanes
    that ``live`` (N,) bool leaves out, and, where ``offset`` (a bound on
    |o - ref|) is given, none for a lane whose reach tmax + offset lies
    below its cell's ``skip_r``: no prim of the row is in reach, so the
    lane misses, as the sweep would give it.  Both change nothing on a
    live lane; the 2D gather form sweeps every lane."""
    if bg.coords is None:
        return _band_ray_gather(bg, gs, o, d, tmax, o if ref is None else ref)
    lin, outside, cell = _kernel_cell(bg, o if ref is None else ref)
    t, slot = K.band_ray(cell, o.contiguous(), d.contiguous(),
                         tmax.contiguous(), bg.coords,
                         None if offset is None else bg.skip_r,
                         None if live is None else live.contiguous(),
                         0.0 if offset is None else offset)
    K_row = bg.rows.shape[1]
    hit = torch.isfinite(t) & (t <= tmax) & ~outside
    pid = bg.rows[lin, slot.long().clamp(max=K_row - 1)]
    return (hit, torch.where(hit, t, _INF),
            torch.where(hit, torch.clamp(pid, min=0), 0).to(torch.int32))


def _band_ball_gather(bg: BandGrid, gs: GeomSet, q, R, u):
    """band_sample_in_ball on the rows' gathered corners (the reference's
    form for a grid without a corner table), in lane chunks; every lane is
    sampled."""
    n = q.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=q.device)
    pdf = torch.empty((n,), device=q.device)
    for n0 in range(0, n, _CHUNK_LANES):
        sl = slice(n0, n0 + _CHUNK_LANES)
        rows, valid = _band_rows(bg, q[sl])
        safe = rows.clamp(min=0)
        dd, _ = prim_closest_point(gs.dim, q[sl, None, :],
                                   gs.prim_verts(safe))      # (m, K)
        Rc = R[sl, None]
        inside = valid & (dd < Rc)
        gw = green_eval(torch.clamp(dd, min=GREEN_R_CLAMP), Rc, gs.dim)
        meas = gs.prim_measure[safe.long()]
        w = torch.where(inside, meas * torch.clamp(gw, min=0.0),
                        torch.zeros_like(dd))
        total = w.sum(dim=-1)
        # the short row axis scanned as the outer axis (see sample_in_ball)
        cdf = torch.cumsum(w.t().contiguous(), dim=0).t()
        target = u[sl] * total
        k = (target[:, None] >= cdf).sum(dim=-1).clamp(max=w.shape[1] - 1)
        w_sel = w.gather(-1, k[:, None])[:, 0]
        m_sel = meas.gather(-1, k[:, None])[:, 0]
        ok = (total > 0) & (w_sel > 0)
        pdf[sl] = torch.where(ok, w_sel / (torch.clamp(total, min=1e-30)
                                           * torch.clamp(m_sel, min=1e-30)),
                              torch.zeros_like(total))
        idx[sl] = torch.where(ok, safe.gather(-1, k[:, None])[:, 0], -1)
    return idx, pdf


def band_sample_in_ball(bg: BandGrid, gs: GeomSet, q, R, u, live=None):
    """(prim id, pdf per unit area): the Green-weighted in-ball prim
    sample over the band row of q's cell, kernel K8 in 3D and the gather
    form in 2D; -1 and 0 when no prim weighs.  The pdf takes the prim's
    measure (the sample is uniform on the prim); the kernel's in-tile
    area only weights the CDF.  In 3D, K8 sweeps no row for a lane whose
    R lies below its cell's ``skip_r`` (no prim of the row is in the
    ball, so none weighs: the same outputs on every lane) nor for the
    lanes that ``live`` (N,) bool leaves out (-1 and 0 there); the 2D
    gather form samples every lane."""
    if bg.coords is None:
        return _band_ball_gather(bg, gs, q, R, u)
    lin, outside, cell = _kernel_cell(bg, q)
    slot, w_sel, total = K.band_ball(cell, q.contiguous(), R.contiguous(),
                                     u.contiguous(), bg.coords, bg.skip_r,
                                     None if live is None
                                     else live.contiguous(), 0.0)
    K_row = bg.rows.shape[1]
    pid = torch.clamp(bg.rows[lin, slot.long().clamp(max=K_row - 1)], min=0)
    m_sel = gs.prim_measure[pid]
    ok = (slot < K_row) & (total > 0) & (w_sel > 0) & ~outside
    pdf = torch.where(ok, w_sel / (torch.clamp(total, min=1e-30)
                                   * torch.clamp(m_sel, min=1e-30)),
                      torch.zeros_like(total))
    return torch.where(ok, pid, -1).to(torch.int32), pdf
