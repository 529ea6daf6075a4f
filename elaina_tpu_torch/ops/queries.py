"""Neumann band-grid kernels K6-K9 and the 2D closest-segment sweeps K12,
K13: wrappers, plain versions, build.

Port of ``band_neumann_walk_dma_3d``, ``band_ray_dma_3d``,
``band_ball_dma_3d``, ``sil_band_dma`` (3D and 2D),
``closest_point_dense_pallas`` and ``candidate_band_pallas`` of
``elaina_tpu/ops/pallas_queries.py``.  The CUDA sources are in
``csrc/queries.cu`` (built and bound as ``ops/cuda.py`` says).  Each
wrapper checks its inputs, allocates its outputs, launches on the current
stream and counts its launches in ``<wrapper>.launches``.  A CPU tensor
takes the plain PyTorch version beside the kernel; a CUDA tensor launches
the kernel or raises.

Contracts (the TPU kernels', minus the per-lane DMAs):

* ``sil_band(cell, q, coords) -> d2 (N,)``: the least squared distance
  from q to the entities of its SilGrid cell that pass s1 s2 <= 0 (point
  to segment, t clamped to [0, 1]); +inf where cell < 0.  Padded slots
  give ~1e18, which the caller reads as "none".
  ``sil_band_2d(cell, q, coords, live=None)`` is the same over a 2D cell
  table (C, 6, Kp), point to vertex, and gives +inf also to the lanes
  that ``live`` (N,) bool leaves out, without reading their cell.
* ``closest_point_dense(q, seg_a, seg_b, active=None) -> (dist (N,),
  prim (N,))``: the closest of all P segments, dist = sqrt(min d^2) and
  the smallest index attaining it (0 when every d^2 overflows).  With
  ``active`` (N,) bool, the lane-list form: K1 compacts the set lanes and
  only those are swept; every other lane gets dist = +inf and prim = 0.
* ``candidate_rows(q, row, cand, seg) -> (dist (N,), pid (N,))``: the
  closest of the segments in each lane's candidate row ``cand[row]``
  (prim ids, -1 padded) over the segment table ``seg`` (P, 4) = (ax, ay,
  bx, by): dist = sqrt(min d^2 over the slots with an id) (inf when none
  has) and pid = cand[row, s], s the smallest slot attaining it (0 when
  the min is inf).  It is the TPU kernel's contract
  (``candidate_band_plain``: the closest of each lane's own K gathered
  segments among its valid slots, and that slot) with the gathers that
  feed it.
* ``band_neumann_walk(cell, q, R, on, n_normal, u_sel, u_pt, d_walk, eps,
  coords, skip_r=None, live=None) -> (out (N, 15), slot (N,))``: the
  Green-weighted in-ball CDF sample over the lane's prim-band cell, its
  sample point, plane side and unnormalized plane normal, the visibility
  ray's any hit, and the walk ray's closest hit with its unit normal;
  columns [w_sel, total, sp.xyz, side, plane_n.xyz, occluded, walk_hit,
  walk_t, walk_n.xyz].  ``slot`` is the count of CDF entries <= u_sel *
  total, Kp meaning none (then w_sel = 0 and the selected corners are
  PAD_COORD).  Skipped lanes get zeros, walk_t = inf and slot = Kp: those
  with cell < 0, those that ``live`` (N,) bool leaves out, and those whose
  reach R + oe (oe = eps where ``on``, else 0) lies below ``skip_r`` (C,)
  of their cell (``BandGrid.skip_r``: there the ball and the rays reach
  no prim of the row).  On a live lane the skip changes none of slot,
  w_sel, total, walk_hit, walk_t and walk_n; occluded, sample_pt, side
  and plane_n of a skipped lane are zeros where the unskipped kernel
  gives those of a lane without a selection (the visibility ray toward
  PAD_COORD), which every caller masks by the selection.
* ``band_ray(cell, o, d, tmax, coords, skip_r=None, live=None, offset=0.0)
  -> (t (N,), slot (N,))``: K6's walk ray alone, the closest hit with t
  in (1e-6, tmax] (the smallest slot on equal t); t = inf and slot = Kp
  on a miss, where cell < 0, and on the lanes it skips without a sweep:
  those that ``live`` leaves out and those whose reach tmax + offset lies
  below ``skip_r`` (C,) of their cell (``offset`` bounds the distance
  from the origin to the point whose cell was passed).  The skip changes
  no output of a live lane.
* ``band_ball(cell, q, R, u, coords, skip_r=None, live=None, offset=0.0)
  -> (slot, w_sel, total)``: K6's in-ball CDF sample alone; slot = Kp
  means none (w_sel = 0).  Lanes with cell < 0 get slot = Kp and zeros
  without a sweep, and so do the lanes that ``live`` leaves out and those
  whose reach R + offset lies below ``skip_r`` (C,) of their cell
  (``offset`` bounds the distance from the ball's centre to the point
  whose cell was passed).  Those are the sweep's outputs when no slot
  weighs, so the reach test changes no output of any lane, and the mask
  only those of the lanes it leaves out.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..geometry.grid import PAD_COORD
from . import cuda as _cuda
from .cuda import F32, I32, I64, VP
from .cuda import build_log as _lib_log
from .cuda import check as _check
from .cuda import launch as _launch
from .resolve import (compact_lanes, compact_lanes_plain, seg_d2,
                      tri_d2_planes)

INV_4PI = float(np.float32(1.0 / (4.0 * math.pi)))
_PLAIN_CHUNK = 16384    # lanes per chunk of the plain versions
_PLAIN_PAIRS = 1 << 24  # lanes x segments per chunk of K13's plain version

_SIGNATURES = {
    "sil_band_launch": [VP, VP, VP, I64, I32, VP, VP],
    "sil_band_2d_launch": [VP, VP, VP, VP, I64, I32, VP, VP],
    "closest_point_dense_launch": [VP, VP, VP, I64, I32, VP, VP, VP, VP,
                                   VP, VP],
    "candidate_rows_launch": [VP, VP, VP, VP, I64, I32, VP, VP, VP],
    "band_neumann_walk_launch": [VP, VP, VP, VP, VP, VP, VP, VP, F32, VP,
                                 VP, VP, I64, I32, VP, VP, VP],
    "band_ray_launch": [VP, VP, VP, VP, VP, VP, VP, F32, I64, I32, VP, VP,
                        VP],
    "band_ball_launch": [VP, VP, VP, VP, VP, VP, VP, F32, I64, I32, VP, VP,
                         VP, VP],
}


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/queries.cu`` on first call."""
    return _cuda.load_library("elaina_queries", "queries.cu", _SIGNATURES)


def build_log() -> str:
    return _lib_log(library())


def _dot(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _cross(u, v):
    return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0])


# --------------------------------------------------------------------------- #
# K9 sil_band
# --------------------------------------------------------------------------- #


def _sil_band_plain(cell, q, coords, dim: int, live=None):
    n = cell.shape[0]
    d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=q.device)
    work = cell >= 0
    if live is not None:
        work &= live
    sel = torch.nonzero(work).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        pl = coords[cell[ids].long()].unbind(1)       # 12 or 6 x (m, Kp)
        qk = [q[ids, k:k + 1] for k in range(dim)]
        if dim == 3:
            e = [pl[3 + k] - pl[k] for k in range(3)]
            w = [qk[k] - pl[k] for k in range(3)]
            den = torch.clamp(_dot(e, e), min=1e-30)
            t = torch.clamp(_dot(w, e) / den, 0.0, 1.0)
            v = [w[k] - t * e[k] for k in range(3)]
            s1 = _dot(pl[6:9], v)
            s2 = _dot(pl[9:12], v)
            dd = _dot(v, v)
        else:
            v = [qk[k] - pl[k] for k in range(2)]
            s1 = pl[2] * v[0] + pl[3] * v[1]
            s2 = pl[4] * v[0] + pl[5] * v[1]
            dd = v[0] * v[0] + v[1] * v[1]
        d = torch.where(s1 * s2 <= 0.0, dd, torch.full_like(dd, float("inf")))
        d2[ids] = d.min(dim=1).values
    return d2


def sil_band_plain(cell, q, coords):
    return _sil_band_plain(cell, q, coords, 3)


def sil_band_2d_plain(cell, q, coords, live=None):
    return _sil_band_plain(cell, q, coords, 2, live)


def _sil_band_checks(cell, q, coords, dim: int, live=None):
    n = cell.shape[0]
    dev = q.device
    C, _, Kp = coords.shape
    _check("cell", cell, torch.int32, (n,), dev)
    _check("q", q, torch.float32, (n, dim), dev)
    _check("coords", coords, torch.float32, (C, 12 if dim == 3 else 6, Kp),
           dev)
    if live is not None:
        _check("live", live, torch.bool, (n,), dev)
    if Kp % 32:
        raise ValueError(f"coords has {Kp} slots per cell")


def sil_band(cell, q, coords):
    _sil_band_checks(cell, q, coords, 3)
    if q.device.type == "cpu":
        return sil_band_plain(cell, q, coords)
    d2 = torch.empty_like(cell, dtype=torch.float32)
    _launch(library().sil_band_launch, cell.data_ptr(), q.data_ptr(),
            coords.data_ptr(), cell.shape[0], coords.shape[2], d2.data_ptr(),
            device=q.device)
    sil_band.launches += 1
    return d2


sil_band.launches = 0

def sil_band_2d(cell, q, coords, live=None):
    _sil_band_checks(cell, q, coords, 2, live)
    if q.device.type == "cpu":
        return sil_band_2d_plain(cell, q, coords, live)
    if coords.data_ptr() % 16:
        raise ValueError("coords must start on 16 bytes")
    d2 = torch.empty_like(cell, dtype=torch.float32)
    _launch(library().sil_band_2d_launch, cell.data_ptr(), q.data_ptr(),
            coords.data_ptr(), 0 if live is None else live.data_ptr(),
            cell.shape[0], coords.shape[2], d2.data_ptr(), device=q.device)
    sil_band_2d.launches += 1
    return d2


sil_band_2d.launches = 0


# --------------------------------------------------------------------------- #
# K13 closest_point_dense
# --------------------------------------------------------------------------- #


def closest_point_dense_plain(q, seg_a, seg_b, active=None):
    n = q.shape[0]
    P = seg_a.shape[0]
    dist = torch.full((n,), float("inf"), dtype=torch.float32,
                      device=q.device)
    prim = torch.zeros((n,), dtype=torch.int32, device=q.device)
    ax, ay = seg_a[:, 0], seg_a[:, 1]
    ex, ey = seg_b[:, 0] - ax, seg_b[:, 1] - ay
    if active is None:
        ids = torch.arange(n, device=q.device)
    else:
        lanes, cnt = compact_lanes_plain(active, n)
        ids = lanes[:int(cnt)].long()
    m = max(1, _PLAIN_PAIRS // P)
    for c0 in range(0, ids.numel(), m):
        sl = ids[c0:c0 + m]
        qc = q[sl]
        d2 = seg_d2(qc[:, 0:1] - ax, qc[:, 1:2] - ay, ex, ey)[0]  # (m, P)
        s = torch.argmin(d2, dim=1, keepdim=True)          # first minimum
        dist[sl] = torch.sqrt(d2.gather(1, s)[:, 0])
        prim[sl] = s[:, 0].to(torch.int32)
    return dist, prim


def closest_point_dense(q, seg_a, seg_b, active=None):
    n = q.shape[0]
    P = seg_a.shape[0]
    dev = q.device
    _check("q", q, torch.float32, (n, 2), dev)
    _check("seg_a", seg_a, torch.float32, (P, 2), dev)
    _check("seg_b", seg_b, torch.float32, (P, 2), dev)
    if active is not None:
        _check("active", active, torch.bool, (n,), dev)
    if P == 0 or P > np.iinfo(np.int32).max:
        raise ValueError(f"{P} segments")
    if dev.type == "cpu":
        return closest_point_dense_plain(q, seg_a, seg_b, active)
    if seg_a.data_ptr() % 8 or seg_b.data_ptr() % 8:
        raise ValueError("seg_a and seg_b must start on 8 bytes (the "
                         "kernel stages them with 8-byte cp.async)")
    lists = (0, 0, 0)
    if active is not None:
        lanes, cnt = compact_lanes(active, n)
        lists = (active.data_ptr(), lanes.data_ptr(), cnt.data_ptr())
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().closest_point_dense_launch, q.data_ptr(),
            seg_a.data_ptr(), seg_b.data_ptr(), n, P, *lists,
            dist.data_ptr(), prim.data_ptr(), device=dev)
    closest_point_dense.launches += 1
    return dist, prim


closest_point_dense.launches = 0


# --------------------------------------------------------------------------- #
# K12 candidate_rows
# --------------------------------------------------------------------------- #


def candidate_band_plain(q, vax, vay, vbx, vby, valid):
    """The TPU kernel's contract on gathered rows: q (N, 2), endpoint
    planes (N, K) and valid (N, K) -> (dist (N,), slot (N,))."""
    n, K = vax.shape
    _check("q", q, torch.float32, (n, 2), q.device)
    for name, x in (("vax", vax), ("vay", vay), ("vbx", vbx), ("vby", vby)):
        _check(name, x, torch.float32, (n, K), q.device)
    _check("valid", valid, torch.bool, (n, K), q.device)
    d2 = seg_d2(q[:, 0:1] - vax, q[:, 1:2] - vay, vbx - vax, vby - vay)[0]
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    s = torch.argmin(d2, dim=1, keepdim=True)              # first minimum
    return torch.sqrt(d2.gather(1, s)[:, 0]), s[:, 0].to(torch.int32)


def candidate_rows_plain(q, row, cand, seg):
    """Gather each lane's row and its segments, then
    ``candidate_band_plain``, in lane chunks."""
    n = q.shape[0]
    K = cand.shape[1]
    dist = torch.empty((n,), dtype=torch.float32, device=q.device)
    pid = torch.empty((n,), dtype=torch.int32, device=q.device)
    m = max(1, _PLAIN_PAIRS // K)
    for c0 in range(0, n, m):
        c = cand[row[c0:c0 + m].long()]                    # (m, K)
        g = seg[c.clamp(min=0).long()].unbind(-1)          # 4 x (m, K)
        dist[c0:c0 + m], slot = candidate_band_plain(
            q[c0:c0 + m], *(x.contiguous() for x in g), c >= 0)
        pid[c0:c0 + m] = c.gather(1, slot[:, None].long())[:, 0]
    return dist, pid


def candidate_rows(q, row, cand, seg):
    n = q.shape[0]
    R, K = cand.shape
    dev = q.device
    _check("q", q, torch.float32, (n, 2), dev)
    _check("row", row, torch.int32, (n,), dev)
    _check("cand", cand, torch.int32, (R, K), dev)
    _check("seg", seg, torch.float32, (seg.shape[0], 4), dev)
    if K == 0:
        raise ValueError("no candidate slots")
    if dev.type == "cpu":
        return candidate_rows_plain(q, row, cand, seg)
    if seg.data_ptr() % 16 or (K % 4 == 0 and cand.data_ptr() % 16):
        raise ValueError("seg (and cand when K % 4 == 0) must start on 16 "
                         "bytes: the kernel reads them as float4 / int4")
    dist = torch.empty((n,), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().candidate_rows_launch, q.data_ptr(), row.data_ptr(),
            cand.data_ptr(), seg.data_ptr(), n, K, dist.data_ptr(),
            pid.data_ptr(), device=dev)
    candidate_rows.launches += 1
    return dist, pid


candidate_rows.launches = 0


# --------------------------------------------------------------------------- #
# K6 band_neumann_walk
# --------------------------------------------------------------------------- #


def _mt_planes(o, d, c, tmax):
    """Moller-Trumbore over corner planes: t (m, Kp), inf on a miss."""
    a = c[0:3]
    e1 = [c[3 + k] - a[k] for k in range(3)]
    e2 = [c[6 + k] - a[k] for k in range(3)]
    tv = [o[k] - a[k] for k in range(3)]
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, torch.ones_like(det))
    u = _dot(tv, p) / safe
    qv = _cross(tv, e1)
    v = _dot(d, qv) / safe
    t = _dot(e2, qv) / safe
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
           & (t <= tmax))
    return torch.where(hit, t, torch.full_like(t, float("inf")))


def _pick(planes, slot):
    return [p.gather(1, slot[:, None])[:, 0] for p in planes]


def _ball_plain(c, qk, Rm, u):
    """The in-ball CDF sample over corner planes c (9 x (m, Kp)) from q
    (3 x (m, 1)) and radii Rm (m, 1), as K6 and K8 take it: (w_sel (m,),
    total (m,), count of CDF entries <= u * total (m,), Kp meaning none
    and then w_sel = 0)."""
    dd = torch.sqrt(tri_d2_planes(qk, c))
    cr = _cross([c[3 + k] - c[k] for k in range(3)],
                [c[6 + k] - c[k] for k in range(3)])
    area = 0.5 * torch.sqrt(_dot(cr, cr))
    g = (1.0 / torch.clamp(dd, min=1e-4) - 1.0 / Rm) * INV_4PI
    w = torch.where(dd < Rm, area * torch.clamp(g, min=0.0),
                    torch.zeros_like(dd))
    total = w.sum(dim=1)
    target = u * total
    cnt = (target[:, None] >= torch.cumsum(w, dim=1)).sum(dim=1)
    ws = w.gather(1, cnt.clamp(max=w.shape[1] - 1)[:, None])[:, 0]
    return torch.where(cnt < w.shape[1], ws, torch.zeros_like(ws)), total, cnt


def _closest_hit_plain(o, d, c, tmax):
    """(t, slot) of the closest hit over corner planes c, the first slot
    on equal t (K6's walk ray and K7); t = inf on a miss."""
    return torch.min(_mt_planes(o, d, c, tmax), dim=1)


def _in_reach(cell, reach, skip_r, live):
    """The lanes in the grid, live, and with ``reach`` at or above their
    cell's ``skip_r`` (each test where its input is given)."""
    work = cell >= 0
    if live is not None:
        work &= live
    if skip_r is not None:
        work &= ~(reach < skip_r[cell.clamp(min=0).long()])
    return work


def band_work(cell, R, on, eps: float, skip_r=None, live=None):
    """The lanes K6 does band work for: reach R + oe."""
    return _in_reach(cell, R + torch.where(on, eps, 0.0), skip_r, live)


def band_neumann_walk_plain(cell, q, R, on, n_normal, u_sel, u_pt, d_walk,
                            eps: float, coords, skip_r=None, live=None):
    n = cell.shape[0]
    Kp = coords.shape[2]
    dev = q.device
    inf = float("inf")
    out = torch.zeros((n, 15), dtype=torch.float32, device=dev)
    out[:, 11] = inf
    slot = torch.full((n,), Kp, dtype=torch.int32, device=dev)
    sel = torch.nonzero(band_work(cell, R, on, eps, skip_r, live)).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        c = coords[cell[ids].long()].unbind(1)             # 9 x (m, Kp)
        qk = [q[ids, k:k + 1] for k in range(3)]
        Rm = R[ids][:, None]
        # 1. weights and the CDF sample
        w_sel, total, cnt = _ball_plain(c, qk, Rm, u_sel[ids])
        has = cnt < Kp
        s_idx = cnt.clamp(max=Kp - 1)
        # 2. the sample point on the selected triangle
        s = [torch.where(has, x, torch.full_like(x, PAD_COORD))
             for x in _pick(c, s_idx)]
        su = torch.sqrt(u_pt[ids, 0])
        b0 = 1.0 - su
        b1 = u_pt[ids, 1] * su
        b2 = 1.0 - b0 - b1
        sp = [s[k] * b0 + s[3 + k] * b1 + s[6 + k] * b2 for k in range(3)]
        nw = _cross([s[3 + k] - s[k] for k in range(3)],
                    [s[6 + k] - s[k] for k in range(3)])
        qv = [q[ids, k] for k in range(3)]
        side = torch.sign(_dot([qv[k] - s[k] for k in range(3)], nw))
        # 3. visibility ray
        oe = torch.where(on[ids], eps, 0.0)
        o = [qv[k] + oe * n_normal[ids, k] for k in range(3)]
        ray = [sp[k] - o[k] for k in range(3)]
        dist = torch.sqrt(_dot(ray, ray))
        rd = [ray[k] / torch.clamp(dist, min=1e-20) for k in range(3)]
        o2 = [x[:, None] for x in o]
        vis = _mt_planes(o2, [x[:, None] for x in rd], c,
                         (dist - eps)[:, None])
        occluded = torch.isfinite(vis.min(dim=1).values)
        # 4. walk ray
        wt, wslot = _closest_hit_plain(
            o2, [d_walk[ids, k:k + 1] for k in range(3)], c, Rm)
        whit = torch.isfinite(wt)
        wc = _pick(c, wslot)
        wcr = _cross([wc[3 + k] - wc[k] for k in range(3)],
                     [wc[6 + k] - wc[k] for k in range(3)])
        wlen = torch.sqrt(torch.clamp(_dot(wcr, wcr), min=1e-38))
        wn = [torch.where(whit, x / wlen, torch.zeros_like(x)) for x in wcr]
        out[ids] = torch.stack(
            [w_sel, total, *sp, side, *nw, occluded.float(), whit.float(),
             torch.where(whit, wt, torch.full_like(wt, inf)), *wn], dim=1)
        slot[ids] = cnt.to(torch.int32)
    return out, slot


def band_neumann_walk(cell, q, R, on, n_normal, u_sel, u_pt, d_walk,
                      eps: float, coords, skip_r=None, live=None):
    n = cell.shape[0]
    dev = q.device
    C, _, Kp = coords.shape
    _check("cell", cell, torch.int32, (n,), dev)
    for name, x in (("q", q), ("n_normal", n_normal), ("d_walk", d_walk)):
        _check(name, x, torch.float32, (n, 3), dev)
    for name, x in (("R", R), ("u_sel", u_sel)):
        _check(name, x, torch.float32, (n,), dev)
    _check("on", on, torch.bool, (n,), dev)
    _check("u_pt", u_pt, torch.float32, (n, 2), dev)
    _check("coords", coords, torch.float32, (C, 9, Kp), dev)
    if skip_r is not None:
        _check("skip_r", skip_r, torch.float32, (C,), dev)
    if live is not None:
        _check("live", live, torch.bool, (n,), dev)
    if Kp % 32 or Kp > 256:
        raise ValueError(f"coords has {Kp} slots per cell (a multiple of "
                         f"32, at most 256)")
    if dev.type == "cpu":
        return band_neumann_walk_plain(cell, q, R, on, n_normal, u_sel,
                                       u_pt, d_walk, eps, coords, skip_r,
                                       live)
    out = torch.empty((n, 15), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().band_neumann_walk_launch, cell.data_ptr(), q.data_ptr(),
            R.data_ptr(), on.data_ptr(), n_normal.data_ptr(), u_sel.data_ptr(),
            u_pt.data_ptr(), d_walk.data_ptr(), float(eps), coords.data_ptr(),
            0 if skip_r is None else skip_r.data_ptr(),
            0 if live is None else live.data_ptr(),
            n, Kp, out.data_ptr(), slot.data_ptr(), device=dev)
    band_neumann_walk.launches += 1
    return out, slot


band_neumann_walk.launches = 0


# --------------------------------------------------------------------------- #
# K7 band_ray
# --------------------------------------------------------------------------- #


def ray_work(cell, tmax, offset: float, skip_r=None, live=None):
    """The lanes K7 sweeps: reach tmax + offset."""
    return _in_reach(cell, tmax + offset, skip_r, live)


def band_ray_plain(cell, o, d, tmax, coords, skip_r=None, live=None,
                   offset: float = 0.0):
    n = cell.shape[0]
    Kp = coords.shape[2]
    dev = o.device
    t = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    slot = torch.full((n,), Kp, dtype=torch.int32, device=dev)
    sel = torch.nonzero(ray_work(cell, tmax, offset, skip_r, live)).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        c = coords[cell[ids].long()].unbind(1)             # 9 x (m, Kp)
        tt, s = _closest_hit_plain([o[ids, k:k + 1] for k in range(3)],
                                   [d[ids, k:k + 1] for k in range(3)], c,
                                   tmax[ids][:, None])
        t[ids] = tt
        slot[ids] = torch.where(torch.isfinite(tt), s,
                                torch.full_like(s, Kp)).to(torch.int32)
    return t, slot


def band_ray(cell, o, d, tmax, coords, skip_r=None, live=None,
             offset: float = 0.0):
    n = cell.shape[0]
    dev = o.device
    C, _, Kp = coords.shape
    _check("cell", cell, torch.int32, (n,), dev)
    _check("o", o, torch.float32, (n, 3), dev)
    _check("d", d, torch.float32, (n, 3), dev)
    _check("tmax", tmax, torch.float32, (n,), dev)
    _check("coords", coords, torch.float32, (C, 9, Kp), dev)
    if skip_r is not None:
        _check("skip_r", skip_r, torch.float32, (C,), dev)
    if live is not None:
        _check("live", live, torch.bool, (n,), dev)
    if Kp % 32:
        raise ValueError(f"coords has {Kp} slots per cell")
    if dev.type == "cpu":
        return band_ray_plain(cell, o, d, tmax, coords, skip_r, live, offset)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().band_ray_launch, cell.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmax.data_ptr(), coords.data_ptr(),
            0 if skip_r is None else skip_r.data_ptr(),
            0 if live is None else live.data_ptr(), float(offset), n, Kp,
            t.data_ptr(), slot.data_ptr(), device=dev)
    band_ray.launches += 1
    return t, slot


band_ray.launches = 0


# --------------------------------------------------------------------------- #
# K8 band_ball
# --------------------------------------------------------------------------- #


def ball_work(cell, R, offset: float, skip_r=None, live=None):
    """The lanes K8 sweeps: reach R + offset."""
    return _in_reach(cell, R + offset, skip_r, live)


def band_ball_plain(cell, q, R, u, coords, skip_r=None, live=None,
                    offset: float = 0.0):
    n = cell.shape[0]
    Kp = coords.shape[2]
    dev = q.device
    slot = torch.full((n,), Kp, dtype=torch.int32, device=dev)
    w_sel = torch.zeros((n,), dtype=torch.float32, device=dev)
    total = torch.zeros((n,), dtype=torch.float32, device=dev)
    sel = torch.nonzero(ball_work(cell, R, offset, skip_r, live)).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        c = coords[cell[ids].long()].unbind(1)             # 9 x (m, Kp)
        w_sel[ids], total[ids], cnt = _ball_plain(
            c, [q[ids, k:k + 1] for k in range(3)], R[ids][:, None], u[ids])
        slot[ids] = cnt.to(torch.int32)
    return slot, w_sel, total


def band_ball(cell, q, R, u, coords, skip_r=None, live=None,
              offset: float = 0.0):
    n = cell.shape[0]
    dev = q.device
    C, _, Kp = coords.shape
    _check("cell", cell, torch.int32, (n,), dev)
    _check("q", q, torch.float32, (n, 3), dev)
    _check("R", R, torch.float32, (n,), dev)
    _check("u", u, torch.float32, (n,), dev)
    _check("coords", coords, torch.float32, (C, 9, Kp), dev)
    if skip_r is not None:
        _check("skip_r", skip_r, torch.float32, (C,), dev)
    if live is not None:
        _check("live", live, torch.bool, (n,), dev)
    if Kp % 32 or Kp > 256:
        raise ValueError(f"coords has {Kp} slots per cell (a multiple of "
                         f"32, at most 256)")
    if dev.type == "cpu":
        return band_ball_plain(cell, q, R, u, coords, skip_r, live, offset)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    w_sel = torch.empty((n,), dtype=torch.float32, device=dev)
    total = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch(library().band_ball_launch, cell.data_ptr(), q.data_ptr(),
            R.data_ptr(), u.data_ptr(), coords.data_ptr(),
            0 if skip_r is None else skip_r.data_ptr(),
            0 if live is None else live.data_ptr(), float(offset), n, Kp,
            slot.data_ptr(), w_sel.data_ptr(), total.data_ptr(), device=dev)
    band_ball.launches += 1
    return slot, w_sel, total


band_ball.launches = 0

KERNELS = (band_neumann_walk, band_ray, band_ball, sil_band, sil_band_2d,
           closest_point_dense, candidate_rows)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
