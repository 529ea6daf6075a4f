"""The BVH route's traversal kernels B1-B4: wrappers, plain versions, build.

Port of the JAX package's per-lane traversals (vmap-ed ``lax.while_loop``s
in ``elaina_tpu/geometry/queries.py``, not Pallas kernels):
``_closest_point_bvh_one`` (B1), ``_ray_bvh_one`` (B2, closest hit and any
hit), ``_sample_in_ball_bvh_one`` (B3) and ``_closest_silhouette_bvh_one``
(B4).  The CUDA sources are in ``csrc/bvh.cu`` (built and bound as
``ops/cuda.py`` says): each lane's whole descent runs in one launch.  B2
and B3 read the tree's fields; B1 and B4 read the packed forms that
``pack_trees`` builds once for each set (node records with both
children's boxes, leaves in leaf order, B4's cone constants), kept on
the set by ``with_packs`` where it is uploaded or first queried, with
four threads a lane in 3D.  Each
wrapper takes the set (``GeomSet`` with its trees), checks its inputs,
allocates its outputs, launches on the current stream and counts its
launches in ``<wrapper>.launches``.  A CPU tensor takes the plain PyTorch
version beside the kernel; a CUDA tensor launches the kernel or raises.

The plain versions of B1 and B2 run the descents in lockstep over the
lanes, each with its own (N, stack) int32 stack: an iteration pops one
node of every lane whose stack is not empty (the lanes are compacted
each iteration, so the loop reads the stack pointers on the host) and
ends when every stack is empty; B3's descends one node a lane an
iteration, and B4's a whole level of (lane, node) pairs (its result does
not depend on the order).  They repeat the JAX functions' rules:

* ``closest_point_bvh(gs, q, live=None) -> (d (N,), pid (N,) i32)``: the
  closest prim; a leaf takes its first minimum in ``leaf_prims`` order
  and replaces the best only on a strict <; the nearer child (box
  distance dl <= dr) pops first, and a child is pushed only while its
  box distance is < the best.
* ``ray_bvh(gs, o, d, tmax, any_hit=False, live=None) -> (hit, t, pid)``:
  the closest hit with t in (1e-6, tmax] (the slab test against the
  current best t; children by entry t); ``any_hit`` stops at the first
  leaf with a hit.  A miss gives t = inf and pid 0.
* ``sample_in_ball_bvh(gs, q, R, u, live=None) -> (pid, pdf)``: the
  stochastic descent weighted by node_measure x G(max(box distance,
  GREEN_R_CLAMP), R), its exact pdf (the product of the branch
  probabilities, each at least 1e-30, times the leaf's CDF pick); -1 and
  0 where nothing weighs.
* ``closest_silhouette_bvh(gs, q, live=None) -> d (N,)``: the coned
  descent over the silhouette entities' tree (SNCH prune of the normal
  cones, ``sil_cone_cos > -1.5`` where a cone exists).

Lanes that ``live`` (N,) bool leaves out get what an empty descent gives:
d = +inf and prim 0 (B1, B4), no hit, t = +inf, prim 0 (B2), -1 and 0
(B3).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..geometry.geomset import LEAF_SIZE, MAX_STACK, GeomSet
from ..solver.green import GREEN_R_CLAMP, green_eval
from . import cuda as _cuda
from .cuda import I32, I64, VP
from .cuda import build_log as _lib_log
from .cuda import check as _check
from .cuda import launch as _launch

HALF_PI = float(torch.tensor(math.pi / 2, dtype=torch.float32))
U_MAX = 1.0 - 1e-7   # the descent's rescaled u stays below 1 (float32)

_SIGNATURES = {
    "closest_point_bvh_launch": [VP, VP, VP, VP, VP, VP, I32, I32, I64, I32,
                                 VP, VP, VP, VP],
    "ray_bvh_launch": [VP, VP, VP, VP, VP, VP, VP, VP, VP, VP, I64, I32,
                       I32, VP, VP, VP, VP],
    "sample_in_ball_bvh_launch": [VP, VP, VP, VP, VP, VP, VP, VP, VP, VP,
                                  VP, VP, I64, I32, VP, VP, VP],
    "closest_silhouette_bvh_launch": [VP, VP, VP, VP, VP, VP, I32, I64, I32,
                                      VP, VP, VP],
}

# The packed trees' row widths in 32-bit words, by dimension (csrc/bvh.cu
# lays them out; ``pack_trees`` builds them)
NODE_W = {2: 12, 3: 16}      # [lo_l, hi_l, lo_r, hi_r, id_l, id_r, ref_l,
#                              ref_r]: a node's children
LEAF_W = {2: 20, 3: 48}      # a prim leaf: 2D 4 x [a, b] + 4 ids; 3D 4 x
#                              [a, b, c, id, 0, 0]
CONE_W = {2: 8, 3: 12}       # [c, r, axis, cone_cos, theta, leaf (, 0, 0)]
SIL_W = {2: 20, 3: 32}       # a silhouette node: cone words, node record,
#                              zero pad
ENT_W = {2: 8, 3: 16}        # an entity: 2D [p0, n1, n2, flag, 0]; 3D [p0,
#                              p1, n1, n2, flag, 0, 0, 0]; 4 a leaf


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/bvh.cu`` on first call."""
    return _cuda.load_library("elaina_bvh", "bvh.cu", _SIGNATURES)


def build_log() -> str:
    return _lib_log(library())


# --------------------------------------------------------------------------- #
# the plain versions' pieces
# --------------------------------------------------------------------------- #


# The geometry of ``geometry/primitives.py`` written out component by
# component in the kernels' order: each product and sum is its own op, so
# on the card these versions round as the kernels (built with
# -fmad=false) do, and a reduction's order or a fused multiply-add in
# PyTorch's own kernels cannot part the two.


def _dot(u, v):
    s = u[..., 0] * v[..., 0]
    for k in range(1, u.shape[-1]):
        s = s + u[..., k] * v[..., k]
    return s


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _cross(u, v):
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], -1)


def _box_dist(q, lo, hi):
    return _norm(torch.clamp(torch.maximum(lo - q, q - hi), min=0.0))


def _seg_dist(q, a, b):
    """(distance, t clamped) from q to segment ab."""
    e = b - a
    t = torch.clamp(_dot(q - a, e) / torch.clamp(_dot(e, e), min=1e-30),
                    0.0, 1.0)
    return _norm(q - (a + t[..., None] * e)), t


def _prim_dist(dim: int, q, c):
    """Distance from q to the segment (2D) or triangle (3D) of corners
    ``c``: the triangle's interior projection where its barycentrics are
    all >= 0, else its closest edge point."""
    if dim == 2:
        return _seg_dist(q, *c)[0]
    a, b, cc = c
    e1, e2, w = b - a, cc - a, q - a
    d11, d12, d22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
    w1, w2 = _dot(w, e1), _dot(w, e2)
    den = torch.clamp(d11 * d22 - d12 * d12, min=1e-30)
    u = (d22 * w1 - d12 * w2) / den
    v = (d11 * w2 - d12 * w1) / den
    inside = (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    d_in = _norm(q - (a + u[..., None] * e1 + v[..., None] * e2))
    d_edge = torch.minimum(torch.minimum(_seg_dist(q, a, b)[0],
                                         _seg_dist(q, b, cc)[0]),
                           _seg_dist(q, cc, a)[0])
    return torch.where(inside, d_in, d_edge)


def _prim_ray(dim: int, o, d, c, tmax):
    """(hit, t) of the ray o + t d against the prim of corners ``c``, t in
    (1e-6, tmax] (a segment, or Moller-Trumbore on a triangle)."""
    if dim == 2:
        a, b = c
        ex, ey = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
        denom = d[..., 0] * (-ey) - d[..., 1] * (-ex)
        ok = torch.abs(denom) > 1e-12
        safe = torch.where(ok, denom, 1.0)
        aox, aoy = a[..., 0] - o[..., 0], a[..., 1] - o[..., 1]
        t = (aox * (-ey) - aoy * (-ex)) / safe
        s = (d[..., 0] * aoy - d[..., 1] * aox) / safe
        return (ok & (t > 1e-6) & (t <= tmax) & (s >= 0.0) & (s <= 1.0)), t
    a, b, cc = c
    e1, e2, tv = b - a, cc - a, o - a
    p = _cross(d.expand_as(e2), e2)
    det = _dot(e1, p)
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, 1.0)
    u = _dot(tv, p) / safe
    qv = _cross(tv, e1)
    v = _dot(d, qv) / safe
    t = _dot(e2, qv) / safe
    return (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
            & (t <= tmax)), t


def _leaf_corners(gs: GeomSet, pids):
    """Corner tuple of (m, L, D) tensors of the leaf slots' prims."""
    D = gs.dim
    c = gs.corners[pids.clamp(min=0).long()]            # (m, L, dim * D)
    return tuple(c[..., k * D:(k + 1) * D] for k in range(gs.dim))


def _start(q, live, stack_size: int):
    """(stack (N, S) i32 holding the root, sp (N,) i64: 1, 0 off live).
    S is the tree's depth + 4 (``GeomSet.stack_size``), and a descent
    holds at most depth + 1 nodes."""
    n = q.shape[0]
    stack = torch.zeros((n, stack_size), dtype=torch.int32, device=q.device)
    sp = torch.ones((n,), dtype=torch.int64, device=q.device)
    if live is not None:
        sp = torch.where(live, sp, 0)
    return stack, sp


def _push(stack, sp, lanes, push, node):
    """Push ``node`` on the stacks of ``lanes`` where ``push``."""
    at = lanes[push]
    stack[at, sp[at]] = node[push].to(torch.int32)
    sp[at] += 1


def _pop(stack, sp):
    """(lanes, node): pop one node of every lane with a non-empty stack."""
    lanes = torch.nonzero(sp > 0).flatten()
    sp[lanes] -= 1
    return lanes, stack[lanes, sp[lanes]].long()


def closest_point_bvh_plain(gs: GeomSet, q, live=None, visits=None):
    """B1's plain version; ``visits`` (N,) int64, where given, counts the
    nodes each lane pops."""
    n = q.shape[0]
    best = torch.full((n,), float("inf"), device=q.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=q.device)
    stack, sp = _start(q, live, gs.stack_size)
    while True:
        lanes, nid = _pop(stack, sp)
        if lanes.numel() == 0:
            return best, best_i
        if visits is not None:
            visits[lanes] += 1
        ql = q[lanes]
        bl = best[lanes]
        process = _box_dist(ql, gs.bb_min[nid], gs.bb_max[nid]) < bl
        left = gs.left[nid]
        leaf = process & (left < 0)
        if leaf.any():
            li = lanes[leaf]
            pids = gs.leaf_prims[nid[leaf]]                 # (m, L)
            d = _prim_dist(gs.dim, ql[leaf][:, None, :],
                           _leaf_corners(gs, pids))
            d = torch.where(pids >= 0, d, float("inf"))
            dm, j = torch.min(d, dim=1)                     # first minimum
            better = dm < bl[leaf]
            best[li] = torch.where(better, dm, bl[leaf])
            best_i[li] = torch.where(better, pids.gather(1, j[:, None])[:, 0],
                                     best_i[li])
        inner = process & (left >= 0)
        if inner.any():
            ii = lanes[inner]
            qi = ql[inner]
            l, r = left[inner].long(), gs.right[nid[inner]].long()
            dl = _box_dist(qi, gs.bb_min[l], gs.bb_max[l])
            dr = _box_dist(qi, gs.bb_min[r], gs.bb_max[r])
            lf = dl <= dr
            b = bl[inner]
            _push(stack, sp, ii, torch.maximum(dl, dr) < b,
                  torch.where(lf, r, l))
            _push(stack, sp, ii, torch.minimum(dl, dr) < b,
                  torch.where(lf, l, r))


def _ray_box(o, d_inv, lo, hi, t_best):
    t0 = (lo - o) * d_inv
    t1 = (hi - o) * d_inv
    tn = torch.minimum(t0, t1).max(dim=-1).values
    tf = torch.maximum(t0, t1).min(dim=-1).values
    return (tn <= tf) & (tf > 0.0) & (tn < t_best), torch.clamp(tn, min=0.0)


def ray_bvh_plain(gs: GeomSet, o, d, tmax, any_hit: bool = False,
                  live=None, visits=None):
    """B2's plain version."""
    n = o.shape[0]
    d_inv = torch.where(torch.abs(d) > 1e-12, 1.0 / d,
                        torch.sign(d) * 1e12 + 1e12)
    best_t = tmax.clone()
    best_i = torch.zeros((n,), dtype=torch.int32, device=o.device)
    found = torch.zeros((n,), dtype=torch.bool, device=o.device)
    stack, sp = _start(o, live, gs.stack_size)
    while True:
        lanes, nid = _pop(stack, sp)
        if lanes.numel() == 0:
            break
        if visits is not None:
            visits[lanes] += 1
        ol, dl_, il = o[lanes], d[lanes], d_inv[lanes]
        bt = best_t[lanes]
        process, _ = _ray_box(ol, il, gs.bb_min[nid], gs.bb_max[nid], bt)
        left = gs.left[nid]
        leaf = process & (left < 0)
        if leaf.any():
            li = lanes[leaf]
            pids = gs.leaf_prims[nid[leaf]]
            btl = bt[leaf]
            h, t = _prim_ray(gs.dim, ol[leaf][:, None, :],
                             dl_[leaf][:, None, :], _leaf_corners(gs, pids),
                             btl[:, None])
            h &= pids >= 0
            t = torch.where(h, t, float("inf"))
            tm, j = torch.min(t, dim=1)                     # first minimum
            better = h.gather(1, j[:, None])[:, 0] & (tm < btl)
            best_t[li] = torch.where(better, tm, btl)
            best_i[li] = torch.where(better, pids.gather(1, j[:, None])[:, 0],
                                     best_i[li])
            found[li] |= h.any(dim=1)
            if any_hit:                 # nothing more processes on them
                sp[li[found[li]]] = 0
        inner = process & (left >= 0)
        if inner.any():
            ii = lanes[inner]
            l, r = left[inner].long(), gs.right[nid[inner]].long()
            args = (ol[inner], il[inner])
            b = bt[inner]
            hl, tl = _ray_box(*args, gs.bb_min[l], gs.bb_max[l], b)
            hr, tr = _ray_box(*args, gs.bb_min[r], gs.bb_max[r], b)
            lf = tl <= tr
            _push(stack, sp, ii, torch.where(lf, hr, hl),
                  torch.where(lf, r, l))
            _push(stack, sp, ii, torch.where(lf, hl, hr),
                  torch.where(lf, l, r))
    return found, torch.where(found, best_t, float("inf")), best_i


def _node_weight(gs: GeomSet, q, R, nid):
    bd = _box_dist(q, gs.bb_min[nid], gs.bb_max[nid])
    gw = green_eval(torch.clamp(bd, min=GREEN_R_CLAMP), R, gs.dim)
    return torch.where(bd < R, gs.node_measure[nid] * torch.clamp(gw, min=0.0),
                       0.0)


def sample_in_ball_bvh_plain(gs: GeomSet, q, R, u, live=None, visits=None):
    """B3's plain version."""
    n = q.shape[0]
    dev = q.device
    nid = torch.zeros((n,), dtype=torch.int64, device=dev)
    uu = u.clone()
    pdf = torch.ones((n,), device=dev)
    dead = ~(_node_weight(gs, q, R, nid) > 0.0)
    if live is not None:
        dead |= ~live
    while True:
        lanes = torch.nonzero(~dead & (gs.left[nid] >= 0)).flatten()
        if lanes.numel() == 0:
            break
        if visits is not None:
            visits[lanes] += 1
        nl, ql, Rl, ul = nid[lanes], q[lanes], R[lanes], uu[lanes]
        l, r = gs.left[nl].long(), gs.right[nl].long()
        wl = _node_weight(gs, ql, Rl, l)
        wr = _node_weight(gs, ql, Rl, r)
        tot = wl + wr
        pl = wl / torch.clamp(tot, min=1e-30)
        go_left = ul < pl
        pb = torch.where(go_left, pl, 1.0 - pl)
        ul = torch.where(go_left, ul / torch.clamp(pl, min=1e-30),
                         (ul - pl) / torch.clamp(1.0 - pl, min=1e-30))
        uu[lanes] = torch.clamp(ul, 0.0, U_MAX)
        nid[lanes] = torch.where(go_left, l, r)
        pdf[lanes] = pdf[lanes] * torch.clamp(pb, min=1e-30)
        dead[lanes] = ~(tot > 0.0)
    # the leaf's exact weights (a dead lane's node may be internal: its
    # slots are all -1, so nothing weighs)
    pids = gs.leaf_prims[nid]                               # (N, L)
    d = _prim_dist(gs.dim, q[:, None, :], _leaf_corners(gs, pids))
    m = gs.prim_measure[pids.clamp(min=0).long()]
    gw = green_eval(torch.clamp(d, min=GREEN_R_CLAMP), R[:, None], gs.dim)
    w = torch.where((pids >= 0) & (d < R[:, None]),
                    m * torch.clamp(gw, min=0.0), 0.0)
    cols = [w[:, 0]]                       # the CDF summed left to right
    for k in range(1, LEAF_SIZE):
        cols.append(cols[-1] + w[:, k])
    cdf = torch.stack(cols, dim=1)
    total = cdf[:, -1]
    j = torch.clamp((uu[:, None] * total[:, None] >= cdf).sum(dim=1),
                    max=LEAF_SIZE - 1)[:, None]
    w_sel = w.gather(1, j)[:, 0]
    ok = ~dead & (total > 0) & (w_sel > 0)
    pdf_area = torch.where(
        ok, pdf * w_sel / (torch.clamp(total, min=1e-30)
                           * torch.clamp(m.gather(1, j)[:, 0], min=1e-30)),
        0.0)
    return (torch.where(ok, pids.gather(1, j)[:, 0], -1).to(torch.int32),
            pdf_area)


def _cone_prune(gs: GeomSet, q, nid):
    lo, hi = gs.sil_bb_min[nid], gs.sil_bb_max[nid]
    r = 0.5 * _norm(hi - lo)
    w = 0.5 * (lo + hi) - q
    d_c = _norm(w)
    cone_cos = gs.sil_cone_cos[nid]
    theta = torch.arccos(torch.clamp(cone_cos, -1.0, 1.0))
    phi = torch.arcsin(torch.clamp(r / torch.clamp(d_c, min=1e-20), 0.0,
                                   1.0))
    ang = torch.arccos(torch.clamp(
        _dot(gs.sil_cone_axis[nid], w) / torch.clamp(d_c, min=1e-20), -1.0,
        1.0))
    no_sil = (ang + theta + phi < HALF_PI) | (ang - theta - phi > HALF_PI)
    return (cone_cos > -1.5) & (d_c > r) & no_sil


def _entity_dist(gs: GeomSet, q, eids):
    """(m, L) distance from q (m, D) to the entities eids (m, L) where
    they are silhouettes from q, +inf elsewhere."""
    e = eids.clamp(min=0).long()
    p0 = gs.sil_p0[e]
    qb = q[:, None, :]
    if gs.dim == 2:
        v = qb - p0
        d = _norm(v)
    else:
        p1 = gs.sil_p1[e]
        d, t = _seg_dist(qb, p0, p1)
        v = qb - (p0 + t[..., None] * (p1 - p0))
    s1 = _dot(gs.sil_n1[e], v)
    s2 = _dot(gs.sil_n2[e], v)
    sil = (eids >= 0) & (gs.sil_always[e] | (s1 * s2 <= 0.0))
    return torch.where(sil, d, float("inf"))


def closest_silhouette_bvh_plain(gs: GeomSet, q, live=None, visits=None):
    """B4's plain version, level by level: every (lane, node) pair of a
    level whose box can beat the lane's best and whose cone does not
    prune it is expanded at once, and the leaves' silhouettes lower the
    best before the next level.  The descent's result is the least
    distance over the silhouette entities of the subtrees its cones keep
    (a box test skips only nodes that cannot beat the best), whatever
    order the nodes come in, so this gives the stack descent's
    distances in depth + 1 iterations where the stack takes one a node:
    a lane on a straight or convex Neumann wall sees no silhouette near
    it and visits nearly every node.  ``visits`` counts the pairs each
    lane expands (at least the stack descent's nodes)."""
    n = q.shape[0]
    best = torch.full((n,), float("inf"), device=q.device)
    lanes = (torch.arange(n, device=q.device) if live is None
             else torch.nonzero(live).flatten())
    nid = torch.zeros_like(lanes)
    while lanes.numel():
        near = (_box_dist(q[lanes], gs.sil_bb_min[nid], gs.sil_bb_max[nid])
                < best[lanes])
        lanes, nid = lanes[near], nid[near]
        ql = q[lanes]
        keep = ~_cone_prune(gs, ql, nid)
        lanes, nid, ql = lanes[keep], nid[keep], ql[keep]
        if visits is not None:
            visits.index_add_(0, lanes, torch.ones_like(lanes))
        left = gs.sil_left[nid]
        leaf = left < 0
        if leaf.any():
            dm = _entity_dist(gs, ql[leaf], gs.sil_leaf[nid[leaf]]).min(
                dim=1).values
            best.scatter_reduce_(0, lanes[leaf], dm, "amin")
        inner = ~leaf
        lanes = lanes[inner].repeat(2)
        nid = torch.cat([left[inner], gs.sil_right[nid[inner]]]).long()
    return best


# --------------------------------------------------------------------------- #
# the packed trees of B1 and B4
# --------------------------------------------------------------------------- #


def _words(x):
    """A float32 tensor's bits as int32 words."""
    return x.contiguous().view(torch.int32)


def _leaf_numbers(left):
    """(M,) int32: each leaf's number, leaves numbered in node order; -1
    at an inner node."""
    inner = left >= 0
    return torch.where(inner, -1,
                       torch.cumsum(~inner, 0, dtype=torch.int32) - 1)


def _node_records(bb_min, bb_max, left, right):
    """(M, NODE_W) int32: each inner node's children's boxes, node ids and
    refs (an inner child's id, ~(leaf number) of a leaf); a leaf's row
    holds ids -1 and zeros."""
    M = left.shape[0]
    inner = left >= 0
    ref = torch.where(inner, torch.arange(M, dtype=torch.int32,
                                          device=left.device),
                      ~_leaf_numbers(left))
    l, r = left.clamp(min=0).long(), right.clamp(min=0).long()
    boxes = torch.cat([_words(bb_min[l]), _words(bb_max[l]),
                       _words(bb_min[r]), _words(bb_max[r])], 1)
    refs = torch.stack([ref[l], ref[r]], 1)
    zero = torch.zeros((), dtype=torch.int32, device=left.device)
    return torch.cat([torch.where(inner[:, None], boxes, zero),
                      torch.stack([left, right], 1),
                      torch.where(inner[:, None], refs, zero)], 1)


def _prim_leaves(gs: GeomSet, leaf_nodes):
    """(L, LEAF_W) int32: each leaf's prim corners and ids in slot order
    (a pad slot: id -1, zero corners)."""
    D = gs.dim
    pids = gs.leaf_prims[leaf_nodes]                        # (L, LEAF)
    c = gs.corners[pids.clamp(min=0).long()]                # (L, LEAF, D*D)
    c = torch.where((pids >= 0)[..., None], _words(c), 0)
    L = pids.shape[0]
    if D == 2:
        return torch.cat([c.reshape(L, -1), pids], 1)
    pad = torch.zeros((L, LEAF_SIZE, 2), dtype=torch.int32, device=c.device)
    return torch.cat([c, pids[..., None], pad], 2).reshape(L, -1)


def _entity_leaves(gs: GeomSet, leaf_nodes):
    """(L, LEAF x ENT_W) int32: each leaf's silhouette entities in slot
    order, flag 1 / 0 for ``sil_always``, -1 (and zeros) at a pad."""
    D = gs.dim
    e = gs.sil_leaf[leaf_nodes]                             # (L, LEAF)
    ec = e.clamp(min=0).long()
    parts = (gs.sil_p0, gs.sil_p1, gs.sil_n1, gs.sil_n2) if D == 3 else (
        gs.sil_p0, gs.sil_n1, gs.sil_n2)                    # 2D: no p1
    body = torch.where((e >= 0)[..., None],
                       _words(torch.cat([t[ec] for t in parts], 2)), 0)
    flag = torch.where(e >= 0, gs.sil_always[ec].to(torch.int32), -1)
    pad = torch.zeros(e.shape + (ENT_W[D] - body.shape[2] - 1,),
                      dtype=torch.int32, device=e.device)
    return torch.cat([body, flag[..., None], pad], 2).reshape(e.shape[0], -1)


def sil_cone_consts(lo, hi, cone_cos):
    """(c (M, D), r (M,), theta (M,)) of each node's SNCH cone, computed
    once for each tree as ``_cone_prune`` computes them at a visit (each
    a separate elementwise op, so no contraction on the card either)."""
    return (0.5 * (lo + hi), 0.5 * _norm(hi - lo),
            torch.arccos(torch.clamp(cone_cos, -1.0, 1.0)))


def pack_trees(gs: GeomSet) -> dict:
    """The packed forms of a set's trees that B1 and B4 read (csrc/bvh.cu
    lays them out), built on the set's device from its tree fields:
    ``node_pack`` (M, NODE_W) and ``leaf_pack`` (L, LEAF_W) of the prim
    tree, ``sil_node_pack`` (Ms, SIL_W) and ``sil_ent_pack`` (Ls, LEAF x
    ENT_W) of the entities' tree, each present where its tree is.  Rows
    of int32 words, floats by their bits: copies of the tree's own values
    but the cone constants (``sil_cone_consts``)."""
    out = {}
    if gs.left is not None:
        leaf_nodes = torch.nonzero(gs.left < 0).flatten()
        out["node_pack"] = _node_records(gs.bb_min, gs.bb_max, gs.left,
                                         gs.right)
        out["leaf_pack"] = _prim_leaves(gs, leaf_nodes)
    if gs.sil_left is not None:
        D = gs.dim
        leaf_nodes = torch.nonzero(gs.sil_left < 0).flatten()
        c, r, theta = sil_cone_consts(gs.sil_bb_min, gs.sil_bb_max,
                                      gs.sil_cone_cos)
        cone = torch.cat([_words(c), _words(r[:, None]),
                          _words(gs.sil_cone_axis),
                          _words(gs.sil_cone_cos[:, None]),
                          _words(theta[:, None]),
                          _leaf_numbers(gs.sil_left)[:, None]], 1)
        rec = _node_records(gs.sil_bb_min, gs.sil_bb_max, gs.sil_left,
                            gs.sil_right)

        def zeros(k):
            return torch.zeros((rec.shape[0], k), dtype=torch.int32,
                               device=rec.device)

        out["sil_node_pack"] = torch.cat(
            [cone, zeros(CONE_W[D] - cone.shape[1]), rec,
             zeros(SIL_W[D] - CONE_W[D] - NODE_W[D])], 1)
        out["sil_ent_pack"] = _entity_leaves(gs, leaf_nodes)
    return out


def with_packs(gs: GeomSet) -> GeomSet:
    """The set, its packs built by ``pack_trees`` and kept on it where a
    tree lacks them: once for each set, where the BVH route uploads it
    (``core/problem.py``) or at its first B1 / B4 call."""
    if ((gs.left is not None and gs.node_pack is None)
            or (gs.sil_left is not None and gs.sil_node_pack is None)):
        for k, v in pack_trees(gs).items():
            setattr(gs, k, v)
    return gs


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #


def _tree_checks(gs: GeomSet, dev, sil: bool = False):
    pre = "sil_" if sil else ""
    bb_min = getattr(gs, f"{pre}bb_min")
    if bb_min is None:
        raise ValueError(f"the set has no {'silhouette ' if sil else ''}"
                         f"tree (a GeomSet built with bvh=True)")
    M, D = bb_min.shape
    if D != gs.dim:
        raise ValueError(f"a {D}D tree for a {gs.dim}D set")
    _check(f"{pre}bb_min", bb_min, torch.float32, (M, D), dev)
    _check(f"{pre}bb_max", getattr(gs, f"{pre}bb_max"), torch.float32,
           (M, D), dev)
    for k in ("left", "right"):
        _check(pre + k, getattr(gs, pre + k), torch.int32, (M,), dev)
    leaf = gs.sil_leaf if sil else gs.leaf_prims
    _check(f"{pre}leaf", leaf, torch.int32, (M, LEAF_SIZE), dev)
    depth = gs.sil_depth if sil else gs.depth
    if depth + 4 > MAX_STACK:
        raise ValueError(f"a tree of depth {depth} for a stack of "
                         f"{MAX_STACK}")
    return M, (bb_min.data_ptr(), getattr(gs, f"{pre}bb_max").data_ptr(),
               getattr(gs, pre + "left").data_ptr(),
               getattr(gs, pre + "right").data_ptr(), leaf.data_ptr())


def _lane_checks(gs: GeomSet, live, **lanes):
    n = next(iter(lanes.values())).shape[0]
    dev = gs.verts.device
    for name, x in lanes.items():
        shape = (n, gs.dim) if x.dim() == 2 else (n,)
        _check(name, x, torch.float32, shape, dev)
    if live is not None:
        _check("live", live, torch.bool, (n,), dev)
    return n, dev


def _live_ptr(live):
    return 0 if live is None else live.data_ptr()


def _pack_checks(gs: GeomSet, dev, sil: bool = False) -> int:
    """Check the packs that B1 (the prim tree's) or B4 (the entities'
    tree's) reads; return the tree's node count."""
    D = gs.dim
    M = (gs.sil_left if sil else gs.left).shape[0]
    L = (M + 1) // 2                     # the leaves of a full binary tree
    for name, shape in ((("sil_node_pack", (M, SIL_W[D])),
                         ("sil_ent_pack", (L, LEAF_SIZE * ENT_W[D])))
                        if sil else (("node_pack", (M, NODE_W[D])),
                                     ("leaf_pack", (L, LEAF_W[D])))):
        _check(name, getattr(gs, name), torch.int32, shape, dev)
    return M


def _visit_ptr(visits, n: int, dev) -> int:
    """The kernel's visit-count pointer: null, or (n,) int32 on the card
    (the plain versions count another thing: pops, or level pairs)."""
    if visits is None:
        return 0
    _check("visits", visits, torch.int32, (n,), dev)
    if dev.type == "cpu":
        raise ValueError("visits is the kernel's count, on a CUDA tensor")
    return visits.data_ptr()


def closest_point_bvh(gs: GeomSet, q, live=None, visits=None):
    """``visits`` (N,) int32 on the card, where given, gets the nodes and
    leaves each lane's descent reads."""
    n, dev = _lane_checks(gs, live, q=q)
    _tree_checks(gs, dev)
    M = _pack_checks(with_packs(gs), dev)
    vp = _visit_ptr(visits, n, dev)
    if dev.type == "cpu":
        return closest_point_bvh_plain(gs, q, live)
    d = torch.empty((n,), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().closest_point_bvh_launch, q.data_ptr(), _live_ptr(live),
            gs.bb_min.data_ptr(), gs.bb_max.data_ptr(),
            gs.node_pack.data_ptr(), gs.leaf_pack.data_ptr(), M,
            gs.stack_size, n, gs.dim, vp, d.data_ptr(), pid.data_ptr(),
            device=dev)
    closest_point_bvh.launches += 1
    return d, pid


closest_point_bvh.launches = 0


def ray_bvh(gs: GeomSet, o, d, tmax, any_hit: bool = False, live=None):
    n, dev = _lane_checks(gs, live, o=o, d=d, tmax=tmax)
    M, tree = _tree_checks(gs, dev)
    _check("corners", gs.corners, torch.float32,
           (gs.n_prims, gs.dim * gs.dim), dev)
    if dev.type == "cpu":
        return ray_bvh_plain(gs, o, d, tmax, any_hit, live)
    hit = torch.empty((n,), dtype=torch.bool, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().ray_bvh_launch, o.data_ptr(), d.data_ptr(),
            tmax.data_ptr(), _live_ptr(live), *tree, gs.corners.data_ptr(),
            n, gs.dim, int(bool(any_hit)), hit.data_ptr(), t.data_ptr(),
            pid.data_ptr(), device=dev)
    ray_bvh.launches += 1
    return hit, t, pid


ray_bvh.launches = 0


def sample_in_ball_bvh(gs: GeomSet, q, R, u, live=None):
    n, dev = _lane_checks(gs, live, q=q, R=R, u=u)
    M, tree = _tree_checks(gs, dev)
    if gs.node_measure is None:
        raise ValueError("the set has no subtree measures (more than "
                         "CHUNKED_DENSE_MAX prims, built with bvh=True)")
    _check("node_measure", gs.node_measure, torch.float32, (M,), dev)
    _check("corners", gs.corners, torch.float32,
           (gs.n_prims, gs.dim * gs.dim), dev)
    _check("prim_measure", gs.prim_measure, torch.float32, (gs.n_prims,),
           dev)
    if dev.type == "cpu":
        return sample_in_ball_bvh_plain(gs, q, R, u, live)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch(library().sample_in_ball_bvh_launch, q.data_ptr(), R.data_ptr(),
            u.data_ptr(), _live_ptr(live), *tree, gs.node_measure.data_ptr(),
            gs.corners.data_ptr(), gs.prim_measure.data_ptr(), n, gs.dim,
            pid.data_ptr(), pdf.data_ptr(), device=dev)
    sample_in_ball_bvh.launches += 1
    return pid, pdf


sample_in_ball_bvh.launches = 0


def closest_silhouette_bvh(gs: GeomSet, q, live=None, visits=None):
    """``visits`` as B1's: the nodes each lane's descent reads."""
    n, dev = _lane_checks(gs, live, q=q)
    _tree_checks(gs, dev, sil=True)
    _pack_checks(with_packs(gs), dev, sil=True)
    vp = _visit_ptr(visits, n, dev)
    if dev.type == "cpu":
        return closest_silhouette_bvh_plain(gs, q, live)
    d = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch(library().closest_silhouette_bvh_launch, q.data_ptr(),
            _live_ptr(live), gs.sil_bb_min.data_ptr(),
            gs.sil_bb_max.data_ptr(), gs.sil_node_pack.data_ptr(),
            gs.sil_ent_pack.data_ptr(), gs.sil_depth + 4, n, gs.dim, vp,
            d.data_ptr(), device=dev)
    closest_silhouette_bvh.launches += 1
    return d


closest_silhouette_bvh.launches = 0

KERNELS = (closest_point_bvh, ray_bvh, sample_in_ball_bvh,
           closest_silhouette_bvh)
