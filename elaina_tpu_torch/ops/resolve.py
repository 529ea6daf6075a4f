"""Dirichlet-resolve kernels K1-K5 and the chain-path sweeps K10, K11:
wrappers, plain versions, build.

Port of ``elaina_tpu/ops/pallas_resolve.py`` (``compact_lanes``,
``sweep_resolve``, ``fetch_colors``, ``sweep_resolve_3d``,
``fetch_colors3``) and of ``grid_band_dma_2d`` / ``grid_band_dma_3d``
(``elaina_tpu/ops/pallas_queries.py``).  The CUDA sources are in
``csrc/resolve.cu``, compiled with nvcc for sm_90a into ``_build/`` at the
first launch and bound through ctypes (pointers and the current stream as
``c_void_p``).  Each wrapper checks its inputs, allocates its outputs with
``torch.empty``, launches on the current stream and counts its launches in
``<wrapper>.launches``.  A CPU tensor takes the plain PyTorch version
beside the kernel; a CUDA tensor launches the kernel or raises.

Contracts (from the TPU kernels, minus the bitmask words):

* ``compact_lanes(mask, cap) -> (lanes (cap,) i32, cnt (1,) i32)``: ids of
  the set lanes in ascending order; ``cnt`` counts every set lane, even
  past ``cap``; entries past ``min(cnt, cap)`` are unspecified.  On the
  card both are views of one (cap + 1,) tensor, and the kernel keeps its
  tile counter and status words in a workspace made once per device
  (``_compact_workspace``), which serialises calls on one stream.
* ``sweep_resolve(mask, row, q, coords, cand) -> (d, t, side, pid)``: on
  masked lanes, the exact closest of the K candidates of row ``row``:
  distance, segment parameter t in [0, 1], the winner's cross product
  ``e x (q - a)`` (prim_side's sign) and its prim id; the smallest slot
  wins ties.  Unmasked lanes give 0, 0, 0, -1.  On the card the wrapper
  compacts ``mask`` with K1 and launches K2 once over K1's list: the
  count stays on the device, each listed lane reads its row and point by
  lane id and writes at it, and the same launch fills the unmasked lanes;
  its grid is one wave of the card's SMs, not N, so the listed lanes, not
  N, bound its sweep.  ``coords`` must start on 16 bytes there.
* ``fetch_colors(mask, cfi, color_rows) -> (c0, c1)``: on masked lanes,
  the two endpoint colors of row ``cfi`` of the (2P, 6) table; 0 on
  unmasked lanes and rows out of range.
* ``sweep_resolve_3d(mask, row, q, coords, cand) -> (d, pid, corners)``:
  on masked lanes, the exact closest of the K triangles of row ``row``
  (the distance of ``_tri_d2_tile``): distance, prim id and the winner's
  corners (N, 9) [a, b, c]; the smallest slot wins ties.  Unmasked lanes
  give 0, -1, 0.  On the card, K1 and one K4 launch over its list, as
  K2.
* ``fetch_colors3(mask, cfi, color_rows) -> (ca, cb, cc)``: K3 for the
  three triangle corners of the (2P, 9) table.
* ``grid_band_2d(row, q, coords) -> (d2, slot, corners (N, 4))`` and
  ``grid_band_3d(row, q, coords) -> (d2, slot, corners (N, 9))``: on every
  lane with row >= 0, the exact closest segment / triangle of the row
  (K2's and K4's distances, the smallest slot on equal d^2): its squared
  distance, slot in [0, Kp) and corners; slot 0 where every d^2
  overflows.  Lanes with row < 0 give +inf, slot 0 and zero corners.
  ``coords`` must start on 16 bytes on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda as _cuda
from .cuda import CPU, I32, I64, VP
from .cuda import build_log as _lib_log
from .cuda import check as _check
from .cuda import launch as _launch

COMPACT_TILE = 4096     # lanes per tile of K1 (csrc CL_TILE)
_COMPACT_MIN_TILES = 4096   # K1's first workspace: up to 16.7M lanes
_PLAIN_CHUNK = 16384    # lanes per chunk of the plain sweep (bounds memory)

_SIGNATURES = {
    "compact_lanes_launch": [VP, I64, I32, VP, VP, VP, I64, VP],
    "sweep_resolve_launch": [VP, VP, VP, VP, VP, VP, VP, I64, I32, I32, VP,
                             VP, VP, VP, VP],
    "sweep_resolve_3d_launch": [VP, VP, VP, VP, VP, VP, VP, I64, I32, I32,
                                VP, VP, VP, VP],
    "fetch_colors_launch": [VP, VP, VP, I64, I64, VP, VP],
    "fetch_colors3_launch": [VP, VP, VP, I64, I64, VP, VP],
    "grid_band_2d_launch": [VP, VP, VP, I64, I32, VP, VP, VP, VP],
    "grid_band_3d_launch": [VP, VP, VP, I64, I32, VP, VP, VP, VP],
}


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/resolve.cu`` on first call."""
    return _cuda.load_library("elaina_resolve", "resolve.cu", _SIGNATURES)


def build_log() -> str:
    """The compiler's notes from the kernel build (``-Xptxas -v``)."""
    return _lib_log(library())


# --------------------------------------------------------------------------- #
# K1 compact_lanes
# --------------------------------------------------------------------------- #


def compact_lanes_plain(mask: torch.Tensor, cap: int):
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    lanes = torch.zeros((cap,), dtype=torch.int32, device=mask.device)
    k = min(cap, ids.numel())
    lanes[:k] = ids[:k]
    cnt = torch.full((1,), ids.numel(), dtype=torch.int32,
                     device=mask.device)
    return lanes, cnt


_WORKSPACE: dict = {}    # device index -> K1's workspace


def _compact_workspace(dev: torch.device, n_tiles: int) -> torch.Tensor:
    """K1's int64 workspace on ``dev``: the tile counter and epoch, then a
    status word a tile.  Zeroed when made, then left to the kernel, which
    resets what it uses itself; made again, larger, only for more tiles."""
    work = _WORKSPACE.get(dev.index)
    if work is None or work.numel() - 1 < n_tiles:
        work = torch.zeros((1 + max(n_tiles, _COMPACT_MIN_TILES),),
                           dtype=torch.int64, device=dev)
        _WORKSPACE[dev.index] = work
    return work


def _compact_into(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """K1 on a checked CUDA mask into one new (cap + 1,) int32 tensor: the
    list, then its count."""
    dev = mask.device
    n = mask.shape[0]
    work = _compact_workspace(dev, -(-n // COMPACT_TILE))
    out = torch.empty(cap + 1, dtype=torch.int32, device=dev)
    p = out.data_ptr()
    _launch(library().compact_lanes_launch, mask.data_ptr(), n, cap, p,
            p + 4 * cap, work.data_ptr(), work.numel() - 1, device=dev)
    compact_lanes.launches += 1
    return out


def compact_lanes(mask: torch.Tensor, cap: int):
    _check("mask", mask, torch.bool, (mask.shape[0],), mask.device)
    if mask.device == CPU:
        return compact_lanes_plain(mask, cap)
    return _compact_into(mask, cap).split_with_sizes((cap, 1))


compact_lanes.launches = 0


# --------------------------------------------------------------------------- #
# K2 sweep_resolve
# --------------------------------------------------------------------------- #


def seg_d2(wx, wy, ex, ey):
    """(d^2, t): the squared distance from a + w to the segment a + t e,
    t = clip((w . e) / max(|e|^2, 1e-30), 0, 1) (csrc ``seg_d2``)."""
    den = torch.clamp(ex * ex + ey * ey, min=1e-30)
    tt = torch.clamp((wx * ex + wy * ey) / den, 0.0, 1.0)
    dx = wx - tt * ex
    dy = wy - tt * ey
    return dx * dx + dy * dy, tt


def sweep_resolve_plain(mask, row, q, coords, cand):
    n = row.shape[0]
    K = cand.shape[1]
    dev = q.device
    d = torch.zeros((n,), dtype=torch.float32, device=dev)
    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    side = torch.zeros((n,), dtype=torch.float32, device=dev)
    pid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sel = torch.nonzero(mask).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        r = row[ids].long()
        ax, ay, bx, by = coords[r].unbind(1)                # (c, Kp) each
        qx = q[ids, 0:1]
        qy = q[ids, 1:2]
        ex = bx - ax
        ey = by - ay
        wx = qx - ax
        wy = qy - ay
        d2, tt = seg_d2(wx, wy, ex, ey)
        slot = torch.argmin(d2, dim=1, keepdim=True)       # first minimum
        d[ids] = torch.sqrt(d2.gather(1, slot)[:, 0])
        t[ids] = tt.gather(1, slot)[:, 0]
        side[ids] = (ex * wy - ey * wx).gather(1, slot)[:, 0]
        s = slot[:, 0]
        pid[ids] = torch.where(s < K, cand[r, s.clamp(max=K - 1)],
                               torch.full_like(s, -1, dtype=torch.int32))
    return d, t, side, pid


def _check_sweep(mask, row, q, coords, cand, dim: int):
    n = row.shape[0]
    dev = q.device
    R, K = cand.shape
    Kp = coords.shape[2]
    _check("mask", mask, torch.bool, (n,), dev)
    _check("row", row, torch.int32, (n,), dev)
    _check("q", q, torch.float32, (n, dim), dev)
    _check("coords", coords, torch.float32, (R, dim * dim, Kp), dev)
    _check("cand", cand, torch.int32, (R, K), dev)
    if Kp < K or Kp % 32:
        raise ValueError(f"coords has {Kp} slots per row for K={K}")
    if dev.type != "cpu" and coords.data_ptr() % 16:
        raise ValueError("coords must start on 16 bytes (the kernel reads "
                         "its planes as float4)")


def _sweep_lanes(dim: int, mask, lanes: int, cnt: int, row, q, coords,
                 cand):
    """K2 (dim 2) or K4 (dim 3) on checked CUDA tensors over K1's list of
    the set lanes of ``mask``, at the device addresses ``lanes`` (N int32)
    and ``cnt`` (one int32, read on the device)."""
    n = row.shape[0]
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    if dim == 2:
        wrapper, fn = sweep_resolve, library().sweep_resolve_launch
        outs = (torch.empty((n,), **f32), torch.empty((n,), **f32),
                torch.empty((n,), **f32), torch.empty((n,), **i32))
    else:
        wrapper, fn = sweep_resolve_3d, library().sweep_resolve_3d_launch
        outs = (torch.empty((n,), **f32), torch.empty((n,), **i32),
                torch.empty((n, 9), **f32))
    _launch(fn, mask.data_ptr(), lanes, cnt, row.data_ptr(), q.data_ptr(),
            coords.data_ptr(), cand.data_ptr(), n, cand.shape[1],
            coords.shape[2], *(o.data_ptr() for o in outs), device=dev)
    wrapper.launches += 1
    return outs


def _sweep(dim: int, mask, row, q, coords, cand):
    """K1 on ``mask``, then K2 / K4 over its list: the CUDA path of both
    wrappers."""
    n = row.shape[0]
    lst = _compact_into(mask, n)   # held until the sweep is enqueued
    p = lst.data_ptr()
    return _sweep_lanes(dim, mask, p, p + 4 * n, row, q, coords, cand)


def sweep_resolve(mask, row, q, coords, cand):
    _check_sweep(mask, row, q, coords, cand, 2)
    if q.device.type == "cpu":
        return sweep_resolve_plain(mask, row, q, coords, cand)
    return _sweep(2, mask, row, q, coords, cand)


sweep_resolve.launches = 0


# --------------------------------------------------------------------------- #
# K3 fetch_colors / K5 fetch_colors3
# --------------------------------------------------------------------------- #


def _fetch_plain(mask, cfi, color_rows, nc: int):
    r = cfi.long()
    n_rows = color_rows.shape[0]
    on = mask & (r >= 0) & (r < n_rows)
    c = torch.where(on[:, None], color_rows[r.clamp(0, n_rows - 1)],
                    torch.zeros((), dtype=torch.float32, device=cfi.device))
    return tuple(c[:, 3 * k:3 * k + 3].contiguous() for k in range(nc))


def _fetch(wrapper, fn: str, mask, cfi, color_rows, nc: int):
    dev = cfi.device
    n = cfi.shape[0]
    n_rows = color_rows.shape[0]
    _check("mask", mask, torch.bool, (n,), dev)
    _check("cfi", cfi, torch.int32, (n,), dev)
    _check("color_rows", color_rows, torch.float32, (n_rows, 3 * nc), dev)
    if dev == CPU:
        return _fetch_plain(mask, cfi, color_rows, nc)
    out = torch.empty(nc, n, 3, dtype=torch.float32, device=dev)
    _launch(getattr(library(), fn), mask.data_ptr(), cfi.data_ptr(),
            color_rows.data_ptr(), n, n_rows, out.data_ptr(), device=dev)
    wrapper.launches += 1
    return out.unbind()


def fetch_colors_plain(mask, cfi, color_rows):
    return _fetch_plain(mask, cfi, color_rows, 2)


def fetch_colors(mask, cfi, color_rows):
    return _fetch(fetch_colors, "fetch_colors_launch", mask, cfi, color_rows,
                  2)


fetch_colors.launches = 0


def fetch_colors3_plain(mask, cfi, color_rows):
    return _fetch_plain(mask, cfi, color_rows, 3)


def fetch_colors3(mask, cfi, color_rows):
    return _fetch(fetch_colors3, "fetch_colors3_launch", mask, cfi,
                  color_rows, 3)


fetch_colors3.launches = 0


# --------------------------------------------------------------------------- #
# K4 sweep_resolve_3d
# --------------------------------------------------------------------------- #


def _edge_d2(q, p0, p1):
    e = [p1[k] - p0[k] for k in range(3)]
    w = [q[k] - p0[k] for k in range(3)]
    t = torch.clamp((w[0] * e[0] + w[1] * e[1] + w[2] * e[2])
                    / torch.clamp(e[0] * e[0] + e[1] * e[1] + e[2] * e[2],
                                  min=1e-30), 0.0, 1.0)
    dd = [w[k] - t * e[k] for k in range(3)]
    return dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]


def tri_d2_planes(q, c):
    """Point-triangle squared distance, ``_tri_d2_tile``'s formula with
    the kernels' order of operations: q a tuple of 3 (n, 1) tensors, c a
    tuple of 9 (n, K) corner planes."""
    a, b, cc = c[0:3], c[3:6], c[6:9]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    e1 = [b[k] - a[k] for k in range(3)]
    e2 = [cc[k] - a[k] for k in range(3)]
    w = [q[k] - a[k] for k in range(3)]
    d11, d12, d22 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
    w1, w2 = dot(w, e1), dot(w, e2)
    den = torch.clamp(d11 * d22 - d12 * d12, min=1e-30)
    u = (d22 * w1 - d12 * w2) / den
    v = (d11 * w2 - d12 * w1) / den
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    diff = [w[k] - u * e1[k] - v * e2[k] for k in range(3)]
    d2_edge = torch.minimum(torch.minimum(_edge_d2(q, a, b),
                                          _edge_d2(q, b, cc)),
                            _edge_d2(q, cc, a))
    return torch.where(inside, dot(diff, diff), d2_edge)


def sweep_resolve_3d_plain(mask, row, q, coords, cand):
    n = row.shape[0]
    K = cand.shape[1]
    dev = q.device
    d = torch.zeros((n,), dtype=torch.float32, device=dev)
    pid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    corners = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    sel = torch.nonzero(mask).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        r = row[ids].long()
        planes = coords[r].unbind(1)                        # 9 x (c, Kp)
        qc = tuple(q[ids, k:k + 1] for k in range(3))
        d2 = tri_d2_planes(qc, planes)
        slot = torch.argmin(d2, dim=1, keepdim=True)       # first minimum
        d[ids] = torch.sqrt(d2.gather(1, slot)[:, 0])
        corners[ids] = torch.cat([p.gather(1, slot) for p in planes], dim=1)
        s = slot[:, 0]
        pid[ids] = torch.where(s < K, cand[r, s.clamp(max=K - 1)],
                               torch.full_like(s, -1, dtype=torch.int32))
    return d, pid, corners


def sweep_resolve_3d(mask, row, q, coords, cand):
    _check_sweep(mask, row, q, coords, cand, 3)
    if q.device.type == "cpu":
        return sweep_resolve_3d_plain(mask, row, q, coords, cand)
    return _sweep(3, mask, row, q, coords, cand)


sweep_resolve_3d.launches = 0


# --------------------------------------------------------------------------- #
# K10 grid_band_2d / K11 grid_band_3d
# --------------------------------------------------------------------------- #


def _segment_d2_planes(q, c):
    """K2's segment distance on (m, Kp) planes (ax, ay, bx, by)."""
    ax, ay, bx, by = c
    return seg_d2(q[0] - ax, q[1] - ay, bx - ax, by - ay)[0]


def _grid_band_plain(row, q, coords, dim: int):
    n = row.shape[0]
    npl = dim * dim
    dev = q.device
    d2 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    slot = torch.zeros((n,), dtype=torch.int32, device=dev)
    corners = torch.zeros((n, npl), dtype=torch.float32, device=dev)
    dist = _segment_d2_planes if dim == 2 else tri_d2_planes
    sel = torch.nonzero(row >= 0).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        planes = coords[row[ids].long()].unbind(1)         # npl x (m, Kp)
        all_d2 = dist(tuple(q[ids, k:k + 1] for k in range(dim)), planes)
        s = torch.argmin(all_d2, dim=1, keepdim=True)      # first minimum
        d2[ids] = all_d2.gather(1, s)[:, 0]
        slot[ids] = s[:, 0].to(torch.int32)
        corners[ids] = torch.cat([p.gather(1, s) for p in planes], dim=1)
    return d2, slot, corners


def grid_band_2d_plain(row, q, coords):
    return _grid_band_plain(row, q, coords, 2)


def grid_band_3d_plain(row, q, coords):
    return _grid_band_plain(row, q, coords, 3)


def _grid_band(wrapper, fn: str, row, q, coords, dim: int):
    n = row.shape[0]
    dev = q.device
    npl = dim * dim
    R, _, Kp = coords.shape
    _check("row", row, torch.int32, (n,), dev)
    _check("q", q, torch.float32, (n, dim), dev)
    _check("coords", coords, torch.float32, (R, npl, Kp), dev)
    if Kp % 32:
        raise ValueError(f"coords has {Kp} slots per row")
    if dev.type == "cpu":
        return _grid_band_plain(row, q, coords, dim)
    if coords.data_ptr() % 16:
        raise ValueError("coords must start on 16 bytes (the kernel reads "
                         "its planes as float4)")
    d2 = torch.empty((n,), dtype=torch.float32, device=dev)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    corners = torch.empty((n, npl), dtype=torch.float32, device=dev)
    _launch(getattr(library(), fn), row.data_ptr(), q.data_ptr(),
            coords.data_ptr(), n, Kp, d2.data_ptr(), slot.data_ptr(),
            corners.data_ptr(), device=dev)
    wrapper.launches += 1
    return d2, slot, corners


def grid_band_2d(row, q, coords):
    return _grid_band(grid_band_2d, "grid_band_2d_launch", row, q, coords, 2)


grid_band_2d.launches = 0


def grid_band_3d(row, q, coords):
    return _grid_band(grid_band_3d, "grid_band_3d_launch", row, q, coords, 3)


grid_band_3d.launches = 0

KERNELS = (compact_lanes, sweep_resolve, fetch_colors, sweep_resolve_3d,
           fetch_colors3, grid_band_2d, grid_band_3d)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
