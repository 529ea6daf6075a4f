"""Candidate grid + FinePack (Dirichlet) and band grids (Neumann).

Port of the parts of ``elaina_tpu/geometry/grid.py`` that the port's
uniform solve reads.  The candidate-grid build is the reference's, level
for level: every cell of a grid over the domain keeps the band of
primitives that can be the nearest one for some point in the cell; cells
whose band exceeds K split 2x per axis, up to ``max_levels``.  The
per-level band passes run in the native library (``native/scene_build.cpp``);
the result is cached on disk under the reference's key, in the
reference's file format.

The chain path (``grid_row_index`` -> ``grid_closest_point_detail``)
walks each query down the refinement levels to its candidate row and
sweeps the row exactly: with kernels K10 (2D) / K11 (3D) over the
coordinate table that ``attach_coords`` adds (the scene's grids always
carry it; the DIRICHLET_SDF channel takes this route), and on a bare grid
over the row's gathered corners, as the reference's XLA branch does (K12
for 2D rows of at most 128 slots, a planar chunked sweep otherwise).  The
FinePack collapses the refinement chain into one int32 per finest
cell: bit 31 the need flag (baked with the solve's eps), bits 30..20 a
quantized lower bound of the boundary distance, bits 19..0 the candidate
row.  ``fine_decode`` turns a query point into (row, need, bound) with one
load.  The port builds it on the host by upsampling level by level, in
place of the reference's TPU-tiled interleaves.

The band grids of a Neumann set are single-level grids of K-wide rows
(the reference's PrimBandGrid and SilGrid, one ``BandGrid`` here): the
prim-band grid keeps per cell the K prims of smallest lower bound and a
completeness cap r_cap (the star radius is clamped to it, so one row holds
every prim a step's ball or rays can touch); the silhouette grid keeps the
K nearest entities that may be silhouettes and a validity cap.  Both are
built by the native band passes (in 2D and 3D) and cached under the
reference's keys.

Device layouts are the port's own, planes by slot so the 32 threads of a
warp read 32 neighbouring floats, with Kp = K rounded up to the warp
width:
  * candidate and 3D prim-band coordinates (R, dim*D, Kp): plane k*D + d
    is corner k, axis d (2D ax, ay, bx, by; 3D ax..cz); padded and -1
    slots hold PAD_COORD.  A 2D prim-band grid has no table: its queries
    gather the rows' corners, as the reference's do;
  * silhouette entities, 3D (C, 12, Kp): p0.xyz, p1.xyz, n1.xyz, n2.xyz;
    2D (C, 6, Kp): p0.xy, n1.xy, n2.xy (the entities are vertices).
    "Always" entities get n1 = 0 and pads PAD_COORD points with zero
    normals;
  * colors (2P, 3*dim): row 2p + s holds the side-s colors of prim p's
    corners.
"""

from __future__ import annotations

import hashlib
import logging
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops.resolve import grid_band_2d, grid_band_3d, seg_d2, tri_d2_planes
from .primitives import prim_closest_point

PAD_COORD = 1.0e9     # far-away coordinate for padded candidate slots
FINE_BUCKETS = 2047
FINE_ROW_MASK = (1 << 20) - 1
WARP = 32
_FINE_CELL_CAP = 300_000_000   # dense finest-grid cap (1.2 GB int32)
_COORD_CHUNK_ROWS = 1 << 16
BARE_ROW_MAX = 128             # widest row the bare chain path sweeps whole
SKIP_REL = 2.0 ** -10          # band_skip_radius's margins: relative ...
SKIP_ABS = 2.0 ** -16          # ... and of the scene's extent
_BARE_CHUNK_SLOTS = 1 << 22    # lanes x slots a chunk of the gathered bare rows


@dataclass
class GridArrays:
    """Host (numpy) result of ``build_candidate_grid``; the same fields as
    the reference's CandidateGrid."""

    origin: np.ndarray       # (D,) f32
    inv_cell: np.ndarray     # (D,) f32 level-0 cells per world unit
    res: tuple               # level-0 cell counts per axis
    cand: np.ndarray         # (R, K) int32 prim rows, -1 padded
    meta: list               # per-level int32: >= 0 row id, < 0 pointer
    coverage: float          # 1.0 if every leaf band fit K
    lbound: np.ndarray       # (C0,) f32 level-0 cell lower bound
    row_lbound: np.ndarray   # (R,) f32 leaf-cell lower bound
    row_diag: np.ndarray     # (R,) f32 leaf-cell diameter
    row_trunc: np.ndarray    # (R,) bool band exceeded K (nearest-K kept)


@dataclass
class FinePack:
    packed: torch.Tensor     # (prod(res),) int32
    origin: torch.Tensor     # (D,) f32
    inv_cell: torch.Tensor   # (D,) f32 finest cells per world unit
    res_f: torch.Tensor      # (D,) f32 res: the outside test
    hi_f: torch.Tensor       # (D,) f32 res - 1: the clamp
    r0: float                # quantization base (an exact f32 value)
    res: tuple               # finest resolution per axis
    s: float                 # buckets per octave
    eps: float               # epsilon the need bit was baked with


@dataclass
class CandidateGrid:
    origin: torch.Tensor     # (D,) f32
    inv_cell: torch.Tensor   # (D,) f32
    res: tuple
    res_hi: torch.Tensor     # (D,) int32 res - 1: the clamp of a cell index
    cand: torch.Tensor       # (R, K) int32
    meta: list               # host int32 arrays (FinePack build input)
    meta_t: list             # the same levels as int32 device tensors
    row_lbound: torch.Tensor  # (R,) f32
    row_diag: torch.Tensor   # (R,) f32
    row_trunc: torch.Tensor  # (R,) bool
    trunc_min_rl: float      # min row_lbound over truncated rows (inf: none)
    verts: torch.Tensor      # (V, D) f32 the set's vertices
    indices: torch.Tensor    # (P, dim) int64 its prims
    color_rows: torch.Tensor  # (2P, 3*dim) f32 corner colors per (prim, side)
    coords: torch.Tensor | None = None  # (R, dim*D, Kp) corner planes
    fine: FinePack | None = None
    seg: torch.Tensor | None = None  # (P, 4) f32 (ax, ay, bx, by): a bare
    #                                  2D grid's segments, K12's table


@dataclass
class BandArrays:
    """Host (numpy) result of ``build_prim_band_grid`` /
    ``build_silhouette_grid``: a single-level grid of K-wide rows."""

    origin: np.ndarray       # (D,) f32
    inv_cell: np.ndarray     # (D,) f32 cells per world unit
    res: tuple
    rows: np.ndarray         # (C, K) int32 prim / entity ids, -1 padded
    r_cap: np.ndarray        # (C,) f32 completeness / validity cap (1e30: all)
    lbound: np.ndarray       # (C,) f32 min lower bound over the kept ids
    ent_lo: np.ndarray       # (D,) f32 bbox of the set (out-of-grid bound)
    ent_hi: np.ndarray       # (D,) f32


@dataclass
class BandGrid:
    """A band grid on the device: the arrays of ``BandArrays`` as tensors,
    plus the coordinate table the band kernels sweep."""

    origin: torch.Tensor
    inv_cell: torch.Tensor
    res: tuple
    res_f: torch.Tensor      # (D,) f32 res: the outside test
    res_hi: torch.Tensor     # (D,) int32 res - 1: the clamp of a cell index
    rows: torch.Tensor       # (C, K) int32
    r_cap: torch.Tensor      # (C,) f32
    lbound: torch.Tensor     # (C,) f32
    skip_r: torch.Tensor     # (C,) f32 reach below which no kept id is near
    ent_lo: torch.Tensor     # (D,) f32
    ent_hi: torch.Tensor     # (D,) f32
    coords: torch.Tensor | None  # prim corners (C, 9, Kp), 3D only; entities
    #                              (C, 12, Kp) in 3D, (C, 6, Kp) in 2D


# --------------------------------------------------------------------------- #
# build
# --------------------------------------------------------------------------- #


def _cell_centers(lo, hi, res):
    dim = len(res)
    axes = [lo[d] + (np.arange(res[d]) + 0.5) * (hi[d] - lo[d]) / res[d]
            for d in range(dim)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(np.float32)


def _children_centers(centers, hcell, dim):
    """2^dim children per cell; child ordinal bit d set <-> upper half of
    axis d."""
    offs = []
    for sub in range(2 ** dim):
        offs.append([(0.25 if (sub >> d) & 1 else -0.25) * 2.0 * hcell[d]
                     for d in range(dim)])
    offs = np.asarray(offs, np.float32)
    return (centers[:, None, :] + offs[None]).reshape(-1, dim)


def build_candidate_grid(verts: np.ndarray, indices: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray, K: int = 256,
                         max_res: int = 2048, max_levels: int = 6,
                         cache_dir: str | None = None) -> GridArrays:
    """Build the adaptive candidate grid on the host (cached by geometry
    hash).  Level 0 targets 512 cells on the longest 2D axis, capped at
    ``max_res``; cells whose band exceeds K subdivide."""
    from .native import grid_band_full_native

    verts = np.ascontiguousarray(verts, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    dim = indices.shape[1]
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    span = hi - lo

    key = hashlib.sha1(
        b"v6" + verts.tobytes() + indices.tobytes() + lo.tobytes()
        + hi.tobytes() + np.int64([K, max_res, max_levels]).tobytes()
    ).hexdigest()[:16]
    cache_path = (os.path.join(cache_dir, f"candgrid_{key}.npz")
                  if cache_dir else None)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        rlb = np.asarray(z["row_lbound"])
        return GridArrays(
            origin=np.asarray(z["origin"]), inv_cell=np.asarray(z["inv_cell"]),
            res=tuple(int(r) for r in z["res"]), cand=np.asarray(z["cand"]),
            meta=[np.asarray(z[f"meta_{i}"])
                  for i in range(int(z["n_levels"]))],
            coverage=float(z["coverage"]), lbound=np.asarray(z["lbound"]),
            row_lbound=rlb, row_diag=np.asarray(z["row_diag"]),
            row_trunc=np.asarray(z["row_trunc"] if "row_trunc" in z
                                 else np.zeros(rlb.shape, bool)))

    base = 512 if dim == 2 else 64
    res = tuple(int(np.clip(base * span[d] / max(span), 8, max_res))
                for d in range(dim))
    centers = _cell_centers(lo, hi, res)
    hcell = 0.5 * span / np.asarray(res, np.float64)

    metas, row_blocks, lb_blocks, tr_blocks, dg_blocks = [], [], [], [], []
    row_base = 0
    lbound = None
    coverage = 1.0
    for lvl in range(max_levels):
        counts, rows, lcell = grid_band_full_native(verts, indices, centers,
                                                    hcell, K)
        if lvl == 0:
            lbound = lcell
        last = lvl == max_levels - 1
        # deep-interior cutoff (3D, levels 0-1): see the reference build
        deep = ((lcell > 4.0 * np.linalg.norm(hcell)) & (counts > K)
                if lvl <= 1 and dim == 3 else np.zeros_like(counts, bool))
        fit = (counts <= K) | deep if not last else np.ones_like(counts, bool)
        trunc = counts > K if last else deep
        if trunc.any():
            coverage = 0.0
            logging.getLogger("elaina").warning(
                "candidate grid: %d cells keep nearest-%d truncated bands "
                "at level %d (max band %d)", int(trunc.sum()), K, lvl,
                int(counts.max()))
        fit_idx = np.flatnonzero(fit)
        over_idx = np.flatnonzero(~fit)
        meta = np.empty((centers.shape[0],), np.int32)
        meta[fit_idx] = row_base + np.arange(fit_idx.shape[0], dtype=np.int32)
        meta[over_idx] = -np.arange(over_idx.shape[0], dtype=np.int32) - 1
        metas.append(meta)
        if fit_idx.shape[0]:
            row_blocks.append(rows[fit_idx])
            lb_blocks.append(lcell[fit_idx])
            tr_blocks.append(counts[fit_idx] > K)
            diam = np.float32(2.0 * np.linalg.norm(hcell))
            dg_blocks.append(np.full((fit_idx.shape[0],), diam, np.float32))
            row_base += fit_idx.shape[0]
        if over_idx.shape[0] == 0:
            break
        centers = _children_centers(centers[over_idx], hcell, dim)
        hcell = hcell * 0.5

    cand = (np.concatenate(row_blocks, 0) if row_blocks
            else np.full((1, K), -1, np.int32))
    row_lbound = (np.concatenate(lb_blocks) if lb_blocks
                  else np.zeros((1,), np.float32))
    row_trunc = (np.concatenate(tr_blocks) if tr_blocks
                 else np.zeros((1,), bool))
    row_diag = (np.concatenate(dg_blocks) if dg_blocks
                else np.full((1,), np.float32(np.inf)))
    inv_cell = np.asarray(res, np.float32) / np.maximum(span, 1e-20)
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache_path[:-4] + f".tmp{os.getpid()}.npz"
        np.savez_compressed(
            tmp, origin=lo, inv_cell=inv_cell, res=np.asarray(res, np.int64),
            cand=cand, n_levels=np.int64(len(metas)),
            coverage=np.float32(coverage), lbound=lbound,
            row_lbound=row_lbound, row_diag=row_diag, row_trunc=row_trunc,
            **{f"meta_{i}": m for i, m in enumerate(metas)})
        os.replace(tmp, cache_path)
    return GridArrays(origin=lo, inv_cell=inv_cell, res=res, cand=cand,
                      meta=metas, coverage=coverage, lbound=lbound,
                      row_lbound=row_lbound, row_diag=row_diag,
                      row_trunc=row_trunc)


# --------------------------------------------------------------------------- #
# device tables
# --------------------------------------------------------------------------- #


def padded_k(K: int) -> int:
    """Candidate slots per row in the coordinate table (warp multiple)."""
    return -(-K // WARP) * WARP


def coords_from_cand(cand: torch.Tensor, verts: torch.Tensor,
                     indices: torch.Tensor) -> torch.Tensor:
    """(R, K) prim ids -> (R, dim*D, Kp) corner planes; -1 and pad slots
    hold PAD_COORD.  Built in row chunks on cand's device."""
    R, K = cand.shape
    dim = indices.shape[1]
    D = verts.shape[1]
    out = torch.full((R, dim * D, padded_k(K)), PAD_COORD,
                     dtype=torch.float32, device=cand.device)
    for r0 in range(0, R, _COORD_CHUNK_ROWS):
        c = cand[r0:r0 + _COORD_CHUNK_ROWS].long()
        valid = c >= 0
        for k in range(dim):
            vi = indices[c.clamp(min=0), k]                 # (r, K)
            for d in range(D):
                v = verts[vi, d]
                out[r0:r0 + c.shape[0], k * D + d, :K] = torch.where(
                    valid, v, torch.full_like(v, PAD_COORD))
    return out


def sil_coords_from_rows(rows: torch.Tensor, p0, p1, n1, n2,
                         always) -> torch.Tensor:
    """(C, K) entity ids -> planes by slot: in 3D (C, 12, Kp) p0, p1, n1,
    n2 (x, y, z each), in 2D (C, 6, Kp) p0, n1, n2 (x, y each; a 2D
    entity is a vertex, p1 = p0).  "Always" entities get n1 = 0, so the
    kernel's s1 s2 <= 0 test keeps them; -1 and pad slots get PAD_COORD
    points and zero normals (they pass the test at a distance that never
    wins)."""
    C, K = rows.shape
    dim = p0.shape[1]
    groups = ((p0, PAD_COORD), (p1, PAD_COORD)) if dim == 3 else (
        (p0, PAD_COORD),)
    n1 = torch.where(always[:, None], torch.zeros_like(n1), n1)
    groups += ((n1, 0.0), (n2, 0.0))
    out = torch.zeros((C, len(groups) * dim, padded_k(K)),
                      dtype=torch.float32, device=rows.device)
    out[:, :(len(groups) - 2) * dim] = PAD_COORD
    for r0 in range(0, C, _COORD_CHUNK_ROWS):
        e = rows[r0:r0 + _COORD_CHUNK_ROWS].long()
        valid = e >= 0
        safe = e.clamp(min=0)
        for g, (arr, pad) in enumerate(groups):
            for d in range(dim):
                v = arr[safe, d]
                out[r0:r0 + e.shape[0], dim * g + d, :K] = torch.where(
                    valid, v, torch.full_like(v, pad))
    return out


def color_rows_from(colors: torch.Tensor,
                    indices: torch.Tensor) -> torch.Tensor:
    """(V, 2, 3) two-sided vertex colors -> (2P, 3*dim): row 2p + s holds
    the side-s colors of prim p's corners."""
    dim = indices.shape[1]
    per = [colors[indices[:, k]] for k in range(dim)]      # (P, 2, 3) each
    return torch.cat(per, dim=-1).reshape(-1, 3 * dim).contiguous()


def grid_from_numpy(*, cand, meta, row_lbound, row_diag, row_trunc, origin,
                    inv_cell, res, verts, indices, colors,
                    device: torch.device) -> CandidateGrid:
    """The port's CandidateGrid from numpy arrays (the port's own build, or
    np.asarray of a reference grid) plus the boundary's verts (V, D),
    indices (P, D) and colors (V, 2, 3): a bare grid, without the
    coordinate table (``attach_coords`` adds it).  In 2D it carries the
    segment table that its chain path (K12) reads, 16 bytes a segment."""
    def t(a, dtype):
        return torch.as_tensor(np.require(a, requirements=("C", "W")),
                               dtype=dtype, device=device)

    rlb = np.asarray(row_lbound, np.float32)
    rt = np.asarray(row_trunc, bool)
    verts_t = t(np.asarray(verts, np.float32), torch.float32)
    idx_t = t(np.asarray(indices, np.int64), torch.int64)
    cand_t = t(np.asarray(cand, np.int32), torch.int32)
    seg = None
    if idx_t.shape[1] == 2:
        seg = verts_t[idx_t].reshape(-1, 4).contiguous()
    return CandidateGrid(
        origin=t(np.asarray(origin, np.float32), torch.float32),
        inv_cell=t(np.asarray(inv_cell, np.float32), torch.float32),
        res=tuple(int(r) for r in res),
        res_hi=t(np.asarray(res, np.int32) - 1, torch.int32), cand=cand_t,
        meta=[np.asarray(m, np.int32) for m in meta],
        meta_t=[t(np.asarray(m, np.int32), torch.int32) for m in meta],
        row_lbound=t(rlb, torch.float32),
        row_diag=t(np.asarray(row_diag, np.float32), torch.float32),
        row_trunc=t(rt, torch.bool),
        trunc_min_rl=float(rlb[rt].min()) if rt.any() else float("inf"),
        verts=verts_t, indices=idx_t,
        color_rows=color_rows_from(t(np.asarray(colors, np.float32),
                                     torch.float32), idx_t), seg=seg)


def attach_coords(grid: CandidateGrid) -> CandidateGrid:
    """The grid with its coordinate table (the reference's
    ``attach_coords``): the corner planes that K2-K5, K10 and K11 sweep,
    in place of the bare chain path's segment table."""
    if grid.coords is not None:
        return grid
    return replace(grid, coords=coords_from_cand(grid.cand, grid.verts,
                                                 grid.indices), seg=None)


# --------------------------------------------------------------------------- #
# band grids (Neumann)
# --------------------------------------------------------------------------- #


def _band_res(span: np.ndarray, max_res: int) -> tuple:
    base = 256 if span.shape[0] == 2 else 48
    return tuple(int(np.clip(base * span[d] / max(span), 8, max_res))
                 for d in range(span.shape[0]))


def _band_build(tag: bytes, prefix: str, key_arrays, lo, hi, K, max_res,
                cache_dir, native_pass, ent_lo, ent_hi) -> BandArrays:
    """The reference's single-level band build and its on-disk cache:
    ``native_pass(centers, hcell, K) -> (rows, r_cap, lbound)``."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    span = hi - lo
    key = hashlib.sha1(
        tag + b"".join(a.tobytes() for a in key_arrays) + lo.tobytes()
        + hi.tobytes() + np.int64([K, max_res]).tobytes()).hexdigest()[:16]
    cache_path = (os.path.join(cache_dir, f"{prefix}_{key}.npz")
                  if cache_dir else None)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        return BandArrays(
            origin=np.asarray(z["origin"]), inv_cell=np.asarray(z["inv_cell"]),
            res=tuple(int(r) for r in z["res"]), rows=np.asarray(z["rows"]),
            r_cap=np.asarray(z["r_cap"]), lbound=np.asarray(z["lbound"]),
            ent_lo=ent_lo, ent_hi=ent_hi)
    res = _band_res(span, max_res)
    centers = _cell_centers(lo, hi, res)
    hcell = 0.5 * span / np.asarray(res, np.float64)
    rows, r_cap, lbound = native_pass(centers, hcell, K)
    inv_cell = np.asarray(res, np.float32) / np.maximum(span, 1e-20)
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = cache_path[:-4] + f".tmp{os.getpid()}.npz"
        np.savez_compressed(tmp, origin=lo, inv_cell=inv_cell, rows=rows,
                            r_cap=r_cap, lbound=lbound,
                            res=np.asarray(res, np.int64))
        os.replace(tmp, cache_path)
    return BandArrays(origin=lo, inv_cell=inv_cell, res=res, rows=rows,
                      r_cap=r_cap, lbound=lbound, ent_lo=ent_lo,
                      ent_hi=ent_hi)


def build_prim_band_grid(verts, indices, lo, hi, K: int = 64,
                         max_res: int = 2048,
                         cache_dir: str | None = None) -> BandArrays:
    """The radius-complete prim band grid of a Neumann set (48 cells on
    the longest 3D axis), cached under the reference's ``pband1`` key."""
    from .native import prim_band_rows_native

    verts = np.ascontiguousarray(verts, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    pv = verts[indices.reshape(-1)]
    return _band_build(
        b"pband1", "pbandgrid", (verts, indices), lo, hi, K, max_res,
        cache_dir,
        lambda c, h, k: prim_band_rows_native(verts, indices, c, h, k),
        pv.min(0), pv.max(0))


def build_silhouette_grid(p0, p1, n1, n2, always, lo, hi, K: int = 64,
                          max_res: int = 2048,
                          cache_dir: str | None = None) -> BandArrays:
    """The silhouette band grid of a Neumann set's entities, cached under
    the reference's ``sil1`` key."""
    from .native import sil_band_rows_native

    p0 = np.ascontiguousarray(p0, np.float32)
    p1 = np.ascontiguousarray(p1, np.float32)
    n1 = np.ascontiguousarray(n1, np.float32)
    always = np.asarray(always, bool)
    return _band_build(
        b"sil1", "silgrid", (p0, p1, n1, always.astype(np.uint8)), lo, hi,
        K, max_res, cache_dir,
        lambda c, h, k: sil_band_rows_native(p0, p1, n1, n2, always, c, h,
                                             k),
        np.minimum(p0.min(0), p1.min(0)), np.maximum(p0.max(0), p1.max(0)))


def band_skip_radius(arrays: dict) -> np.ndarray:
    """(C,) f32: the reach below which a point of the cell is farther than
    it from every kept id, ``lbound (1 - SKIP_REL) - SKIP_ABS * extent``.

    The native band pass writes lbound = min over the kept ids of max(d(c,
    id) - |h|, 0), with c the cell's center and |h| its half-diagonal, so
    by the triangle inequality every point of the cell lies at least
    lbound from each of them.  A depth step's ball (radius R) and rays
    (from q + oe n, length <= R, with |n| = |d| = 1) stay within R + oe of
    q, so a lane whose R + oe lies below skip_r finds no weight and no hit
    in its row (K6 skips it).  The margin covers float rounding:
    SKIP_ABS = 2^-16 of the scene's extent (the largest coordinate of the
    grid's box and the set's) is ~2^8 float32 ulps of it, against the few
    ulps by which the build's and the kernel's distances and a point's cell
    index can be off; SKIP_REL = 2^-10 covers the relative rounding of R +
    oe, of |n| and |d|, and of a ray's t.  ``tests/test_torch_band_skip.py``
    holds it at the tight case (a plane across the cell's diagonal)."""
    lo = np.asarray(arrays["origin"], np.float64)
    hi = lo + (np.asarray(arrays["res"], np.float64)
               / np.asarray(arrays["inv_cell"], np.float64))
    extent = float(np.abs(np.concatenate([
        lo, hi, np.asarray(arrays["ent_lo"], np.float64),
        np.asarray(arrays["ent_hi"], np.float64)])).max())
    lb = np.asarray(arrays["lbound"], np.float64)
    return (lb * (1.0 - SKIP_REL) - SKIP_ABS * extent).astype(np.float32)


def _band_tensors(arrays: dict, device) -> dict:
    def t(a):
        return torch.as_tensor(np.require(a, requirements=("C", "W")),
                               device=device)

    res = np.asarray(arrays["res"], np.int64)
    return dict(
        origin=t(np.asarray(arrays["origin"], np.float32)),
        inv_cell=t(np.asarray(arrays["inv_cell"], np.float32)),
        res=tuple(int(r) for r in res), res_f=t(res.astype(np.float32)),
        res_hi=t((res - 1).astype(np.int32)),
        rows=t(np.asarray(arrays["rows"], np.int32)),
        r_cap=t(np.asarray(arrays["r_cap"], np.float32)),
        lbound=t(np.asarray(arrays["lbound"], np.float32)),
        skip_r=t(band_skip_radius(arrays)),
        ent_lo=t(np.asarray(arrays["ent_lo"], np.float32)),
        ent_hi=t(np.asarray(arrays["ent_hi"], np.float32)))


def band_grid_from_numpy(arrays: dict, verts, indices,
                         device: torch.device) -> BandGrid:
    """The prim-band grid on the device from the fields of ``BandArrays``
    (the port's build, or np.asarray of a reference grid) and the set's
    verts (V, D) and indices (P, D); the corner table in 3D only (2D
    queries gather, as the reference's)."""
    f = _band_tensors(arrays, device)
    if np.asarray(indices).shape[1] == 2:
        return BandGrid(**f, coords=None)
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=device)
    return BandGrid(**f, coords=coords_from_cand(f["rows"], v, idx))


def sil_grid_from_numpy(arrays: dict, gs, device: torch.device) -> BandGrid:
    """The silhouette grid on the device from the fields of ``BandArrays``
    and the set's entities (a GeomSet on ``device``)."""
    f = _band_tensors(arrays, device)
    return BandGrid(**f, coords=sil_coords_from_rows(
        f["rows"], gs.sil_p0, gs.sil_p1, gs.sil_n1, gs.sil_n2,
        gs.sil_always))


# --------------------------------------------------------------------------- #
# FinePack
# --------------------------------------------------------------------------- #


def _meta_coords_np(metas: list, res0) -> list:
    """Per-level integer cell coords (n_l, D) of every meta entry: a
    level-(l+1) entry e descends from the level-l pointer with ordinal
    e >> D, child offset bit d <-> upper half of axis d."""
    dim = len(res0)
    coords = [np.stack(np.meshgrid(*[np.arange(r) for r in res0],
                                   indexing="ij"), -1).reshape(-1, dim)]
    for lvl in range(1, len(metas)):
        prev = metas[lvl - 1]
        neg = np.flatnonzero(prev < 0)
        parent_of_ord = np.empty(neg.shape[0], np.int64)
        parent_of_ord[-prev[neg].astype(np.int64) - 1] = neg
        e = np.arange(metas[lvl].shape[0], dtype=np.int64)
        parent = coords[lvl - 1][parent_of_ord[e >> dim]]
        sub = e & (2 ** dim - 1)
        off = np.stack([(sub >> d) & 1 for d in range(dim)], -1)
        coords.append(parent * 2 + off)
    return coords


def _bucket_table(row_lbound: np.ndarray, eps: float, s: float):
    """(packed0 (R,) int32 leaf entries, r0) — bucket b of each row's lower
    bound and the need bit ``decoded bound < eps``."""
    rl = np.asarray(row_lbound, np.float32)
    rl_pos = np.where(rl > 0, rl, np.float32(np.inf))
    r0 = np.float32(max(np.min(np.where(np.isfinite(rl_pos), rl_pos,
                                        np.float32(1.0))), 1e-12))
    finite = np.isfinite(rl)
    ratio = np.maximum(np.where(finite, rl, r0), r0) / r0
    b = np.floor(np.log2(ratio) * np.float32(s)).astype(np.int32) + 1
    b = np.where(rl <= r0, 0, b)
    b = np.where(finite, np.clip(b, 0, FINE_BUCKETS - 1), FINE_BUCKETS - 1)
    rl_dec = np.where(
        b == 0, np.float32(0.0),
        r0 * np.exp2((b.astype(np.float32) - np.float32(1.0)) / np.float32(s))
        * np.float32(1.0 - 1.9e-6))
    need = rl_dec < np.float32(eps)
    rows = np.arange(rl.shape[0], dtype=np.int32)
    packed0 = rows | (b.astype(np.int32) << 20) | np.where(
        need, np.int32(-2 ** 31), np.int32(0))
    return packed0.astype(np.int32), float(r0)


def build_fine_pack(grid: CandidateGrid, eps: float,
                    s: float = 64.0) -> FinePack:
    """Expand the refinement chain into the dense finest-level table: the
    level-0 leaves upsample 2x per axis per level, and each deeper level's
    leaves overwrite the cells they cover."""
    dim = len(grid.res)
    L = len(grid.meta)
    if grid.cand.shape[0] > FINE_ROW_MASK:
        raise ValueError(f"{grid.cand.shape[0]} candidate rows exceed the "
                         f"FinePack's 20-bit row field")
    fine_res = tuple(r << (L - 1) for r in grid.res)
    if int(np.prod(fine_res)) > _FINE_CELL_CAP:
        raise ValueError(f"FinePack of {fine_res} cells exceeds the "
                         f"{_FINE_CELL_CAP}-cell cap")
    packed0, r0 = _bucket_table(grid.row_lbound.cpu().numpy(), eps, s)
    metas = grid.meta
    coords = _meta_coords_np(metas, grid.res)
    cur = packed0[np.maximum(metas[0], 0)].reshape(grid.res)
    for lvl in range(1, L):
        for d in range(dim):
            cur = np.repeat(cur, 2, axis=d)
        leaf = np.flatnonzero(metas[lvl] >= 0)
        cur[tuple(coords[lvl][leaf].T)] = packed0[metas[lvl][leaf]]
    return fine_pack_from_numpy(
        packed=cur.reshape(-1), origin=grid.origin.cpu().numpy(),
        inv_cell=(grid.inv_cell * float(1 << (L - 1))).cpu().numpy(),
        r0=r0, res=fine_res, s=s, eps=eps, device=grid.cand.device)


def fine_pack_from_numpy(*, packed, origin, inv_cell, r0, res, s, eps,
                         device: torch.device) -> FinePack:
    res_f = np.asarray(res, np.float32)
    return FinePack(
        packed=torch.as_tensor(np.require(packed, np.int32, ("C", "W")),
                               device=device),
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        inv_cell=torch.tensor(np.asarray(inv_cell, np.float32),
                              device=device),
        res_f=torch.tensor(res_f, device=device),
        hi_f=torch.tensor(res_f - np.float32(1.0), device=device),
        r0=float(np.float32(r0)), res=tuple(int(r) for r in res),
        s=float(s), eps=float(eps))


def fine_decode(fp: FinePack, q: torch.Tensor):
    """(row int32, need, rl, outside) for query points q (N, D): one load
    of the packed table per lane.  The bounds are the pack's own device
    tensors: a tensor made from host values here would copy from pageable
    memory, and the host would wait for the device once a step."""
    rel = (q - fp.origin) * fp.inv_cell
    outside = ((rel < 0.0) | (rel >= fp.res_f)).any(dim=-1)
    idx = torch.minimum(torch.clamp(rel, min=0.0), fp.hi_f).long()
    lin = idx[..., 0]
    for d in range(1, len(fp.res)):
        lin = lin * fp.res[d] + idx[..., d]
    p = fp.packed[lin]
    need = p < 0
    pu = p & 0x7FFFFFFF
    row = pu & FINE_ROW_MASK
    b = pu >> 20
    rl = torch.where(
        b == 0, torch.zeros_like(q[..., 0]),
        fp.r0 * torch.exp2((b.float() - 1.0) / fp.s) * (1.0 - 1.9e-6))
    return row, need, rl, outside


# --------------------------------------------------------------------------- #
# chain path: query -> refinement levels -> candidate row -> exact sweep
# --------------------------------------------------------------------------- #


def grid_cell_index(grid: CandidateGrid, q: torch.Tensor) -> torch.Tensor:
    """Level-0 linear cell index (int64) of query points q (N, D),
    clamped to the grid."""
    rel = (q - grid.origin) * grid.inv_cell
    idx = torch.minimum(rel.to(torch.int32).clamp(min=0), grid.res_hi)
    lin = idx[..., 0].long()
    for d in range(1, len(grid.res)):
        lin = lin * grid.res[d] + idx[..., d]
    return lin


def grid_row_index(grid: CandidateGrid, q: torch.Tensor) -> torch.Tensor:
    """Each query's candidate row (int32) through the refinement levels:
    the level-0 cell from floor((q - origin) inv_cell), then one child
    per level from the fraction within the cell (clipped to 1 - 1e-7, so
    a point on a cell border stays in its floor cell)."""
    dim = len(grid.res)
    rel = (q - grid.origin) * grid.inv_cell
    idx = torch.minimum(torch.floor(rel).to(torch.int32).clamp(min=0),
                        grid.res_hi)
    lin = idx[..., 0].long()
    for d in range(1, dim):
        lin = lin * grid.res[d] + idx[..., d]
    frac = torch.clamp(rel - idx.to(rel.dtype), 0.0, 1.0 - 1e-7)
    row = grid.meta_t[0][lin]
    for lvl in range(1, len(grid.meta_t)):
        need = row < 0
        bits = frac >= 0.5
        sub = bits[..., 0].to(torch.int32)
        for d in range(1, dim):
            sub = sub + (bits[..., d].to(torch.int32) << d)
        child = (-row - 1) * (2 ** dim) + sub
        child = child.clamp(0, grid.meta_t[lvl].shape[0] - 1)
        row = torch.where(need, grid.meta_t[lvl][child.long()], row)
        frac = torch.where(frac >= 0.5, frac * 2.0 - 1.0, frac * 2.0)
    return torch.clamp(row, min=0)


def _trunc_fallback(grid: CandidateGrid, row: torch.Tensor, d: torch.Tensor):
    """A truncated row (over K, nearest K kept) can overestimate the
    distance: its cell's lower bound stands in there (valid for a star
    radius)."""
    r = row.long()
    return torch.where(grid.row_trunc[r], grid.row_lbound[r], d)


def _bare_rows_3d(grid: CandidateGrid, q, cand):
    """A whole 3D row of at most BARE_ROW_MAX slots on gathered corners,
    the reference's dense prim_closest_point sweep: (distance, winning
    slot's prim id, -1 where the row holds none)."""
    safe = cand.clamp(min=0).long()
    corner = [grid.verts[grid.indices[:, k][safe]] for k in range(3)]
    d, _ = prim_closest_point(3, q[:, None, :], corner)
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    j = torch.argmin(d, dim=1, keepdim=True)                # first minimum
    return d.gather(1, j)[:, 0], cand.gather(1, j)[:, 0]


def _planar_rows(grid: CandidateGrid, q, cand):
    """Wider rows: BARE_ROW_MAX slots at a time on coordinate planes,
    keeping the running (d^2, prim) on a strict < (the reference's planar
    sweep, but over every slot of the row: the reference sweeps K // 128
    chunks and skips the tail of a row whose K is not a multiple)."""
    kc = BARE_ROW_MAX
    dim = len(grid.res)
    n, K = cand.shape
    qc = tuple(q[:, d:d + 1] for d in range(dim))
    planes = [grid.verts[:, d] for d in range(dim)]
    cols = [grid.indices[:, k] for k in range(dim)]
    best_d2 = torch.full((n,), float("inf"), device=q.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=q.device)
    for k0 in range(0, K, kc):
        c = cand[:, k0:k0 + kc]
        safe = c.clamp(min=0).long()
        corner = [planes[d][cols[k][safe]] for k in range(dim)
                  for d in range(dim)]
        if dim == 2:
            ax, ay, bx, by = corner
            d2 = seg_d2(qc[0] - ax, qc[1] - ay, bx - ax, by - ay)[0]
        else:
            d2 = tri_d2_planes(qc, corner)
        d2 = torch.where(c >= 0, d2, torch.full_like(d2, float("inf")))
        j = torch.argmin(d2, dim=1, keepdim=True)           # first minimum
        d_c = d2.gather(1, j)[:, 0]
        better = d_c < best_d2
        best_d2 = torch.where(better, d_c, best_d2)
        best_i = torch.where(better, c.gather(1, j)[:, 0], best_i)
    return torch.sqrt(best_d2), best_i


def _grid_closest_point_bare(grid: CandidateGrid, q, row):
    """The chain path's sweep on a grid without a coordinate table (the
    reference's ``_grid_closest_point_xla``): in 2D with rows of at most
    BARE_ROW_MAX slots, K12 over every lane in one launch, reading the
    rows and the segment table itself; else each lane's row of prim ids
    and their corners gathered, in lane chunks of _BARE_CHUNK_SLOTS
    slots.  (distance (N,), prim id (N,) int32)."""
    n = q.shape[0]
    K = grid.cand.shape[1]
    if len(grid.res) == 2 and K <= BARE_ROW_MAX:
        from ..ops.queries import candidate_rows  # it imports this module

        return candidate_rows(q.contiguous(), row.contiguous(), grid.cand,
                              grid.seg)
    sweep = _bare_rows_3d if K <= BARE_ROW_MAX else _planar_rows
    dist = torch.empty((n,), dtype=torch.float32, device=q.device)
    pid = torch.empty((n,), dtype=torch.int32, device=q.device)
    m = max(1, _BARE_CHUNK_SLOTS // K)
    for c0 in range(0, n, m):
        dist[c0:c0 + m], pid[c0:c0 + m] = sweep(
            grid, q[c0:c0 + m], grid.cand[row[c0:c0 + m].long()])
    return dist, pid


def grid_closest_point_detail(grid: CandidateGrid, q: torch.Tensor,
                              row: torch.Tensor | None = None):
    """The exact closest prim through the chain path: (distance (N,),
    prim id (N,) int32, the winner's corners as a tuple of dim (N, D)
    tensors).  The row is swept by K10 (2D) or K11 (3D) over the
    coordinate table; a bare grid takes ``_grid_closest_point_bare`` (its
    prim id is -1 where a row holds none, as the reference's).  Truncated
    rows give their lower bound."""
    dim = len(grid.res)
    K = grid.cand.shape[1]
    if row is None:
        row = grid_row_index(grid, q)
    if grid.coords is None:
        d, pid = _grid_closest_point_bare(grid, q, row)
        safe = pid.clamp(min=0).long()
        pv = tuple(grid.verts[grid.indices[safe, k]] for k in range(dim))
        return _trunc_fallback(grid, row, d), pid, pv
    band = grid_band_2d if dim == 2 else grid_band_3d
    d2, slot, corners = band(row.contiguous(), q.contiguous(), grid.coords)
    pid = torch.clamp(grid.cand[row.long(), slot.long().clamp(max=K - 1)],
                      min=0)
    pv = tuple(corners[:, k * dim:(k + 1) * dim] for k in range(dim))
    return _trunc_fallback(grid, row, torch.sqrt(d2)), pid, pv


def grid_closest_point(grid: CandidateGrid, q: torch.Tensor,
                       row: torch.Tensor | None = None):
    """(distance (N,), prim id (N,)) through the chain path: exact for
    in-grid queries whenever every leaf band fit K; out-of-grid queries
    take the clamped border cell's candidates."""
    d, pid, _ = grid_closest_point_detail(grid, q, row)
    return d, pid
