"""Problem (scene) layer: config -> boundary geometry, colors, grids.

Port of ``elaina_tpu/core/problem.py`` for uniform WoSt in 2D and 3D: OBJ
Dirichlet and Neumann boundaries with two-sided vertex colors, the
evaluation grid, and the accelerators of one of two routes
(``load_config(accel=)``):

* ``"grid"`` (and ``"auto"``, on every device): the Dirichlet candidate
  grid with its coordinate table (built above ``GRID_ACCEL_MIN_PRIMS``
  prims, as the reference builds it on an accelerator; a smaller set
  takes ``geometry/queries.closest_point``), the silhouette and prim-band
  grids of a Neumann set (on the reference's bounds: in 3D always, since
  both grids give valid star radii at any set size; in 2D, as the
  reference, the silhouette grid above ``CHUNKED_DENSE_MAX`` entities and
  the prim-band grid above ``CHUNKED_DENSE_MAX`` prims, the dense and
  chunked sweeps below);
* ``"bvh"``: no grid; every set carries its trees (``make_geom_set(...,
  bvh=True)``), and above ``CHUNKED_DENSE_MAX`` prims or entities its
  queries descend them (kernels B1-B4), the sweeps below;

and the volumetric source (``source_path``: a
dense ``.npy`` / ``.npz`` array or a NanoVDB ``.nvdb`` grid, sampled
trilinearly), and the mask image (``mask_path``: a PNG whose pixels
with any nonzero channel are solved, read with ``output/image_io.
read_png``).  The scene's tensors live on the device passed in; the
solver works wherever they are.

The problem keeps the balanced solve's hints (reference problem.py:
234-300): each frame's per-pixel walk cost and the walk rates by lane
count, and the port's seconds an iteration by phase and lane width,
cached in memory and, for a scene loaded with a ``cache_dir``, in
``hints_<sha1>.npz`` there (the JAX package's file format, whose loader
skips the port's ``iter_`` keys, in the port's own cache, so that no
rate measured on another device seeds a solve).
They are hints only: a solve with or without them estimates the same
solution.

Every set with a grid takes the same grid and resolve: a 512-cell level 0
in 2D (64 in 3D), and the FinePack's need bit chooses the lanes that the
kernels resolve exactly.  Rows are as wide as the set when it has fewer
than K = 256 prims, since a row never holds more; the band grids' rows
likewise (K = 64 otherwise, the reference's).  In 2D a 64-cell level 0
for small sets was tried and is wrong at depth 64: its one-level
FinePack is as coarse as the cells, so its bound falls a cell diagonal
short of the distance, and
on the 64-segment circle of ``tests/test_torch_slice.py`` walks took 2.6x
the steps, more of them met the depth cap, and the image's mean fell to
0.452 against 0.486 with every lane resolved (1.1e-3 standard error,
CPU).  At depth 512, or on the 512-cell level 0, it gives 0.487.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import time
import zipfile
import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..geometry.bvh import median_split_depth
from ..geometry.geomset import LEAF_SIZE, GeomSet, make_geom_set
from ..geometry.grid import (BandGrid, CandidateGrid, attach_coords,
                             band_grid_from_numpy, build_candidate_grid,
                             build_prim_band_grid, build_silhouette_grid,
                             fine_pack_from_numpy, grid_from_numpy, padded_k,
                             sil_grid_from_numpy)
from ..geometry.native import load_obj_native, silhouette_entities_native
from ..geometry.queries import CHUNKED_DENSE_MAX
from ..ops.bvh import with_packs
from ..output.image_io import read_png
from .config import json_get_optional, json_get_or_throw, load_json_file
from .evaluation_grid import EvaluationGrid
from .logger import log_info, log_success, log_warning
from .nanovdb import read_nvdb

GRID_K = 256
BAND_K = 64
GRID_MAX_RES = 2048
GRID_ACCEL_MIN_PRIMS = 256   # a Dirichlet set of at most this many prims
#                              has no candidate grid (the reference's)
ACCELS = ("auto", "grid", "bvh")


@dataclass
class Boundary:
    gs: GeomSet
    colors: torch.Tensor      # (V, 2, 3) f32: (side >= 0, side < 0) pairs


@dataclass
class SourceGrid:
    """Dense volumetric source: world -> voxel affine and a trilinear
    (bilinear in 2D) fetch, clamped at the border.  ``data`` is (X, Y, 3)
    or (X, Y, Z, 3)."""

    data: torch.Tensor
    origin: torch.Tensor     # (D,) world position of voxel (0, ..., 0)
    inv_voxel: torch.Tensor  # (D,) 1 / voxel size
    hi: torch.Tensor         # (D,) int64 voxel counts - 1: the clamp
    corners: torch.Tensor    # (2^D, D) int64 the cell's corner offsets

    def sample(self, p: torch.Tensor) -> torch.Tensor:
        """Values (N, 3) at world points p (N, D).  The clamp and the
        corner offsets are the grid's own device tensors, so a depth step
        copies nothing from the host here (and never waits for the
        device)."""
        dim = p.shape[-1]
        idx_f = (p - self.origin) * self.inv_voxel
        i0 = torch.floor(idx_f).to(torch.int64)
        frac = idx_f - i0.to(idx_f.dtype)
        out = 0.0
        for k, corner in enumerate(itertools.product((0, 1), repeat=dim)):
            ii = torch.minimum((i0 + self.corners[k]).clamp(min=0), self.hi)
            w = torch.ones(p.shape[:-1], dtype=self.data.dtype,
                           device=p.device)
            for d in range(dim):
                w = w * (frac[..., d] if corner[d] else 1.0 - frac[..., d])
            out = out + w[..., None] * self.data[ii.unbind(-1)]
        return out


def source_from_numpy(data, origin, voxel, device) -> SourceGrid:
    data = np.asarray(data, np.float32)
    dim = data.ndim - 1
    return SourceGrid(
        data=torch.as_tensor(np.require(data, requirements=("C", "W")),
                             device=device),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        inv_voxel=torch.as_tensor(
            (1.0 / np.asarray(voxel, np.float32)).astype(np.float32),
            device=device),
        hi=torch.as_tensor(np.asarray(data.shape[:dim], np.int64) - 1,
                           device=device),
        corners=torch.as_tensor(np.asarray(list(itertools.product(
            (0, 1), repeat=dim)), np.int64), device=device))


def load_source(path: str, dim: int, device) -> SourceGrid:
    """The source grid of ``source_path`` (elaina_tpu/core/problem.py
    ``_load_source``): ``.npy`` (unit voxels at the origin) or ``.npz``
    (``data``, optional ``origin`` and ``voxel_size``), a scalar grid
    repeated to RGB; or a NanoVDB ``.nvdb``, whose 2D problems sample the
    world plane z = 0 (the z interpolation baked in at load)."""
    if path.endswith((".npy", ".npz")):
        if path.endswith(".npy"):
            data = np.load(path)
            origin = np.zeros(dim, np.float32)
            voxel = np.ones(dim, np.float32)
        else:
            z = np.load(path)
            data = z["data"]
            origin = np.asarray(z.get("origin", np.zeros(dim)), np.float32)
            voxel = np.asarray(z.get("voxel_size", np.ones(dim)), np.float32)
        if data.ndim == dim:
            data = np.repeat(data[..., None], 3, axis=-1)
        return source_from_numpy(data, origin, voxel, device)
    if path.endswith(".nvdb"):
        g = read_nvdb(path)
        data = g.values
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        voxel3 = g.voxel_size.astype(np.float32)
        origin3 = (g.world_offset + g.origin * g.voxel_size).astype(np.float32)
        if dim == 2:
            zf = float((0.0 - g.world_offset[2]) / g.voxel_size[2]
                       - g.origin[2])
            z0 = int(np.clip(np.floor(zf), 0, data.shape[2] - 1))
            z1 = int(np.clip(z0 + 1, 0, data.shape[2] - 1))
            fz = np.float32(np.clip(zf - z0, 0.0, 1.0))
            data = (1.0 - fz) * data[:, :, z0] + fz * data[:, :, z1]
            return source_from_numpy(data, origin3[:2], voxel3[:2], device)
        return source_from_numpy(data, origin3, voxel3, device)
    if path.endswith(".vdb"):
        raise NotImplementedError(
            f"{path!r}: OpenVDB .vdb needs pyopenvdb (not installed); "
            "convert to .nvdb (tools/make_source_grid.py --nvdb) or a "
            "dense .npz")
    raise ValueError(f"unsupported source file {path!r} (.npy, .npz, .nvdb)")


@dataclass
class Scene:
    dirichlet: Optional[Boundary]
    neumann: Optional[Boundary]
    d_grid: Optional[CandidateGrid]
    aabb_lo: np.ndarray
    aabb_hi: np.ndarray
    dim: int = 2
    dirichlet_intensity: float = 1.0
    neumann_intensity: float = 1.0
    n_sgrid: Optional[BandGrid] = None   # Neumann: silhouette grid
    n_bgrid: Optional[BandGrid] = None   # Neumann: prim-band grid
    source: Optional[SourceGrid] = None  # volumetric source term
    source_intensity: float = 1.0
    accel: str = "grid"                  # the route: "grid" or "bvh"

    @property
    def device(self) -> torch.device:
        b = self.dirichlet or self.neumann
        return b.gs.verts.device


def grid_size_for(n_prims: int) -> tuple[int, int]:
    """(K, max_res) of the candidate grid for a set of n_prims prims."""
    return min(GRID_K, padded_k(n_prims)), GRID_MAX_RES


def band_size_for(n: int) -> tuple[int, int]:
    """(K, max_res) of a band grid over n prims or entities."""
    return min(BAND_K, padded_k(n)), GRID_MAX_RES


def grid_bounds(verts: np.ndarray, aabb_lo, aabb_hi):
    """The grid's box: the scene box and the boundary, with a 5% margin."""
    lo = np.asarray(aabb_lo, np.float32)
    hi = np.asarray(aabb_hi, np.float32)
    margin = 0.05 * (hi - lo)
    return (np.minimum(lo, verts.min(0)) - margin,
            np.maximum(hi, verts.max(0)) + margin)


def _boundary(verts, indices, colors, device, bvh: bool = False,
              silhouettes: bool = True) -> Boundary:
    return Boundary(gs=with_packs(make_geom_set(verts, indices, device, bvh,
                                                silhouettes)),
                    colors=torch.as_tensor(np.require(colors, np.float32,
                                                      ("C", "W")),
                                           device=device))


def scene_from_numpy(*, aabb_lo, aabb_hi, device: torch.device,
                     dirichlet=None, neumann=None, grid=None, fine=None,
                     sgrid=None, bgrid=None, source=None,
                     dirichlet_intensity: float = 1.0,
                     neumann_intensity: float = 1.0,
                     source_intensity: float = 1.0,
                     bvh: bool = False) -> Scene:
    """The port's Scene from numpy arrays.

    ``dirichlet`` / ``neumann``: (verts (V, D), indices (P, D), colors
    (V, 2, 3)), segments in 2D and triangles in 3D.  ``grid`` (optional):
    a mapping with the candidate-grid arrays (cand, meta, row_lbound,
    row_diag, row_trunc, origin, inv_cell, res); the scene's grid carries
    its coordinate table.  Without it the Dirichlet set takes
    ``closest_point``.  ``fine`` (optional): the FinePack arrays (packed,
    origin, inv_cell, r0, res, s, eps); without it the integrator bakes
    one for its eps.  ``sgrid`` / ``bgrid``: mappings with the fields of
    ``BandArrays`` for the silhouette and prim-band grids, required with a
    3D Neumann set on the grid route and optional with a 2D one (each
    replaces its dense or chunked sweeps).  ``source`` (optional): a
    ``SourceGrid``.  ``bvh``: the BVH route, every set with its trees (the
    Dirichlet set without the silhouette entities' tree, which nothing
    queries) and no grid given.
    """
    if bvh and any(x is not None for x in (grid, fine, sgrid, bgrid)):
        raise ValueError("the BVH route takes no grid")
    d_grid = None
    if dirichlet is not None and grid is not None:
        v, idx, col = dirichlet
        keys = ("cand", "meta", "row_lbound", "row_diag", "row_trunc",
                "origin", "inv_cell", "res")
        d_grid = attach_coords(grid_from_numpy(
            **{k: grid[k] for k in keys}, verts=v, indices=idx, colors=col,
            device=device))
        if fine is not None:
            d_grid.fine = fine_pack_from_numpy(**fine, device=device)
    n_bound = (_boundary(*neumann, device, bvh) if neumann is not None
               else None)
    aabb_lo = np.asarray(aabb_lo, np.float32)
    if (n_bound is not None and n_bound.gs.dim == 3 and not bvh
            and (sgrid is None or bgrid is None)):
        raise ValueError("a 3D Neumann set needs its silhouette and "
                         "prim-band grids, or the BVH route")
    n_sgrid = (sil_grid_from_numpy(sgrid, n_bound.gs, device)
               if n_bound is not None and sgrid is not None else None)
    n_bgrid = (band_grid_from_numpy(bgrid, neumann[0], neumann[1], device)
               if n_bound is not None and bgrid is not None else None)
    return Scene(
        dirichlet=(_boundary(*dirichlet, device, bvh, silhouettes=False)
                   if dirichlet is not None else None),
        neumann=n_bound, d_grid=d_grid, aabb_lo=aabb_lo,
        aabb_hi=np.asarray(aabb_hi, np.float32), dim=aabb_lo.shape[0],
        dirichlet_intensity=float(dirichlet_intensity),
        neumann_intensity=float(neumann_intensity),
        n_sgrid=n_sgrid, n_bgrid=n_bgrid, source=source,
        source_intensity=float(source_intensity),
        accel="bvh" if bvh else "grid")


def _parse_vertex_colors(path: str, n_verts: int) -> np.ndarray:
    """Two-sided vertex color pairs from the reference's JSON schema."""
    colors = np.zeros((n_verts, 2, 3), np.float32)
    entries = json_get_or_throw(load_json_file(path), "ColorConfigurations")
    for i, e in enumerate(entries):
        if int(json_get_or_throw(e, "vertexID")) != i + 1:
            raise ValueError("ColorConfigurations must be sorted by vertexID")
        colors[i, 0] = [e["leftColor"][c] for c in "RGB"]
        colors[i, 1] = [e["rightColor"][c] for c in "RGB"]
    return colors


def load_colors(path, n_verts: int) -> np.ndarray:
    """(V, 2, 3) colors from .npz (``colors``, or ``left``/``right``) or
    JSON; a missing file gives zeros, as in the reference."""
    if path and os.path.exists(path):
        if path.endswith(".npz"):
            z = np.load(path)
            if "colors" in z:
                return np.asarray(z["colors"], np.float32)
            left = np.asarray(z["left"], np.float32)
            right = np.asarray(z["right"] if "right" in z else left,
                               np.float32)
            return np.stack([left, right], axis=1)
        return _parse_vertex_colors(path, n_verts)
    if path:
        log_warning("vertex color file missing: %s (using zeros)", path)
    return np.zeros((n_verts, 2, 3), np.float32)


class Problem:
    """Host-side scene owner: loads a config, builds the device scene."""

    def __init__(self, dim: int, device: torch.device, verbose: bool = True):
        if dim not in (2, 3):
            raise ValueError(f"dimensionality {dim}: 2 or 3")
        self.dim = dim
        self.device = torch.device(device)
        self.verbose = verbose
        self.scene: Scene | None = None
        self.probe: EvaluationGrid | None = None
        self.mask = None
        self.stats: dict = {}
        self.cache_dir: str | None = None
        # the JAX Problem's traversal stacks: the sets' tree depth + 4
        self.d_stack = 48
        self.n_stack = 48

    # -- the balanced solve's hints (reference problem.py:234-300) --------

    def _hint_path(self) -> str | None:
        """``hints_<key>.npz`` under ``cache_dir``, keyed by the first 64
        Dirichlet vertices, their count and the dimension, as the JAX
        package keys it, and, where the scene has them, the first 64
        Neumann vertices and their count and the source grid's shape and
        first 64 values: the walks' costs and rates are the whole scene's
        (one Dirichlet set in a wavy Neumann box of 8,192 segments walks
        several times slower an iteration than in a box of 4); on the BVH
        route also the route's name, since an iteration's seconds on one
        route do not predict the other's.  None without a cache dir or a
        Dirichlet set."""
        scene = self.scene
        if not self.cache_dir or scene is None or scene.dirichlet is None:
            return None

        def head(t: torch.Tensor) -> bytes:
            return t.reshape(t.shape[0], -1)[:64].cpu().numpy().astype(
                np.float32).tobytes()

        verts = scene.dirichlet.gs.verts
        data = head(verts) + np.int64([verts.shape[0], self.dim]).tobytes()
        if scene.neumann is not None:
            nv = scene.neumann.gs.verts
            data += head(nv) + np.int64([nv.shape[0]]).tobytes()
        if scene.source is not None:
            src = scene.source.data
            data += head(src.reshape(-1, 1)) + np.int64(src.shape).tobytes()
        if scene.accel != "grid":
            data += f"accel={scene.accel}".encode()
        key = hashlib.sha1(data).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"hints_{key}.npz")

    def hint_cache_load(self) -> None:
        """Fill the cost and rate caches from the hint file, once, without
        replacing an entry this process measured.  A truncated or corrupt
        file is ignored (a hint is never worth a failed solve)."""
        path = self._hint_path()
        if not path or not os.path.exists(path) or getattr(
                self, "_hints_loaded", False):
            return
        self._hints_loaded = True
        cost = self.__dict__.setdefault("_cost_cache", {})
        rate = self.__dict__.setdefault("_rate_cache", {})
        try:
            # the members decompress as they are read: keep every read
            # inside
            with np.load(path, allow_pickle=False) as z:
                for k in z.files:
                    parts = k.split("_")
                    if k.startswith("cost_"):
                        cost.setdefault((int(parts[1]), float(parts[2]),
                                         int(parts[3])), np.asarray(z[k]))
                    elif k.startswith("ratetrain_"):
                        rate.setdefault(("train", int(parts[1])),
                                        float(z[k]))
                    elif k.startswith("iter_"):
                        rate.setdefault(("iter", int(parts[1]),
                                         int(parts[2])), float(z[k]))
                    elif k.startswith("rate_"):
                        rate.setdefault(int(parts[1]), float(z[k]))
        except (OSError, EOFError, ValueError, IndexError, KeyError,
                zipfile.BadZipFile, zlib.error) as e:
            log_warning("hint file %s unreadable (%s); solving without it",
                        path, e)

    def hint_cache_save(self) -> None:
        """Write the cost and rate caches to the hint file, atomically (a
        temporary file renamed over it)."""
        path = self._hint_path()
        if not path:
            return
        payload = {}
        for k, v in self.__dict__.get("_cost_cache", {}).items():
            payload[f"cost_{k[0]}_{k[1]}_{k[2]}"] = np.asarray(v, np.float32)
        for k, v in self.__dict__.get("_rate_cache", {}).items():
            if not isinstance(k, tuple):
                payload[f"rate_{k}"] = np.float64(v)
            elif k[0] == "train":
                payload[f"ratetrain_{k[1]}"] = np.float64(v)
            else:
                payload[f"iter_{k[1]}_{k[2]}"] = np.float64(v)
        if payload:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # the temporary name keeps the .npz suffix (np.savez adds it)
            tmp = path[:-4] + f".tmp{os.getpid()}.npz"
            np.savez_compressed(tmp, **payload)
            os.replace(tmp, path)

    def load_config(self, conf: dict, base_dir: str = ".",
                    cache_dir: str | None = None,
                    accel: str = "auto") -> "Problem":
        """``accel``: "grid" builds the grids (the default route),
        "bvh" builds none and gives every set its trees (the traversal
        kernels serve above CHUNKED_DENSE_MAX prims or entities), "auto"
        is "grid" on every device (the JAX package takes "bvh" on its
        1-core CPU; the port's CPU runs its tests, on the default
        route)."""
        if accel not in ACCELS:
            raise ValueError(f"accel {accel!r}: one of {ACCELS}")
        bvh = accel == "bvh"
        self.stats["accel"] = "bvh" if bvh else "grid"
        self.cache_dir = cache_dir
        aabb_min = np.asarray(json_get_or_throw(conf, "aabb/min"), np.float32)
        aabb_max = np.asarray(json_get_or_throw(conf, "aabb/max"), np.float32)
        self.probe = EvaluationGrid.from_json(
            json_get_or_throw(conf, "evaluation_grid"), self.dim)
        mesh = json_get_or_throw(conf, "mesh")

        def resolve(p):
            return p if p is None or os.path.isabs(p) else os.path.join(
                base_dir, p)

        dirichlet = neumann = grid = sgrid = bgrid = None
        if json_get_optional(mesh, "dirichlet_path"):
            v, idx = load_obj_native(resolve(mesh["dirichlet_path"]), self.dim)
            colors = load_colors(resolve(json_get_optional(
                mesh, "vertex_color_dirichlet_path")), v.shape[0])
            dirichlet = (v, idx, colors)
            self.stats["dirichlet_vertices"] = v.shape[0]
            self.stats["dirichlet_primitives"] = idx.shape[0]
            self.d_stack = median_split_depth(idx.shape[0], LEAF_SIZE) + 4
            if bvh:
                self.stats["dirichlet_grid"] = "none (accel=bvh: its tree)"
            elif idx.shape[0] > GRID_ACCEL_MIN_PRIMS:
                K, max_res = grid_size_for(idx.shape[0])
                lo, hi = grid_bounds(v, aabb_min, aabb_max)
                t0 = time.time()
                ga = build_candidate_grid(v, idx, lo, hi, K=K,
                                          max_res=max_res,
                                          cache_dir=cache_dir)
                grid = vars(ga)
                self.stats["dirichlet_grid"] = (
                    f"res={ga.res} levels={len(ga.meta)} "
                    f"rows={ga.cand.shape[0]} K={K} "
                    f"coverage={ga.coverage:.0%} "
                    f"truncated={int(ga.row_trunc.sum())} "
                    f"built_s={time.time() - t0:.1f}")
            else:
                self.stats["dirichlet_grid"] = (
                    f"none (at most {GRID_ACCEL_MIN_PRIMS} prims: the dense "
                    f"sweep)")
        if json_get_optional(mesh, "neumann_path"):
            v, idx = load_obj_native(resolve(mesh["neumann_path"]), self.dim)
            colors = load_colors(resolve(json_get_optional(
                mesh, "vertex_color_neumann_path")), v.shape[0])
            neumann = (v, idx, colors)
            self.stats["neumann_vertices"] = v.shape[0]
            self.stats["neumann_primitives"] = idx.shape[0]
            self.n_stack = median_split_depth(idx.shape[0], LEAF_SIZE) + 4
            if not bvh:
                sgrid, bgrid = self.neumann_grids(v, idx, aabb_min,
                                                  aabb_max, cache_dir)

        source = None
        if json_get_optional(conf, "source_path"):
            source = load_source(resolve(conf["source_path"]), self.dim,
                                 self.device)
            self.stats["source_shape"] = tuple(source.data.shape)

        mask_path = json_get_optional(conf, "mask_path")
        if mask_path:
            # (H, W) bool: a pixel is solved where its RGB is not all zero
            # (reference problem.cu:215-249); the integrator resizes it
            img = read_png(resolve(mask_path))
            self.mask = np.any(img != 0, axis=-1)

        self.scene = scene_from_numpy(
            aabb_lo=aabb_min, aabb_hi=aabb_max, device=self.device,
            dirichlet=dirichlet, neumann=neumann, grid=grid, sgrid=sgrid,
            bgrid=bgrid, source=source,
            dirichlet_intensity=json_get_optional(
                conf, "dirichlet_intensity", 1.0),
            neumann_intensity=json_get_optional(
                conf, "neumann_intensity", 1.0),
            source_intensity=json_get_optional(
                conf, "source_intensity", 1.0), bvh=bvh)
        for name, b in (("dirichlet", self.scene.dirichlet),
                        ("neumann", self.scene.neumann)):
            if b is not None and b.gs.has_tree:
                self.stats[f"{name}_tree"] = (
                    f"nodes={b.gs.left.shape[0]} depth={b.gs.depth} "
                    f"measures={b.gs.node_measure is not None} "
                    f"silhouette_depth={b.gs.sil_depth}")
        if self.verbose:
            log_success("Problem: loadConfig completed on %s.", self.device)
            for k, v in self.stats.items():
                log_info("  %s = %s", k, v)
        return self

    def neumann_grids(self, v, idx, aabb_min, aabb_max, cache_dir,
                      every: bool = False):
        """The silhouette and prim-band grids' arrays of a Neumann set, on
        the reference's bounds and keys (elaina_tpu/core/problem.py:
        393-439): in 3D both; in 2D the silhouette grid above
        CHUNKED_DENSE_MAX entities and the prim-band grid above
        CHUNKED_DENSE_MAX prims (None where the sweeps serve), or both
        with ``every``."""
        sil = silhouette_entities_native(v, idx)
        p0, p1 = sil["p0"], sil["p1"]
        margin = 0.05 * (aabb_max - aabb_min)
        sgrid = bgrid = None
        if every or self.dim == 3 or p0.shape[0] > CHUNKED_DENSE_MAX:
            t0 = time.time()
            K, max_res = band_size_for(p0.shape[0])
            sgrid = build_silhouette_grid(
                p0, p1, sil["n1"], sil["n2"], sil["always"],
                np.minimum(np.minimum(aabb_min, p0.min(0)), p1.min(0))
                - margin,
                np.maximum(np.maximum(aabb_max, p0.max(0)), p1.max(0))
                + margin, K=K, max_res=max_res, cache_dir=cache_dir)
            self.stats["neumann_sil_grid"] = (
                f"res={sgrid.res} K={sgrid.rows.shape[1]} "
                f"entities={p0.shape[0]} always={int(sil['always'].sum())} "
                f"built_s={time.time() - t0:.1f}")
            sgrid = vars(sgrid)
        if every or self.dim == 3 or idx.shape[0] > CHUNKED_DENSE_MAX:
            t0 = time.time()
            K, max_res = band_size_for(idx.shape[0])
            bgrid = build_prim_band_grid(v, idx, aabb_min - margin,
                                         aabb_max + margin, K=K,
                                         max_res=max_res,
                                         cache_dir=cache_dir)
            self.stats["neumann_band_grid"] = (
                f"res={bgrid.res} K={bgrid.rows.shape[1]} "
                f"r_cap_min={float(bgrid.r_cap.min()):.4g} "
                f"built_s={time.time() - t0:.1f}")
            bgrid = vars(bgrid)
        return sgrid, bgrid

    def table_bytes(self) -> dict:
        """Bytes of the scene's grid tables on the device, by table."""
        if self.scene is None:
            return {}
        out = {}
        g = self.scene.d_grid
        if g is not None:
            out.update({name: t.numel() * t.element_size() for name, t in (
                ("cand", g.cand), ("coords", g.coords),
                ("color_rows", g.color_rows)) if t is not None})
            if g.fine is not None:
                out["finepack"] = g.fine.packed.numel() * 4
        for name, b in (("dirichlet", self.scene.dirichlet),
                        ("neumann", self.scene.neumann)):
            if b is not None and b.gs.has_tree:
                out[f"{name}_tree"] = b.gs.tree_bytes()
                out[f"{name}_packs"] = b.gs.pack_bytes()
        for prefix, bg in (("sil", self.scene.n_sgrid),
                           ("band", self.scene.n_bgrid)):
            if bg is not None:
                out[f"{prefix}_rows"] = bg.rows.numel() * 4
                if bg.coords is not None:
                    out[f"{prefix}_coords"] = bg.coords.numel() * 4
        return out
