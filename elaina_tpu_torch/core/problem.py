"""Problem (scene) layer: config -> boundary geometry, colors, grid.

Port of ``elaina_tpu/core/problem.py`` for the 2D uniform slice: OBJ
Dirichlet and Neumann boundaries with two-sided vertex colors, the
evaluation grid, and the Dirichlet candidate grid (always built; the
slice has no BVH query).  The scene's tensors live on the device passed
in; the solver works wherever they are.

Every set takes the same grid and resolve: a 512-cell level 0, and the
FinePack's need bit chooses the lanes that the kernels resolve exactly.
Rows are as wide as the set when it has fewer than K = 256 segments,
since a row never holds more.  A 64-cell level 0 for small sets was
tried and is wrong at depth 64: its one-level FinePack is as coarse as
the cells, so its bound falls a cell diagonal short of the distance, and
on the 64-segment circle of ``tests/test_torch_slice.py`` walks took 2.6x
the steps, more of them met the depth cap, and the image's mean fell to
0.452 against 0.486 with every lane resolved (1.1e-3 standard error,
CPU).  At depth 512, or on the 512-cell level 0, it gives 0.487.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..geometry.geomset import GeomSet, make_geom_set
from ..geometry.grid import (CandidateGrid, build_candidate_grid,
                             fine_pack_from_numpy, grid_from_numpy, padded_k)
from ..geometry.native import load_obj_native
from ..geometry.queries import check_dense
from .config import json_get_optional, json_get_or_throw, load_json_file
from .evaluation_grid import EvaluationGrid
from .logger import log_info, log_success, log_warning

GRID_K = 256
GRID_MAX_RES = 2048


@dataclass
class Boundary:
    gs: GeomSet
    colors: torch.Tensor      # (V, 2, 3) f32: (side >= 0, side < 0) pairs


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

    @property
    def device(self) -> torch.device:
        b = self.dirichlet or self.neumann
        return b.gs.verts.device


def grid_size_for(n_prims: int) -> tuple[int, int]:
    """(K, max_res) of the candidate grid for a set of n_prims segments."""
    return min(GRID_K, padded_k(n_prims)), GRID_MAX_RES


def grid_bounds(verts: np.ndarray, aabb_lo, aabb_hi):
    """The grid's box: the scene box and the boundary, with a 5% margin."""
    lo = np.asarray(aabb_lo, np.float32)
    hi = np.asarray(aabb_hi, np.float32)
    margin = 0.05 * (hi - lo)
    return (np.minimum(lo, verts.min(0)) - margin,
            np.maximum(hi, verts.max(0)) + margin)


def _boundary(verts, indices, colors, device) -> Boundary:
    return Boundary(gs=make_geom_set(verts, indices, device),
                    colors=torch.as_tensor(np.require(colors, np.float32,
                                                      ("C", "W")),
                                           device=device))


def scene_from_numpy(*, aabb_lo, aabb_hi, device: torch.device,
                     dirichlet=None, neumann=None, grid=None, fine=None,
                     dirichlet_intensity: float = 1.0,
                     neumann_intensity: float = 1.0) -> Scene:
    """The port's Scene from numpy arrays.

    ``dirichlet`` / ``neumann``: (verts (V, 2), indices (P, 2), colors
    (V, 2, 3)).  ``grid``: a mapping with the candidate-grid arrays
    (cand, meta, row_lbound, row_diag, row_trunc, origin, inv_cell, res),
    required with a Dirichlet set.  ``fine`` (optional): the FinePack
    arrays (packed, origin, inv_cell, r0, res, s, eps); without it the
    integrator bakes one for its eps.
    """
    d_grid = None
    if dirichlet is not None:
        if grid is None:
            raise ValueError("a Dirichlet set needs its candidate grid")
        v, idx, col = dirichlet
        keys = ("cand", "meta", "row_lbound", "row_diag", "row_trunc",
                "origin", "inv_cell", "res")
        d_grid = grid_from_numpy(**{k: grid[k] for k in keys}, verts=v,
                                 indices=idx, colors=col, device=device)
        if fine is not None:
            d_grid.fine = fine_pack_from_numpy(**fine, device=device)
    scene = Scene(
        dirichlet=(_boundary(*dirichlet, device)
                   if dirichlet is not None else None),
        neumann=_boundary(*neumann, device) if neumann is not None else None,
        d_grid=d_grid,
        aabb_lo=np.asarray(aabb_lo, np.float32),
        aabb_hi=np.asarray(aabb_hi, np.float32),
        dirichlet_intensity=float(dirichlet_intensity),
        neumann_intensity=float(neumann_intensity))
    if scene.neumann is not None:
        check_dense(scene.neumann.gs)
    return scene


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
        if dim != 2:
            raise NotImplementedError(
                "3D scenes arrive with ROADMAP Queue 1 items 11-12 (3D)")
        self.dim = dim
        self.device = torch.device(device)
        self.verbose = verbose
        self.scene: Scene | None = None
        self.probe: EvaluationGrid | None = None
        self.mask = None
        self.stats: dict = {}

    def load_config(self, conf: dict, base_dir: str = ".",
                    cache_dir: str | None = None) -> "Problem":
        for key, item in (("source_path", "source and NanoVDB"),
                          ("mask_path", "other channels and masks")):
            if json_get_optional(conf, key):
                raise NotImplementedError(
                    f"{key!r} arrives with the ROADMAP item '{item}'")
        aabb_min = np.asarray(json_get_or_throw(conf, "aabb/min"), np.float32)
        aabb_max = np.asarray(json_get_or_throw(conf, "aabb/max"), np.float32)
        self.probe = EvaluationGrid.from_json(
            json_get_or_throw(conf, "evaluation_grid"), self.dim)
        mesh = json_get_or_throw(conf, "mesh")

        def resolve(p):
            return p if p is None or os.path.isabs(p) else os.path.join(
                base_dir, p)

        dirichlet = neumann = grid = None
        if json_get_optional(mesh, "dirichlet_path"):
            v, idx = load_obj_native(resolve(mesh["dirichlet_path"]), self.dim)
            colors = load_colors(resolve(json_get_optional(
                mesh, "vertex_color_dirichlet_path")), v.shape[0])
            dirichlet = (v, idx, colors)
            K, max_res = grid_size_for(idx.shape[0])
            lo, hi = grid_bounds(v, aabb_min, aabb_max)
            ga = build_candidate_grid(v, idx, lo, hi, K=K, max_res=max_res,
                                      cache_dir=cache_dir)
            grid = vars(ga)
            self.stats["dirichlet_vertices"] = v.shape[0]
            self.stats["dirichlet_primitives"] = idx.shape[0]
            self.stats["dirichlet_grid"] = (
                f"res={ga.res} levels={len(ga.meta)} rows={ga.cand.shape[0]} "
                f"K={K} coverage={ga.coverage:.0%}")
        if json_get_optional(mesh, "neumann_path"):
            v, idx = load_obj_native(resolve(mesh["neumann_path"]), self.dim)
            colors = load_colors(resolve(json_get_optional(
                mesh, "vertex_color_neumann_path")), v.shape[0])
            neumann = (v, idx, colors)
            self.stats["neumann_vertices"] = v.shape[0]
            self.stats["neumann_primitives"] = idx.shape[0]

        self.scene = scene_from_numpy(
            aabb_lo=aabb_min, aabb_hi=aabb_max, device=self.device,
            dirichlet=dirichlet, neumann=neumann, grid=grid,
            dirichlet_intensity=json_get_optional(
                conf, "dirichlet_intensity", 1.0),
            neumann_intensity=json_get_optional(
                conf, "neumann_intensity", 1.0))
        if self.verbose:
            log_success("Problem: loadConfig completed on %s.", self.device)
            for k, v in self.stats.items():
                log_info("  %s = %s", k, v)
        return self

    def table_bytes(self) -> dict:
        """Bytes of the Dirichlet tables on the device, by table."""
        g = self.scene.d_grid if self.scene is not None else None
        if g is None:
            return {}
        out = {name: t.numel() * t.element_size() for name, t in (
            ("cand", g.cand), ("coords", g.coords),
            ("color_rows", g.color_rows))}
        if g.fine is not None:
            out["finepack"] = g.fine.packed.numel() * 4
        return out
