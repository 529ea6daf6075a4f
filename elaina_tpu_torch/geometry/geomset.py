"""GeomSet: one boundary set (Dirichlet or Neumann) as tensors on a device.

Port of ``elaina_tpu/geometry/geomset.py`` without the BVH and the
hierarchical-query fields: the port reaches large sets only through its
grids (the candidate grid, and in 3D the silhouette and prim-band grids)
and small 2D Neumann sets through dense sweeps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .native import silhouette_entities_native


@dataclass
class GeomSet:
    verts: torch.Tensor          # (V, D) f32
    indices: torch.Tensor        # (P, dim) int64
    prim_normal: torch.Tensor    # (P, D) f32
    prim_measure: torch.Tensor   # (P,) f32 segment length / triangle area
    sil_p0: torch.Tensor         # (E, D) silhouette entities: 2D vertices,
    sil_p1: torch.Tensor         # (E, D)   3D edges p0-p1
    sil_n1: torch.Tensor         # (E, D) normals of the adjacent prims
    sil_n2: torch.Tensor         # (E, D)
    sil_always: torch.Tensor     # (E,) bool open ends / boundary edges

    @property
    def dim(self) -> int:
        return int(self.indices.shape[1])

    @property
    def n_prims(self) -> int:
        return int(self.indices.shape[0])

    def prim_verts(self, pid: torch.Tensor):
        """Corner tuple of (..., D) at prim ids (negatives -> 0).
        Column by column: PyTorch's row gather of the (P, 2) int64 table
        took ~0.6 ms at 1M lanes on an H100 (PERF.md)."""
        p = torch.clamp(pid, min=0)
        return tuple(self.verts[self.indices[p, k]] for k in range(self.dim))


def make_geom_set(verts: np.ndarray, indices: np.ndarray,
                  device: torch.device) -> GeomSet:
    """verts (V, D) and indices (P, D) of segments (D = 2) or triangles
    (D = 3); the normal and measure as the reference computes them."""
    verts = np.asarray(verts, np.float32)
    indices = np.asarray(indices, np.int32)
    dim = indices.shape[1]
    if dim not in (2, 3) or verts.shape[1] != dim:
        raise ValueError(f"verts {verts.shape} / indices {indices.shape}: "
                         f"expected segments in 2D or triangles in 3D")
    pv = verts[indices]                                   # (P, dim, D)
    if dim == 2:
        e = pv[:, 1] - pv[:, 0]
        n = np.stack([-e[:, 1], e[:, 0]], axis=-1)
        measure = np.linalg.norm(e, axis=-1)
    else:
        n = np.cross(pv[:, 1] - pv[:, 0], pv[:, 2] - pv[:, 0])
        measure = 0.5 * np.linalg.norm(n, axis=-1)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    sil = silhouette_entities_native(verts, indices)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.require(a, requirements=("C", "W")),
                               dtype=dtype, device=device)

    return GeomSet(
        verts=t(verts), indices=t(indices, torch.int64),
        prim_normal=t(n.astype(np.float32)),
        prim_measure=t(measure.astype(np.float32)),
        sil_p0=t(sil["p0"]), sil_p1=t(sil["p1"]), sil_n1=t(sil["n1"]),
        sil_n2=t(sil["n2"]), sil_always=t(sil["always"], torch.bool))
