"""GeomSet: one boundary set (Dirichlet or Neumann) as tensors on a device.

Port of ``elaina_tpu/geometry/geomset.py``.  The BVH fields are built on
the BVH route only (``make_geom_set(..., bvh=True)``, which
``Problem.load_config(accel="bvh")`` asks for), as the JAX package builds
them: the prim tree and its leaf table, the subtree measures above
``CHUNKED_DENSE_MAX`` prims (the in-ball sample's descent), and above
``CHUNKED_DENSE_MAX`` silhouette entities their own tree with SNCH
normal cones; and, built from those on the device by the ops layer
(``ops/bvh.with_packs``), the packed forms B1 and B4 read.  The
queries descend them above that count.  On the grid
route they are None, and the grids and the dense and chunked sweeps
serve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bvh as bvh_mod
from .native import silhouette_entities_native

LEAF_SIZE = 4
CHUNKED_DENSE_MAX = 4096   # the traversals serve above this many prims or
#                            entities (geometry/queries.py)
MAX_STACK = 64             # the traversal kernels' stack (csrc/bvh.cu)
TREE_FIELDS = ("bb_min", "bb_max", "left", "right", "leaf_prims", "corners",
               "node_measure", "sil_bb_min", "sil_bb_max", "sil_left",
               "sil_right", "sil_leaf", "sil_cone_axis", "sil_cone_cos")
PACK_FIELDS = ("node_pack", "leaf_pack", "sil_node_pack", "sil_ent_pack")


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
    # the BVH route's trees (None on the grid route)
    bb_min: torch.Tensor | None = None       # (M, D) node bounds
    bb_max: torch.Tensor | None = None
    left: torch.Tensor | None = None         # (M,) i32 children, -1 at a
    right: torch.Tensor | None = None        #   leaf
    leaf_prims: torch.Tensor | None = None   # (M, LEAF_SIZE) i32, -1 pad
    corners: torch.Tensor | None = None      # (P, dim * D) prim corners
    depth: int = -1                          # the prim tree's depth
    node_measure: torch.Tensor | None = None  # (M,) subtree prim measure
    sil_bb_min: torch.Tensor | None = None   # (Ms, D) entity tree
    sil_bb_max: torch.Tensor | None = None
    sil_left: torch.Tensor | None = None     # (Ms,) i32
    sil_right: torch.Tensor | None = None
    sil_leaf: torch.Tensor | None = None     # (Ms, LEAF_SIZE) i32, -1 pad
    sil_cone_axis: torch.Tensor | None = None  # (Ms, D) unit
    sil_cone_cos: torch.Tensor | None = None   # (Ms,) <= -1.5: no prune
    sil_depth: int = -1
    # B1's and B4's packed trees (``ops/bvh.with_packs`` builds them from
    # the fields above; None until then): (rows, width) int32 words,
    # floats by their bits
    node_pack: torch.Tensor | None = None      # (M, 4 D + 4) children
    leaf_pack: torch.Tensor | None = None      # (L, ...) corners and ids
    sil_node_pack: torch.Tensor | None = None  # (Ms, ...) cones, children
    sil_ent_pack: torch.Tensor | None = None   # (Ls, ...) entities

    @property
    def dim(self) -> int:
        return int(self.indices.shape[1])

    @property
    def n_prims(self) -> int:
        return int(self.indices.shape[0])

    @property
    def has_tree(self) -> bool:
        """The prim tree is there (the BVH route)."""
        return self.left is not None

    @property
    def stack_size(self) -> int:
        """The prim traversal's stack, depth + 4 (the JAX Problem's
        d_stack / n_stack)."""
        return self.depth + 4

    def tree_bytes(self) -> int:
        """Bytes of the trees' tensors on the device."""
        return sum(t.numel() * t.element_size() for t in (
            getattr(self, k) for k in TREE_FIELDS) if t is not None)

    def pack_bytes(self) -> int:
        """Bytes of B1's and B4's packed trees on the device."""
        return sum(t.numel() * t.element_size() for t in (
            getattr(self, k) for k in PACK_FIELDS) if t is not None)

    def prim_verts(self, pid: torch.Tensor):
        """Corner tuple of (..., D) at prim ids (negatives -> 0).
        Column by column: PyTorch's row gather of the (P, 2) int64 table
        took ~0.6 ms at 1M lanes on an H100 (PERF.md)."""
        p = torch.clamp(pid, min=0)
        return tuple(self.verts[self.indices[p, k]] for k in range(self.dim))


def _check_depth(depth: int, what: str) -> None:
    if depth + 4 > MAX_STACK:
        raise ValueError(f"{what} of depth {depth}: its traversal needs a "
                         f"stack of {depth + 4}, above the kernels' "
                         f"{MAX_STACK}")


def tree_depth(left: np.ndarray, right: np.ndarray) -> int:
    """A flattened tree's depth from its child ids (a child's id is above
    its parent's, so one forward pass sets every node's level)."""
    left, right = np.asarray(left), np.asarray(right)
    level = np.zeros(left.shape[0], np.int64)
    for nid in np.nonzero(left >= 0)[0]:
        level[left[nid]] = level[right[nid]] = level[nid] + 1
    return int(level.max()) if level.size else 0


def _tree_arrays(verts, indices, measure, sil) -> dict:
    """The JAX package's tree fields of one set (its ``make_geom_set``)
    as numpy, with the depths."""
    tree = bvh_mod.build_bvh(verts, indices, LEAF_SIZE)
    out = dict(bb_min=tree.bb_min, bb_max=tree.bb_max, left=tree.left,
               right=tree.right,
               leaf_prims=bvh_mod.pad_leaf_prims(tree, LEAF_SIZE),
               depth=tree.depth)
    if indices.shape[0] > CHUNKED_DENSE_MAX:
        out["node_measure"] = bvh_mod.node_sums(tree, measure)
    if sil is not None and sil["p0"].shape[0] > CHUNKED_DENSE_MAX:
        stree = bvh_mod.build_bvh_boxes(np.minimum(sil["p0"], sil["p1"]),
                                        np.maximum(sil["p0"], sil["p1"]),
                                        LEAF_SIZE)
        axis, cone_cos = bvh_mod.node_normal_cones(
            stree, sil["n1"], sil["n2"], sil["always"])
        out.update(sil_bb_min=stree.bb_min, sil_bb_max=stree.bb_max,
                   sil_left=stree.left, sil_right=stree.right,
                   sil_leaf=bvh_mod.pad_leaf_prims(stree, LEAF_SIZE),
                   sil_cone_axis=axis, sil_cone_cos=cone_cos,
                   sil_depth=stree.depth)
    return out


def make_geom_set(verts: np.ndarray, indices: np.ndarray,
                  device: torch.device, bvh: bool = False,
                  silhouettes: bool = True) -> GeomSet:
    """verts (V, D) and indices (P, D) of segments (D = 2) or triangles
    (D = 3); the normal and measure as the reference computes them.
    ``bvh``: also the trees of the BVH route, the JAX package's fields
    (the entities' tree only with ``silhouettes``: a Dirichlet set's
    silhouettes are never queried)."""
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

    arrays = dict(verts=verts, indices=indices,
                  prim_normal=n.astype(np.float32),
                  prim_measure=measure.astype(np.float32),
                  **{f"sil_{k}": v for k, v in sil.items()})
    if bvh:
        arrays.update(_tree_arrays(verts, indices, measure,
                                   sil if silhouettes else None))
    return geom_set_from_arrays(arrays, device)


_INT_FIELDS = ("left", "right", "leaf_prims", "sil_left", "sil_right",
               "sil_leaf")


def geom_set_from_arrays(arrays: dict, device: torch.device) -> GeomSet:
    """The port's GeomSet from numpy arrays named as the JAX GeomSet's
    fields (``{k: np.asarray(v) for k, v in gs._asdict().items()}``, the
    None ones left out or None), so that both sides can hold one tree.
    The depths are the given ``depth`` / ``sil_depth`` or, without them,
    read off the trees; the corner table is made here."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.require(a, requirements=("C", "W")),
                               dtype=dtype, device=device)

    a = {k: v for k, v in arrays.items() if v is not None}
    verts = np.asarray(a["verts"], np.float32)
    indices = np.asarray(a["indices"], np.int64)
    fields = dict(verts=t(verts), indices=t(indices, torch.int64),
                  sil_always=t(np.asarray(a["sil_always"], bool),
                               torch.bool))
    for k in ("prim_normal", "prim_measure", "sil_p0", "sil_p1", "sil_n1",
              "sil_n2", "bb_min", "bb_max", "node_measure", "sil_bb_min",
              "sil_bb_max", "sil_cone_axis", "sil_cone_cos"):
        if k in a:
            fields[k] = t(np.asarray(a[k], np.float32))
    for k in _INT_FIELDS:
        if k in a:
            fields[k] = t(np.asarray(a[k], np.int32), torch.int32)
    for pre, what in (("", "the prim tree"), ("sil_", "the silhouette tree")):
        if pre + "left" in a:
            depth = a.get(pre + "depth")
            if depth is None:
                depth = tree_depth(a[pre + "left"], a[pre + "right"])
            _check_depth(int(depth), what)
            fields[pre + "depth"] = int(depth)
    if "left" in a:
        fields["corners"] = t(verts[indices].reshape(indices.shape[0], -1))
    return GeomSet(**fields)
