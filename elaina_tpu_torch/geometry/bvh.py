"""Host-side BVH construction for the BVH route (numpy).

The port's own copy of ``elaina_tpu/geometry/bvh.py``'s builders: a
longest-axis median split over the prims' centroids (the prim tree, from
the native ``bvh_build``), over arbitrary boxes (the silhouette entities'
tree, in numpy), the per-node subtree sums that weight the in-ball
sample's descent, the SNCH normal cones that prune the silhouette
descent, and the fixed-width leaf table the traversals gather from.

Flattened layout (M nodes, ids in pop order, so a child's id is above its
parent's):
  bb_min, bb_max : (M, D) f32  node bounds
  left, right    : (M,) i32    child ids (-1 at a leaf)
  start, count   : (M,) i32    sorted-prim range of a leaf (count 0:
                               internal)
  prim_order     : (P,) i32    permutation into the original prim list
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .native import build_bvh_native


@dataclass
class BVHArrays:
    bb_min: np.ndarray
    bb_max: np.ndarray
    left: np.ndarray
    right: np.ndarray
    start: np.ndarray
    count: np.ndarray
    prim_order: np.ndarray
    depth: int


def median_split_depth(n: int, leaf_size: int) -> int:
    """The depth of a median-split tree over n elements: a node of more
    than ``leaf_size`` splits into (n // 2, n - n // 2), and the larger
    half sets the depth (both builders split so)."""
    depth = 0
    while n > leaf_size:
        n -= n // 2
        depth += 1
    return depth


def build_bvh(verts: np.ndarray, indices: np.ndarray,
              leaf_size: int = 4) -> BVHArrays:
    """The prim tree, from the native builder (``native/scene_build.cpp``
    ``bvh_build``, which the JAX package also loads where it can): the
    same topology as the numpy split, with ``std::nth_element``'s order of
    the prims within a leaf."""
    return BVHArrays(**build_bvh_native(verts, indices, leaf_size))


def build_bvh_boxes(box_min: np.ndarray, box_max: np.ndarray,
                    leaf_size: int = 4) -> BVHArrays:
    """Median-split BVH over arbitrary element boxes (the silhouette
    entities'), in numpy: ``np.argpartition`` orders a leaf's elements,
    as the JAX package's builder does."""
    P = box_min.shape[0]
    centroids = 0.5 * (box_min + box_max)
    order = np.arange(P)
    bb_min, bb_max, left, right, start, count = [], [], [], [], [], []
    stack = [(0, P, -1, False, 0)]   # (lo, hi, parent, is_left, depth)
    max_depth = 0
    while stack:
        lo, hi, parent, is_left, d = stack.pop()
        max_depth = max(max_depth, d)
        nid = len(bb_min)
        if parent >= 0:
            (left if is_left else right)[parent] = nid
        sel = order[lo:hi]
        bb_min.append(box_min[sel].min(axis=0))
        bb_max.append(box_max[sel].max(axis=0))
        left.append(-1)
        right.append(-1)
        if hi - lo <= leaf_size:
            start.append(lo)
            count.append(hi - lo)
            continue
        start.append(0)
        count.append(0)
        c = centroids[sel]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        mid = (hi - lo) // 2
        order[lo:hi] = sel[np.argpartition(c[:, axis], mid)]
        # the right half is pushed first, so the left one pops first
        stack.append((lo + mid, hi, nid, False, d + 1))
        stack.append((lo, lo + mid, nid, True, d + 1))
    return BVHArrays(
        bb_min=np.asarray(bb_min, np.float32),
        bb_max=np.asarray(bb_max, np.float32),
        left=np.asarray(left, np.int32), right=np.asarray(right, np.int32),
        start=np.asarray(start, np.int32), count=np.asarray(count, np.int32),
        prim_order=order.astype(np.int32), depth=max_depth)


def node_sums(bvh: BVHArrays, values: np.ndarray) -> np.ndarray:
    """(M,) f32 subtree sums of per-element ``values`` (the prims'
    measures), accumulated in float64 by one reverse sweep (children
    have higher ids than their parent)."""
    M = bvh.bb_min.shape[0]
    out = np.zeros((M,), np.float64)
    for nid in range(M - 1, -1, -1):
        c = bvh.count[nid]
        if c > 0:
            s = bvh.start[nid]
            out[nid] = values[bvh.prim_order[s:s + c]].astype(
                np.float64).sum()
        else:
            out[nid] = out[bvh.left[nid]] + out[bvh.right[nid]]
    return out.astype(np.float32)


def node_normal_cones(bvh: BVHArrays, n1: np.ndarray, n2: np.ndarray,
                      always: np.ndarray):
    """Per-node bounding cones of the entities' adjacent normals, for the
    SNCH silhouette prune: (axis (M, D) unit f32, cos_half (M,) f32), with
    cos_half = -2 on a node that holds an always-silhouette entity (never
    pruned).  The merge is conservative: a node's cone holds every normal
    of its subtree."""
    M = bvh.bb_min.shape[0]
    D = n1.shape[1]
    axis = np.zeros((M, D), np.float64)
    half = np.zeros((M,), np.float64)        # half-angle in radians
    flag = np.zeros((M,), bool)

    def merge(a1, t1, a2, t2):
        s = a1 + a2
        ns = np.linalg.norm(s)
        if ns < 1e-9:                        # opposite axes: full sphere
            return a1, np.pi
        ax = s / ns
        ang = max(np.arccos(np.clip(np.dot(ax, a1), -1, 1)) + t1,
                  np.arccos(np.clip(np.dot(ax, a2), -1, 1)) + t2)
        return ax, min(ang, np.pi)

    for nid in range(M - 1, -1, -1):
        c = bvh.count[nid]
        if c > 0:
            s = bvh.start[nid]
            ids = bvh.prim_order[s:s + c]
            ns = np.concatenate([n1[ids], n2[ids]], axis=0).astype(np.float64)
            ax = ns.sum(0)
            nrm = np.linalg.norm(ax)
            if nrm < 1e-9:
                axis[nid], half[nid] = ns[0], np.pi
            else:
                ax /= nrm
                half[nid] = np.arccos(np.clip((ns @ ax).min(), -1, 1))
                axis[nid] = ax
            flag[nid] = bool(always[ids].any())
        else:
            l, r = bvh.left[nid], bvh.right[nid]
            axis[nid], half[nid] = merge(axis[l], half[l], axis[r], half[r])
            flag[nid] = flag[l] or flag[r]
    cos_half = np.where(flag, -2.0, np.cos(np.minimum(half, np.pi)))
    return axis.astype(np.float32), cos_half.astype(np.float32)


def pad_leaf_prims(bvh: BVHArrays, leaf_size: int) -> np.ndarray:
    """(M, leaf_size) i32 element ids of each leaf in ``prim_order``'s
    order, -1 padded (and -1 on internal nodes): the traversals' fixed-
    width gather target."""
    M = bvh.bb_min.shape[0]
    out = np.full((M, leaf_size), -1, np.int32)
    for nid in np.nonzero(bvh.count > 0)[0]:
        s, c = bvh.start[nid], bvh.count[nid]
        out[nid, :c] = bvh.prim_order[s:s + c]
    return out
