"""The packed trees that the BVH kernels B1 and B4 read, on the CPU.

``ops/bvh.pack_trees`` lays each set's trees out for ``csrc/bvh.cu``
(once for each set, kept on it by ``with_packs``): node records that hold both children's boxes,
node ids and refs, the prims' corners and ids in leaf order, and the
silhouette entities' nodes with their SNCH cone constants and their
entities in leaf order.  Here, on small trees (a wavy closed polyline of
300 segments, bumpy3d_3's 1,280 triangles, and the entities' tree of
each, built with ``CHUNKED_DENSE_MAX`` lowered so that such small sets
get one), a plain reader of that layout gives back the ``GeomSet``'s
own tree arrays bit for bit, and the cone constants equal what
``_cone_prune`` computes and prune the same nodes from every query.
The kernels themselves run only on the card (``chip_smoke.py`` [11a]).
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry.native import load_obj_native  # noqa: E402
from elaina_tpu_torch.ops import bvh as B  # noqa: E402

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), os.pardir, "configs", "data")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _polyline(n=300):
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = 3.0 + 0.6 * np.sin(12 * t)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n], -1)
    return verts, idx


def _bumpy():
    return load_obj_native(os.path.join(DATA, "bumpy3d_3.obj"), 3)[:2]


@pytest.fixture(scope="module", params=["polyline_2d", "bumpy3d_3"])
def gs(request):
    """The set with both trees and their packs (the entities' tree from
    64 entities up, where the port builds it above 4,096)."""
    verts, idx = _polyline() if request.param == "polyline_2d" else _bumpy()
    mp = pytest.MonkeyPatch()
    mp.setattr(TGS, "CHUNKED_DENSE_MAX", 64)
    try:
        out = B.with_packs(TGS.make_geom_set(verts, idx, CPU, bvh=True))
    finally:
        mp.undo()
    assert out.sil_left is not None and out.node_pack is not None
    return out


def _f(words):
    return words.contiguous().view(torch.float32)


def _read_records(rec, lo0, hi0):
    """A plain reader of node records (M, 4 D + 4) int32 and the root's
    box: (bb_min, bb_max, left, right, refs of each node as a child)."""
    M, D = rec.shape[0], lo0.shape[0]
    bb_min = torch.full((M, D), float("nan"))
    bb_max = torch.full((M, D), float("nan"))
    bb_min[0], bb_max[0] = lo0, hi0
    left, right = rec[:, 4 * D], rec[:, 4 * D + 1]
    ref = torch.full((M,), 2 ** 31 - 1, dtype=torch.int32)
    for n in torch.nonzero(left >= 0).flatten().tolist():
        for c, child in enumerate((int(left[n]), int(right[n]))):
            bb_min[child] = _f(rec[n, 2 * D * c:2 * D * c + D])
            bb_max[child] = _f(rec[n, 2 * D * c + D:2 * D * (c + 1)])
            ref[child] = rec[n, 4 * D + 2 + c]
    return bb_min, bb_max, left, right, ref


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _leaf_numbers(left):
    """Each leaf's number in node order."""
    leaves = torch.nonzero(left < 0).flatten()
    out = torch.full(left.shape, -1, dtype=torch.int32)
    out[leaves] = torch.arange(leaves.numel(), dtype=torch.int32)
    return leaves, out


@pytest.mark.parametrize("sil", [False, True], ids=["prims", "entities"])
def test_node_records_give_back_the_tree(gs, sil):
    """Unpacking the records (and the root's box, kept apart) gives back
    bb_min, bb_max, left and right bit for bit; each child's ref is its
    node id where it is inner and ~(its leaf number) where it is a
    leaf; a leaf's row holds nothing else."""
    pre = "sil_" if sil else ""
    D = gs.dim
    tree = [getattr(gs, pre + k) for k in ("bb_min", "bb_max", "left",
                                           "right")]
    rec = gs.sil_node_pack[:, B.CONE_W[D]:B.CONE_W[D] + B.NODE_W[D]] \
        if sil else gs.node_pack
    assert rec.dtype is torch.int32
    assert rec.shape == (tree[2].shape[0], B.NODE_W[D])
    got = _read_records(rec, tree[0][0], tree[1][0])
    for a, b in zip(got[:2], tree[:2]):
        assert _bits_equal(a, b)
    assert torch.equal(got[2], tree[2]) and torch.equal(got[3], tree[3])
    _, number = _leaf_numbers(tree[2])
    ids = torch.arange(tree[2].shape[0], dtype=torch.int32)
    want = torch.where(tree[2] >= 0, ids, ~number)
    assert torch.equal(got[4][1:], want[1:])
    leaf = tree[2] < 0
    assert not rec[leaf][:, :4 * D].any()
    assert not rec[leaf][:, 4 * D + 2:].any()
    if sil:   # the pad after the record
        assert not gs.sil_node_pack[:, B.CONE_W[D] + B.NODE_W[D]:].any()


def test_prim_leaves_in_leaf_order(gs):
    """Leaf k of ``leaf_pack`` is the k-th leaf in node order: its slots
    hold corners[leaf_prims] and the prim ids, a pad slot id -1 and zero
    corners."""
    D = gs.dim
    leaves, _ = _leaf_numbers(gs.left)
    pack = gs.leaf_pack
    assert pack.shape == (leaves.numel(), B.LEAF_W[D])
    pids = gs.leaf_prims[leaves]
    if D == 2:
        corners = pack[:, :4 * TGS.LEAF_SIZE].reshape(-1, TGS.LEAF_SIZE, 4)
        ids = pack[:, 4 * TGS.LEAF_SIZE:]
    else:
        slots = pack.reshape(-1, TGS.LEAF_SIZE, 12)
        corners, ids = slots[..., :9], slots[..., 9]
        assert not slots[..., 10:].any()
    assert torch.equal(ids, pids)
    pad = pids < 0
    assert pad.any()           # a leaf of fewer than LEAF_SIZE prims
    assert not corners[pad].any()
    assert _bits_equal(_f(corners[~pad]), gs.corners[pids[~pad].long()])


def test_entity_leaves_in_leaf_order(gs):
    """Each entity slot holds sil_p0 (sil_p1 in 3D), sil_n1, sil_n2 of
    sil_leaf's entity and a flag: 1 / 0 for sil_always, -1 at a pad, whose
    words are all 0."""
    D = gs.dim
    leaves, _ = _leaf_numbers(gs.sil_left)
    W = B.ENT_W[D]
    slots = gs.sil_ent_pack.reshape(leaves.numel(), TGS.LEAF_SIZE, W)
    e = gs.sil_leaf[leaves]
    pad = e < 0
    fields = (gs.sil_p0, gs.sil_p1, gs.sil_n1, gs.sil_n2) if D == 3 else (
        gs.sil_p0, gs.sil_n1, gs.sil_n2)
    body = len(fields) * D
    flag = slots[..., body]
    assert torch.equal(flag[pad], torch.full_like(flag[pad], -1))
    assert torch.equal(flag[~pad],
                       gs.sil_always[e[~pad].long()].to(torch.int32))
    assert not slots[..., body + 1:].any()
    assert not slots[pad][:, :body].any()
    ek = e[~pad].long()
    for k, t in enumerate(fields):
        assert _bits_equal(_f(slots[~pad][:, k * D:(k + 1) * D]), t[ek])


def _cone_words(gs):
    D = gs.dim
    w = gs.sil_node_pack
    return (_f(w[:, :D]), _f(w[:, D]), _f(w[:, D + 1:2 * D + 1]),
            _f(w[:, 2 * D + 1]), _f(w[:, 2 * D + 2]), w[:, 2 * D + 3])


def test_cone_constants_equal_cone_prune(gs):
    """The records' c, r and theta are ``_cone_prune``'s intermediates
    (computed here as it writes them, in float32), the axis and cos its
    inputs, the leaf word each leaf's number (-1 inner); and a prune
    that reads them, the two cheap tests first as the kernel does,
    prunes the same (query, node) pairs as ``_cone_prune``."""
    lo, hi = gs.sil_bb_min, gs.sil_bb_max
    c, r, axis, cos, theta, leaf = _cone_words(gs)
    assert _bits_equal(c, 0.5 * (lo + hi))
    assert _bits_equal(r, 0.5 * B._norm(hi - lo))
    assert _bits_equal(theta, torch.arccos(torch.clamp(gs.sil_cone_cos,
                                                       -1.0, 1.0)))
    assert _bits_equal(axis, gs.sil_cone_axis)
    assert _bits_equal(cos, gs.sil_cone_cos)
    _, number = _leaf_numbers(gs.sil_left)
    assert torch.equal(leaf, torch.where(gs.sil_left < 0, number, -1))

    rng = np.random.default_rng(3)
    M, D = lo.shape
    span = (hi[0] - lo[0]).numpy()
    qs = torch.as_tensor(rng.uniform(lo[0].numpy() - 0.2 * span,
                                     hi[0].numpy() + 0.2 * span,
                                     (16, D)).astype(np.float32))
    nid = torch.arange(M)
    for q in qs:
        qm = q.expand(M, D)
        w = c - qm
        d_c = B._norm(w)
        cheap = (cos > -1.5) & (d_c > r)
        phi = torch.arcsin(torch.clamp(r / torch.clamp(d_c, min=1e-20), 0.0,
                                       1.0))
        ang = torch.arccos(torch.clamp(
            B._dot(axis, w) / torch.clamp(d_c, min=1e-20), -1.0, 1.0))
        no_sil = (ang + theta + phi < B.HALF_PI) | (
            ang - theta - phi > B.HALF_PI)
        assert torch.equal(cheap & no_sil, B._cone_prune(gs, qm, nid))


def test_packs_are_built_once_and_kept(gs):
    """``with_packs`` keeps a set's packs (a second call builds nothing
    anew), and a B1 or B4 call on a set without them builds them first,
    equal to ``pack_trees``'."""
    import dataclasses

    before = {k: getattr(gs, k) for k in TGS.PACK_FIELDS}
    assert B.with_packs(gs) is gs
    assert all(getattr(gs, k) is v for k, v in before.items())
    bare = dataclasses.replace(gs, **{k: None for k in TGS.PACK_FIELDS})
    q = gs.verts[:8].contiguous()
    B.closest_point_bvh(bare, q)
    B.closest_silhouette_bvh(bare, q)
    assert all(torch.equal(getattr(bare, k), v) for k, v in before.items())


def test_pack_checks_raise(gs):
    """The wrappers refuse a pack of the wrong dtype or width, and a visit
    count on the CPU."""
    import dataclasses

    q = gs.verts[:4].contiguous()
    with pytest.raises(ValueError, match="node_pack"):
        B.closest_point_bvh(dataclasses.replace(
            gs, node_pack=gs.node_pack[:, :-4].contiguous()), q)
    with pytest.raises(TypeError, match="leaf_pack"):
        B.closest_point_bvh(dataclasses.replace(
            gs, leaf_pack=gs.leaf_pack.float()), q)
    with pytest.raises(ValueError, match="sil_node_pack"):
        B.closest_silhouette_bvh(dataclasses.replace(
            gs, sil_node_pack=gs.sil_node_pack[:, :-4].contiguous()), q)
    with pytest.raises(ValueError, match="visits"):
        B.closest_point_bvh(gs, q, visits=torch.zeros(4, dtype=torch.int32))


def test_packs_follow_the_tree_fields():
    """A set without its trees has no packs, the geometry layer builds
    none, and ``pack_bytes`` counts the four packs of a set with both."""
    verts, idx = _polyline(32)
    assert B.with_packs(TGS.make_geom_set(verts, idx, CPU)).pack_bytes() == 0
    mp = pytest.MonkeyPatch()
    mp.setattr(TGS, "CHUNKED_DENSE_MAX", 8)
    try:
        g = TGS.make_geom_set(verts, idx, CPU, bvh=True)
    finally:
        mp.undo()
    assert g.pack_bytes() == 0
    B.with_packs(g)
    assert g.pack_bytes() == 4 * sum(getattr(g, k).numel()
                                     for k in TGS.PACK_FIELDS)
