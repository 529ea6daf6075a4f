"""ctypes bindings for the native scene builder (``native/scene_build.cpp``).

The library is compiled from the checkout's source with g++ into the
port's build directory at first use (``utils/build.py``); the committed
``native/libelaina_scene.so`` is not loaded, since it was built with
``-march=native`` on another host.  There is no numpy fallback: a failed
build raises.  Only the entry points the port uses are bound: OBJ
parsing, the BVH build of the BVH route, silhouette entities, the fused
candidate-grid band pass, and the silhouette and prim band passes of the
3D Neumann grids.

The band passes treat each cell on its own (the BVH they build over the
set is the only shared state, and it is rebuilt identically per call), so
the wrappers split the cells into chunks and run one native call per
chunk on a thread pool; ctypes releases the interpreter lock during the
call, and the outputs are the single call's, bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import platform
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..utils.build import REPO_DIR, build_shared

SOURCE = os.path.join(REPO_DIR, "native", "scene_build.cpp")
# -mfma on x86-64: the reference's library (native/Makefile) is built with
# -march=native, and g++ contracts its multiply-adds into FMAs; -mfma gives
# the same roundings (so the same grid tables, bit for bit) without tying
# the library to one host's other instruction-set extensions.  aarch64 has
# FMA in its base instruction set.
CXXFLAGS = (["-O3", "-fPIC", "-std=c++17", "-shared"]
            + (["-mfma"] if platform.machine() in ("x86_64", "AMD64")
               else []))

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_UP = ctypes.POINTER(ctypes.c_uint8)
_CHUNKS_PER_THREAD = 4      # native calls per thread of a band pass (each
#                             call rebuilds the set's BVH, milliseconds)


class _ObjData(ctypes.Structure):
    _fields_ = [("verts", _FP), ("segs", _IP), ("tris", _IP),
                ("n_verts", ctypes.c_int64), ("n_segs", ctypes.c_int64),
                ("n_tris", ctypes.c_int64)]


class _BvhOut(ctypes.Structure):
    _fields_ = [("bb_min", _FP), ("bb_max", _FP), ("left", _IP),
                ("right", _IP), ("start", _IP), ("count", _IP),
                ("order", _IP), ("n_nodes", ctypes.c_int64),
                ("depth", ctypes.c_int32)]


class _SilOut(ctypes.Structure):
    _fields_ = [("p0", _FP), ("p1", _FP), ("n1", _FP), ("n2", _FP),
                ("always", ctypes.POINTER(ctypes.c_uint8)),
                ("n_entities", ctypes.c_int64)]


_LIB = None


def library() -> ctypes.CDLL:
    """The scene library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_shared("elaina_scene", ["g++"], [SOURCE],
                                   CXXFLAGS))
    lib.obj_load.restype = ctypes.POINTER(_ObjData)
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [ctypes.POINTER(_ObjData)]
    lib.bvh_build.restype = ctypes.POINTER(_BvhOut)
    lib.bvh_build.argtypes = [_FP, ctypes.c_int64, _IP, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [ctypes.POINTER(_BvhOut)]
    lib.silhouettes_build.restype = ctypes.POINTER(_SilOut)
    lib.silhouettes_build.argtypes = [_FP, ctypes.c_int64, _IP,
                                      ctypes.c_int64, ctypes.c_int32]
    lib.silhouettes_free.restype = None
    lib.silhouettes_free.argtypes = [ctypes.POINTER(_SilOut)]
    lib.grid_band_full.restype = None
    lib.grid_band_full.argtypes = [
        _FP, ctypes.c_int64, _IP, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, _FP, ctypes.c_int64, _FP, ctypes.c_int32, _IP, _IP,
        _FP]
    lib.sil_band_rows.restype = None
    lib.sil_band_rows.argtypes = [
        _FP, _FP, _FP, _FP, _UP, ctypes.c_int64, ctypes.c_int32, _FP,
        ctypes.c_int64, _FP, ctypes.c_int32, _IP, _FP, _FP]
    lib.prim_band_rows.restype = None
    lib.prim_band_rows.argtypes = [
        _FP, ctypes.c_int64, _IP, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, _FP, ctypes.c_int64, _FP, ctypes.c_int32, _IP, _FP,
        _FP]
    _LIB = lib
    return lib


def _copy(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(
        dtype, copy=True).reshape(shape)


def load_obj_native(path: str, dim: int):
    """(verts (V, dim) f32, indices (P, dim) i32) of an OBJ file."""
    lib = library()
    d = lib.obj_load(path.encode())
    if not d:
        raise FileNotFoundError(path)
    try:
        c = d.contents
        verts = _copy(c.verts, (int(c.n_verts), 3), np.float32)
        if dim == 2:
            verts = verts[:, :2].copy()
            indices = _copy(c.segs, (int(c.n_segs), 2), np.int32)
        else:
            indices = _copy(c.tris, (int(c.n_tris), 3), np.int32)
    finally:
        lib.obj_free(d)
    if indices.shape[0] == 0:
        raise ValueError(f"{path}: no dim-{dim} primitives found")
    return verts, indices


def build_bvh_native(verts: np.ndarray, indices: np.ndarray,
                     leaf_size: int) -> dict:
    """The median-split BVH of ``bvh_build`` over the prims' boxes: a
    dict of bb_min, bb_max (M, D) f32, left, right, start, count (M,) i32,
    prim_order (P,) i32 and depth (int), the layout of
    ``geometry/bvh.BVHArrays``."""
    lib = library()
    dim = verts.shape[1]
    v = _f32(verts)
    idx = np.ascontiguousarray(indices, np.int32)
    out = lib.bvh_build(v.ctypes.data_as(_FP), v.shape[0],
                        idx.ctypes.data_as(_IP), idx.shape[0], idx.shape[1],
                        dim, int(leaf_size))
    try:
        c = out.contents
        m = int(c.n_nodes)
        return dict(
            bb_min=_copy(c.bb_min, (m, dim), np.float32),
            bb_max=_copy(c.bb_max, (m, dim), np.float32),
            left=_copy(c.left, (m,), np.int32),
            right=_copy(c.right, (m,), np.int32),
            start=_copy(c.start, (m,), np.int32),
            count=_copy(c.count, (m,), np.int32),
            prim_order=_copy(c.order, (idx.shape[0],), np.int32),
            depth=int(c.depth))
    finally:
        lib.bvh_free(out)


def silhouette_entities_native(verts: np.ndarray, indices: np.ndarray):
    """Silhouette entities: dict of p0, p1, n1, n2 (E, D) and always (E,)."""
    lib = library()
    dim = verts.shape[1]
    v = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    out = lib.silhouettes_build(v.ctypes.data_as(_FP), v.shape[0],
                                idx.ctypes.data_as(_IP), idx.shape[0], dim)
    try:
        c = out.contents
        e = int(c.n_entities)
        return dict(
            p0=_copy(c.p0, (e, dim), np.float32),
            p1=_copy(c.p1, (e, dim), np.float32),
            n1=_copy(c.n1, (e, dim), np.float32),
            n2=_copy(c.n2, (e, dim), np.float32),
            always=_copy(c.always, (e,), np.uint8).astype(bool),
        )
    finally:
        lib.silhouettes_free(out)


def _f32(a):
    return np.ascontiguousarray(a, np.float32)


def _over_cells(call, centers: np.ndarray, outs: list) -> None:
    """Run ``call(centers_chunk, *out_chunks)`` over chunks of the cells on
    a thread pool; every array of ``outs`` has the cells on axis 0."""
    n = centers.shape[0]
    workers = os.cpu_count() or 1
    cuts = np.linspace(0, n, min(n, _CHUNKS_PER_THREAD * workers) + 1)
    spans = list(zip(cuts[:-1].astype(int), cuts[1:].astype(int)))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = [pool.submit(call, centers[a:b], *(o[a:b] for o in outs))
                   for a, b in spans]
        for f in futures:
            f.result()


def grid_band_full_native(verts: np.ndarray, indices: np.ndarray,
                          centers: np.ndarray, hcell: np.ndarray, K: int):
    """One band pass over cells: (counts (n,) i32, rows (n, K) i32 -1
    padded, lcell (n,) f32).  Rows are meaningful where counts <= K."""
    lib = library()
    v = _f32(verts)
    idx = np.ascontiguousarray(indices, np.int32)
    c = _f32(centers)
    h = _f32(hcell)
    n = c.shape[0]
    counts = np.empty((n,), np.int32)
    rows = np.empty((n, int(K)), np.int32)
    lcell = np.empty((n,), np.float32)

    def call(cc, counts_c, rows_c, lcell_c):
        lib.grid_band_full(
            v.ctypes.data_as(_FP), v.shape[0], idx.ctypes.data_as(_IP),
            idx.shape[0], idx.shape[1], v.shape[1], cc.ctypes.data_as(_FP),
            cc.shape[0], h.ctypes.data_as(_FP), int(K),
            counts_c.ctypes.data_as(_IP), rows_c.ctypes.data_as(_IP),
            lcell_c.ctypes.data_as(_FP))

    _over_cells(call, c, [counts, rows, lcell])
    return counts, rows, lcell


def sil_band_rows_native(p0, p1, n1, n2, always, centers, hcell, K: int):
    """Silhouette band pass (``sil_band_rows``): per cell the K nearest
    (by lower bound) entities not certified non-silhouette over the cell,
    the validity cap r_cap and the kept entities' min lower bound.
    Returns (rows (n, K) i32 -1 padded, r_cap (n,), lbound (n,))."""
    lib = library()
    p0, p1, n1, n2 = (_f32(a) for a in (p0, p1, n1, n2))
    aw = np.ascontiguousarray(always, np.uint8)
    c = _f32(centers)
    h = _f32(hcell)
    n = c.shape[0]
    rows = np.empty((n, int(K)), np.int32)
    rcap = np.empty((n,), np.float32)
    lbound = np.empty((n,), np.float32)

    def call(cc, rows_c, rcap_c, lbound_c):
        lib.sil_band_rows(
            p0.ctypes.data_as(_FP), p1.ctypes.data_as(_FP),
            n1.ctypes.data_as(_FP), n2.ctypes.data_as(_FP),
            aw.ctypes.data_as(_UP), p0.shape[0], p0.shape[1],
            cc.ctypes.data_as(_FP), cc.shape[0], h.ctypes.data_as(_FP),
            int(K), rows_c.ctypes.data_as(_IP), rcap_c.ctypes.data_as(_FP),
            lbound_c.ctypes.data_as(_FP))

    _over_cells(call, c, [rows, rcap, lbound])
    return rows, rcap, lbound


def prim_band_rows_native(verts, indices, centers, hcell, K: int):
    """Radius-complete prim band pass (``prim_band_rows``): per cell the K
    prims of smallest lower bound over the cell and the completeness cap
    r_cap (every prim of lower bound < r_cap is in the row).  Returns
    (rows (n, K) i32 -1 padded, r_cap (n,), lbound (n,))."""
    lib = library()
    v = _f32(verts)
    idx = np.ascontiguousarray(indices, np.int32)
    c = _f32(centers)
    h = _f32(hcell)
    n = c.shape[0]
    rows = np.empty((n, int(K)), np.int32)
    rcap = np.empty((n,), np.float32)
    lbound = np.empty((n,), np.float32)

    def call(cc, rows_c, rcap_c, lbound_c):
        lib.prim_band_rows(
            v.ctypes.data_as(_FP), v.shape[0], idx.ctypes.data_as(_IP),
            idx.shape[0], idx.shape[1], v.shape[1], cc.ctypes.data_as(_FP),
            cc.shape[0], h.ctypes.data_as(_FP), int(K),
            rows_c.ctypes.data_as(_IP), rcap_c.ctypes.data_as(_FP),
            lbound_c.ctypes.data_as(_FP))

    _over_cells(call, c, [rows, rcap, lbound])
    return rows, rcap, lbound
