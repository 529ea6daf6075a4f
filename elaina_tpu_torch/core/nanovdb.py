"""NanoVDB (.nvdb) reader for volumetric source grids.

The port's own copy of the reader of ``elaina_tpu/core/nanovdb.py`` (it
imports nothing of the JAX package).  The reference reads its source term
with ``nanovdb::io::readGrid`` and samples the Vec3f grid trilinearly in
its kernels; the port, like the JAX package, decodes the sparse tree into a
dense array at load time (``core/problem.SourceGrid`` samples it), so only
the serialization format is needed, not the runtime tree.

Format: NanoVDB file layout v32.x ("NanoVDB0" magic): FileHeader, per-grid
FileMetaData + name + a grid blob (codec NONE or ZIP) of GridData(672) /
TreeData(64) / root / upper / lower / leaf(8^3) node arrays.  The dense
array is filled from the breadth-first leaf array alone (every leaf stores
its own origin in ``mBBoxMin``), so the reader does not depend on the
child-offset convention, which changed across NanoVDB versions.

Supported: Float and Vec3f grids, codec NONE and ZIP; BLOSC is rejected.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = 0x304244566F6E614E          # "NanoVDB0" little-endian

CODEC_NONE = 0
CODEC_ZIP = 1

GRID_TYPE_FLOAT = 1
GRID_TYPE_VEC3F = 6


def _align_up(x, a=32):
    return -(-x // a) * a


def _value_spec(grid_type):
    """(channels, bytes per value)."""
    if grid_type == GRID_TYPE_FLOAT:
        return 1, 4
    if grid_type == GRID_TYPE_VEC3F:
        return 3, 12
    raise ValueError(f"unsupported NanoVDB grid type {grid_type} "
                     "(only Float=1 and Vec3f=6)")


def _leaf_layout(channels):
    """(header size, values offset, leaf byte size) of a leaf node.

    LeafData: Coord mBBoxMin(12), uint8 mBBoxDif[3], uint8 mFlags,
    Mask<3> mValueMask(64), ValueT mMin, mMax, float mAvg, mStd,
    ValueT mValues[512]; struct aligned to 32.
    """
    vb = 4 * channels
    header = 12 + 3 + 1 + 64 + 2 * vb + 8
    values_off = header
    size = _align_up(values_off + 512 * vb)
    return header, values_off, size


@dataclass
class NvdbGrid:
    """Dense decode of one NanoVDB grid."""

    values: np.ndarray        # (nx, ny, nz, C) float32, C in {1, 3}
    origin: np.ndarray        # (3,) int32 index-space origin of values[0,0,0]
    voxel_size: np.ndarray    # (3,) float64
    world_offset: np.ndarray  # (3,) float64: world = ijk * voxel + offset
    name: str = ""
    background: np.ndarray | None = None


def read_nvdb(path: str, grid_index: int = 0) -> NvdbGrid:
    with open(path, "rb") as f:
        data = f.read()
    magic, version, grid_count, codec = struct.unpack_from("<QIHH", data, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file (magic {magic:#x})")
    if grid_index >= grid_count:
        raise ValueError(f"{path}: grid {grid_index} of {grid_count}")
    off = 16
    for gi in range(grid_count):
        (grid_size, file_size, _name_key, _voxel_count, grid_type,
         _grid_class) = struct.unpack_from("<QQQQII", data, off)
        # worldBBox(48) indexBBox(24) voxelSize(24)
        index_bbox = struct.unpack_from("<6i", data, off + 48 + 48)
        voxel_size = np.array(struct.unpack_from("<3d", data, off + 120))
        (name_size,) = struct.unpack_from("<I", data, off + 144)
        node_count = struct.unpack_from("<4I", data, off + 148)
        g_codec, _pad, _g_version = struct.unpack_from("<HHI", data, off + 176 - 8)
        off += 176
        name = data[off:off + name_size].split(b"\0")[0].decode("utf-8",
                                                                "replace")
        off += name_size
        blob = data[off:off + file_size]
        off += file_size
        if gi != grid_index:
            continue
        if g_codec == CODEC_ZIP:
            # ZIP codec stores a uint64 uncompressed size per chunk
            blob = zlib.decompress(blob[8:])
        elif g_codec != CODEC_NONE:
            raise ValueError(f"{path}: unsupported codec {g_codec} "
                             "(BLOSC not available)")
        return _decode_grid(bytes(blob), grid_type, index_bbox, voxel_size,
                            node_count, name, path)
    raise AssertionError("unreachable")


def _decode_grid(blob, grid_type, index_bbox, voxel_size, node_count, name,
                 path):
    magic, _checksum, _version_, _flags, _gi, _gc, grid_size = \
        struct.unpack_from("<QQIIIIQ", blob, 0)
    if magic != MAGIC and magic != 0:        # some writers zero GridData magic
        raise ValueError(f"{path}: bad GridData magic {magic:#x}")
    g_type_blob, = struct.unpack_from("<I", blob, 672 - 36)
    # Map: floats 22*4=88, doubles: matd(72) invmatd(72) vecd(24) taper(8)
    map_off = 296
    vec_d = np.array(struct.unpack_from("<3d", blob, map_off + 88 + 144))
    grid_type = g_type_blob if g_type_blob in (GRID_TYPE_FLOAT,
                                               GRID_TYPE_VEC3F) else grid_type
    channels, vb = _value_spec(grid_type)

    # TreeData at 672: uint64 offsets[4] (leaf, lower, upper, root —
    # relative to TreeData), uint32 counts[3], uint32 tiles[3], uint64 voxels
    tree_off = 672
    offs = struct.unpack_from("<4Q", blob, tree_off)
    counts = struct.unpack_from("<3I", blob, tree_off + 32)
    n_leaf = counts[0] if counts[0] else node_count[0]

    root_off = tree_off + offs[3]
    root_bbox = struct.unpack_from("<6i", blob, root_off)
    table_size, = struct.unpack_from("<I", blob, root_off + 24)
    background = np.array(
        struct.unpack_from(f"<{channels}f", blob, root_off + 28), np.float32)

    lo = np.array(index_bbox[:3], np.int64)
    hi = np.array(index_bbox[3:], np.int64)
    if np.any(hi < lo):                       # empty bbox: fall back to root's
        lo = np.array(root_bbox[:3], np.int64)
        hi = np.array(root_bbox[3:], np.int64)
    shape = tuple((hi - lo + 1).tolist())
    dense = np.broadcast_to(background, shape + (channels,)).copy()

    # fill from the breadth-first leaf array: each leaf is self-locating
    leaf_header, leaf_values_off, leaf_size = _leaf_layout(channels)
    leaf0 = tree_off + offs[0]
    vals = np.frombuffer(blob, np.float32)
    for li in range(n_leaf):
        base = leaf0 + li * leaf_size
        ox, oy, oz = struct.unpack_from("<3i", blob, base)
        mask = np.unpackbits(
            np.frombuffer(blob, np.uint8, 64, base + 16),
            bitorder="little").astype(bool)
        v0 = (base + leaf_values_off) // 4
        lv = vals[v0:v0 + 512 * channels].reshape(8, 8, 8, channels)
        # leaf voxel n = ((x&7)<<6)|((y&7)<<3)|(z&7): C-order (x, y, z).
        # mBBoxMin is the ACTIVE bbox min; the value array is indexed from
        # the leaf origin (coords floored to the 8-voxel lattice)
        i0 = (np.array([ox, oy, oz], np.int64) >> 3 << 3) - lo
        i1 = i0 + 8
        c0 = np.maximum(i0, 0)
        c1 = np.minimum(i1, np.asarray(shape))
        if np.any(c0 >= c1):
            continue
        s = tuple(slice(int(a), int(b)) for a, b in zip(c0, c1))
        ls = tuple(slice(int(a - b), int(8 - (d - c)))
                   for a, b, c, d in zip(c0, i0, c1, i1))
        m = mask.reshape(8, 8, 8)[ls]
        dense[s][m] = lv[ls][m]

    return NvdbGrid(values=dense, origin=lo.astype(np.int32),
                    voxel_size=voxel_size, world_offset=vec_d,
                    name=name, background=background)
