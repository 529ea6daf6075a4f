"""NanoVDB (.nvdb) reader and writer for volumetric source grids.

The port's own copy of the reader and the writer of
``elaina_tpu/core/nanovdb.py`` (it imports nothing of the JAX package);
``write_nvdb`` writes the JAX writer's bytes for the same inputs.  The
reference reads its source term with ``nanovdb::io::readGrid`` and
samples the Vec3f grid trilinearly in its kernels; the port, like the JAX package, decodes the sparse tree into a
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
ALIGN = 32

CODEC_NONE = 0
CODEC_ZIP = 1

GRID_TYPE_FLOAT = 1
GRID_TYPE_VEC3F = 6
GRID_CLASS_FOG = 2

_LEAF_DIM, _LOWER_DIM, _UPPER_DIM = 8, 16, 32
_LEAF_LOG2, _LOWER_LOG2, _UPPER_LOG2 = 3, 4, 5
_LOWER_TOTAL = _LEAF_LOG2 + _LOWER_LOG2          # 7
_UPPER_TOTAL = _LOWER_TOTAL + _UPPER_LOG2        # 12


def _version(major=32, minor=3, patch=0):
    return (major << 21) | (minor << 10) | patch


def _align_up(x, a=ALIGN):
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


def _internal_layout(dim, channels):
    """(table offset, tile stride, node byte size) of an internal node.

    InternalData: CoordBBox mBBox(24), uint64 mFlags, Mask mValueMask,
    Mask mChildMask, ValueT mMin, mMax, float mAvg, mStd, pad, then
    Tile[dim^3] with Tile = union{ValueT, int64} (8-aligned).
    """
    n = dim ** 3
    mask_bytes = n // 8
    vb = 4 * channels
    header = _align_up(24 + 8 + 2 * mask_bytes + 2 * vb + 8)
    tile = max(8, _align_up(vb, 8))
    size = _align_up(header + n * tile)
    return header, tile, size


def _root_layout(channels):
    """(tile table offset, tile stride) of RootData.

    RootData: CoordBBox mBBox(24), uint32 mTableSize, ValueT mBackground,
    mMin, mMax, float mAvg, mStd, pad to 32; Tile = {uint64 key,
    int64 child, uint32 state, ValueT value} rounded to 8.
    """
    vb = 4 * channels
    header = _align_up(24 + 4 + 3 * vb + 8)
    tile = _align_up(8 + 8 + 4 + vb, 8)
    return header, tile


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


def write_nvdb(path: str, values: np.ndarray, voxel_size=1.0,
               world_offset=(0.0, 0.0, 0.0), origin=(0, 0, 0),
               name: str = "source", codec: int = CODEC_NONE) -> None:
    """Serialize a dense array as a single-grid .nvdb file.

    values: (nx, ny, nz) float or (nx, ny, nz, 3) Vec3f; ``origin`` is the
    index-space coordinate of values[0,0,0]; world = ijk * voxel_size +
    world_offset (a pure scale+translate Map, which is what
    ``Problem::loadSource`` consumes).
    """
    values = np.asarray(values, np.float32)
    if values.ndim == 3:
        values = values[..., None]
    channels = values.shape[-1]
    grid_type = {1: GRID_TYPE_FLOAT, 3: GRID_TYPE_VEC3F}[channels]
    voxel = np.broadcast_to(np.asarray(voxel_size, np.float64), (3,))
    offset = np.asarray(world_offset, np.float64)
    origin = np.asarray(origin, np.int64)
    nx, ny, nz = values.shape[:3]
    lo = origin
    hi = origin + np.array([nx, ny, nz]) - 1

    # --- carve the index space into leaves/lowers/uppers -------------- #
    def cover(lo, hi, total):
        a = lo >> total
        b = hi >> total
        return [(i, j, k)
                for i in range(a[0], b[0] + 1)
                for j in range(a[1], b[1] + 1)
                for k in range(a[2], b[2] + 1)]

    uppers = cover(lo, hi, _UPPER_TOTAL)
    lowers = cover(lo, hi, _LOWER_TOTAL)
    leaves = cover(lo, hi, _LEAF_LOG2)

    leaf_header, leaf_values_off, leaf_size = _leaf_layout(channels)
    lo_tab, lo_tile, lower_size = _internal_layout(_LOWER_DIM, channels)
    up_tab, up_tile, upper_size = _internal_layout(_UPPER_DIM, channels)
    root_header, root_tile = _root_layout(channels)
    root_size = _align_up(root_header + len(uppers) * root_tile)

    tree_data = 64
    root_off = tree_data
    upper_off = root_off + root_size
    lower_off = upper_off + len(uppers) * upper_size
    leaf_off = lower_off + len(lowers) * lower_size
    tree_size = leaf_off + len(leaves) * leaf_size
    grid_size = 672 + tree_size

    buf = bytearray(grid_size)
    vmin = values.reshape(-1, channels).min(0)
    vmax = values.reshape(-1, channels).max(0)
    vavg = float(values.mean())
    vstd = float(values.std())

    # --- GridData ------------------------------------------------------ #
    struct.pack_into("<QQIIIIQ", buf, 0, MAGIC, 0xFFFFFFFFFFFFFFFF,
                     _version(), (1 << 1) | (1 << 2) | (1 << 5),  # bbox|minmax|breadthfirst
                     0, 1, grid_size)
    nm = name.encode()[:255]
    buf[40:40 + len(nm)] = nm
    map_off = 296
    matf = np.zeros(22, np.float32)
    matf[[0, 4, 8]] = voxel.astype(np.float32)           # mMatF diag
    matf[[9, 13, 17]] = (1.0 / voxel).astype(np.float32)  # mInvMatF diag
    matf[18:21] = offset.astype(np.float32)
    struct.pack_into("<22f", buf, map_off, *matf.tolist())
    matd = np.zeros(22, np.float64)
    matd[[0, 4, 8]] = voxel
    matd[[9, 13, 17]] = 1.0 / voxel
    matd[18:21] = offset
    struct.pack_into("<22d", buf, map_off + 88, *matd.tolist())
    wlo = lo * voxel + offset
    whi = (hi + 1) * voxel + offset
    struct.pack_into("<6d", buf, 560, *wlo.tolist(), *whi.tolist())
    struct.pack_into("<3d", buf, 608, *voxel.tolist())
    struct.pack_into("<II", buf, 632, GRID_CLASS_FOG, grid_type)
    struct.pack_into("<qI", buf, 640, 0, 0)

    # --- TreeData ------------------------------------------------------ #
    struct.pack_into("<4Q", buf, 672, leaf_off, lower_off, upper_off,
                     root_off)
    struct.pack_into("<3I", buf, 672 + 32, len(leaves), len(lowers),
                     len(uppers))
    struct.pack_into("<3I", buf, 672 + 44, 0, 0, 0)
    struct.pack_into("<Q", buf, 672 + 56, int(np.prod(values.shape[:3])))

    base = 672

    def node_coords_index(coords, total):
        return {c: i for i, c in enumerate(coords)}

    upper_index = node_coords_index(uppers, _UPPER_TOTAL)
    lower_index = node_coords_index(lowers, _LOWER_TOTAL)

    # --- Root ---------------------------------------------------------- #
    ro = base + root_off
    struct.pack_into("<6i", buf, ro, *lo.tolist(), *hi.tolist())
    struct.pack_into("<I", buf, ro + 24, len(uppers))
    bg = np.zeros(channels, np.float32)
    struct.pack_into(f"<{channels}f", buf, ro + 28, *bg.tolist())
    struct.pack_into(f"<{channels}f", buf, ro + 28 + 4 * channels,
                     *vmin.tolist())
    struct.pack_into(f"<{channels}f", buf, ro + 28 + 8 * channels,
                     *vmax.tolist())
    struct.pack_into("<2f", buf, ro + 28 + 12 * channels, vavg, vstd)
    for t, (ui, uj, uk) in enumerate(uppers):
        to = ro + root_header + t * root_tile
        # CoordToKey: uint32(coord) >> 12 per axis, z low bits, x high
        def kbits(c):
            return ((c << _UPPER_TOTAL) & 0xFFFFFFFF) >> _UPPER_TOTAL

        key = kbits(uk) | (kbits(uj) << 21) | (kbits(ui) << 42)
        child = (upper_off + upper_index[(ui, uj, uk)] * upper_size
                 + base - ro)                  # byte offset relative to root
        struct.pack_into("<QqI", buf, to, int(key), child, 0)

    # --- internal nodes ------------------------------------------------ #
    def write_internal(coords, index, off0, size, tab, tile, dim, log2,
                       child_total, child_coords_index, child_off0,
                       child_size):
        child_log2 = child_total
        for (ci, cj, ck) in coords:
            i_node = index[(ci, cj, ck)]
            no = base + off0 + i_node * size
            node_lo = (np.array([ci, cj, ck], np.int64)
                       << (child_total + log2))
            b_lo = np.maximum(node_lo, lo)
            b_hi = np.minimum(node_lo + (dim << child_total) - 1, hi)
            struct.pack_into("<6i", buf, no, *b_lo.tolist(), *b_hi.tolist())
            struct.pack_into("<Q", buf, no + 24, 0)
            n = dim ** 3
            mask_bytes = n // 8
            child_mask = np.zeros(n, bool)
            a = np.maximum((b_lo >> child_total) - (node_lo >> child_total), 0)
            b = np.minimum((b_hi >> child_total) - (node_lo >> child_total),
                           dim - 1)
            for x in range(a[0], b[0] + 1):
                for y in range(a[1], b[1] + 1):
                    for z in range(a[2], b[2] + 1):
                        child_mask[(x << (2 * log2)) | (y << log2) | z] = True
            cm = np.packbits(child_mask, bitorder="little")
            vm_off = no + 32
            # value mask all zero, child mask set
            buf[vm_off + mask_bytes:vm_off + 2 * mask_bytes] = cm.tobytes()
            stat = vm_off + 2 * mask_bytes
            struct.pack_into(f"<{channels}f", buf, stat, *vmin.tolist())
            struct.pack_into(f"<{channels}f", buf, stat + 4 * channels,
                             *vmax.tolist())
            struct.pack_into("<2f", buf, stat + 8 * channels, vavg, vstd)
            for x in range(a[0], b[0] + 1):
                for y in range(a[1], b[1] + 1):
                    for z in range(a[2], b[2] + 1):
                        gxyz = ((node_lo >> child_total)
                                + np.array([x, y, z], np.int64))
                        ci2 = child_coords_index[tuple(gxyz.tolist())]
                        child = (child_off0 + ci2 * child_size + base - no)
                        e = no + tab + ((x << (2 * log2)) | (y << log2) | z) * tile
                        struct.pack_into("<q", buf, e, child)

    leaf_index = node_coords_index(leaves, _LEAF_LOG2)
    write_internal(uppers, upper_index, upper_off, upper_size, up_tab,
                   up_tile, _UPPER_DIM, _UPPER_LOG2, _LOWER_TOTAL,
                   lower_index, lower_off, lower_size)
    write_internal(lowers, lower_index, lower_off, lower_size, lo_tab,
                   lo_tile, _LOWER_DIM, _LOWER_LOG2, _LEAF_LOG2,
                   leaf_index, leaf_off, leaf_size)

    # --- leaves -------------------------------------------------------- #
    pad = np.zeros((channels,), np.float32)
    for (li, lj, lk) in leaves:
        i_node = leaf_index[(li, lj, lk)]
        no = base + leaf_off + i_node * leaf_size
        node_lo = np.array([li, lj, lk], np.int64) << _LEAF_LOG2
        b_lo = np.maximum(node_lo, lo)
        b_hi = np.minimum(node_lo + 7, hi)
        struct.pack_into("<3i", buf, no, *b_lo.tolist())
        dif = (b_hi - b_lo).astype(np.uint8)
        struct.pack_into("<3B", buf, no + 12, *dif.tolist())
        struct.pack_into("<B", buf, no + 15, 0)
        block = np.broadcast_to(pad, (8, 8, 8, channels)).copy()
        mask = np.zeros((8, 8, 8), bool)
        s0 = b_lo - node_lo
        s1 = b_hi - node_lo + 1
        src = values[
            b_lo[0] - lo[0]:b_hi[0] - lo[0] + 1,
            b_lo[1] - lo[1]:b_hi[1] - lo[1] + 1,
            b_lo[2] - lo[2]:b_hi[2] - lo[2] + 1]
        block[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2]] = src
        mask[s0[0]:s1[0], s0[1]:s1[1], s0[2]:s1[2]] = True
        buf[no + 16:no + 80] = np.packbits(
            mask.reshape(-1), bitorder="little").tobytes()
        stat = no + 80
        struct.pack_into(f"<{channels}f", buf, stat,
                         *src.reshape(-1, channels).min(0).tolist())
        struct.pack_into(f"<{channels}f", buf, stat + 4 * channels,
                         *src.reshape(-1, channels).max(0).tolist())
        struct.pack_into("<2f", buf, stat + 8 * channels, float(src.mean()),
                         float(src.std()))
        vo = no + leaf_values_off
        buf[vo:vo + 512 * 4 * channels] = block.astype("<f4").tobytes()

    blob = bytes(buf)
    if codec == CODEC_ZIP:
        comp = zlib.compress(blob)
        blob_out = struct.pack("<Q", len(blob)) + comp
    elif codec == CODEC_NONE:
        blob_out = blob
    else:
        raise ValueError(f"unsupported codec {codec}")

    nm_bytes = name.encode() + b"\0"
    with open(path, "wb") as f:
        f.write(struct.pack("<QIHH", MAGIC, _version(), 1, codec))
        meta = bytearray(176)
        struct.pack_into("<QQQQII", meta, 0, grid_size, len(blob_out),
                         zlib.crc32(nm_bytes) & 0xFFFFFFFF,
                         int(np.prod(values.shape[:3])), grid_type,
                         GRID_CLASS_FOG)
        struct.pack_into("<6d", meta, 48, *wlo.tolist(), *whi.tolist())
        struct.pack_into("<6i", meta, 96, *lo.tolist(), *hi.tolist())
        struct.pack_into("<3d", meta, 120, *voxel.tolist())
        struct.pack_into("<I", meta, 144, len(nm_bytes))
        struct.pack_into("<4I", meta, 148, len(leaves), len(lowers),
                         len(uppers), 1)
        struct.pack_into("<HHI", meta, 168, codec, 0, _version())
        f.write(bytes(meta))
        f.write(nm_bytes)
        f.write(blob_out)
