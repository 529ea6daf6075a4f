"""Image IO: uncompressed OpenEXR writer/reader and a stdlib PNG writer.

The EXR functions are copies of ``elaina_tpu/output/image_io.py``.
``write_png`` writes the PNG with ``zlib`` and ``struct`` from the
standard library, where the reference uses Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_EXR_MAGIC = 0x01312F76
_PIXELTYPE_UINT = 0
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2
_COMPRESSION_NONE = 0
_COMPRESSION_ZIPS = 2   # zlib, 1 scanline per block
_COMPRESSION_ZIP = 3    # zlib, 16 scanlines per block


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return name.encode() + b"\x00" + type_.encode() + b"\x00" + struct.pack(
        "<i", len(payload)) + payload


def write_exr(path: str, image: np.ndarray) -> None:
    """Write (H, W, C) float32 (C in {1, 3, 4}) as uncompressed EXR."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    if c == 1:
        names = ["Y"]
    elif c == 3:
        names = ["R", "G", "B"]
    else:
        names = ["R", "G", "B", "A"]

    # channel list: alphabetical order required
    order = sorted(range(c), key=lambda i: names[i])
    chan_payload = b""
    for i in order:
        chan_payload += names[i].encode() + b"\x00" + struct.pack(
            "<iiii", _PIXELTYPE_FLOAT, 0, 1, 1)
    chan_payload += b"\x00"

    header = b""
    header += _attr("channels", "chlist", chan_payload)
    header += _attr("compression", "compression", b"\x00")  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\x00")      # increasing y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    scan_bytes = w * c * 4
    table_start = 8 + len(header)
    data_start = table_start + 8 * h
    offsets = [data_start + y * (8 + scan_bytes) for y in range(h)]

    with open(path, "wb") as f:
        f.write(struct.pack("<II", _EXR_MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, scan_bytes))
            # channel-planar within the scanline, alphabetical order
            row = image[y]
            f.write(np.ascontiguousarray(row[:, order].T).tobytes())


def _exr_unzip(block: bytes) -> bytes:
    """Undo the EXR zip transform: zlib + delta predictor + two-half byte
    interleave (OpenEXR ImfZip::uncompress order)."""
    raw = bytearray(zlib.decompress(block))
    for i in range(1, len(raw)):
        raw[i] = (raw[i] + raw[i - 1] - 128) & 0xFF
    out = np.empty(len(raw), np.uint8)
    half = (len(raw) + 1) // 2
    a = np.frombuffer(bytes(raw[:half]), np.uint8)
    b = np.frombuffer(bytes(raw[half:]), np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR: float32/half channels, compression in
    {none, ZIPS, ZIP} (what the reference's tinyexr path handles for the
    files this framework and its tools exchange)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _version = struct.unpack_from("<II", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    pos = 8
    channels: list[str] = []
    chan_types: list[int] = []
    data_window = None
    compression = 0
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name_end = buf.index(b"\x00", pos)
        name = buf[pos:name_end].decode()
        pos = name_end + 1
        type_end = buf.index(b"\x00", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                ce = payload.index(b"\x00", p)
                channels.append(payload[p:ce].decode())
                chan_types.append(struct.unpack_from("<i", payload, ce + 1)[0])
                p = ce + 1 + 16
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    if compression not in (_COMPRESSION_NONE, _COMPRESSION_ZIPS,
                           _COMPRESSION_ZIP):
        raise NotImplementedError(
            f"unsupported EXR compression {compression} (none/ZIP/ZIPS only)")
    if any(t == _PIXELTYPE_UINT for t in chan_types):
        raise NotImplementedError("uint EXR channels not supported")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    c = len(channels)
    lines_per_block = {_COMPRESSION_NONE: 1, _COMPRESSION_ZIPS: 1,
                       _COMPRESSION_ZIP: 16}[compression]
    n_blocks = -(-h // lines_per_block)
    pos += 8 * n_blocks  # offset table
    bpp = [2 if t == _PIXELTYPE_HALF else 4 for t in chan_types]
    line_bytes = w * sum(bpp)
    out = np.empty((h, w, c), np.float32)
    for blk in range(n_blocks):
        y_c, nbytes = struct.unpack_from("<ii", buf, pos)
        pos += 8
        data = buf[pos:pos + nbytes]
        pos += nbytes
        n_lines = min(lines_per_block, h - (y_c - y0))
        if compression != _COMPRESSION_NONE:
            if nbytes < n_lines * line_bytes:
                data = _exr_unzip(data)
        for li in range(n_lines):
            y = y_c - y0 + li
            o = li * line_bytes
            for ci in range(c):  # channel-planar, file (alphabetical) order
                if chan_types[ci] == _PIXELTYPE_HALF:
                    row = np.frombuffer(data, np.float16, w, o)
                    o += 2 * w
                else:
                    row = np.frombuffer(data, np.float32, w, o)
                    o += 4 * w
                out[y, :, ci] = row.astype(np.float32)
    # reorder alphabetical -> RGB[A] / Y
    want = ["R", "G", "B", "A"][:c] if c > 1 else channels
    idx = [channels.index(n) for n in want if n in channels]
    return out[..., idx] if len(idx) == c else out


def _linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, srgb: bool = True) -> None:
    """Write (H, W, 3|4) float image as an 8-bit RGB PNG (linear -> sRGB
    unless ``srgb=False``)."""
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    rgb = img[..., :3]
    rgb = _linear_to_srgb(rgb) if srgb else np.clip(rgb, 0, 1)
    out = (rgb * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = out.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),       # filter: none
                          out.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
