"""Image IO: uncompressed OpenEXR writer/reader, a stdlib PNG writer and
PNG reader.

The EXR functions are copies of ``elaina_tpu/output/image_io.py``.
``write_png`` and ``read_png`` use ``zlib`` and ``struct`` from the
standard library, where the reference and the JAX package use Pillow:
``read_png`` gives the array of Pillow's ``Image.open(p).convert("RGB")``
(it reads the scene's mask image, ``Problem.load_config``).
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, the bit depths the PNG spec allows)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunks(buf: bytes, path: str):
    """(tag, data) of each chunk, CRC checked, up to IEND."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 8 > len(buf):
            raise ValueError(f"{path}: PNG truncated before IEND")
        n, tag = struct.unpack_from(">I4s", buf, pos)
        data = buf[pos + 8:pos + 8 + n]
        if len(data) < n or pos + 12 + n > len(buf):
            raise ValueError(f"{path}: PNG chunk {tag!r} truncated")
        (crc,) = struct.unpack_from(">I", buf, pos + 8 + n)
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {tag!r} fails its CRC")
        pos += 12 + n
        yield tag, data
        if tag == b"IEND":
            return


def _png_unfilter(x: np.ndarray, filt: np.ndarray, bpp: int,
                  path: str) -> np.ndarray:
    """Undo the scanline filters of one image (or Adam7 pass): ``x`` (h,
    stride) filtered bytes, ``filt`` (h,) their filter types (0-4).

    A byte depends on the byte ``bpp`` to its left (a), the byte above
    (b) and the one above-left (c), so the pixels on one anti-diagonal
    (row + pixel column = t) depend only on the two diagonals before it:
    the rows are skewed so that each diagonal is one column, and the
    image is undone in h + w column steps, every row at once."""
    if filt.size and filt.max() > 4:
        raise ValueError(f"{path}: PNG filter type {int(filt.max())} "
                         f"(0-4 only)")
    h, stride = x.shape
    w = stride // bpp
    t_n = h + w
    rows = np.arange(h)[:, None]
    cols = rows + np.arange(w)[None, :]
    xs = np.zeros((h, t_n, bpp), np.int16)
    xs[rows, cols] = x.reshape(h, w, bpp)
    valid = np.zeros((h, t_n), bool)
    valid[rows, cols] = True
    # row 0 of s is the zero row above the image; column 0 the zero pixel
    # left of it, so s[r + 1, t + 1] is pixel (r, t - r)
    s = np.zeros((h + 1, t_n + 1, bpp), np.int16)
    f = filt[:, None]
    for t in range(t_n):
        a = s[1:, t]
        b = s[:-1, t]
        c = s[:-1, t - 1] if t > 0 else np.zeros_like(b)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        s[1:, t + 1] = np.where(valid[:, t, None],
                                (xs[:, t] + pred) & 0xFF, 0)
    return s[1:, 1:][rows, cols].reshape(h, stride).astype(np.uint8)


def _png_samples(raw: bytes, w: int, h: int, depth: int, n_ch: int,
                 path: str) -> tuple[np.ndarray, int]:
    """One image (or Adam7 pass) of ``h`` filtered scanlines from the
    front of ``raw``: its samples (h, w, n_ch) as int32, and the bytes it
    used."""
    stride = (w * n_ch * depth + 7) // 8
    bpp = max(1, n_ch * depth // 8)
    size = h * (stride + 1)
    if len(raw) < size:
        raise ValueError(f"{path}: PNG image data truncated")
    rows = np.frombuffer(raw, np.uint8, size).reshape(h, stride + 1)
    x = _png_unfilter(rows[:, 1:], rows[:, 0], bpp, path)
    if depth == 16:
        v = x.view(">u2").astype(np.int32)
    elif depth == 8:
        v = x.astype(np.int32)
    else:
        bits = np.unpackbits(x, axis=1).reshape(h, -1, depth)
        v = (bits.astype(np.int32) << np.arange(depth - 1, -1, -1)).sum(-1)
    return v[:, :w * n_ch].reshape(h, w, n_ch), size


def read_png(path: str) -> np.ndarray:
    """Read a PNG as (H, W, 3) uint8, the array of Pillow's
    ``Image.open(path).convert("RGB")``: every colour type and bit depth
    of the PNG spec, filters 0-4, Adam7 interlacing.  Alpha and ``tRNS``
    are dropped, a palette index past ``PLTE`` is black, grey below 8 bits
    is scaled to 0-255, and at 16 bits grey is clipped to 255 while RGB,
    grey + alpha and RGBA keep the high byte (so an RGB sample of 1-255
    is 0), as Pillow 12 reads them.  Raises ValueError on a file it cannot
    decode."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for tag, data in _png_chunks(buf, path):
        if tag == b"IHDR":
            if len(data) != 13:
                raise ValueError(f"{path}: PNG IHDR of {len(data)} bytes")
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            if len(data) % 3 or len(data) > 768:
                raise ValueError(f"{path}: PNG palette of {len(data)} bytes")
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag != b"IEND" and not tag[0] & 0x20:
            raise ValueError(f"{path}: unknown critical PNG chunk {tag!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if ctype not in _PNG_TYPES or depth not in _PNG_TYPES[ctype][1]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth} is not in the PNG spec")
    if comp != 0 or filt_method != 0 or interlace not in (0, 1):
        raise ValueError(f"{path}: PNG compression {comp}, filter method "
                         f"{filt_method}, interlace {interlace}")
    if w == 0 or h == 0:
        raise ValueError(f"{path}: PNG of {w}x{h} pixels")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG image data: {e}") from None
    n_ch = _PNG_TYPES[ctype][0]
    if interlace == 0:
        v, _ = _png_samples(raw, w, h, depth, n_ch, path)
    else:
        v = np.zeros((h, w, n_ch), np.int32)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue           # an empty pass has no scanlines
            v[y0::dy, x0::dx], size = _png_samples(raw[pos:], pw, ph, depth,
                                                   n_ch, path)
            pos += size

    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return lut[v[..., 0]]
    if ctype in (0, 4):
        g = v[..., 0]
        if depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        elif depth == 16:
            g = np.minimum(g, 255) if ctype == 0 else g >> 8
        return np.repeat(g.astype(np.uint8)[..., None], 3, -1)
    rgb = v[..., :3]
    return (rgb >> 8 if depth == 16 else rgb).astype(np.uint8)
