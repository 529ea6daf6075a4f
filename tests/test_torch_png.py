"""The port's PNG reader (``elaina_tpu_torch/output/image_io.read_png``)
against Pillow's ``Image.open(p).convert("RGB")``, which the JAX package
reads the scene's mask with: PNGs that Pillow writes, and PNGs of every
colour type, bit depth, filter type and both interlace modes from the
encoder below (Pillow writes no 16-bit RGB, no Adam7 and no chosen
filters).  Where Pillow's array is 8-bit RGB the whole array is compared;
the mask ``np.any(img != 0, axis=-1)`` is compared everywhere.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from elaina_tpu_torch.output.image_io import read_png, write_png

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_rows(lines: list, bpp: int, filters) -> bytes:
    """Filter each scanline with the next type of ``filters`` (cycled)."""
    out, prev = bytearray(), bytes(len(lines[0]))
    for r, line in enumerate(lines):
        ft = filters[r % len(filters)]
        out.append(ft)
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ft]
            out.append((x - pred) & 0xFF)
        prev = line
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> list:
    """(h, w, ch) samples -> scanline bytes at ``depth`` bits."""
    h, w, ch = samples.shape
    if depth == 16:
        return [samples[r].astype(">u2").tobytes() for r in range(h)]
    if depth == 8:
        return [samples[r].astype(np.uint8).tobytes() for r in range(h)]
    bits = ((samples.reshape(h, -1)[..., None]
             >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return [np.packbits(bits[r].reshape(-1)).tobytes() for r in range(h)]


def encode(samples: np.ndarray, depth: int, ctype: int, *,
           interlace: int = 0, filters=(0, 1, 2, 3, 4),
           palette=None, extra=b"", idat_split: int = 1) -> bytes:
    """A PNG of ``samples`` (h, w, ch)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack(sub, depth), bpp, filters)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, filters)
    z = zlib.compress(raw)
    cut = [len(z) * i // idat_split for i in range(idat_split + 1)]
    body = b"".join(_chunk(b"IDAT", z[cut[i]:cut[i + 1]])
                    for i in range(idat_split))
    head = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       interlace))
    if palette is not None:
        head += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + head + extra + _chunk(b"tEXt", b"k\0v")
            + body + _chunk(b"IEND", b""))


def _samples(rng, h, w, ch, depth, special=()):
    hi = 1 << depth
    v = rng.integers(0, hi, (h, w, ch))
    # zeros in patches, so the mask has both values; special values
    v[rng.random((h, w)) < 0.3] = 0
    for k, s in enumerate(special):
        v.reshape(-1)[k::len(special) + 5] = s
    return v


def _compare(path):
    with Image.open(path) as im:
        mode = im.mode
        ref = np.asarray(im.convert("RGB"))
    got = read_png(str(path))
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(np.any(got != 0, axis=-1),
                                  np.any(ref != 0, axis=-1))
    np.testing.assert_array_equal(got, ref)
    return mode


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", [(c, d) for c, ds in DEPTHS.items()
                                         for d in ds])
def test_read_png_matches_pillow(tmp_path, ctype, depth, interlace):
    """Every colour type and bit depth, every filter type on some rows,
    both interlace modes, odd sizes (partial bytes, short Adam7 passes),
    the data over three IDAT chunks; 16-bit samples of 1, 255 and 256."""
    rng = np.random.default_rng(100 * ctype + depth + 7 * interlace)
    special = (1, 255, 256, 65535) if depth == 16 else ()
    h, w = 13, 11
    palette = None
    extra = b""
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth) - 3 if depth > 1 else 1,
                               dtype=np.int64).reshape(-1, 1).repeat(3, 1)
        palette[:, 1] = rng.integers(0, 256, palette.shape[0])
        palette[0] = 0
        extra = _chunk(b"tRNS", bytes([0, 128]))   # dropped by convert
    v = _samples(rng, h, w, CHANNELS[ctype], depth, special)
    path = tmp_path / "x.png"
    path.write_bytes(encode(v, depth, ctype, interlace=interlace,
                            palette=palette, extra=extra, idat_split=3))
    _compare(path)


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
def test_read_png_each_filter(tmp_path, ft):
    """One filter type on every row, RGB and 2-bit grey."""
    rng = np.random.default_rng(ft)
    for ctype, depth in ((2, 8), (0, 2), (6, 16)):
        v = _samples(rng, 9, 10, CHANNELS[ctype], depth)
        path = tmp_path / f"f{ctype}_{depth}.png"
        path.write_bytes(encode(v, depth, ctype, filters=(ft,)))
        _compare(path)


def test_read_png_16bit_masks(tmp_path):
    """16-bit grey is clipped (1 -> 1, 256 -> 255), 16-bit RGB keeps the
    high byte (255 -> 0, 256 -> 1): a pixel of value 1-255 is on in grey
    and off in RGB, as Pillow reads it."""
    vals = np.array([0, 1, 255, 256, 65535])
    grey = vals.reshape(1, 5, 1)
    p = tmp_path / "g.png"
    p.write_bytes(encode(grey, 16, 0))
    assert _compare(p) == "I;16"
    np.testing.assert_array_equal(read_png(str(p))[0, :, 0],
                                  [0, 1, 255, 255, 255])
    rgb = np.repeat(grey, 3, -1)
    p = tmp_path / "c.png"
    p.write_bytes(encode(rgb, 16, 2))
    _compare(p)
    np.testing.assert_array_equal(read_png(str(p))[0, :, 0],
                                  [0, 0, 0, 1, 255])


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "I;16",
                                  "P1", "P2", "P4", "P8"])
def test_read_png_pillow_written(tmp_path, mode):
    """PNGs that Pillow writes (its own filter choice), the test_exec.py
    mask among them."""
    rng = np.random.default_rng(len(mode))
    h, w = 24, 19
    if mode.startswith("P"):
        bits = int(mode[1:])
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w))
                             .astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * (1 << bits)).astype(
            np.uint8).tobytes())
        kw = {"bits": bits}
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
        kw = {}
    else:
        arr = rng.integers(0, 256, (h, w, len(mode))).astype(np.uint8)
        arr[rng.random((h, w)) < 0.4] = 0
        im = Image.fromarray(arr[..., 0] if len(mode) == 1 else arr,
                             "L" if len(mode) == 1 else mode).convert(mode)
        kw = {}
    path = tmp_path / "p.png"
    im.save(path, **kw)
    _compare(path)

    mask = np.zeros((16, 16, 3), np.uint8)
    mask[:, :8] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    _compare(tmp_path / "mask.png")


def test_read_png_reads_write_png(tmp_path):
    """The port's own writer, as chip_smoke.py makes its mask."""
    img = np.random.default_rng(3).random((20, 30, 3)).astype(np.float32)
    write_png(str(tmp_path / "w.png"), img, srgb=False)
    _compare(tmp_path / "w.png")


def _raw_png(w, h, depth, ctype, rows: bytes, interlace=0, extra=b""):
    """A PNG of already filtered scanlines ``rows``, CRCs right."""
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)) + extra
        + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def test_read_png_raises(tmp_path):
    """A file it cannot decode raises ValueError, never a partial array."""
    good = encode(np.ones((4, 4, 3), np.int64), 8, 2)
    row = bytes(1 + 12)
    cases = {
        "not_png": b"GIF89a" + good[6:],
        "bad_crc": good[:40] + bytes([good[40] ^ 1]) + good[41:],
        "truncated": good[:-20],
        "depth_4_rgb": _raw_png(4, 4, 4, 2, bytes(1 + 6) * 4),
        "colour_type_5": _raw_png(4, 4, 8, 5, row * 4),
        "interlace_2": _raw_png(4, 4, 8, 2, row * 4, interlace=2),
        "no_plte": encode(np.ones((4, 4, 1), np.int64), 8, 3),
        "filter_5": _raw_png(4, 4, 8, 2, (bytes([5]) + bytes(12)) * 4),
        "short_data": _raw_png(4, 4, 8, 2, row * 3),
        "bad_zlib": good[:33] + _chunk(b"IDAT", b"x\x9cnot zlib")
        + _chunk(b"IEND", b""),
        "critical_chunk": good.replace(_chunk(b"tEXt", b"k\0v"),
                                       _chunk(b"ABCD", b"x")),
    }
    for name, data in cases.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            read_png(str(p))
