"""Copy of ``elaina_tpu/output/tonemapping.py`` (numpy).

Energy-image tone mapping (reference: util/tonemapping.cuh:6-482).

Tone names match the reference enum so configs parse verbatim:
NONE, NONE_NORMALIZED, MATLAB_JET, MATLAB_PARULA, IDL_RDBU.

The reference embeds piecewise-polynomial fits of the colormaps; here the
same maps are produced from compact public anchor tables with linear
interpolation (visually identical for 8-bit output).
"""

from __future__ import annotations

import numpy as np

# parula anchors (MATLAB's default colormap, public sample points)
_PARULA = np.array([
    [0.2422, 0.1504, 0.6603],
    [0.2810, 0.3228, 0.9579],
    [0.1786, 0.5289, 0.9682],
    [0.0689, 0.6948, 0.8394],
    [0.2161, 0.7843, 0.5923],
    [0.6720, 0.7793, 0.2227],
    [0.9970, 0.7659, 0.2199],
    [0.9769, 0.9839, 0.0805],
], np.float32)

# ColorBrewer RdBu 11-class (IDL's red-blue diverging map), reversed so low
# values map to blue like the reference's IDLRdBu.
_RDBU = np.array([
    [0.0196, 0.1882, 0.3804],
    [0.1294, 0.4000, 0.6745],
    [0.2627, 0.5765, 0.7647],
    [0.5725, 0.7725, 0.8706],
    [0.8196, 0.8980, 0.9412],
    [0.9686, 0.9686, 0.9686],
    [0.9922, 0.8588, 0.7804],
    [0.9569, 0.6471, 0.5098],
    [0.8392, 0.3765, 0.3020],
    [0.6980, 0.0941, 0.1686],
    [0.4039, 0.0000, 0.1216],
], np.float32)[::-1].copy()


def _interp_map(t: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    n = anchors.shape[0]
    x = t * (n - 1)
    i0 = np.clip(np.floor(x).astype(np.int32), 0, n - 2)
    f = (x - i0)[..., None]
    return anchors[i0] * (1 - f) + anchors[i0 + 1] * f


def _jet(t: np.ndarray) -> np.ndarray:
    """MATLAB jet, analytic form: blue -> cyan -> yellow -> red."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4 * t - 1.0), 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


TONES = ("NONE", "NONE_NORMALIZED", "MATLAB_JET", "MATLAB_PARULA", "IDL_RDBU")


def luminance(rgb: np.ndarray) -> np.ndarray:
    return (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2])


def apply_tone(rgb: np.ndarray, tone: str) -> np.ndarray:
    """Energy mapping like Film::saveEnergy (util/film.h:107-144): luminance
    -> min/max normalize -> colormap."""
    if tone == "NONE":
        return rgb
    lum = luminance(rgb)
    finite = np.isfinite(lum)
    lo = float(lum[finite].min()) if finite.any() else 0.0
    hi = float(lum[finite].max()) if finite.any() else 1.0
    t = (lum - lo) / max(hi - lo, 1e-20)
    t = np.where(finite, t, 1.0)
    if tone == "NONE_NORMALIZED":
        return np.repeat(t[..., None], 3, -1)
    if tone == "MATLAB_JET":
        return _jet(t)
    if tone == "MATLAB_PARULA":
        return _interp_map(t, _PARULA)
    if tone == "IDL_RDBU":
        return _interp_map(t, _RDBU)
    raise ValueError(f"unknown tone mapping {tone!r} (expected one of {TONES})")
