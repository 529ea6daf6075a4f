"""Film: weighted accumulation image + save paths.

Copy of ``elaina_tpu/output/film.py`` (numpy).

Reference: util/film.h:16-155 (WeightedPixel accumulation, save =
weight-normalize -> EXR & PNG, saveEnergy = luminance -> normalize ->
colormap).  Host-side numpy; the solver hands over full frames at once, so
no per-pixel device traffic.
"""

from __future__ import annotations

import os

import numpy as np

from .image_io import write_exr, write_png
from .tonemapping import apply_tone


class Film:
    def __init__(self, size):
        self.size = tuple(size)  # (W, H)
        w, h = self.size
        self.rgba = np.zeros((h, w, 4), np.float32)
        self.weight = np.zeros((h, w), np.float32)

    def reset(self):
        self.rgba[:] = 0
        self.weight[:] = 0

    def put_frame(self, rgb: np.ndarray, weight: float = 1.0):
        """Accumulate a full (N|H*W, 3) or (H, W, 3) frame (Film::put)."""
        w, h = self.size
        rgb = np.asarray(rgb, np.float32).reshape(h, w, -1)
        self.rgba[..., :3] += rgb[..., :3] * weight
        self.rgba[..., 3] += weight
        self.weight += weight

    def pixels(self) -> np.ndarray:
        """Weight-normalized (H, W, 4)."""
        w = np.maximum(self.weight, 1e-20)[..., None]
        out = self.rgba / w
        out[..., 3] = np.where(self.weight > 0, 1.0, 0.0)
        return out.astype(np.float32)

    def save(self, path: str):
        """EXR (linear float) or PNG (sRGB 8-bit) by extension
        (film.h:93-105)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        img = self.pixels()
        if path.endswith(".exr"):
            write_exr(path, img)
        else:
            write_png(path, img)

    def save_energy(self, path: str, tone: str):
        """Colormapped energy image (film.h:107-144)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        img = self.pixels()[..., :3]
        mapped = apply_tone(img, tone)
        if path.endswith(".exr"):
            write_exr(path, mapped.astype(np.float32))
        else:
            write_png(path, mapped, srgb=False)
