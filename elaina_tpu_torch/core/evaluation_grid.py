"""Evaluation grid: pixel id -> world-space evaluation point.

Port of ``elaina_tpu/core/evaluation_grid.py`` (reference:
core/evaluation_grid.h).  The arithmetic follows the reference op for op
in float32, so the points match it pixel for pixel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class EvaluationGrid:
    dim: int
    scale: float
    pos: np.ndarray    # (D,) f32
    up: np.ndarray     # (D,) f32
    right: np.ndarray  # (D,) f32, 3D only

    @classmethod
    def from_json(cls, conf: dict, dim: int) -> "EvaluationGrid":
        m = conf.get("mData", conf)
        up_default = [0.0, 1.0] if dim == 2 else [0.0, 0.0, 1.0]
        right_default = [1.0, 0.0, 0.0] if dim == 3 else [1.0, 0.0]
        return cls(
            dim=dim, scale=float(m.get("scale", 1.0)),
            pos=np.asarray(m.get("pos", [0.0] * dim), np.float32),
            up=np.asarray(m.get("up", up_default), np.float32),
            right=np.asarray(m.get("right", right_default), np.float32))

    def points(self, pixel_ids: torch.Tensor, frame_size) -> torch.Tensor:
        """(N,) integer pixel ids -> (N, D) evaluation points.  2D maps NDC
        through (perp(up), up), 3D through (right, up)."""
        w, h = frame_size
        dev = pixel_ids.device
        px = (pixel_ids % w).to(torch.float32)
        py = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
        ndc_x = 2.0 * px / w - 1.0
        ndc_y = 2.0 * py / h - 1.0
        up = torch.as_tensor(self.up, device=dev)
        if self.dim == 2:
            u = torch.stack([up[1], -up[0]])
        else:
            u = torch.as_tensor(self.right, device=dev)
        v = up
        pos = torch.as_tensor(self.pos, device=dev)
        return (self.scale * (ndc_x[:, None] * u[None] + ndc_y[:, None] * v[None])
                + pos[None])
