"""The full-scale synthetic 2D scene of ``chip_smoke.py`` and the profiler.

The reference's own ``u.json`` workload (configs/ladybug_u.json) runs on a
~61k-segment Dirichlet drawing that is not in the repository.  This scene
stands in at the same scale: 65,536 Dirichlet segments in 63 closed loops
inside a 4-segment Neumann box, with the config's settings (1024^2 frame,
depth 64, eps 1, aabb [-100, 600]^2, evaluation grid at 250 / 250).

A single smooth curve of 65,536 segments is no scene the candidate grid
can hold: near its medial axis every cell's band spans hundreds of
near-equidistant segments, and bench.py's lobed curve at that count
refines to 14.1M rows (measured on an H100 host), past the FinePack's
2^20-row field (the reference's limit too).  Drawings are many short
loops, so the scene is bench.py's lobed outline at its 2,048 segments
plus lobed spots of 1,024 segments on a lattice inside it.
"""

from __future__ import annotations

import json
import os

import numpy as np

SEGMENTS = 65_536
FRAME = 1024
DEPTH = 64
EPS = 1.0
CENTER = (250.0, 250.0)


def lobed_curve(n: int, r0: float = 200.0, amp: float = 50.0,
                center=CENTER) -> np.ndarray:
    """bench.py's lobed curve, r = r0 + amp sin(9t), as (n, 2) vertices."""
    t = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    r = r0 + amp * np.sin(9 * t)
    return (np.stack([r * np.cos(t), r * np.sin(t)], -1)
            + np.asarray(center)).astype(np.float32)


def outline_radius(theta: np.ndarray) -> np.ndarray:
    """Radius of the outline at polar angle theta around CENTER."""
    return 200.0 + 50.0 * np.sin(9 * theta)


def dirichlet_loops(segments: int = SEGMENTS) -> list[np.ndarray]:
    """The outline and, to reach ``segments``, spots of 1,024 segments
    (r = 10 + 2.5 sin(9t)) on the 29-unit lattice points nearest the
    centre, all inside the outline."""
    loops = [lobed_curve(2048)]
    n_spots = (segments - 2048) // 1024
    ij = np.stack(np.meshgrid(np.arange(-6, 7), np.arange(-6, 7)),
                  -1).reshape(-1, 2) * 29.0
    ij = ij[np.argsort(np.hypot(ij[:, 0], ij[:, 1]), kind="stable")]
    for c in ij[:n_spots]:
        loops.append(lobed_curve(1024, 10.0, 2.5,
                                 (CENTER[0] + c[0], CENTER[1] + c[1])))
    return loops


def write_obj(path: str, loops: list[np.ndarray]) -> None:
    """Closed polylines as OBJ vertices and line elements."""
    with open(path, "w") as f:
        for verts in loops:
            f.writelines(f"v {x:.6f} {y:.6f} 0\n" for x, y in verts)
        base = 1
        for verts in loops:
            n = len(verts)
            f.writelines(f"l {base + i} {base + (i + 1) % n}\n"
                         for i in range(n))
            base += n


def write_scene(root: str, spp: int, segments: int = SEGMENTS,
                frame: int = FRAME) -> str:
    """Scene files (curve and box OBJs, seeded two-sided vertex colors)
    and a reference-schema config under ``root``; returns its path."""
    loops = dirichlet_loops(segments)
    write_obj(os.path.join(root, "curve.obj"), loops)
    box = np.array([[-50, -50], [550, -50], [550, 550], [-50, 550]],
                   np.float32)
    write_obj(os.path.join(root, "box.obj"), [box])
    n_verts = sum(len(v) for v in loops)
    colors = np.random.default_rng(0).uniform(0, 1, (n_verts, 2, 3))
    np.savez(os.path.join(root, "colors.npz"),
             colors=colors.astype(np.float32))
    conf = {
        "dimensionality": 2,
        "base_path": os.path.join(root, "exp") + "/",
        "exp_name": "lobed_u",
        "integrator": {
            "setting": {"frameSize": [frame, frame],
                        "maxWalkingDepth": DEPTH, "samplesPerPixel": spp,
                        "saveSppMetricsDuration": -1,
                        "saveSppMetricsUntil": -1,
                        "saveTimeMetricsDuration": -1,
                        "epsilonShell": EPS},
            "type": "uniform",
            "channels": ["SOLUTION"],
        },
        "export": [
            {"type": "image", "channel": "SOLUTION", "file_name": "solution"},
            {"type": "energy", "tone": "IDL_RDBU", "channel": "SOLUTION",
             "file_name": "solution_energy_rdbu"},
        ],
        "scene": {
            "aabb": {"min": [-100.0, -100.0], "max": [600.0, 600.0]},
            "evaluation_grid": {"mData": {"pos": list(CENTER),
                                          "scale": 250, "up": [-1.0, 0.0]}},
            "mesh": {"dirichlet_path": os.path.join(root, "curve.obj"),
                     "vertex_color_dirichlet_path":
                         os.path.join(root, "colors.npz"),
                     "neumann_path": os.path.join(root, "box.obj")},
        },
    }
    path = os.path.join(root, "lobed_u.json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path
