"""The scenes of ``chip_smoke.py``: a full-scale synthetic 2D scene (its
Neumann box straight or traced as a wavy curve of many segments, its
Dirichlet set cut down to bench.py's curve alone), the same scene with
the guided integrator of ``configs/ladybug_n.json``, bench.py's own scene,
the repository's 3D configs with their data in the checkout (as shipped,
neumann3d_u with a volumetric source, or neumann3d_u's scene with
bumpy3d_n's guided integrator), and the mixed Dirichlet/Neumann cube
(with or without a unit source).

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

from .build import REPO_DIR

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


def bench_square_scene():
    """``bench.py``'s own scene without the reference data
    (``_build_square_problem``): the lobed curve at 2,048 segments, closed,
    and its seed-0 two-sided vertex colors.  (verts (2048, 2), indices
    (2048, 2) int32, colors (2048, 2, 3)) as numpy arrays."""
    verts = lobed_curve(2048)
    n = len(verts)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    colors = np.random.default_rng(0).uniform(0, 1, (n, 2, 3))
    return verts, idx, colors.astype(np.float32)


def neumann_box(segments: int = 4, amp: float = 4.0,
                periods: int = 32) -> np.ndarray:
    """The Neumann box [-50, 550]^2 as one closed CCW loop of
    ``segments`` vertices: its 4 corners, or above 4 each side cut into
    segments / 4 pieces and displaced along its normal by amp sin(2 pi
    periods s), s in [0, 1] along the side (zero at the corners)."""
    corners = np.array([[-50, -50], [550, -50], [550, 550], [-50, 550]],
                       np.float64)
    if segments == 4:
        return corners.astype(np.float32)
    if segments % 4:
        raise ValueError(f"{segments} segments: a multiple of 4")
    s = np.arange(segments // 4) / (segments // 4)
    sides = []
    for k in range(4):
        a, b = corners[k], corners[(k + 1) % 4]
        e = (b - a) / np.linalg.norm(b - a)
        normal = np.array([e[1], -e[0]])                  # outward
        sides.append(a + s[:, None] * (b - a)
                     + amp * np.sin(2 * np.pi * periods * s)[:, None]
                     * normal)
    return np.concatenate(sides).astype(np.float32)


def dirichlet_loops(segments: int = SEGMENTS) -> list[np.ndarray]:
    """The outline and, to reach ``segments``, spots of 1,024 segments
    (r = 10 + 2.5 sin(9t)) on the 29-unit lattice points nearest the
    centre, all inside the outline.  At most 2,048 segments: the outline
    alone, cut into that many."""
    if segments <= 2048:
        return [lobed_curve(segments)]
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
                frame: int = FRAME, neumann_segments: int = 4) -> str:
    """Scene files (curve and box OBJs, seeded two-sided vertex colors)
    and a reference-schema config under ``root``; returns its path.  The
    box is ``neumann_box(neumann_segments)``."""
    loops = dirichlet_loops(segments)
    write_obj(os.path.join(root, "curve.obj"), loops)
    write_obj(os.path.join(root, "box.obj"), [neumann_box(neumann_segments)])
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


def write_lobed_n(root: str, spp: int, train_spp: int,
                  segments: int = SEGMENTS, frame: int = FRAME,
                  network: dict | None = None) -> str:
    """lobed_n: the scene of ``write_scene`` with the guided integrator
    and the network of ``configs/ladybug_n.json`` (the reference's own
    ``n.json``: DenseGrid 8 levels x 4 features, MLP 64 x 3, Adam + EMA,
    uniform fraction 0.5 and max guided depth 10 in both phases).  Cut:
    ``spp`` samples of which ``train_spp`` train (the config: 1,024 and
    256); ``segments``, ``frame`` and ``network`` (its blocks replacing
    the config's) cut it further for tests.  Returns the config's path."""
    return _guided_copy(write_scene(root, spp, segments=segments,
                                    frame=frame), "ladybug_n", "lobed_n",
                        train_spp, network)


def _guided_copy(path: str, ref_name: str, exp_name: str, train_spp: int,
                 network: dict | None = None) -> str:
    """The config at ``path`` with the guided integrator settings and the
    network of ``configs/<ref_name>.json`` (``network``'s blocks replacing
    its), ``train_spp`` training samples, written beside it as
    ``<exp_name>.json``.  Returns that path."""
    with open(path) as f:
        conf = json.load(f)
    with open(os.path.join(REPO_DIR, "configs", ref_name + ".json")) as f:
        ref = json.load(f)
    guided = {k: v for k, v in ref["integrator"]["setting"].items()
              if k.startswith(("uniformFraction", "maxGuidedDepth"))}
    conf["exp_name"] = exp_name
    conf["integrator"]["type"] = "guided"
    conf["integrator"]["setting"].update(guided, trainSppCount=train_spp)
    conf["network"] = dict(ref["network"], **(network or {}))
    path = os.path.join(os.path.dirname(path), exp_name + ".json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path


def write_per_sample(conf_path: str, exp_name: str) -> str:
    """A copy of a config beside it, named ``exp_name``, that takes the
    per-sample route: metric frames asked for (saveSppMetricsDuration 1)
    and none written (saveSppMetricsUntil 0).  Returns its path."""
    with open(conf_path) as f:
        conf = json.load(f)
    conf["exp_name"] = exp_name
    conf["integrator"]["setting"].update(saveSppMetricsDuration=1,
                                         saveSppMetricsUntil=0)
    path = os.path.join(os.path.dirname(conf_path), exp_name + ".json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path


def _data_path(path: str) -> str:
    return os.path.join(REPO_DIR, "configs", "data", os.path.basename(path))


def write_config_copy(root: str, name: str, spp: int,
                      train_spp: int | None = None) -> str:
    """``configs/<name>.json`` as shipped, channels and exports included,
    with its data files in this checkout, ``spp`` samples (of which
    ``train_spp`` train, where given: a guided config) and outputs under
    ``root``; returns the copy's path."""
    with open(os.path.join(REPO_DIR, "configs", name + ".json")) as f:
        conf = json.load(f)
    mesh = conf["scene"]["mesh"]
    for key, path in mesh.items():
        mesh[key] = _data_path(path)
    if "source_path" in conf["scene"]:
        conf["scene"]["source_path"] = _data_path(conf["scene"]["source_path"])
    conf["base_path"] = os.path.join(root, "exp") + "/"
    conf["integrator"]["setting"]["samplesPerPixel"] = spp
    if train_spp is not None:
        conf["integrator"]["setting"]["trainSppCount"] = train_spp
    path = os.path.join(root, name + ".json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path


def write_neumann3d_n(root: str, spp: int, train_spp: int) -> str:
    """neumann3d_n: ``configs/neumann3d_u.json``'s scene, channels and
    exports (the 768-triangle Dirichlet cube, the 20,480-triangle Neumann
    blob, SOLUTION and DIRICHLET_SDF, 256^2, depth 64, eps 0.01) with the
    guided integrator settings and the network of
    ``configs/bumpy3d_n.json`` (DenseGrid 8 levels x 4 features, MLP 64 x
    3, Adam + EMA, uniform fraction 0.5 and max guided depth 10 in both
    phases), ``spp`` samples of which ``train_spp`` train.  Returns the
    config's path."""
    return _guided_copy(write_config_copy(root, "neumann3d_u", spp),
                        "bumpy3d_n", "neumann3d_n", train_spp)


def smooth_source(res: int, lo, hi) -> dict:
    """A smooth positive RGB field over the box [lo, hi]^3 at res^3
    voxels, as a dense ``.npz`` source's arrays: data (res, res, res, 3),
    origin (the first voxel's centre) and voxel_size."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    voxel = (hi - lo) / (res - 1)
    x, y, z = np.meshgrid(*[lo[d] + voxel[d] * np.arange(res)
                            for d in range(3)], indexing="ij")
    data = np.stack([1.0 + 0.5 * np.sin(np.pi * (x + c / 3.0))
                     * np.cos(0.5 * np.pi * y) * np.cos(0.5 * np.pi * z)
                     for c in range(3)], axis=-1)
    return dict(data=data.astype(np.float32), origin=lo, voxel_size=voxel)


def write_neumann3d_source(root: str, spp: int, res: int = 64) -> str:
    """``configs/neumann3d_u.json`` as shipped plus a volumetric source:
    ``source_path`` (``smooth_source`` at res^3 over the scene box, as
    ``.npz``) and ``source_intensity`` 1, the reference schema's keys
    (``configs/ladybug_source.json``), and the SOURCE channel with an
    image export of it.  Returns the config's path."""
    path = write_config_copy(root, "neumann3d_u", spp)
    with open(path) as f:
        conf = json.load(f)
    aabb = conf["scene"]["aabb"]
    src = os.path.join(root, "neumann3d_source.npz")
    np.savez(src, **smooth_source(res, aabb["min"], aabb["max"]))
    conf["exp_name"] = "neumann3d_source"
    conf["scene"].update(source_path=src, source_intensity=1.0)
    conf["integrator"]["channels"] = ["SOLUTION", "SOURCE"]
    conf["export"].append({"type": "image", "channel": "SOURCE",
                           "file_name": "source"})
    path = os.path.join(root, "neumann3d_source.json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path


def cube_boundary(n: int = 3, faces=(0, 1, 2, 3, 4, 5)):
    """The triangulated surface of [-1, 1]^3, n x n squares a face, welded
    (tests/test_wost_3d.py::_cube_boundary).  Faces 0/1 are -x/+x, 2/3
    -y/+y, 4/5 -z/+z."""
    verts, tris = [], []
    for face in faces:
        axis, sign = face // 2, (face % 2) * 2 - 1
        u_ax, v_ax = [a for a in range(3) if a != axis]
        base = len(verts)
        for i in range(n + 1):
            for j in range(n + 1):
                p = np.zeros(3, np.float32)
                p[axis] = sign
                p[u_ax] = -1 + 2 * i / n
                p[v_ax] = -1 + 2 * j / n
                verts.append(p)
        for i in range(n):
            for j in range(n):
                a = base + i * (n + 1) + j
                b, c, d = a + 1, a + (n + 1), a + (n + 1) + 1
                tris.extend([(a, b, d), (a, d, c)])
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.int32)
    keys = np.round(verts * 1e5).astype(np.int64)
    _, first, inverse = np.unique(keys, axis=0, return_index=True,
                                  return_inverse=True)
    remap = np.empty(len(first), np.int32)
    remap[np.argsort(first)] = np.arange(len(first))
    return verts[np.sort(first)], remap[inverse.reshape(-1)][tris]


def write_mixed_cube(root: str, n: int = 3) -> dict:
    """The mixed cube as OBJs under ``root``: Dirichlet faces x = -1 and
    x = 1 colored u = (x + 1) / 2, zero Neumann on the other four, whose
    solution is u = (x + 1) / 2; ``n`` x ``n`` squares a face (n = 33: the
    Dirichlet set's 4,356 and the Neumann set's 8,712 triangles pass the
    BVH route's CHUNKED_DENSE_MAX).  Returns the config's ``scene``
    entry."""
    paths = {}
    for name, faces in (("dirichlet", (0, 1)), ("neumann", (2, 3, 4, 5))):
        v, t = cube_boundary(n, faces)
        paths[name] = os.path.join(root, f"cube_{name}.obj")
        with open(paths[name], "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in v)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in t)
        if name == "dirichlet":
            u = ((v[:, 0] + 1.0) / 2.0).astype(np.float32)
            colors = np.repeat(np.repeat(u[:, None, None], 2, 1), 3, 2)
            paths["colors"] = os.path.join(root, "cube_colors.npz")
            np.savez(paths["colors"], colors=colors)
    return {"aabb": {"min": [-1.0] * 3, "max": [1.0] * 3},
            "evaluation_grid": {"mData": {"pos": [0.0] * 3, "scale": 1.0}},
            "mesh": {"dirichlet_path": paths["dirichlet"],
                     "vertex_color_dirichlet_path": paths["colors"],
                     "neumann_path": paths["neumann"]}}


def write_mixed_cube_source(root: str) -> dict:
    """The mixed cube of ``write_mixed_cube`` with a unit source over the
    box: -Laplace u = 1 gives u = (x + 1) / 2 + (1 - x^2) / 2, which still
    meets the Dirichlet data at x = +-1 and has zero normal derivative on
    the Neumann faces.  The dense ``.npz`` grid is 1 on the voxels of
    [-1, 1]^3 (so every sample inside the box is exactly 1) and 0 one
    voxel beyond: a walk that leaves the box through a Neumann face (a
    step ending within the rays' 1e-6 of the face, unflagged, can cross
    it) takes steps as large as its distance to the box, and a source of
    1 out there would weigh them by R^2 / 6 without bound.  Returns the
    config's ``scene`` entry."""
    scene = write_mixed_cube(root)
    path = os.path.join(root, "cube_source.npz")
    data = np.zeros((11, 11, 11), np.float32)
    data[1:-1, 1:-1, 1:-1] = 1.0
    np.savez(path, data=data, origin=np.full(3, -1.25, np.float32),
             voxel_size=np.full(3, 0.25, np.float32))
    scene.update(source_path=path, source_intensity=1.0)
    return scene
