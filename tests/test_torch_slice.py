"""The 2D uniform slice of the PyTorch port as a whole.

(a) The mixed Dirichlet/Neumann square of
``tests/test_wost_uniform.py::test_mixed_dirichlet_neumann_linear``:
u = (x + 1) / 2 within the same bound at the same three points.
(b) The port and ``elaina_tpu`` solve a small circle scene through their
CLIs (``run_expr``); both write a frame after every sample, from which each
side's per-pixel mean and standard error follow.  The two estimators are
the same, their random numbers are not, so the images must agree within
their combined Monte Carlo error.  The circle runs at 64 segments (no
candidate grid: the exact closest segment on every lane) and at 512
(K = 256 rows that hold a subset of the set, on several levels), where the
FinePack's lower bound is the star radius of every lane it leaves
unresolved.
"""

import json
from functools import partial
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elaina_tpu.output.image_io import read_exr  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.core.problem import (  # noqa: E402
    GRID_ACCEL_MIN_PRIMS, Problem, grid_bounds, grid_size_for,
    scene_from_numpy)
from elaina_tpu_torch.geometry.grid import build_candidate_grid  # noqa: E402
from elaina_tpu_torch.solver.integrator import UniformIntegrator  # noqa: E402

CPU = torch.device("cpu")


def _square_side(sides, n_per_side=6, half=1.0):
    """tests/test_wost_uniform.py::_square_boundary."""
    corners = np.array([[-half, -half], [half, -half], [half, half],
                        [-half, half]], np.float32)
    verts, indices = [], []
    for s in sides:
        a, b = corners[s], corners[(s + 1) % 4]
        base = len(verts)
        pts = a[None] + np.linspace(0, 1, n_per_side + 1)[:, None] * (b - a)[None]
        verts.extend(pts)
        indices.extend([(base + i, base + i + 1) for i in range(n_per_side)])
    return np.asarray(verts, np.float32), np.asarray(indices, np.int32)


def test_mixed_dirichlet_neumann_square():
    """Dirichlet u = (x+1)/2 on the left and right walls, zero Neumann on
    the top and bottom: u = (x+1)/2 inside.  256 walks per point of depth
    64 at eps 0.02, as the JAX test runs them; they run as 64 lanes per
    point and 4 samples, the same estimator in a quarter of the steps."""
    dv, di = _square_side((1, 3))
    nv, ni = _square_side((0, 2))
    dc = np.repeat(((dv[:, 0] + 1.0) / 2.0)[:, None, None], 2, 1)
    dc = np.repeat(dc, 3, 2).astype(np.float32)
    nc = np.zeros((len(nv), 2, 3), np.float32)
    lo, hi = grid_bounds(dv, [-1, -1], [1, 1])
    K, max_res = grid_size_for(len(di))
    ga = build_candidate_grid(dv, di, lo, hi, K=K, max_res=max_res)

    problem = Problem(2, CPU, verbose=False)
    problem.scene = scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=CPU, dirichlet=(dv, di, dc),
        neumann=(nv, ni, nc), grid=vars(ga))
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8]], np.float32)
    reps = 64
    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0))
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=4, maxWalkingDepth=64,
                                  epsilonShell=0.02)
    integ = UniformIntegrator(problem, settings, "unused", points=lanes)
    integ.solve()
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(3, reps).mean(1)
    np.testing.assert_allclose(u, (pts[:, 0] + 1.0) / 2.0, atol=0.07)
    assert integ.total_walk_steps > len(lanes) * 4 * 3


def _write_scene(tmp_path, n=64):
    obj = tmp_path / "circle.obj"
    with open(obj, "w") as f:
        for i in range(n):
            t = 2 * math.pi * i / n
            f.write(f"v {math.cos(t)} {math.sin(t)} 0\n")
        for i in range(n):
            f.write(f"l {i + 1} {(i + 1) % n + 1}\n")
    colors = tmp_path / "colors.npz"
    rng = np.random.default_rng(11)
    np.savez(colors, colors=rng.uniform(0, 1, (n, 2, 3)).astype(np.float32))
    return str(obj), str(colors)


def _conf(tmp_path, exp_name, spp, obj, colors, depth=64):
    return {
        "dimensionality": 2,
        "base_path": str(tmp_path / "exp") + "/",
        "exp_name": exp_name,
        "integrator": {
            "setting": {"frameSize": [16, 16], "maxWalkingDepth": depth,
                        "samplesPerPixel": spp, "epsilonShell": 0.005,
                        "saveSppMetricsDuration": 1,
                        "saveSppMetricsUntil": spp},
            "type": "uniform",
            "channels": ["SOLUTION"],
        },
        "export": [
            {"type": "image", "channel": "SOLUTION", "file_name": "solution"},
            {"type": "energy", "tone": "MATLAB_JET", "channel": "SOLUTION",
             "file_name": "energy"},
        ],
        "scene": {
            "aabb": {"min": [-1.2, -1.2], "max": [1.2, 1.2]},
            "evaluation_grid": {"mData": {"scale": 0.7, "pos": [0, 0],
                                          "up": [0, 1]}},
            "mesh": {"dirichlet_path": obj,
                     "vertex_color_dirichlet_path": colors},
        },
    }


def _samples(out_dir, spp):
    """Per-sample images (spp, H, W, 3) from the running-mean frames."""
    means = np.stack([read_exr(os.path.join(out_dir, "frames", f"{i}.exr"))
                      [..., :3].astype(np.float64) for i in range(spp)])
    k = np.arange(1, spp + 1, dtype=np.float64)[:, None, None, None]
    sums = means * k
    return np.diff(sums, axis=0, prepend=0.0)


def _cli_parity(tmp_path, monkeypatch, n_segments, depth=64):
    """Both CLIs on an n-segment circle; returns the port's result.json."""
    from elaina_tpu.exec import run_expr as run_jax
    from elaina_tpu_torch.exec import run_expr

    run_port = partial(run_expr, device="cpu")

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    spp = 32
    obj, colors = _write_scene(tmp_path, n_segments)
    runs = {}
    for name, run in (("jax", run_jax), ("port", run_port)):
        conf = _conf(tmp_path, name, spp, obj, colors, depth)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(conf))
        result = run(str(path))
        out = tmp_path / "exp" / name
        for f in ("conf.json", "result.json", "solution.exr",
                  "solution.png", "energy.exr", "energy.png"):
            assert (out / f).exists(), (name, f)
        assert result["duration"] >= 0 and result["walk_steps"] > 0
        runs[name] = _samples(str(out), spp)
        final = read_exr(str(out / "solution.exr"))[..., :3]
        np.testing.assert_allclose(runs[name].mean(0), final, atol=1e-4)
    rp = json.loads((tmp_path / "exp" / "port" / "result.json").read_text())
    assert rp["device"] == "cpu"
    if n_segments > GRID_ACCEL_MIN_PRIMS:
        # the need bit leaves some live lane-steps to the FinePack's bound
        assert 0 < rp["resolved_lanes"] < rp["walk_steps"]
        assert rp["table_bytes"]["coords"] > 0
    else:
        # no candidate grid: every live lane-step is resolved exactly
        assert rp["resolved_lanes"] == rp["walk_steps"]
        assert rp["table_bytes"] == {}

    mp, mj = runs["port"].mean(0), runs["jax"].mean(0)
    var = (runs["port"].var(0, ddof=1) + runs["jax"].var(0, ddof=1)) / spp
    assert np.isfinite(mp).all() and mp.max() > 0.1
    diff = np.abs(mp - mj)
    within = diff <= 4.0 * np.sqrt(var) + 1e-5
    assert within.mean() >= 0.99, (within.mean(), diff.max())
    se_mean = np.sqrt(var.sum()) / var.size
    assert abs(mp.mean() - mj.mean()) <= 3.0 * se_mean
    return rp


def test_cli_matches_jax_within_standard_error(tmp_path, monkeypatch):
    """64 segments: no candidate grid (at most GRID_ACCEL_MIN_PRIMS), the
    exact closest point on every lane through K13's plain version."""
    rp = _cli_parity(tmp_path, monkeypatch, 64)
    assert "cand" not in rp["table_bytes"]


def test_cli_matches_jax_on_large_set_rows(tmp_path, monkeypatch):
    """512 segments take K = 256 rows, several levels and truncated rows
    at the circle's centre, where every segment is near-equidistant.
    Level 0 capped at 64 cells keeps the tables CPU-sized; its cells are
    8x eps wide, so the FinePack's bounds shorten the steps, and depth 512
    keeps walks clear of the cap: what is compared is that the bounds are
    valid star radii (problem.py's docstring has the reading at depth 64)."""
    from elaina_tpu_torch.core import problem

    monkeypatch.setattr(problem, "GRID_MAX_RES", 64)
    rp = _cli_parity(tmp_path, monkeypatch, 512, depth=512)
    K = 256
    assert rp["table_bytes"]["cand"] % (K * 4) == 0
    assert rp["table_bytes"]["cand"] >= 64 * 64 * K * 4


def test_unsupported_config_raises(tmp_path):
    """What the port cannot load raises: a mask that is missing or not a
    PNG (masks are read since the port has its PNG reader; nothing falls
    back to an unmasked frame); an unknown channel is refused."""
    obj, colors = _write_scene(tmp_path)
    conf = _conf(tmp_path, "x", 1, obj, colors)
    problem = Problem(2, CPU, verbose=False)
    scene = dict(conf["scene"], mask_path="m.png")
    with pytest.raises(FileNotFoundError):
        problem.load_config(scene, base_dir=str(tmp_path))
    (tmp_path / "m.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="PNG"):
        problem.load_config(scene, base_dir=str(tmp_path))
    with pytest.raises(ValueError):
        Problem(4, CPU)
    from elaina_tpu_torch.exec import run_expr
    c = json.loads(json.dumps(conf))
    c["integrator"]["channels"] = ["NORMALS"]
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(c))
    with pytest.raises(ValueError, match="channel"):
        run_expr(str(path), device="cpu")


def test_full_scale_scene(tmp_path):
    """The main-path scene of chip_smoke.py: 65,536 Dirichlet segments in
    63 closed loops, every spot inside the outline, written as OBJs and a
    config the port's loader reads."""
    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.geometry.native import load_obj_native
    from elaina_tpu_torch.utils import scenes

    loops = scenes.dirichlet_loops()
    assert len(loops) == 63 and sum(map(len, loops)) == scenes.SEGMENTS
    for spot in loops[1:]:
        rel = spot - np.asarray(scenes.CENTER)
        theta = np.arctan2(rel[:, 1], rel[:, 0])
        assert (np.hypot(rel[:, 0], rel[:, 1])
                < scenes.outline_radius(theta) - 2.0).all()
    cfg = ExperimentConfig.from_file(scenes.write_scene(str(tmp_path), 16))
    assert cfg.settings.frameSize == (scenes.FRAME, scenes.FRAME)
    assert cfg.settings.epsilonShell == scenes.EPS
    v, idx = load_obj_native(cfg.scene["mesh"]["dirichlet_path"], 2)
    assert v.shape == (scenes.SEGMENTS, 2) and idx.shape == (scenes.SEGMENTS, 2)
    np.testing.assert_allclose(v, np.concatenate(loops), atol=1e-4)
    _, nidx = load_obj_native(cfg.scene["mesh"]["neumann_path"], 2)
    assert nidx.shape == (4, 2)
