"""The 3D uniform slice of the PyTorch port: one depth step stage by stage,
and the whole solve through the CLI.

(a) The banded mixed cube of ``tests/test_fused_band.py`` (Dirichlet
faces x = +-1 with u = (x + 1) / 2, zero Neumann on the other four), with
the JAX package's grids (candidate grid + FinePack, silhouette grid,
prim-band grid) carried across: ``_separate`` and the band step agree
lane for lane on the same lanes and random numbers.
(b) The same cube as OBJ files (``utils/scenes.write_mixed_cube``, the
scene of ``chip_smoke.py``'s analytic phase) through both CLIs: the
images agree within their combined Monte Carlo error, as
``tests/test_torch_slice.py`` holds the 2D slice.
(c) ``bumpy3d_quick`` through the port's CLI against the analytic
interior solution, within ``tests/test_exec_3d.py``'s 8-spp bounds.

The port's CLI runs here with its grids capped at 16 cells a side
(``GRID_MAX_RES``) so the tables stay CPU-sized; the FinePack bound of a
cell that coarse shortens the steps near the boundary, so the CLI solves
walk deeper than their configs' 64 (see each test).
"""

import json
from functools import partial
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.output.image_io import read_exr  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 0.02


def _cube_sets():
    """tests/test_fused_band.py's mixed cube."""
    from test_wost_3d import _colors_from_fn, _cube_boundary

    dv, dt = _cube_boundary(n=3, faces=(0, 1))
    nv, nt = _cube_boundary(n=3, faces=(2, 3, 4, 5))
    dc = _colors_from_fn(dv, lambda v: (v[0] + 1.0) / 2.0)
    return dv, dt, dc, nv, nt


@pytest.fixture(scope="module")
def cube_scenes():
    """The JAX banded mixed cube with its fast-path Dirichlet grid and its
    silhouette grid, and the port's scene holding the same grids."""
    return cube_scene_pair()


def cube_scene_pair(neumann_colors=None):
    """``cube_scenes``' pair; ``neumann_colors`` (V, 2, 3) colors the
    Neumann faces (default zero)."""
    from elaina_tpu.core.problem import Boundary, Scene
    from elaina_tpu.geometry.geomset import make_geom_set
    from elaina_tpu.geometry.grid import (attach_coords, attach_fine,
                                          attach_shading,
                                          build_candidate_grid,
                                          build_prim_band_grid,
                                          build_silhouette_grid)

    dv, dt, dc, nv, nt = _cube_sets()
    nc = (np.zeros((len(nv), 2, 3), np.float32) if neumann_colors is None
          else np.asarray(neumann_colors, np.float32))
    lo, hi = P.grid_bounds(dv, [-1] * 3, [1] * 3)
    K, _ = P.grid_size_for(len(dt))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        g = build_candidate_grid(dv, dt, lo, hi, K=K, max_res=16)
        g = attach_shading(attach_fine(attach_coords(g, dv, dt), EPS), dc, dt)
        n_gs = make_geom_set(nv, nt)[0]
        blo, bhi = np.full(3, -1.1, np.float32), np.full(3, 1.1, np.float32)
        sg = build_silhouette_grid(
            np.asarray(n_gs.sil_p0), np.asarray(n_gs.sil_p1),
            np.asarray(n_gs.sil_n1), np.asarray(n_gs.sil_n2),
            np.asarray(n_gs.sil_always), blo, bhi,
            K=P.band_size_for(n_gs.sil_p0.shape[0])[0], max_res=8)
        bg = build_prim_band_grid(nv, nt, blo, bhi,
                                  K=P.band_size_for(len(nt))[0], max_res=8)
    scene_jax = Scene(
        dirichlet=Boundary(gs=make_geom_set(dv, dt)[0],
                           colors=jnp.asarray(dc)),
        neumann=Boundary(gs=n_gs, colors=jnp.asarray(nc)), d_grid=g,
        source=None, aabb_lo=jnp.asarray([-1.0] * 3),
        aabb_hi=jnp.asarray([1.0] * 3), dim=3, source_intensity=1.0,
        dirichlet_intensity=1.0, neumann_intensity=1.0, n_sgrid=sg,
        n_bgrid=bg)

    def arrays(b):
        return {f: np.asarray(getattr(b, f)) for f in (
            "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
            "ent_hi")} | {"res": b.res}

    fp = g.fine
    scene_port = P.scene_from_numpy(
        aabb_lo=[-1] * 3, aabb_hi=[1] * 3, device=CPU,
        dirichlet=(dv, dt, dc), neumann=(nv, nt, nc),
        grid=dict(cand=np.asarray(g.cand),
                  meta=[np.asarray(m) for m in g.meta],
                  row_lbound=np.asarray(g.row_lbound),
                  row_diag=np.asarray(g.row_diag),
                  row_trunc=np.asarray(g.row_trunc),
                  origin=np.asarray(g.origin),
                  inv_cell=np.asarray(g.inv_cell), res=g.res),
        fine=dict(packed=np.asarray(fp.packed), origin=np.asarray(fp.origin),
                  inv_cell=np.asarray(fp.inv_cell), r0=float(fp.r0),
                  res=fp.res, s=fp.s, eps=fp.eps),
        sgrid=arrays(sg), bgrid=arrays(bg))
    return scene_jax, scene_port


def test_depth_step_stages_match_jax(cube_scenes, monkeypatch):
    """_separate (R_B, in-shell, color) equal lane for lane; the band step
    on its R_B with identical uniforms and directions, within the
    thresholds of tests/test_fused_band.py."""
    from elaina_tpu.solver import wost as W

    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    scene_jax, scene_port = cube_scenes
    rng = np.random.default_rng(5)
    n = 1024
    # half the lanes near the Dirichlet faces, so the shell test fires
    q = rng.uniform(-0.99, 0.99, (n, 3)).astype(np.float32)
    q[::2, 0] = np.sign(q[::2, 0]) * rng.uniform(0.9, 0.995, n // 2)
    act = np.arange(n) % 7 != 0
    in_j, RB_j, col_j, RD_j = (np.asarray(a) for a in W._separate(
        scene_jax, W.init_walk_state(jnp.asarray(q), jnp.asarray(act)), EPS,
        32, shrink=True))
    st = TW.init_walk_state(torch.as_tensor(q), torch.as_tensor(act))
    in_p, RB_p, col_p, RD_p, need = (a.numpy() for a in TW._separate(
        scene_port, st, EPS, shrink=True))
    assert (in_p & act).sum() > 20 and need.sum() > n // 4
    np.testing.assert_array_equal(in_p & act, in_j & act)
    np.testing.assert_allclose(RB_p[act], RB_j[act], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(RD_p[act], RD_j[act], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(col_p[in_p & act], col_j[in_p & act],
                               rtol=1e-5, atol=1e-6)

    # the band step on the live lanes' radii
    from elaina_tpu.geometry import queries as QJ

    on_n = rng.random(n) < 0.3
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(on_n[:, None], nrm, 0.0).astype(np.float32)
    u_sel = rng.uniform(0, 1, n).astype(np.float32)
    u_pt = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    d_walk = rng.normal(size=(n, 3)).astype(np.float32)
    d_walk /= np.linalg.norm(d_walk, axis=-1, keepdims=True)
    args = (q, RB_p, on_n, nrm, u_sel, u_pt, d_walk)
    oj = QJ.band_neumann_walk(scene_jax.n_bgrid, scene_jax.neumann.gs,
                              *map(jnp.asarray, args), EPS)
    op = QT.band_neumann_walk(scene_port.n_bgrid, scene_port.neumann.gs,
                              *map(torch.as_tensor, args), EPS)
    live = act & ~in_p
    pj, pp = np.asarray(oj.pid), op.pid.numpy()
    assert (pj[live] >= 0).sum() > live.sum() // 4
    np.testing.assert_array_equal(pp[live] >= 0, pj[live] >= 0)
    match = (pp == pj) | (pj < 0)
    assert match[live].mean() > 0.995
    sel = live & match & (pj >= 0)
    np.testing.assert_allclose(op.pdf_area.numpy()[sel],
                               np.asarray(oj.pdf_area)[sel], rtol=2e-4)
    np.testing.assert_array_equal(op.occluded.numpy()[sel],
                                  np.asarray(oj.occluded)[sel])
    np.testing.assert_array_equal(op.side.numpy()[sel],
                                  np.asarray(oj.side)[sel])
    # the walk update both sides would make
    cur = q + np.where(on_n[:, None], EPS * nrm, 0.0)

    def next_pos(o):
        whit = np.asarray(o.whit)
        wt = np.where(whit, np.asarray(o.wt), 0.0)
        return np.where(whit[:, None], cur + wt[:, None] * d_walk,
                        q + RB_p[:, None] * d_walk), whit

    (pos_p, hit_p), (pos_j, hit_j) = next_pos(op), next_pos(oj)
    pos_match = np.all(np.isclose(pos_p, pos_j, rtol=1e-4, atol=1e-5), -1)
    assert pos_match[live].mean() > 0.99
    assert (hit_p == hit_j)[live].mean() > 0.99
    assert hit_j[live].any()


def _samples(out_dir, spp):
    """Per-sample images (spp, H, W, 3) from the running-mean frames."""
    means = np.stack([read_exr(os.path.join(out_dir, "frames", f"{i}.exr"))
                      [..., :3].astype(np.float64) for i in range(spp)])
    k = np.arange(1, spp + 1, dtype=np.float64)[:, None, None, None]
    return np.diff(means * k, axis=0, prepend=0.0)


def test_cli_matches_jax_on_mixed_cube(tmp_path, monkeypatch):
    """Both CLIs on the cube (the reference's CPU path takes its BVH
    queries, the port its grids) at depth 128: walks that stall by the
    Neumann-Neumann edges bias both images at depth 64, by amounts that
    differ with the star radii (the port's FinePack bounds on a 16-cell
    grid take more steps)."""
    from elaina_tpu.exec import run_expr as run_jax
    from elaina_tpu_torch.exec import run_expr

    run_port = partial(run_expr, device="cpu")

    from elaina_tpu_torch.utils.scenes import write_mixed_cube

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(P, "GRID_MAX_RES", 16)
    scene = write_mixed_cube(str(tmp_path))
    scene["evaluation_grid"] = {"mData": {
        "scale": 0.7, "pos": [0, 0, 0.3], "up": [0, 1, 0],
        "right": [1, 0, 0]}}
    spp = 16
    runs = {}
    for name, run in (("jax", run_jax), ("port", run_port)):
        conf = {
            "dimensionality": 3, "base_path": str(tmp_path / "exp") + "/",
            "exp_name": name,
            "integrator": {
                "setting": {"frameSize": [8, 8], "maxWalkingDepth": 128,
                            "samplesPerPixel": spp, "epsilonShell": EPS,
                            "saveSppMetricsDuration": 1,
                            "saveSppMetricsUntil": spp},
                "type": "uniform", "channels": ["SOLUTION"]},
            "export": [{"type": "image", "channel": "SOLUTION",
                        "file_name": "solution"}],
            "scene": scene}
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(conf))
        result = run(str(path))
        assert result["walk_steps"] > 0
        runs[name] = _samples(str(tmp_path / "exp" / name), spp)
    rp = json.loads((tmp_path / "exp" / "port" / "result.json").read_text())
    assert rp["device"] == "cpu"
    # 36 Dirichlet triangles, no candidate grid: every live lane-step is
    # resolved exactly (the reference's route for such a set)
    assert rp["resolved_lanes"] == rp["walk_steps"] > 0
    assert "cand" not in rp["table_bytes"]
    assert rp["table_bytes"]["band_coords"] > 0
    assert rp["table_bytes"]["sil_coords"] > 0

    mp, mj = runs["port"].mean(0), runs["jax"].mean(0)
    var = (runs["port"].var(0, ddof=1) + runs["jax"].var(0, ddof=1)) / spp
    assert np.isfinite(mp).all() and 0.2 < mp.mean() < 0.8
    within = np.abs(mp - mj) <= 4.0 * np.sqrt(var) + 1e-5
    assert within.mean() >= 0.99, within.mean()
    se_mean = np.sqrt(var.sum()) / var.size
    assert abs(mp.mean() - mj.mean()) <= 3.0 * se_mean


def test_bumpy3d_cli_matches_analytic(tmp_path, monkeypatch):
    """bumpy3d_quick (1,280 triangles, h = 0.5 + 0.4 (x^2 - y^2) on the
    boundary and inside) at 16x16 and 8 spp through the port's CLI:
    |bias| < 0.02 and RMSE < 0.15 (tests/test_exec_3d.py:46-49).  Depth
    512: on the 16-cell grid the FinePack's cell-wide bounds slow the
    walks near the surface, and depth 64 caps enough of them to bias the
    mean past the bound; chip_smoke.py runs the reference's 64-cell grid
    on the card."""
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(P, "GRID_MAX_RES", 16)
    conf = json.loads(open(os.path.join(REPO, "configs",
                                        "bumpy3d_quick.json")).read())
    conf["base_path"] = str(tmp_path) + "/"
    conf["integrator"]["channels"] = ["SOLUTION"]
    conf["export"] = [e for e in conf["export"] if e["channel"] == "SOLUTION"]
    st = conf["integrator"]["setting"]
    st.update(frameSize=[16, 16], samplesPerPixel=8, maxWalkingDepth=512)
    conf["scene"]["mesh"]["dirichlet_path"] = os.path.join(
        REPO, "configs", "data", "bumpy3d_3.obj")
    conf["scene"]["mesh"]["vertex_color_dirichlet_path"] = os.path.join(
        REPO, "configs", "data", "bumpy3d_3_colors.npz")
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    result = run_expr(str(path), device="cpu")
    assert result["resolved_lanes"] > 0
    img = read_exr(str(tmp_path / conf["exp_name"] / "solution.exr"))
    n = img.shape[0]
    xs = 2 * np.arange(n) / n - 1.0
    X, Y = np.meshgrid(xs * 0.6, xs * 0.6, indexing="xy")
    err = img[..., 0] - (0.5 + 0.4 * (X ** 2 - Y ** 2))
    rmse = float(np.sqrt((err ** 2).mean()))
    bias = float(err.mean())
    assert rmse < 0.15, rmse
    assert abs(bias) < 0.02, bias
    np.testing.assert_allclose(img[..., 0], img[..., 1], atol=1e-6)


def test_3d_scene_needs_its_band_grids():
    """A 3D Neumann set takes the band grids; the 2D dense rule stays."""
    dv, dt, dc, nv, nt = _cube_sets()
    with pytest.raises(ValueError, match="band"):
        P.scene_from_numpy(aabb_lo=[-1] * 3, aabb_hi=[1] * 3, device=CPU,
                           neumann=(nv, nt, np.zeros((len(nv), 2, 3))))
