"""2D Neumann sets of every size in the PyTorch port, against
``elaina_tpu``.

Up to ``CHUNKED_DENSE_MAX`` prims a 2D Neumann set takes the chunked
sweeps (``_ray_dense_chunked``, ``_sample_in_ball_chunked``, 64 prims a
chunk); above it the 2D SilGrid, whose silhouette distance is kernel K9's
2D form (``sil_band_dma`` with ``dim=2``, interpret mode here; the port's
``sil_band_2d`` takes its plain PyTorch version on CPU tensors and
``chip_smoke.py`` holds the CUDA kernel to it on the card), and the 2D
prim-band grid, whose ray and in-ball queries gather the rows' corners.
Inputs are made with numpy from a seed; the grids are built from the same
arrays on both sides.  Distances agree to 1e-5, ids exactly; the in-ball
pdf within XLA-CPU's transcendental floor plus the lane's conditioning
(``tests/test_torch_queries.py``).  The CLI runs compare images within
their combined Monte Carlo error.
"""

import json
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.geometry.grid import (build_prim_band_grid,  # noqa: E402
                                      build_silhouette_grid,
                                      sil_coords_from_rows)
from elaina_tpu.ops.pallas_queries import sil_band_dma  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import geomset as TGS  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.ops import queries as K  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402
from tests.test_torch_queries import _pdf_tolerance  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5
BAND_FIELDS = ("origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
               "ent_hi")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them (the no-grid CLI test took ~500 s there, 11 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _wavy_box(n):
    """The scenes module's wavy Neumann box of n segments, scaled to
    [-1, 1]^2 (amplitude 4 / 300 of the half-side)."""
    verts = (S.neumann_box(n) - 250.0) / 300.0
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    return verts.astype(np.float32), idx


def _arrays(g):
    return {f: np.asarray(getattr(g, f)) for f in BAND_FIELDS} | {
        "res": g.res}


LO = np.full(2, -1.3, np.float32)
HI = -LO


@pytest.fixture(scope="module")
def wavy():
    """A 600-segment wavy box: both sides' GeomSets and band grids (the
    JAX SilGrid with its K9 table), K = 16 on a capped grid so some cells'
    r_cap binds."""
    verts, idx = _wavy_box(600)
    gj = make_geom_set(verts, idx)[0]
    gp = TGS.make_geom_set(verts, idx, CPU)
    ent = tuple(np.asarray(getattr(gj, f)) for f in (
        "sil_p0", "sil_p1", "sil_n1", "sil_n2", "sil_always"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        sg = build_silhouette_grid(*ent, LO, HI, K=16, max_res=24)
    bg = build_prim_band_grid(verts, idx, LO, HI, K=16, max_res=24)
    assert sg.coords is not None
    return dict(verts=verts, idx=idx, gj=gj, gp=gp, ent=ent, sg=sg, bg=bg,
                sgp=GT.sil_grid_from_numpy(_arrays(sg), gp, CPU),
                bgp=GT.band_grid_from_numpy(_arrays(bg), verts, idx, CPU))


def test_band_grids_2d_match_jax(wavy):
    """The port's 2D SilGrid and prim-band grid builds, field for field;
    the SilGrid's cell table holds the JAX table's values, re-laid planes
    by slot; the 2D prim-band grid carries no table (its queries gather)."""
    sg, bg = wavy["sg"], wavy["bg"]
    sa = GT.build_silhouette_grid(*wavy["ent"], LO, HI, K=16, max_res=24)
    ba = GT.build_prim_band_grid(wavy["verts"], wavy["idx"], LO, HI, K=16,
                                 max_res=24)
    for mine, ref in ((sa, sg), (ba, bg)):
        assert mine.res == ref.res
        for f in BAND_FIELDS:
            np.testing.assert_array_equal(getattr(mine, f),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
    assert (sa.r_cap < 1e29).any() and (sa.rows >= 0).sum() > sa.rows.size / 4
    assert wavy["bgp"].coords is None
    coords = wavy["sgp"].coords.numpy()
    C, Kw = sa.rows.shape
    Kp = GT.padded_k(Kw)
    assert coords.shape == (C, 6, Kp)
    ref = np.asarray(sg.coords).reshape(C, -1)
    Kp_j = -(-Kw // 128) * 128
    for p in range(6):
        np.testing.assert_array_equal(coords[:, p, :Kw],
                                      ref[:, p * Kp_j:p * Kp_j + Kw])
        pad = GT.PAD_COORD if p < 2 else 0.0
        assert (coords[:, p, Kw:] == pad).all()
    # the same table through the port's own 2D layout from numpy rows
    np.testing.assert_array_equal(
        coords, GT.sil_coords_from_rows(
            _t(sa.rows), *(getattr(wavy["gp"], f) for f in (
                "sil_p0", "sil_p1", "sil_n1", "sil_n2", "sil_always")))
        .numpy())
    np.testing.assert_array_equal(
        ref, sil_coords_from_rows(np.asarray(sg.rows), *wavy["ent"])
        .reshape(C, -1))


def test_sil_band_2d_matches_pallas(wavy, monkeypatch):
    """K9's 2D form: the plain version against ``sil_band_dma(dim=2)`` in
    interpret mode, then ``grid_closest_silhouette`` end to end (the r_cap
    clamp, "none", the bbox distance outside the grid) against the JAX
    package's, and the SilGrid's property (tests/test_queries_hier.py:150):
    a lower bound of the dense silhouette distance, equal to it wherever
    that lies below the cell's r_cap."""
    sg, sgp, gj, gp = wavy["sg"], wavy["sgp"], wavy["gj"], wavy["gp"]
    rng = np.random.default_rng(7)
    n = 2048
    q = rng.uniform(-1.45, 1.45, (n, 2)).astype(np.float32)  # some outside
    lin, outside = (a.numpy() for a in QT.band_cell(sgp, _t(q)))
    cell = np.where(outside, -1, lin).astype(np.int32)
    Kw = sg.rows.shape[1]
    dj = np.asarray(sil_band_dma(jnp.asarray(cell), jnp.asarray(q),
                                 sg.coords, -(-Kw // 128), 2, interpret=True))
    dp = K.sil_band_2d(_t(cell), _t(q), sgp.coords).numpy()
    inn = cell >= 0
    found = inn & (dj < 1e17)
    assert inn.sum() > n // 2 and found.sum() > n // 4
    np.testing.assert_array_equal(dp[inn] < 1e17, dj[inn] < 1e17)
    np.testing.assert_allclose(dp[found], dj[found], rtol=TOL, atol=1e-9)
    assert np.isinf(dp[~inn]).all()

    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    rj = np.asarray(QJ.grid_closest_silhouette(sg, gj, jnp.asarray(q)))
    rp = QT.grid_closest_silhouette(sgp, _t(q)).numpy()
    fin = np.isfinite(rj)
    np.testing.assert_array_equal(np.isfinite(rp), fin)
    np.testing.assert_allclose(rp[fin], rj[fin], rtol=TOL, atol=1e-6)

    true = QT.closest_silhouette(gp, _t(q)).numpy()
    assert (rp <= true * (1 + TOL) + TOL).all()
    cap = sgp.r_cap.numpy()[lin]
    tight = inn & (true < cap * 0.999) & np.isfinite(true)
    assert tight.sum() > 100
    np.testing.assert_allclose(rp[tight], true[tight], rtol=TOL, atol=1e-6)


def test_sil_band_2d_refuses_bad_inputs(wavy):
    sgp = wavy["sgp"]
    cell = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.sil_band_2d(cell, torch.zeros((4, 3)), sgp.coords)
    with pytest.raises(ValueError):
        K.sil_band(cell, torch.zeros((4, 3)), sgp.coords)   # a 2D table


def _rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(th), np.sin(th)], -1).astype(np.float32)
    return o, d


@pytest.mark.parametrize("n_prims", [300, 2048])
def test_chunked_queries_match_jax(n_prims):
    """65 to 4,096 prims: ``ray_intersect`` against ``_ray_dense_chunked``
    and ``sample_in_ball`` against ``_sample_in_ball_chunked`` (the JAX
    package's branches at these sizes), with identical uniforms."""
    verts, idx = _wavy_box(n_prims)
    gj = make_geom_set(verts, idx)[0]
    gp = TGS.make_geom_set(verts, idx, CPU)
    assert gj.node_measure is None           # the chunked sample, not BVH
    rng = np.random.default_rng(n_prims)
    n = 1500
    o, d = _rays(rng, n, -1.1, 1.1)
    tmax = rng.uniform(0.01, 2.5, n).astype(np.float32)
    hj, tj, ij = (np.asarray(a) for a in QJ.ray_intersect(
        gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
    hp, tp, ip = (a.numpy() for a in QT.ray_intersect(gp, _t(o), _t(d),
                                                       _t(tmax)))
    assert hj.any() and not hj.all()
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hj], tj[hj], rtol=TOL, atol=1e-6)
    assert np.isinf(tp[~hj]).all()
    np.testing.assert_array_equal(ip[hj], ij[hj])

    q = rng.uniform(-1.05, 1.05, (n, 2)).astype(np.float32)
    R = rng.uniform(0.005, 0.4, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    pj, fj = (np.asarray(a) for a in QJ.sample_in_ball(
        gj, jnp.asarray(q), jnp.asarray(R), jnp.asarray(u)))
    pp, fp = (a.numpy() for a in QT.sample_in_ball(gp, _t(q), _t(R), _t(u)))
    assert (pj >= 0).sum() > n // 4 and (pj < 0).any()
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_array_less(np.abs(fp - fj),
                                 _pdf_tolerance(gp, q, R, pj, fj))


def test_band_queries_2d_match_jax(wavy):
    """The 2D prim band's gather forms: ``band_ray_intersect`` (from a ref
    point, as the walk calls it) and ``band_sample_in_ball`` against the
    JAX package's with identical uniforms, on radii within the cells'
    r_cap (the rows are complete there) and beyond it."""
    bg, bgp, gj, gp = wavy["bg"], wavy["bgp"], wavy["gj"], wavy["gp"]
    rng = np.random.default_rng(11)
    n = 2048
    ref, d = _rays(rng, n, -1.05, 1.05)
    eps = 0.002
    o = (ref + eps * d).astype(np.float32)
    rcap = QT.band_r_cap(bgp, _t(ref)).numpy()
    tmax = np.minimum(rng.uniform(0.01, 0.5, n), rcap).astype(np.float32)
    hj, tj, ij = (np.asarray(a) for a in QJ.band_ray_intersect(
        bg, gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
        ref=jnp.asarray(ref)))
    hp, tp, ip = (a.numpy() for a in QT.band_ray_intersect(
        bgp, gp, _t(o), _t(d), _t(tmax), ref=_t(ref)))
    assert hj.sum() > 50 and not hj.all()
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hj], tj[hj], rtol=TOL, atol=1e-6)
    np.testing.assert_array_equal(ip, ij)

    q = rng.uniform(-1.05, 1.05, (n, 2)).astype(np.float32)
    R = rng.uniform(0.005, 0.3, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    pj, fj = (np.asarray(a) for a in QJ.band_sample_in_ball(
        bg, gj, jnp.asarray(q), jnp.asarray(R), jnp.asarray(u)))
    pp, fp = (a.numpy() for a in QT.band_sample_in_ball(bgp, gp, _t(q),
                                                        _t(R), _t(u)))
    assert (pj >= 0).sum() > n // 4 and (pj < 0).any()
    np.testing.assert_array_equal(pp, pj)
    np.testing.assert_array_less(np.abs(fp - fj),
                                 _pdf_tolerance(gp, q, R, pj, fj))


def test_separate_with_2d_band_grids_matches_jax(wavy, monkeypatch):
    """``_separate`` on the wavy box with its SilGrid and prim-band grid
    (the star radius through K9's 2D form, clamped to r_cap) and a
    256-segment Dirichlet curve without a grid, lane for lane against the
    JAX package's on the active lanes (K13 sweeps only those; the port's
    R_D is +inf on the others, dead walks that the step never reads)."""
    from elaina_tpu.core.problem import Boundary, Scene
    from elaina_tpu.solver import wost as WJ
    from elaina_tpu_torch.solver import wost as WT

    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    dv = ((S.lobed_curve(256) - 250.0) / 400.0).astype(np.float32)
    di = np.stack([np.arange(256), (np.arange(256) + 1) % 256],
                  -1).astype(np.int32)
    dc = np.random.default_rng(0).uniform(0, 1, (256, 2, 3)).astype(
        np.float32)
    nv, ni = wavy["verts"], wavy["idx"]
    nc = np.zeros((len(nv), 2, 3), np.float32)
    eps = 0.005
    scene_j = Scene(
        dirichlet=Boundary(gs=make_geom_set(dv, di)[0], colors=jnp.asarray(dc)),
        neumann=Boundary(gs=wavy["gj"], colors=jnp.asarray(nc)), d_grid=None,
        source=None, aabb_lo=jnp.asarray(LO), aabb_hi=jnp.asarray(HI), dim=2,
        source_intensity=1.0, dirichlet_intensity=1.0, neumann_intensity=1.0,
        n_sgrid=wavy["sg"], n_bgrid=wavy["bg"])
    scene_p = P.scene_from_numpy(
        aabb_lo=LO, aabb_hi=HI, device=CPU, dirichlet=(dv, di, dc),
        neumann=(nv, ni, nc), sgrid=_arrays(wavy["sg"]),
        bgrid=_arrays(wavy["bg"]))
    assert scene_p.d_grid is None and scene_p.n_bgrid.coords is None
    rng = np.random.default_rng(13)
    n = 2048
    q = rng.uniform(-1.05, 1.05, (n, 2)).astype(np.float32)
    act = np.arange(n) % 7 != 0
    in_j, RB_j, col_j, RD_j = (np.asarray(a) for a in WJ._separate(
        scene_j, WJ.init_walk_state(jnp.asarray(q), jnp.asarray(act)), eps,
        48, shrink=True))
    in_p, RB_p, col_p, RD_p, _ = (a.numpy() for a in WT._separate(
        scene_p, WT.init_walk_state(_t(q), _t(act)), eps, shrink=True))
    np.testing.assert_array_equal(in_p & act, in_j & act)
    np.testing.assert_allclose(RD_p[act], RD_j[act], rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(RB_p[act], RB_j[act], rtol=TOL, atol=1e-6)
    assert np.isinf(RD_p[~act]).all()
    rd = act & (RB_p < 0.99 * RD_p)  # the Neumann radius binds
    assert rd.sum() > n // 4
    np.testing.assert_allclose(col_p[in_p & act], col_j[in_p & act],
                               rtol=TOL, atol=1e-6)


def _write_loop_obj(path, n):
    """A closed circle of n segments around the scene's centre, inside the
    box [-50, 550]^2."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    verts = np.stack([250 + 290 * np.cos(t), 250 + 290 * np.sin(t)],
                     -1).astype(np.float32)
    S.write_obj(path, [verts])


def test_problem_routes_neumann_sets_by_size(tmp_path, monkeypatch):
    """A 2D Neumann set of 4,096 prims (and silhouette vertices) takes the
    sweeps, 4,097 both band grids (elaina_tpu/core/problem.py:398-439);
    either solves through ``run_expr`` on the CPU."""
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setattr(P, "GRID_MAX_RES", 32)
    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    path = S.write_scene(str(tmp_path), 1, segments=256, frame=4)
    conf = json.loads(open(path).read())
    conf["integrator"]["setting"]["maxWalkingDepth"] = 8
    for n, banded in ((4096, False), (4097, True)):
        _write_loop_obj(os.path.join(str(tmp_path), "box.obj"), n)
        problem = P.Problem(2, CPU, verbose=False).load_config(conf["scene"])
        scene = problem.scene
        assert scene.neumann.gs.n_prims == n
        assert (scene.n_sgrid is not None) == banded, n
        assert (scene.n_bgrid is not None) == banded, n
        if banded:
            assert tuple(scene.n_sgrid.coords.shape[1:]) == (6, 64)
            assert scene.n_bgrid.coords is None
        conf["exp_name"] = f"loop{n}"
        p = tmp_path / f"loop{n}.json"
        p.write_text(json.dumps(conf))
        result = run_expr(str(p), device="cpu")
        assert result["walk_steps"] > 0
        assert ("sil_rows" in result["table_bytes"]) == banded


def test_cli_matches_jax_on_wavy_box(tmp_path, monkeypatch):
    """bench.py's curve at 256 segments (no grid) in the wavy box of 1,024
    segments (the chunked sweeps on both sides), through both CLIs at
    16^2: the images agree within their combined Monte Carlo error.  (The
    band-grid route of a larger box runs through ``run_expr`` in
    ``test_problem_routes_neumann_sets_by_size``; the JAX package's CPU
    run takes its BVH there, whose star radii are not the band's r_cap
    clamp, so at depth 64 the two capped shares differ.)"""
    from elaina_tpu.exec import run_expr as run_jax
    from elaina_tpu.output.image_io import read_exr
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    spp = 16
    path = S.write_scene(str(tmp_path), spp, segments=256, frame=16,
                         neumann_segments=1024)
    conf = json.loads(open(path).read())
    conf["integrator"]["setting"].update(saveSppMetricsDuration=1,
                                         saveSppMetricsUntil=spp)
    runs = {}
    for name, run in (("jax", run_jax),
                      ("port", partial(run_expr, device="cpu"))):
        conf["exp_name"] = name
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(conf))
        result = run(str(p))
        out = tmp_path / "exp" / name
        means = np.stack([read_exr(str(out / "frames" / f"{i}.exr"))
                          [..., :3].astype(np.float64) for i in range(spp)])
        k = np.arange(1, spp + 1, dtype=np.float64)[:, None, None, None]
        runs[name] = np.diff(means * k, axis=0, prepend=0.0)
        if name == "port":
            assert result["table_bytes"] == {}     # no grid of any kind
    mp, mj = runs["port"].mean(0), runs["jax"].mean(0)
    var = (runs["port"].var(0, ddof=1) + runs["jax"].var(0, ddof=1)) / spp
    assert np.isfinite(mp).all() and mp.max() > 0.1
    within = np.abs(mp - mj) <= 4.0 * np.sqrt(var) + 1e-5
    assert within.mean() >= 0.99, within.mean()
    se_mean = np.sqrt(var.sum()) / var.size
    assert abs(mp.mean() - mj.mean()) <= 3.0 * se_mean
