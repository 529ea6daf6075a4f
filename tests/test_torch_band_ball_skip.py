"""K8's skip in the PyTorch port: a lane that is not live, or whose ball
cannot reach its cell's row, gets the outputs of "no prim weighs" (slot =
Kp, w_sel = total = 0) without a sweep.

The reach test is ``R + offset < skip_r[cell]`` (``geometry/grid.
band_skip_radius``: the band grid's lbound less a float margin); the ball
is centred on the point whose cell is passed, so the depth step passes
offset 0.  On the CPU the plain version runs, with the same skip
(``chip_smoke.py`` phase 5 holds the CUDA kernel to it on the card).
Here: ``band_sample_in_ball`` with the skip and the live mask against
``elaina_tpu``'s ``band_ball_dma_3d`` in interpret mode on every lane of
the soup and of a neumann3d-like blob (a bumpy closed sphere, radii on
both sides of skip_r): live lanes to the JAX package's tolerances, the
lanes the skip takes pid -1 and pdf 0 on both sides; the kernel's outputs
with the reach test equal those without it on every lane, bit for bit;
the margin at its tight case, a plane across a cell's diagonal seen from
the cell's corner; and three unfused depth steps of the source cube equal
with and without K8's skip and mask, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import elaina_tpu.geometry.queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.geometry.grid import \
    build_prim_band_grid as jax_band_grid  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.geometry.geomset import \
    make_geom_set as port_geom_set  # noqa: E402
from elaina_tpu_torch.ops import queries as KQ  # noqa: E402

CPU = torch.device("cpu")
CDF_FLIPS = 0.005     # CDF slot flips allowed (tests/test_torch_band_unfused)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _soup_mesh():
    """tests/test_band_dma.py's soup: 180 triangles in [-2.35, 2.35]^3."""
    rng = np.random.default_rng(11)
    n_tri = 180
    centers = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-0.35, 0.35, (n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    return verts, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)


def _blob_mesh(n_lat=12, n_lon=20):
    """A closed bumpy sphere of radius ~1.2 (neumann3d's blob in small:
    440 triangles)."""
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = 1.2 * (1 + 0.15 * np.sin(3 * T) * np.cos(4 * P))
    ring = np.stack([r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P),
                     r * np.cos(T)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, 1.2]], ring, [[0, 0, -1.2]]])
    tri = []
    for j in range(n_lon):
        tri.append([0, 1 + j, 1 + (j + 1) % n_lon])
    for i in range(n_lat - 2):
        for j in range(n_lon):
            a = 1 + i * n_lon + j
            b = 1 + i * n_lon + (j + 1) % n_lon
            tri += [[a, a + n_lon, b], [b, a + n_lon, b + n_lon]]
    last = len(verts) - 1
    base = 1 + (n_lat - 2) * n_lon
    for j in range(n_lon):
        tri.append([base + j, last, base + (j + 1) % n_lon])
    return verts.astype(np.float32), np.asarray(tri, np.int32)


SCENES = {"soup": (_soup_mesh, 3.0, 16, 6),
          "blob": (_blob_mesh, 2.0, 32, 8)}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """(name, JAX geom set, JAX band grid with its DMA table, the port's
    geom set and band grid, half-width of the box)."""
    make, half, K, res = SCENES[request.param]
    verts, idx = make()
    lo, hi = np.full(3, -half, np.float32), np.full(3, half, np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        bg = jax_band_grid(verts, idx, lo, hi, K=K, max_res=res)
    arrays = {f: np.asarray(getattr(bg, f)) for f in (
        "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
        "ent_hi")} | {"res": bg.res}
    return (request.param, make_geom_set(verts, idx)[0], bg,
            port_geom_set(verts, idx, CPU),
            GT.band_grid_from_numpy(arrays, verts, idx, CPU), half)


def _below(sr):
    """The largest float32 radii R with R < sr."""
    return np.nextafter(sr, np.float32(-1)).astype(np.float32)


def _lanes(bgp, half, n=3072, seed=21):
    """Lanes in and around the scene: a quarter of the radii from 0.7x to
    1.3x of their cell's skip_r, a quarter the largest below it, half up
    to 1.5; a fifth dead, some outside the grid."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.07 * half, 1.07 * half, (n, 3)).astype(np.float32)
    lin, outside = QT.band_cell(bgp, _t(q))
    sr = bgp.skip_r[lin].numpy().astype(np.float32)
    R = sr * rng.uniform(0.7, 1.3, n).astype(np.float32)
    k = rng.random(n)
    edge = k < 0.25
    R[edge] = _below(sr[edge])
    R[k > 0.5] = rng.uniform(0.05, 1.5, (k > 0.5).sum())
    R = np.maximum(R, np.float32(1e-4)).astype(np.float32)
    cell = torch.where(outside, -1, lin).to(torch.int32)
    return dict(q=q, R=R, u=rng.uniform(0, 1, n).astype(np.float32),
                live=rng.random(n) > 0.2, cell=cell,
                outside=outside.numpy())


def test_sample_matches_pallas_on_every_lane(scene, monkeypatch):
    """``band_sample_in_ball`` with K8's skip and the walks' live mask
    against the TPU kernel in interpret mode, on every lane: the live
    lanes' pids to the CDF flip share and pdfs to 2e-4; a dead lane -1
    and 0; a lane the reach test takes -1 and 0 on both sides."""
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    name, gj, bg, gp, bgp, half = scene
    L = _lanes(bgp, half, seed=31)
    pj, dj = (np.asarray(a) for a in QJ.band_sample_in_ball(
        bg, gj, jnp.asarray(L["q"]), jnp.asarray(L["R"]),
        jnp.asarray(L["u"])))
    pp, dp = (a.numpy() for a in QT.band_sample_in_ball(
        bgp, gp, _t(L["q"]), _t(L["R"]), _t(L["u"]), live=_t(L["live"])))
    live = L["live"]
    valid = live & (pj >= 0)
    assert valid.sum() > 150
    np.testing.assert_array_equal(pp[live] >= 0, pj[live] >= 0)
    match = pp == pj
    assert (match | ~valid)[live].mean() > 1 - CDF_FLIPS, (~match
                                                           & valid).sum()
    sel = match & valid
    np.testing.assert_allclose(dp[sel], dj[sel], rtol=2e-4)
    assert (dp[live & (pj < 0)] == 0).all()
    assert (pp[~live] == -1).all() and (dp[~live] == 0).all()
    # the lanes the reach test took: nothing on either side
    work = KQ.ball_work(L["cell"], _t(L["R"]), 0.0, bgp.skip_r,
                        _t(live)).numpy()
    skipped = live & ~work & ~L["outside"]
    assert skipped.sum() > 200 and work.sum() > 300
    assert (pj[skipped] == -1).all() and (dj[skipped] == 0).all()
    assert (pp[skipped] == -1).all() and (dp[skipped] == 0).all()


def test_reach_test_changes_no_lane(scene):
    """The kernel's contract with and without the reach test: slot,
    w_sel and total bit-equal on every lane; with the live mask too on
    every live lane, and slot = Kp, w_sel = total = 0 on the dead ones."""
    _, _, _, _, bgp, half = scene
    L = _lanes(bgp, half, seed=41)
    args = (L["cell"], _t(L["q"]), _t(L["R"]), _t(L["u"]), bgp.coords)
    live = _t(L["live"])
    s0, w0, t0 = KQ.band_ball(*args)
    s1, w1, t1 = KQ.band_ball(*args, bgp.skip_r, None, 0.0)
    for a, b in ((s1, s0), (w1, w0), (t1, t0)):
        assert torch.equal(a, b)
    s2, w2, t2 = KQ.band_ball(*args, bgp.skip_r, live, 0.0)
    for a, b in ((s2, s0), (w2, w0), (t2, t0)):
        assert torch.equal(a[live], b[live])
    Kp = bgp.coords.shape[2]
    assert (s2[~live] == Kp).all()
    assert (w2[~live] == 0).all() and (t2[~live] == 0).all()
    work = KQ.ball_work(L["cell"], _t(L["R"]), 0.0, bgp.skip_r, live)
    taken = live & ~work & (L["cell"] >= 0)
    assert int(taken.sum()) > 200
    assert int((t0[work] > 0).sum()) > 100       # the sweep found weights
    # a skipped lane's outputs are the sweep's: total +0.0, not -0.0
    assert not torch.signbit(t0[taken]).any()


@pytest.mark.parametrize("gap", [0.05, 1e-3, 1e-4])
def test_skip_margin_at_the_tight_case(gap):
    """A plane across the diagonal of the cell [0, 0.5]^3, ``gap`` beyond
    its corner 0 (tests/test_torch_band_skip.py's case): balls at the
    corner with radii up to one float below skip_r find no weight without
    the skip, so the skip gives what the sweep gives; at 1.1x lbound they
    reach the plane."""
    s = np.float32(gap * np.sqrt(3.0))          # the plane x + y + z = -s
    c0 = -s / 3.0
    u = np.array([1, -1, 0], np.float64) / np.sqrt(2.0)
    w = np.array([1, 1, -2], np.float64) / np.sqrt(6.0)
    tri = np.stack([c0 + 0.9 * (np.cos(a) * u + np.sin(a) * w)
                    for a in (0.0, 2.1, 4.2)]).astype(np.float32)
    far = tri + np.float32(1.4)                 # a second prim, far off
    verts = np.concatenate([tri, far]).astype(np.float32)
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    arrays = GT.build_prim_band_grid(verts, idx, np.full(3, -1, np.float32),
                                     np.full(3, 1, np.float32), K=32,
                                     max_res=4)
    bgp = GT.band_grid_from_numpy(vars(arrays), verts, idx, CPU)
    gp = port_geom_set(verts, idx, CPU)
    corner = np.zeros(3, np.float32)
    lin, outside = QT.band_cell(bgp, _t(corner[None]))
    assert not bool(outside[0])
    lb = float(bgp.lbound[lin[0]])
    np.testing.assert_allclose(lb, gap, rtol=1e-3)
    sr = np.float32(bgp.skip_r[lin[0]])
    assert 0 < sr < lb
    n = 512
    rng = np.random.default_rng(int(gap * 1e5) + 2)
    q = np.repeat(corner[None], n, 0)
    q[n // 2:] += rng.uniform(0, 1e-6, (n // 2, 3)).astype(np.float32)
    R = np.full(n, _below(sr), np.float32)
    uu = _t(rng.uniform(0, 1, n).astype(np.float32))
    plain = dataclasses.replace(bgp, skip_r=None)
    p0, d0 = QT.band_sample_in_ball(plain, gp, _t(q), _t(R), uu)
    assert (R < sr).all()                        # every lane is skipped
    assert (p0 == -1).all() and (d0 == 0).all()
    p1, d1 = QT.band_sample_in_ball(bgp, gp, _t(q), _t(R), uu)
    assert torch.equal(p1, p0) and torch.equal(d1, d0)
    # the case is tight: just past lbound the plane weighs
    R2 = _t(np.full(n, np.float32(1.1 * lb + 1e-5), np.float32))
    p2, _ = QT.band_sample_in_ball(plain, gp, _t(q), R2, uu)
    assert (p2 == 0).all()


def test_unfused_steps_match_unskipped(tmp_path, monkeypatch):
    """Three unfused depth steps (K8 + K7) of the mixed-BC cube with a
    unit source and colored Neumann faces, the same generators, with
    K8's skip and live mask as the step passes them and without them:
    contributions and next walk states equal on every lane, bit for bit;
    the reach test took lanes."""
    from elaina_tpu_torch.core import problem as P
    from elaina_tpu_torch.solver import wost as W
    from elaina_tpu_torch.utils.rng import sample_generators
    from elaina_tpu_torch.utils.scenes import (cube_boundary,
                                               write_mixed_cube_source)

    monkeypatch.setenv("ELAINA_FUSED_BAND", "0")
    monkeypatch.setattr(P, "GRID_MAX_RES", 8)
    conf = write_mixed_cube_source(str(tmp_path))
    nv, _ = cube_boundary(3, (2, 3, 4, 5))
    colors = str(tmp_path / "neumann_colors.npz")
    np.savez(colors, colors=np.random.default_rng(6).uniform(
        0, 1, (len(nv), 2, 3)).astype(np.float32))
    conf["mesh"]["vertex_color_neumann_path"] = colors
    scene = P.Problem(3, CPU, verbose=False).load_config(conf).scene
    assert not W.fused_band_available(scene)
    n = 512
    pts = _t(np.random.default_rng(5).uniform(-0.8, 0.8, (n, 3))
             .astype(np.float32))

    def run():
        st = W.init_walk_state(pts, torch.ones(n, dtype=torch.bool))
        gens = sample_generators(7, 0, CPU)
        out = []
        for _ in range(3):
            st, c, _ = W.wost_depth_step(scene, st, gens, 0.02)
            out.append((c, st))
        return out

    skipped = run()
    ball = QT.band_sample_in_ball
    seen = []

    def unskipped(bg, gs, q, R, u, live=None):
        assert live is not None
        lin, outside = QT.band_cell(bg, q)
        cell = torch.where(outside, -1, lin).to(torch.int32)
        seen.append((int((live & (cell >= 0)).sum()), int(KQ.ball_work(
            cell, R, 0.0, bg.skip_r, live).sum())))
        return ball(dataclasses.replace(bg, skip_r=None), gs, q, R, u)

    monkeypatch.setattr(QT, "band_sample_in_ball", unskipped)
    full = run()
    assert len(seen) == 3
    n_live, n_work = (sum(x) for x in zip(*seen))
    assert n_work < 0.9 * n_live                 # the reach test took lanes
    for (c1, s1), (c0, s0) in zip(skipped, full):
        assert torch.equal(c1, c0)
        for f in ("pos", "thp", "active", "on_neumann", "n_normal"):
            assert torch.equal(getattr(s1, f), getattr(s0, f)), f
