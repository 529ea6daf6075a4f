"""K6's skip in the PyTorch port: a lane that is not live, or whose ball
and rays cannot reach its cell's row, gets the outputs of a lane without a
selection or a hit without a sweep.

The reach test is ``R + oe < skip_r[cell]`` (``geometry/grid.
band_skip_radius``: the band grid's lbound less a float margin; oe = eps
on a Neumann lane).  On the CPU the plain version runs, with the same
skip (``chip_smoke.py`` holds the CUDA kernel to it on the card).  Here:
the fields a depth step reads (pid, pdf_area, whit, wt, wnormal) equal the
unskipped query's on every live lane, at radii on both sides of skip_r
(down to one float below it), Neumann lanes with the eps offset, dead
lanes and lanes outside the grid; the margin at its tight case, a plane
across a cell's diagonal seen from the cell's corner; the non-skipped
lanes against ``elaina_tpu``'s ``band_neumann_walk_dma_3d`` in interpret
mode to the tolerances of ``tests/test_torch_kernels3d.py``; and a whole
depth step of the mixed cube lane for lane against the step without the
skip.
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
EPS = 0.01
STEP_FIELDS = ("pid", "pdf_area", "whit", "wt", "wnormal")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def soup():
    """tests/test_band_dma.py's soup (180 triangles, K = 16 on 6^3 cells)
    with the JAX band grid (and its DMA table) and the port's."""
    rng = np.random.default_rng(11)
    n_tri = 180
    centers = rng.uniform(-2, 2, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-0.35, 0.35, (n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    idx = np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)
    lo, hi = np.full(3, -3, np.float32), np.full(3, 3, np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        bg = jax_band_grid(verts, idx, lo, hi, K=16, max_res=6)
    arrays = {f: np.asarray(getattr(bg, f)) for f in (
        "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
        "ent_hi")} | {"res": bg.res}
    return (make_geom_set(verts, idx)[0], bg, port_geom_set(verts, idx, CPU),
            GT.band_grid_from_numpy(arrays, verts, idx, CPU))


def _below(sr, oe):
    """The largest float32 radii R with R + oe < sr."""
    R = (np.nextafter(sr, np.float32(-1)) - oe).astype(np.float32)
    for _ in range(3):
        R = np.where(R + oe < sr, R, np.nextafter(R, np.float32(-1)))
    return R.astype(np.float32)


def _lanes(bgp, n=4096, seed=21):
    """Lanes in and around the soup: a quarter of the radii from 0.7x to
    1.3x of their cell's skip_r less the eps offset, a quarter the largest
    below it, half up to 1.5; a third on the Neumann boundary (the eps
    offset), a fifth dead, some outside the grid."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3.2, 3.2, (n, 3)).astype(np.float32)
    lin, outside = QT.band_cell(bgp, _t(q))
    on = rng.random(n) < 0.3
    oe = np.where(on, np.float32(EPS), np.float32(0)).astype(np.float32)
    sr = bgp.skip_r[lin].numpy().astype(np.float32)
    R = (sr - oe) * rng.uniform(0.7, 1.3, n).astype(np.float32)
    k = rng.random(n)
    edge = k < 0.25            # the largest skipped reach
    R[edge] = _below(sr[edge], oe[edge])
    R[k > 0.5] = rng.uniform(0.05, 1.5, (k > 0.5).sum())
    R = np.maximum(R, np.float32(1e-4)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(on[:, None], nrm, 0.0).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rng.random(n) > 0.2
    return dict(q=q, R=R, on=on, nrm=nrm,
                u_sel=rng.uniform(0, 1, n).astype(np.float32),
                u_pt=rng.uniform(0, 1, (n, 2)).astype(np.float32), d=d,
                live=live, outside=outside.numpy())


def _walk(bgp, gp, L, live=True, skip=True):
    g = bgp if skip else dataclasses.replace(bgp, skip_r=None)
    return QT.band_neumann_walk(
        g, gp, _t(L["q"]), _t(L["R"]), _t(L["on"]), _t(L["nrm"]),
        _t(L["u_sel"]), _t(L["u_pt"]), _t(L["d"]), EPS,
        live=_t(L["live"]) if live else None)


def test_skip_keeps_the_step_fields(soup):
    """With the skip, every field the step reads equals the unskipped
    query's on every live lane; lanes on both sides of skip_r, and lanes
    the skip takes, are there in numbers."""
    _, _, gp, bgp = soup
    L = _lanes(bgp)
    o1, o0 = _walk(bgp, gp, L), _walk(bgp, gp, L, live=False, skip=False)
    live = L["live"]
    for f in STEP_FIELDS:
        np.testing.assert_array_equal(getattr(o1, f).numpy()[live],
                                      getattr(o0, f).numpy()[live], f)
    lin, outside = QT.band_cell(bgp, _t(L["q"]))
    cell = torch.where(outside, -1, lin).to(torch.int32)
    work = KQ.band_work(cell, _t(L["R"]), _t(L["on"]), EPS, bgp.skip_r,
                        _t(L["live"])).numpy()
    reach = work | ~live | L["outside"]
    assert (~reach).sum() > 300 and work.sum() > 800     # both sides
    assert (o0.pid.numpy()[work] >= 0).sum() > 100
    assert o0.whit.numpy()[work].sum() > 20
    # a skipped lane writes the outputs of a lane without a selection
    out, slot = KQ.band_neumann_walk(
        cell, _t(L["q"]), _t(L["R"]), _t(L["on"]), _t(L["nrm"]),
        _t(L["u_sel"]), _t(L["u_pt"]), _t(L["d"]), EPS, bgp.coords,
        bgp.skip_r, _t(L["live"]))
    Kp = bgp.coords.shape[2]
    assert (slot.numpy()[~work] == Kp).all()
    assert np.isinf(out.numpy()[~work, 11]).all()
    assert (np.delete(out.numpy()[~work], 11, axis=1) == 0).all()


@pytest.mark.parametrize("gap", [0.05, 1e-3, 1e-4])
def test_skip_margin_at_the_tight_case(gap):
    """A plane across the diagonal of the cell [0, 0.5]^3, ``gap`` beyond
    its corner 0: the cell's lbound is the corner's exact distance, so a
    lane at the corner is as near the plane as lbound allows.  Every reach
    up to one float below skip_r, toward the plane and around it, finds no
    weight and no hit without the skip; at 1.1x lbound it does."""
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
    assert not bool(outside[0]) and int(lin[0]) == (2 * 4 + 2) * 4 + 2
    lb = float(bgp.lbound[lin[0]])
    np.testing.assert_allclose(lb, gap, rtol=1e-3)
    sr = np.float32(bgp.skip_r[lin[0]])
    assert 0 < sr < lb
    n = 512
    rng = np.random.default_rng(int(gap * 1e5))
    q = np.repeat(corner[None], n, 0)
    q[n // 2:] += rng.uniform(0, 1e-6, (n // 2, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:n // 4] = -1.0 + rng.normal(0, 1e-3, (n // 4, 3))   # at the plane
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    # Neumann lanes start their rays eps toward the plane
    eps = np.float32(gap / 4)
    on = np.arange(n) % 2 == 1
    nrm = np.where(on[:, None], d, 0.0).astype(np.float32)
    oe = np.where(on, eps, np.float32(0))
    R = _below(np.full(n, sr, np.float32), oe)
    uu = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    args = [_t(x) for x in (q, R, on, nrm, uu[:, 0], uu[:, 1:], d)]
    plain = dataclasses.replace(bgp, skip_r=None)
    o = QT.band_neumann_walk(plain, gp, *args, float(eps))
    assert (R + oe < sr).all()                   # every lane is skipped
    assert (o.pid.numpy() == -1).all() and not o.whit.numpy().any()
    o2 = QT.band_neumann_walk(bgp, gp, *args, float(eps))
    for f in STEP_FIELDS:
        np.testing.assert_array_equal(getattr(o2, f).numpy(),
                                      getattr(o, f).numpy(), f)
    # the case is tight: just past lbound the plane is in reach
    args[1] = _t(np.full(n, np.float32(1.1 * lb + 1e-5), np.float32))
    o3 = QT.band_neumann_walk(plain, gp, *args, float(eps))
    assert (o3.pid.numpy() >= 0).all() and o3.whit.numpy()[:n // 4].all()


def test_non_skipped_lanes_match_pallas(soup, monkeypatch):
    """The non-skipped live lanes against the TPU kernel in interpret
    mode, to tests/test_torch_kernels3d.py's tolerances (a CDF slot can
    flip at a boundary under reassociation)."""
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    gj, bg, gp, bgp = soup
    L = _lanes(bgp, seed=22)
    args = [L[k] for k in ("q", "R", "on", "nrm", "u_sel", "u_pt", "d")]
    oj = QJ.band_neumann_walk(bg, gj, *map(jnp.asarray, args), EPS)
    op = _walk(bgp, gp, L)
    lin, outside = QT.band_cell(bgp, _t(L["q"]))
    cell = torch.where(outside, -1, lin).to(torch.int32)
    work = KQ.band_work(cell, _t(L["R"]), _t(L["on"]), EPS, bgp.skip_r,
                        _t(L["live"])).numpy()
    assert work.sum() > 800
    pj, pp = np.asarray(oj.pid), op.pid.numpy()
    valid = work & (pj >= 0)
    assert valid.sum() > 100
    np.testing.assert_array_equal(pp[work] >= 0, pj[work] >= 0)
    match = (pp == pj) | ~valid
    assert match[work].mean() > 0.995, f"{(~match).sum()} slot mismatches"
    sel = match & valid
    np.testing.assert_allclose(op.pdf_area.numpy()[sel],
                               np.asarray(oj.pdf_area)[sel], rtol=2e-4)
    np.testing.assert_allclose(op.sample_pt.numpy()[sel],
                               np.asarray(oj.sample_pt)[sel], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(op.side.numpy()[sel],
                                  np.asarray(oj.side)[sel])
    np.testing.assert_array_equal(op.occluded.numpy()[sel],
                                  np.asarray(oj.occluded)[sel])
    whit = np.asarray(oj.whit)
    assert whit[work].sum() > 20
    np.testing.assert_array_equal(op.whit.numpy()[work], whit[work])
    hit = work & whit
    np.testing.assert_allclose(op.wt.numpy()[hit], np.asarray(oj.wt)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(op.wnormal.numpy()[hit],
                               np.asarray(oj.wnormal)[hit], atol=1e-5)
    # and the skipped live lanes find nothing on the JAX side either
    skipped = L["live"] & ~work
    assert (pj[skipped] == -1).all() and not whit[skipped].any()


def test_depth_step_matches_unskipped(tmp_path, monkeypatch):
    """Three depth steps of the mixed cube (its Neumann faces colored, a
    unit source) with the same generators, with and without the skip:
    contributions and next walk states equal on every lane."""
    from elaina_tpu_torch.core import problem as P
    from elaina_tpu_torch.solver import wost as W
    from elaina_tpu_torch.utils.rng import sample_generators
    from elaina_tpu_torch.utils.scenes import (cube_boundary,
                                               write_mixed_cube_source)

    monkeypatch.setattr(P, "GRID_MAX_RES", 8)
    conf = write_mixed_cube_source(str(tmp_path))
    nv, _ = cube_boundary(3, (2, 3, 4, 5))
    colors = str(tmp_path / "neumann_colors.npz")
    np.savez(colors, colors=np.random.default_rng(6).uniform(
        0, 1, (len(nv), 2, 3)).astype(np.float32))
    conf["mesh"]["vertex_color_neumann_path"] = colors
    scene = P.Problem(3, CPU, verbose=False).load_config(conf).scene
    assert W.fused_band_available(scene)
    n = 512
    pts = torch.as_tensor(np.random.default_rng(5).uniform(
        -0.8, 0.8, (n, 3)).astype(np.float32))

    def run():
        st = W.init_walk_state(pts, torch.ones(n, dtype=torch.bool))
        gens = sample_generators(7, 0, CPU)
        out = []
        for _ in range(3):
            st, c, _ = W.wost_depth_step(scene, st, gens, EPS)
            out.append((c, st))
        return out

    skipped = run()
    walk = QT.band_neumann_walk
    work = []

    def unskipped(bg, *args, live=None):
        lin, outside = QT.band_cell(bg, args[1])
        cell = torch.where(outside, -1, lin).to(torch.int32)
        on = args[3]
        live_in = live & (cell >= 0)
        work.append((int(live_in.sum()), int(KQ.band_work(
            cell, args[2], on, EPS, bg.skip_r, live).sum())))
        return walk(dataclasses.replace(bg, skip_r=None), *args)

    monkeypatch.setattr(QT, "band_neumann_walk", unskipped)
    full = run()
    n_live, n_work = (sum(w) for w in zip(*work))
    assert n_work < 0.9 * n_live                 # the reach test took lanes
    hits = 0
    for (c1, s1), (c0, s0) in zip(skipped, full):
        assert torch.equal(c1, c0)
        for f in ("pos", "thp", "active", "on_neumann", "n_normal"):
            assert torch.equal(getattr(s1, f), getattr(s0, f)), f
        hits += int(s0.on_neumann.sum())
    assert hits > 0
