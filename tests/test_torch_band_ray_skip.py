"""K7's skip in the PyTorch port: a lane that is not live, or whose ray
cannot reach its cell's row, gets a miss (t = +inf, slot = Kp) without a
sweep.

The reach test is ``tmax + offset < skip_r[cell]`` (``geometry/grid.
band_skip_radius``: the band grid's lbound less a float margin; offset
bounds |o - ref|, the eps of an offset origin).  On the CPU the plain
version runs, with the same skip (``chip_smoke.py`` phase 5 holds the CUDA
kernel to it on the card, and to the unskipped kernel on live lanes).
Here: the live lanes against ``elaina_tpu``'s ``band_ray_dma_3d`` in
interpret mode (through ``band_ray_intersect``, with and without an
offset origin), the skipped and dead lanes a miss; the skip leaves every
live lane of the unskipped query as it was, at reaches on both sides of
skip_r; the margin at its tight case, a plane across a cell's diagonal
seen from the cell's corner; and a few depth steps of the mixed-BC cube
with a unit source, fused (the source term's K7) and unfused (K8 and K7
in the Neumann term and the walk), equal with and without the new
arguments, bit for bit.
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


def _rays(bgp, gj, n, seed, offset: bool):
    """Rays in and around the soup from ref points (o = ref + eps d with
    ``offset``): half aimed at a triangle's centroid; a quarter of the
    lengths the largest whose reach lies below the cell's skip_r, a
    quarter from 0.7x to 1.3x of it, half up to 3; a fifth of the lanes
    dead."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-3.2, 3.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    cen = np.asarray(gj.verts)[np.asarray(gj.indices)].mean(1)
    aim = cen[rng.integers(0, len(cen), n)] - ref
    d[::2] = aim[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    off = np.float32(EPS if offset else 0.0)
    o = (ref + off * d).astype(np.float32)
    lin, _ = QT.band_cell(bgp, _t(ref))
    sr = bgp.skip_r[lin].numpy().astype(np.float32)
    tmax = ((sr - off) * rng.uniform(0.7, 1.3, n)).astype(np.float32)
    k = rng.random(n)
    edge = k < 0.25
    below = (np.nextafter(sr, np.float32(-1)) - off).astype(np.float32)
    for _ in range(3):
        below = np.where(below + off < sr, below,
                         np.nextafter(below, np.float32(-1)))
    tmax[edge] = below[edge]
    tmax[k > 0.5] = rng.uniform(0.05, 3.0, (k > 0.5).sum())
    tmax = np.maximum(tmax, np.float32(1e-4)).astype(np.float32)
    return dict(ref=ref, o=o, d=d, tmax=tmax, off=float(off),
                live=rng.random(n) > 0.2)


@pytest.mark.parametrize("offset", [False, True])
def test_live_lanes_match_pallas(offset, soup, monkeypatch):
    """``band_ray_intersect`` with the skip and the live mask against the
    TPU kernel in interpret mode on the live lanes: hits exact, t within
    1e-5, prim ids exact; the lanes it skips or that are dead miss."""
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    gj, bg, gp, bgp = soup
    L = _rays(bgp, gj, 2048, 31 + offset, offset)
    hj, tj, pj = (np.asarray(a) for a in QJ.band_ray_intersect(
        bg, gj, jnp.asarray(L["o"]), jnp.asarray(L["d"]),
        jnp.asarray(L["tmax"]), ref=jnp.asarray(L["ref"])))
    hp, tp, pp = (a.numpy() for a in QT.band_ray_intersect(
        bgp, gp, _t(L["o"]), _t(L["d"]), _t(L["tmax"]), ref=_t(L["ref"]),
        live=_t(L["live"]), offset=L["off"]))
    live = L["live"]
    assert hj[live].sum() >= 16
    np.testing.assert_array_equal(hp[live], hj[live])
    np.testing.assert_allclose(tp[live & hj], tj[live & hj], rtol=1e-5)
    np.testing.assert_array_equal(pp[live], pj[live])
    assert not hp[~live].any() and np.isinf(tp[~hp]).all()
    # the lanes the reach test took: a miss on the JAX side too
    lin, outside = QT.band_cell(bgp, _t(L["ref"]))
    cell = torch.where(outside, -1, lin).to(torch.int32)
    work = KQ.ray_work(cell, _t(L["tmax"]), L["off"], bgp.skip_r,
                       _t(live)).numpy()
    skipped = live & ~work & ~outside.numpy()
    assert skipped.sum() > 100 and work.sum() > 400
    assert not hj[skipped].any()


def test_skip_keeps_live_lanes(soup):
    """The kernel's contract with and without the skip: on live lanes t
    and slot as the unskipped sweep gives them; every lane the skip or
    the mask takes gets t = +inf and slot = Kp."""
    gj, _, _, bgp = soup
    L = _rays(bgp, gj, 4096, 41, True)
    lin, outside = QT.band_cell(bgp, _t(L["ref"]))
    cell = torch.where(outside, -1, lin).to(torch.int32)
    args = (cell, _t(L["o"]), _t(L["d"]), _t(L["tmax"]), bgp.coords)
    live = _t(L["live"])
    t0, s0 = KQ.band_ray(*args)
    t1, s1 = KQ.band_ray(*args, bgp.skip_r, live, L["off"])
    assert torch.equal(t1[live], t0[live]) and torch.equal(s1[live],
                                                           s0[live])
    work = KQ.ray_work(cell, _t(L["tmax"]), L["off"], bgp.skip_r, live)
    Kp = bgp.coords.shape[2]
    assert torch.isinf(t1[~work]).all() and (s1[~work] == Kp).all()
    assert int(torch.isfinite(t0[live]).sum()) >= 16
    assert int((live & ~work & (cell >= 0)).sum()) > 200


@pytest.mark.parametrize("gap", [0.05, 1e-3, 1e-4])
def test_skip_margin_at_the_tight_case(gap):
    """A plane across the diagonal of the cell [0, 0.5]^3, ``gap`` beyond
    its corner 0 (tests/test_torch_band_skip.py's case): rays from points
    at the corner, with origins eps toward the plane and reaches up to one
    float below skip_r, miss without the skip (so the skip gives what the
    sweep gives); at 1.1x lbound the rays toward the plane hit it."""
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
    rng = np.random.default_rng(int(gap * 1e5) + 1)
    ref = np.repeat(corner[None], n, 0)
    ref[n // 2:] += rng.uniform(0, 1e-6, (n // 2, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:n // 2] = -1.0 + rng.normal(0, 1e-3, (n // 2, 3))   # at the plane
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    eps = np.float32(gap / 4)
    o = (ref + eps * d).astype(np.float32)
    tmax = np.nextafter(sr, np.float32(-1)) - eps
    for _ in range(3):
        tmax = np.where(tmax + eps < sr, tmax,
                        np.nextafter(tmax, np.float32(-1)))
    tmax = np.full(n, tmax, np.float32)
    args = [_t(x) for x in (o, d, tmax)]
    h0, t0, p0 = QT.band_ray_intersect(bgp, gp, *args, ref=_t(ref))
    assert (tmax + eps < sr).all()               # every lane is skipped
    assert not h0.any()
    h1, t1, p1 = QT.band_ray_intersect(bgp, gp, *args, ref=_t(ref),
                                       offset=float(eps))
    assert torch.equal(h1, h0) and torch.equal(t1, t0) and torch.equal(p1,
                                                                       p0)
    # the case is tight: just past lbound the plane is in reach
    args[2] = _t(np.full(n, np.float32(1.1 * lb + 1e-5), np.float32))
    h2, _, _ = QT.band_ray_intersect(bgp, gp, *args, ref=_t(ref),
                                     offset=float(eps))
    assert h2[:n // 2].all()


@pytest.mark.parametrize("fused", [True, False])
def test_source_cube_steps_match_unskipped(fused, tmp_path, monkeypatch):
    """Three depth steps of the mixed-BC cube with a unit source and
    colored Neumann faces, the same generators, with K7's skip and live
    mask as the step passes them and without them: contributions and next
    walk states equal on every lane; the reach test took lanes."""
    from elaina_tpu_torch.core import problem as P
    from elaina_tpu_torch.solver import wost as W
    from elaina_tpu_torch.utils.rng import sample_generators
    from elaina_tpu_torch.utils.scenes import (cube_boundary,
                                               write_mixed_cube_source)

    monkeypatch.setenv("ELAINA_FUSED_BAND", "1" if fused else "0")
    monkeypatch.setattr(P, "GRID_MAX_RES", 8)
    conf = write_mixed_cube_source(str(tmp_path))
    nv, _ = cube_boundary(3, (2, 3, 4, 5))
    colors = str(tmp_path / "neumann_colors.npz")
    np.savez(colors, colors=np.random.default_rng(6).uniform(
        0, 1, (len(nv), 2, 3)).astype(np.float32))
    conf["mesh"]["vertex_color_neumann_path"] = colors
    scene = P.Problem(3, CPU, verbose=False).load_config(conf).scene
    assert W.fused_band_available(scene) == fused
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
    ray = QT.band_ray_intersect
    seen = []

    def unskipped(bg, gs, o, d, tmax, ref=None, live=None, offset=None):
        assert live is not None and offset == 0.02
        lin, outside = QT.band_cell(bg, ref)
        cell = torch.where(outside, -1, lin).to(torch.int32)
        seen.append((int((live & (cell >= 0)).sum()), int(KQ.ray_work(
            cell, tmax, offset, bg.skip_r, live).sum())))
        return ray(dataclasses.replace(bg, skip_r=None), gs, o, d, tmax,
                   ref=ref)

    monkeypatch.setattr(QT, "band_ray_intersect", unskipped)
    full = run()
    assert len(seen) == (3 if fused else 9)      # source; + Neumann, walk
    n_live, n_work = (sum(x) for x in zip(*seen))
    assert n_work < 0.9 * n_live                 # the reach test took lanes
    for (c1, s1), (c0, s0) in zip(skipped, full):
        assert torch.equal(c1, c0)
        for f in ("pos", "thp", "active", "on_neumann", "n_normal"):
            assert torch.equal(getattr(s1, f), getattr(s0, f)), f
