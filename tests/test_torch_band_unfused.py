"""The unfused prim-band queries of the PyTorch port against the JAX
package, and the port's fused band step against its unfused one.

K7 ``band_ray_dma_3d`` and K8 ``band_ball_dma_3d``
(``elaina_tpu/ops/pallas_queries.py``, interpret mode, through
``band_ray_intersect`` / ``band_sample_in_ball``) against the port's
queries, whose wrappers take their plain PyTorch versions on CPU tensors
(the CUDA kernels are held against those on the card by
``chip_smoke.py``), with the thresholds of ``tests/test_band_dma.py``: a
CDF slot can flip at a boundary under reassociation (the TPU's
triangular-matmul prefix sum against ``torch.cumsum``).  Then the port's
depth step with the fused kernel (K6) against the same step on K8 + K7
(``ELAINA_FUSED_BAND=0``), the same generators, lane for lane, with the
thresholds of ``tests/test_fused_band.py:155-190``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import elaina_tpu.geometry.queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.geometry.grid import build_prim_band_grid  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.geometry.geomset import \
    make_geom_set as port_geom_set  # noqa: E402
from elaina_tpu_torch.geometry.grid import band_grid_from_numpy  # noqa: E402
from elaina_tpu_torch.ops import queries as KQ  # noqa: E402

CPU = torch.device("cpu")


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
        bg = build_prim_band_grid(verts, idx, lo, hi, K=16, max_res=6)
    assert bg.coords is not None
    arrays = {f: np.asarray(getattr(bg, f)) for f in (
        "origin", "inv_cell", "rows", "r_cap", "lbound", "ent_lo",
        "ent_hi")} | {"res": bg.res}
    return (make_geom_set(verts, idx)[0], bg, port_geom_set(verts, idx, CPU),
            band_grid_from_numpy(arrays, verts, idx, CPU))


@pytest.mark.parametrize("ref", [False, True])
def test_band_ray_matches_pallas(ref, soup, monkeypatch):
    """Hits, t and prim ids as band_ray_dma_3d gives them; with ``ref``
    the eps-offset origins take their reference point's cell."""
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    gj, bg, gp, bgp = soup
    rng = np.random.default_rng(5 + ref)
    n = 512
    base = rng.uniform(-3.4, 3.4, (n, 3)).astype(np.float32)  # some outside
    o = (base + rng.normal(size=(n, 3)).astype(np.float32) * 0.01
         if ref else base)
    # half the rays aim at a triangle's centroid, so many of them hit
    d = rng.normal(size=(n, 3)).astype(np.float32)
    cen = np.asarray(gj.verts)[np.asarray(gj.indices)].mean(1)
    aim = cen[rng.integers(0, len(cen), n)] - o
    d[::2] = aim[::2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(0.5, 3.0, n).astype(np.float32)
    kw_j = dict(ref=jnp.asarray(base)) if ref else {}
    kw_p = dict(ref=_t(base)) if ref else {}
    hj, tj, pj = (np.asarray(a) for a in QJ.band_ray_intersect(
        bg, gj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), **kw_j))
    hp, tp, pp = (a.numpy() for a in QT.band_ray_intersect(
        bgp, gp, _t(o), _t(d), _t(tmax), **kw_p))
    assert hj.sum() >= 16      # a row holds only its cell's nearest prims
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_allclose(tp[hj], tj[hj], rtol=1e-5)
    assert np.isinf(tp[~hj]).all()
    np.testing.assert_array_equal(pp, pj)


def test_band_ray_kernel_contract(soup):
    """K7's own outputs: slot Kp on a miss and for cell < 0; the hit's
    slot holds the prim the query reports."""
    _, _, _, bgp = soup
    rng = np.random.default_rng(8)
    n = 256
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lin, outside = QT.band_cell(bgp, _t(o))
    cell = torch.where(outside | (torch.arange(n) % 5 == 0), -1,
                       lin).to(torch.int32)
    t, slot = KQ.band_ray(cell, _t(o), _t(d), torch.full((n,), 2.0),
                          bgp.coords)
    Kp = bgp.coords.shape[2]
    miss = ~torch.isfinite(t)
    assert (~miss).sum() >= 8 and miss.sum() > n // 8
    assert (slot[miss] == Kp).all()
    assert (slot[~miss] < bgp.rows.shape[1]).all()
    assert miss[cell < 0].all()


def test_band_ball_matches_pallas(soup, monkeypatch):
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    gj, bg, gp, bgp = soup
    rng = np.random.default_rng(12)
    n = 2048
    q = rng.uniform(-3.2, 3.2, (n, 3)).astype(np.float32)
    R = rng.uniform(0.3, 2.0, n).astype(np.float32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    pj, dj = (np.asarray(a) for a in QJ.band_sample_in_ball(
        bg, gj, jnp.asarray(q), jnp.asarray(R), jnp.asarray(u)))
    pp, dp = (a.numpy() for a in QT.band_sample_in_ball(
        bgp, gp, _t(q), _t(R), _t(u)))
    valid = pj >= 0
    assert valid.sum() > n // 8
    np.testing.assert_array_equal(pp >= 0, valid)
    match = pp == pj
    assert (match | ~valid).mean() > 0.995, (~match & valid).sum()
    sel = match & valid
    np.testing.assert_allclose(dp[sel], dj[sel], rtol=2e-4)
    assert (dp[~valid] == 0).all()


def test_band_ball_pdf_normalization(soup):
    """Over u sweeping (0, 1) at fixed points, every selected prim's pdf
    is positive and finite, and the selection frequencies follow the
    weights: the pdf times the prim's measure sums to 1 over the prims
    the sweep reaches."""
    _, _, gp, bgp = soup
    rng = np.random.default_rng(13)
    m = 4096
    centres = rng.uniform(-1.5, 1.5, (4, 3)).astype(np.float32)
    for c in centres:
        q = torch.as_tensor(np.repeat(c[None], m, 0))
        u = torch.as_tensor((np.arange(m) + 0.5) / m, dtype=torch.float32)
        pid, pdf = QT.band_sample_in_ball(bgp, gp, q, torch.full((m,), 1.5),
                                          u)
        ok = pid >= 0
        if not ok.any():
            continue
        assert ok.all()
        assert torch.isfinite(pdf).all() and (pdf > 0).all()
        ids, first = np.unique(pid.numpy(), return_index=True)
        p_sel = (pdf * gp.prim_measure[pid.long()]).numpy()[first]
        np.testing.assert_allclose(p_sel.sum(), 1.0, rtol=1e-4)
        freq = np.bincount(np.searchsorted(ids, pid.numpy())) / m
        np.testing.assert_allclose(freq, p_sel, atol=2.0 / m)


def test_fused_step_matches_unfused(tmp_path, monkeypatch):
    """The port's depth step with K6 against the step on K8 + K7, three
    steps on the mixed cube (its Neumann faces colored, so the Neumann
    term counts, and a unit source) with the same generators: positions
    >= 99% within rtol 1e-4 / atol 1e-5, contributions >= 99% within rtol 1e-3
    / atol 1e-6, ``active`` equal, ``on_neumann`` >= 99% equal
    (tests/test_fused_band.py:155-190)."""
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
    problem = P.Problem(3, CPU, verbose=False).load_config(conf)
    scene = problem.scene
    eps = 0.02
    # 36 Dirichlet triangles: no candidate grid, the dense 3D sweep
    assert scene.d_grid is None and scene.dirichlet is not None
    n = 512
    pts = torch.as_tensor(np.random.default_rng(5).uniform(
        -0.8, 0.8, (n, 3)).astype(np.float32))

    def run(fused: str, steps=3):
        monkeypatch.setenv("ELAINA_FUSED_BAND", fused)
        assert W.fused_band_available(scene) == (fused == "1")
        st = W.init_walk_state(pts, torch.ones(n, dtype=torch.bool))
        gens = sample_generators(7, 0, CPU)
        acc = torch.zeros((n, 3))
        hits = 0
        for _ in range(steps):
            st, c, _ = W.wost_depth_step(scene, st, gens, eps)
            acc += c
            hits += int(st.on_neumann.sum())
        return acc.numpy(), st, hits

    acc_u, st_u, hits = run("0")
    acc_f, st_f, _ = run("1")
    assert hits > 0 and (acc_u != 0).any()
    pos_match = np.all(np.isclose(st_f.pos.numpy(), st_u.pos.numpy(),
                                  rtol=1e-4, atol=1e-5), axis=-1)
    acc_match = np.all(np.isclose(acc_f, acc_u, rtol=1e-3, atol=1e-6),
                       axis=-1)
    assert pos_match.mean() > 0.99, (~pos_match).sum()
    assert acc_match.mean() > 0.99, (~acc_match).sum()
    np.testing.assert_array_equal(st_f.active.numpy(), st_u.active.numpy())
    assert (st_f.on_neumann == st_u.on_neumann).float().mean() > 0.99
