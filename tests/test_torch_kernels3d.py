"""3D kernels of the PyTorch port against the Pallas kernels they replace,
and the triangle primitives against ``elaina_tpu/geometry/primitives.py``.

K4 ``sweep_resolve_3d`` and K5 ``fetch_colors3``
(``elaina_tpu/ops/pallas_resolve.py``), K9 ``sil_band_dma`` and K6
``band_neumann_walk_dma_3d`` (``elaina_tpu/ops/pallas_queries.py``).  Both
sides get the same scene (the JAX build, carried over with
``scene_from_numpy`` / ``*_grid_from_numpy``) and the same lanes, made
from a seed with numpy.  The Pallas kernels run in interpret mode; on CPU
tensors the port's wrappers take their plain PyTorch versions, which are
what the CUDA kernels are held against on the card (``chip_smoke.py``).
K6's CDF can flip a slot at a boundary under reassociation (the TPU's
triangular-matmul prefix sum against ``torch.cumsum``), so it is held to
the thresholds of ``tests/test_fused_band.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.core.problem import Boundary, Scene  # noqa: E402
from elaina_tpu.geometry import primitives as PJ  # noqa: E402
from elaina_tpu.geometry import queries as QJ  # noqa: E402
from elaina_tpu.geometry.geomset import make_geom_set  # noqa: E402
from elaina_tpu.geometry.grid import (attach_coords, attach_fine,  # noqa: E402
                                      attach_shading, build_candidate_grid,
                                      build_prim_band_grid,
                                      build_silhouette_grid)
from elaina_tpu.geometry.grid import \
    fine_decode as jax_fine_decode  # noqa: E402
from elaina_tpu.ops.pallas_queries import sil_band_dma  # noqa: E402
from elaina_tpu.ops.pallas_resolve import (fetch_colors3,  # noqa: E402
                                           kprime_for, pack_groups,
                                           sweep_resolve_3d)
from elaina_tpu_torch.geometry import primitives as PT  # noqa: E402
from elaina_tpu_torch.geometry import queries as QT  # noqa: E402
from elaina_tpu_torch.geometry.geomset import \
    make_geom_set as port_geom_set  # noqa: E402
from elaina_tpu_torch.geometry.grid import (band_grid_from_numpy,  # noqa: E402
                                            sil_grid_from_numpy)
from elaina_tpu_torch.ops import queries as KQ  # noqa: E402
from elaina_tpu_torch.ops import resolve as R  # noqa: E402

CPU = torch.device("cpu")
EPS = 0.3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _soup(n_tri, seed, spread=2.0, size=0.35):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    return verts, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)


# --------------------------------------------------------------------------- #
# triangle primitives
# --------------------------------------------------------------------------- #


def test_triangle_primitives_match_jax():
    rng = np.random.default_rng(3)
    n = 3000
    a, b, c = (rng.uniform(-1, 1, (n, 3)).astype(np.float32)
               for _ in range(3))
    q = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(0.1, 3.0, n).astype(np.float32)
    u1, u2 = (rng.uniform(0, 1, n).astype(np.float32) for _ in range(2))
    J = tuple(map(jnp.asarray, (a, b, c)))
    T = tuple(map(_t, (a, b, c)))

    def close(x, y, rtol=1e-5, atol=1e-5):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol,
                                   atol=atol)

    close(PT.tri_normal(*T), PJ.tri_normal(*J))
    close(PT.tri_area(*T), PJ.tri_area(*J))
    for x, y in zip(PT.tri_project_bary(_t(q), *T),
                    PJ.tri_project_bary(jnp.asarray(q), *J)):
        close(x, y, rtol=1e-4, atol=1e-4)
    dp, (up, vp) = PT.tri_closest_point(_t(q), *T)
    dj, (uj, vj) = PJ.tri_closest_point(jnp.asarray(q), *J)
    close(dp, dj)
    close(up, uj, atol=1e-4)
    close(vp, vj, atol=1e-4)
    # sides: equal away from the plane (|dot| above rounding)
    sp = PT.tri_side(_t(q), *T).numpy()
    sj = np.asarray(PJ.tri_side(jnp.asarray(q), *J))
    nrm = np.cross(b - a, c - a)
    far = np.abs(np.sum((q - a) * nrm, -1)) > 1e-5
    np.testing.assert_array_equal(sp[far], sj[far])
    hp, tp = PT.ray_tri_intersect(_t(q), _t(d), *T, _t(tmax))
    hj, tj = PJ.ray_tri_intersect(jnp.asarray(q), jnp.asarray(d), *J,
                                  jnp.asarray(tmax))
    hj = np.asarray(hj)
    assert hj.any() and not hj.all()
    np.testing.assert_array_equal(hp.numpy(), hj)
    close(tp.numpy()[hj], np.asarray(tj)[hj])
    for dim in (2, 3):
        vt = T if dim == 3 else tuple(x[:, :2] for x in T[:2])
        vj = J if dim == 3 else tuple(x[:, :2] for x in J[:2])
        qd = q[:, :dim]
        close(PT.prim_sample_point(dim, vt, _t(u1), _t(u2)),
              PJ.prim_sample_point(dim, vj, jnp.asarray(u1), jnp.asarray(u2)))
        close(PT.prim_measure(dim, vt), PJ.prim_measure(dim, vj))
        close(PT.prim_closest_point(dim, _t(qd), vt)[0],
              PJ.prim_closest_point(dim, jnp.asarray(qd), vj)[0])
        close(PT.prim_project(dim, _t(qd), vt),
              PJ.prim_project(dim, jnp.asarray(qd), vj), rtol=1e-4,
              atol=1e-4)


def test_geomset_3d_matches_jax():
    verts, idx = _soup(40, 5)
    gj = make_geom_set(verts, idx)[0]
    gp = port_geom_set(verts, idx, CPU)
    np.testing.assert_allclose(gp.prim_normal.numpy(),
                               np.asarray(gj.prim_normal), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gp.prim_measure.numpy(),
                               np.asarray(gj.prim_measure), rtol=1e-6)
    for name in ("sil_p0", "sil_p1", "sil_n1", "sil_n2", "sil_always"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(),
                                      np.asarray(getattr(gj, name)))


# --------------------------------------------------------------------------- #
# K4 / K5: the 3D Dirichlet resolve
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def resolve_scenes():
    """A 120-triangle soup with the JAX fast-path tables (fine pack,
    coordinate planes, candidate tiles, color rows) on a 16^3 grid, and
    the port's scene holding the same grid."""
    from test_torch_resolve import port_scene_of

    verts, idx = _soup(120, 23, spread=3.0, size=0.6)
    lo = np.full(3, -4.5, np.float32)
    hi = np.full(3, 4.5, np.float32)
    grid = build_candidate_grid(verts, idx, lo, hi, K=64, max_res=16)
    colors = np.random.default_rng(13).uniform(
        0, 1, (len(verts), 2, 3)).astype(np.float32)
    g = attach_shading(attach_fine(attach_coords(grid, verts, idx), EPS),
                       colors, idx)
    scene_jax = Scene(
        dirichlet=Boundary(gs=make_geom_set(verts, idx)[0],
                           colors=jnp.asarray(colors)),
        neumann=None, d_grid=g, source=None, aabb_lo=jnp.asarray(lo),
        aabb_hi=jnp.asarray(hi), dim=3, source_intensity=1.0,
        dirichlet_intensity=1.0, neumann_intensity=1.0)
    return scene_jax, port_scene_of(scene_jax, verts, idx), verts, idx, {}


def _jax_sweep3(n, resolve_scenes):
    scene_jax, _, _, _, memo = resolve_scenes
    if n not in memo:
        g = scene_jax.d_grid
        rng = np.random.default_rng(31 + n)
        q = rng.uniform(-4.4, 4.4, (n, 3)).astype(np.float32)
        active = np.arange(n) % 5 != 0
        row, need_f, _, outside = (np.asarray(a) for a in jax_fine_decode(
            g.fine, jnp.asarray(q)))
        mask = active & (need_f | outside)
        assert 0 < mask.sum() < n
        K = g.cand.shape[1]
        d, pid, pv = sweep_resolve_3d(
            pack_groups(jnp.asarray(mask)), jnp.asarray(row), jnp.asarray(q),
            g.coords, g.cpack, rpp=-(-K // 128), kprime=kprime_for(K),
            interpret=True)
        memo[n] = ((q, row.astype(np.int32), mask),
                   (np.asarray(d), np.asarray(pid),
                    np.concatenate([np.asarray(c) for c in pv], axis=1)))
    return memo[n]


@pytest.mark.parametrize("n", [2048])
def test_sweep_resolve_3d_matches_pallas(n, resolve_scenes):
    scene_jax, scene_port, verts, idx, _ = resolve_scenes
    (q, row, m), (dj, pj, cj) = _jax_sweep3(n, resolve_scenes)
    gp = scene_port.d_grid
    dp, pp, cp = (a.numpy() for a in R.sweep_resolve_3d(
        _t(m), _t(row), _t(q), gp.coords, gp.cand))
    np.testing.assert_allclose(dp[m], dj[m], rtol=1e-5, atol=1e-5)
    # the winner is exact except where the row's two best squared
    # distances are within 1e-6 relative (a shared edge or corner, which
    # XLA's contracted multiply-adds may round the other way)
    cand = np.asarray(gp.cand)[row[m]]
    pvs = [verts[idx[np.maximum(cand, 0), k]] for k in range(3)]
    c9 = tuple(torch.as_tensor(pvs[k][..., d]) for k in range(3)
               for d in range(3))
    d2 = R.tri_d2_planes(tuple(_t(q[m][:, d:d + 1]) for d in range(3)),
                         c9).numpy()
    d2 = np.where(cand >= 0, d2, np.inf)
    two = np.sort(d2, axis=1)[:, :2]
    ok = two[:, 1] - two[:, 0] >= 1e-6 * np.maximum(two[:, 1], 1e-30)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(pp[m][ok], pj[m][ok])
    np.testing.assert_array_equal(cp[m][ok], cj[m][ok])
    # at a tie the port's winner is one of the tied candidates
    slot = np.argmax(cand == pp[m][:, None], axis=1)
    lane = np.arange(slot.shape[0])
    assert (cand[lane, slot] == pp[m]).all()
    assert (d2[lane, slot] <= two[:, 0] * (1 + 1e-6) + 1e-12).all()
    # unmasked lanes: the port's defined fill
    assert (pp[~m] == -1).all() and (dp[~m] == 0).all()
    assert (cp[~m] == 0).all()


@pytest.mark.parametrize("n", [2048])
def test_fetch_colors3_matches_pallas(n, resolve_scenes):
    scene_jax, scene_port, _, _, _ = resolve_scenes
    (q, _, m), (d, pid, c9) = _jax_sweep3(n, resolve_scenes)
    pv = tuple(jnp.asarray(c9[:, 3 * k:3 * k + 3]) for k in range(3))
    uv = np.asarray(PJ.prim_project(3, jnp.asarray(q), pv))
    side = np.asarray(PJ.prim_side(3, jnp.asarray(q), pv))
    ins = (m & (d < EPS) & (uv[:, 0] > 0) & (uv[:, 1] > 0)
           & (uv.sum(-1) < 1))
    assert ins.any()
    cfi = np.where(ins, 2 * np.maximum(pid, 0) + (side < 0), 0).astype(
        np.int32)
    cj = fetch_colors3(pack_groups(jnp.asarray(ins)), jnp.asarray(cfi),
                       scene_jax.d_grid.crows, interpret=True)
    cp = R.fetch_colors3(_t(ins), _t(cfi), scene_port.d_grid.color_rows)
    for a, b in zip(cp, cj):
        np.testing.assert_array_equal(a.numpy()[ins], np.asarray(b)[ins])
        assert (a.numpy()[~ins] == 0).all()


# --------------------------------------------------------------------------- #
# K9 / K6: the Neumann band grids
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def band_sets():
    """The JAX band grids (with their DMA tables) of two sets, and the
    port's, carried over: a closed surface (bumpy3d_3, 1,280 triangles,
    silhouettes by the sign test) and test_fused_band's open soup."""
    from elaina_tpu_torch.geometry.native import load_obj_native

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        for name, (verts, idx), K, res in (
                ("bumpy", load_obj_native(os.path.join(
                    REPO, "configs", "data", "bumpy3d_3.obj"), 3), 64, 8),
                ("soup", _soup(160, 17), 16, 6)):
            lo = np.full(3, -3, np.float32)
            hi = np.full(3, 3, np.float32)
            gj = make_geom_set(verts, idx)[0]
            gp = port_geom_set(verts, idx, CPU)
            sg = build_silhouette_grid(
                np.asarray(gj.sil_p0), np.asarray(gj.sil_p1),
                np.asarray(gj.sil_n1), np.asarray(gj.sil_n2),
                np.asarray(gj.sil_always), lo, hi, K=K, max_res=res)
            bg = build_prim_band_grid(verts, idx, lo, hi, K=K, max_res=res)
            assert sg.coords is not None and bg.coords is not None

            def arrays(g):
                return {f: np.asarray(getattr(g, f)) for f in (
                    "origin", "inv_cell", "rows", "r_cap", "lbound",
                    "ent_lo", "ent_hi")} | {"res": g.res}

            out[name] = (gj, sg, bg, gp,
                         sil_grid_from_numpy(arrays(sg), gp, CPU),
                         band_grid_from_numpy(arrays(bg), verts, idx, CPU))
    return out


@pytest.mark.parametrize("name", ["bumpy", "soup"])
def test_sil_band_matches_pallas(name, band_sets, monkeypatch):
    gj, sg, _, _, sgp, _ = band_sets[name]
    rng = np.random.default_rng(7)
    n = 1024
    q = rng.uniform(-3.3, 3.3, (n, 3)).astype(np.float32)   # some outside
    lin, outside = (a.numpy() for a in QT.band_cell(sgp, _t(q)))
    cell = np.where(outside, -1, lin).astype(np.int32)
    K = sg.rows.shape[1]
    dj = np.asarray(sil_band_dma(jnp.asarray(cell), jnp.asarray(q),
                                 sg.coords, -(-K // 128), 3, interpret=True))
    dp = KQ.sil_band(_t(cell), _t(q), sgp.coords).numpy()
    inn = cell >= 0
    assert inn.sum() > n // 2
    found = inn & (dj < 1e17)
    assert found.sum() > n // 4
    np.testing.assert_array_equal(dp[inn] < 1e17, dj[inn] < 1e17)
    np.testing.assert_allclose(dp[found], dj[found], rtol=1e-5, atol=1e-9)
    assert np.isinf(dp[~inn]).all()
    # the query end to end: r_cap clamp, "none" and the bbox outside
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    rj = np.asarray(QJ.grid_closest_silhouette(sg, gj, jnp.asarray(q)))
    rp = QT.grid_closest_silhouette(sgp, _t(q)).numpy()
    np.testing.assert_array_equal(np.isfinite(rp), np.isfinite(rj))
    fin = np.isfinite(rj)
    np.testing.assert_allclose(rp[fin], rj[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["bumpy", "soup"])
def test_band_neumann_walk_matches_pallas(name, band_sets, monkeypatch):
    """The thresholds of tests/test_fused_band.py:83-131."""
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    gj, _, bg, gp, _, bgp = band_sets[name]
    rng = np.random.default_rng(19)
    n = 1024
    eps = 0.01
    span = 1.6 if name == "bumpy" else 3.2      # bumpy3d_3 has radius ~1
    q = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    # equivalence, not completeness: both sides weigh the same band row
    R_ = rng.uniform(0.05, 1.5, n).astype(np.float32)
    on_n = rng.random(n) < 0.3
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(on_n[:, None], nrm, 0.0).astype(np.float32)
    u_sel = rng.uniform(0, 1, n).astype(np.float32)
    u_pt = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    d_walk = rng.normal(size=(n, 3)).astype(np.float32)
    d_walk /= np.linalg.norm(d_walk, axis=-1, keepdims=True)
    args = (q, R_, on_n, nrm, u_sel, u_pt, d_walk)
    oj = QJ.band_neumann_walk(bg, gj, *map(jnp.asarray, args), eps)
    op = QT.band_neumann_walk(bgp, gp, *map(_t, args), eps)
    np.testing.assert_allclose(np.asarray(QT.band_r_cap(bgp, _t(q))),
                               np.asarray(QJ.band_r_cap(bg, jnp.asarray(q))),
                               rtol=1e-6)

    pj, pp = np.asarray(oj.pid), op.pid.numpy()
    valid = pj >= 0
    assert valid.sum() > n // 8
    np.testing.assert_array_equal(pp >= 0, valid)
    match = (pp == pj) | ~valid
    assert match.mean() > 0.995, f"{(~match).sum()} slot mismatches"
    sel = match & valid
    np.testing.assert_allclose(op.pdf_area.numpy()[sel],
                               np.asarray(oj.pdf_area)[sel], rtol=2e-4)
    np.testing.assert_allclose(op.sample_pt.numpy()[sel],
                               np.asarray(oj.sample_pt)[sel], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(op.side.numpy()[sel],
                                  np.asarray(oj.side)[sel])
    np.testing.assert_allclose(op.plane_n.numpy()[sel],
                               np.asarray(oj.plane_n)[sel], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(op.occluded.numpy()[sel],
                                  np.asarray(oj.occluded)[sel])
    whit = np.asarray(oj.whit)
    assert whit.any()
    np.testing.assert_array_equal(op.whit.numpy(), whit)
    np.testing.assert_allclose(op.wt.numpy()[whit], np.asarray(oj.wt)[whit],
                               rtol=1e-5)
    assert np.isinf(op.wt.numpy()[~whit]).all()
    np.testing.assert_allclose(op.wnormal.numpy()[whit],
                               np.asarray(oj.wnormal)[whit], atol=1e-5)


def test_3d_wrappers_reject_bad_inputs(resolve_scenes, band_sets):
    """The wrappers check dtype, shape and device; CPU tensors take the
    plain versions, so no launch is counted."""
    gp = resolve_scenes[1].d_grid
    _, _, _, _, sgp, bgp = band_sets["soup"]
    n = 64
    mask = torch.ones(n, dtype=torch.bool)
    row = torch.zeros(n, dtype=torch.int32)
    q = torch.zeros((n, 3))
    with pytest.raises(ValueError):
        R.sweep_resolve_3d(mask, row, q[:, :2].contiguous(), gp.coords,
                           gp.cand)
    with pytest.raises(TypeError):
        KQ.sil_band(row.long(), q, sgp.coords)
    with pytest.raises(ValueError):
        KQ.sil_band(row, q, bgp.coords)          # 9 planes, not 12
    with pytest.raises(ValueError):              # K3's (2P, 6) table
        R.fetch_colors3(mask, row, gp.color_rows[:, :6].contiguous())
    before = [k.launches for k in R.KERNELS + KQ.KERNELS]
    R.sweep_resolve_3d(mask, row, q, gp.coords, gp.cand)
    R.fetch_colors3(mask, row, gp.color_rows)
    KQ.sil_band(row, q, sgp.coords)
    zeros = torch.zeros(n)
    KQ.band_neumann_walk(row, q, zeros + 1, mask, q, zeros,
                         torch.zeros((n, 2)), q, 0.01, bgp.coords)
    assert [k.launches for k in R.KERNELS + KQ.KERNELS] == before
