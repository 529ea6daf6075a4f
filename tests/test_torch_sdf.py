"""The chain path and the DIRICHLET_SDF channel of the PyTorch port
against the JAX package.

K10 ``grid_band_dma_2d`` and K11 ``grid_band_dma_3d``
(``elaina_tpu/ops/pallas_queries.py``, interpret mode) against the port's
``grid_band_2d`` / ``grid_band_3d``, which take their plain PyTorch
versions on CPU tensors (the CUDA kernels are held against those on the
card by ``chip_smoke.py``); ``grid_row_index`` on random and cell-border
points; the truncated-row fallback; and the DIRICHLET_SDF film of the
shipped quick configs, run as shipped through the port's CLI, against the
JAX package's ``dirichlet_distance`` on the same grid.  Both sides get the
same grid (the JAX build carried over with ``grid_from_numpy``; the port's
build is the reference's, ``tests/test_torch_grid*.py``) and the same
points, made from a seed with numpy.
"""

import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry.grid import (attach_coords,  # noqa: E402
                                      build_candidate_grid)
from elaina_tpu.geometry.grid import \
    grid_cell_index as jax_cell_index  # noqa: E402
from elaina_tpu.geometry.grid import \
    grid_closest_point as jax_closest  # noqa: E402
from elaina_tpu.geometry.grid import \
    grid_row_index as jax_row_index  # noqa: E402
from elaina_tpu.ops.pallas_queries import (grid_band_dma_2d,  # noqa: E402
                                           grid_band_dma_3d)
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.geometry import grid as GT  # noqa: E402
from elaina_tpu_torch.ops import resolve as R  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _lobed(n=400):
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = 3 + np.sin(5 * t)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n],
                   -1).astype(np.int32)
    return verts, idx


def _soup(n_tri=150, seed=21):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (n_tri, 3)).astype(np.float32)
    offs = rng.uniform(-0.5, 0.5, (n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 3)
    return verts, np.arange(3 * n_tri, dtype=np.int32).reshape(-1, 3)


def _port_grid(g, verts, idx):
    """The port's CandidateGrid holding the JAX grid's arrays, with its
    coordinate table."""
    return GT.attach_coords(GT.grid_from_numpy(
        cand=np.asarray(g.cand), meta=[np.asarray(m) for m in g.meta],
        row_lbound=np.asarray(g.row_lbound), row_diag=np.asarray(g.row_diag),
        row_trunc=np.asarray(g.row_trunc), origin=np.asarray(g.origin),
        inv_cell=np.asarray(g.inv_cell), res=g.res, verts=verts, indices=idx,
        colors=np.zeros((len(verts), 2, 3), np.float32), device=CPU))


@pytest.fixture(scope="module")
def grids():
    """Multi-level grids: the lobed curve (K = 12, 2D) and a triangle
    soup (K = 16, 3D), each with the JAX DMA table and the port's grid."""
    out = {}
    for dim, (verts, idx), K, res in ((2, _lobed(), 12, 32),
                                      (3, _soup(), 16, 8)):
        lo = np.full(dim, -5 if dim == 2 else -4, np.float32)
        hi = -lo
        g = attach_coords(build_candidate_grid(verts, idx, lo, hi, K=K,
                                               max_res=res), verts, idx)
        assert len(g.meta) >= 2                    # the chain has levels
        out[dim] = (g, _port_grid(g, verts, idx), verts, idx)
    return out


def _points(g, n, seed):
    """Random points over the grid box and points on level-0 and level-1
    cell borders (where a wrong order of operations lands a point in the
    neighbouring row)."""
    rng = np.random.default_rng(seed)
    dim = len(g.res)
    origin = np.asarray(g.origin, np.float32)
    inv = np.asarray(g.inv_cell, np.float32)
    hi = origin + np.asarray(g.res, np.float32) / inv
    q = rng.uniform(origin, hi, (n, dim)).astype(np.float32)
    cells = rng.integers(0, np.asarray(g.res), (n, dim)).astype(np.float32)
    off = rng.choice(np.float32([0.0, 0.5, 0.25, 0.75]), (n, dim))
    border = (origin + (cells + off) / inv).astype(np.float32)
    return np.concatenate([q, border])


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_row_index_matches_jax(dim, grids):
    g, gp, _, _ = grids[dim]
    q = _points(g, 1500, 3 + dim)
    rj = np.asarray(jax_row_index(g, jnp.asarray(q)))
    rp = GT.grid_row_index(gp, _t(q)).numpy()
    assert len(np.unique(rj)) > 100
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(
        GT.grid_cell_index(gp, _t(q)).numpy(),
        np.asarray(jax_cell_index(g, jnp.asarray(q))))


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_band_matches_pallas(dim, grids):
    """K10 / K11: d^2 within 1e-5, the same slot and corners except at an
    exact tie (two candidates within 1e-6 relative, as a shared vertex or
    edge gives), where the port's winner is one of the tied ones; lanes
    with row < 0 get the port's defined fill."""
    g, gp, _, _ = grids[dim]
    q = _points(g, 600, 11 + dim)
    n = q.shape[0]
    row = np.asarray(jax_row_index(g, jnp.asarray(q))).astype(np.int32)
    row_m = np.where(np.arange(n) % 9 == 0, -1, row).astype(np.int32)
    K = g.cand.shape[1]
    kern = grid_band_dma_2d if dim == 2 else grid_band_dma_3d
    d2j, sj, cj = kern(jnp.asarray(row_m), jnp.asarray(q), g.coords,
                       -(-K // 128), interpret=True)
    d2j, sj = np.asarray(d2j), np.asarray(sj)
    cj = np.stack([np.asarray(c) for c in cj], axis=1)
    band = R.grid_band_2d if dim == 2 else R.grid_band_3d
    d2p, sp, cp = (a.numpy() for a in band(_t(row_m), _t(q), gp.coords))
    m = row_m >= 0
    np.testing.assert_allclose(d2p[m], d2j[m], rtol=1e-5, atol=1e-7)

    planes = gp.coords[_t(row_m[m]).long()].unbind(1)
    dist = R._segment_d2_planes if dim == 2 else R.tri_d2_planes
    all_d2 = dist(tuple(_t(q[m][:, k:k + 1]) for k in range(dim)),
                  planes).numpy()
    two = np.sort(all_d2, axis=1)[:, :2]
    ok = two[:, 1] - two[:, 0] >= 1e-6 * np.maximum(two[:, 1], 1e-30)
    assert ok.mean() > 0.5          # a polyline ties at its vertices
    np.testing.assert_array_equal(sp[m][ok], sj[m][ok])
    np.testing.assert_array_equal(cp[m][ok], cj[m][ok])
    lane = np.arange(ok.shape[0])
    assert (all_d2[lane, sp[m]] <= two[:, 0] * (1 + 1e-6) + 1e-12).all()
    assert np.isinf(d2p[~m]).all() and (sp[~m] == 0).all()
    assert (cp[~m] == 0).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_grid_band_ties_take_smallest_slot(dim):
    """K10 / K11's tie rule: on a grid whose every prim is listed three
    times (the copies at other slots of a row), the JAX kernel and the
    port give the smallest of the tied slots and its corners wherever the
    least d^2 is held only by copies of one prim, which is most lanes."""
    verts, idx = _lobed(200) if dim == 2 else _soup(60, seed=23)
    idx3 = np.concatenate([idx, idx, idx])
    lo = np.full(dim, -5 if dim == 2 else -4, np.float32)
    g = attach_coords(build_candidate_grid(verts, idx3, lo, -lo, K=48,
                                           max_res=16 if dim == 2 else 8),
                      verts, idx3)
    gp = _port_grid(g, verts, idx3)
    q = _points(g, 400, 31 + dim)
    row = np.asarray(jax_row_index(g, jnp.asarray(q))).astype(np.int32)
    kern = grid_band_dma_2d if dim == 2 else grid_band_dma_3d
    d2j, sj, cj = kern(jnp.asarray(row), jnp.asarray(q), g.coords,
                       -(-g.cand.shape[1] // 128), interpret=True)
    sj = np.asarray(sj)
    cj = np.stack([np.asarray(c) for c in cj], axis=1)
    band = R.grid_band_2d if dim == 2 else R.grid_band_3d
    d2p, sp, cp = (a.numpy() for a in band(_t(row), _t(q), gp.coords))
    np.testing.assert_allclose(d2p, np.asarray(d2j), rtol=1e-5, atol=1e-7)

    planes = gp.coords[_t(row).long()]                     # (n, npl, Kp)
    dist = R._segment_d2_planes if dim == 2 else R.tri_d2_planes
    all_d2 = dist(tuple(_t(q[:, k:k + 1]) for k in range(dim)),
                  planes.unbind(1)).numpy()
    least = all_d2.min(axis=1, keepdims=True)
    tied = all_d2 <= least * (1 + 1e-6) + 1e-12            # near-equal too
    first = tied.argmax(axis=1)
    lane = np.arange(len(q))
    same = (planes.numpy() == planes.numpy()[lane, :, first][..., None]
            ).all(axis=1)                    # slots holding that very prim
    pure = (tied <= same).all(axis=1)        # every near tie is a copy
    copies = (tied & same).sum(axis=1)
    assert pure.mean() > 0.5 and (copies[pure] >= 2).mean() > 0.9
    np.testing.assert_array_equal(sp[pure], first[pure])
    np.testing.assert_array_equal(sj[pure], first[pure])
    np.testing.assert_array_equal(cp[pure], cj[pure])
    np.testing.assert_array_equal(
        cp[pure], planes.numpy()[lane, :, first][pure])


def test_trunc_fallback_keeps_lower_bound(monkeypatch):
    """Truncated rows (K = 8, the segment cluster of
    tests/test_grid.py:584 on two levels, the last one truncated) return
    their cell's lower bound, as the JAX chain path does, and every
    distance stays a valid star radius."""
    from elaina_tpu.geometry.primitives import seg_closest_point

    rng = np.random.default_rng(47)
    n_seg = 600
    centers = rng.uniform(-2, 2, (n_seg, 2)).astype(np.float32)
    offs = rng.uniform(-0.15, 0.15, (n_seg, 2, 2)).astype(np.float32)
    verts = (centers[:, None] + offs).reshape(-1, 2)
    idx = np.arange(2 * n_seg, dtype=np.int32).reshape(-1, 2)
    lo, hi = np.full(2, -3, np.float32), np.full(2, 3, np.float32)
    g = attach_coords(build_candidate_grid(verts, idx, lo, hi, K=8,
                                           max_res=16, max_levels=2),
                      verts, idx)
    trunc = np.asarray(g.row_trunc)
    assert trunc.any() and not trunc.all()
    gp = _port_grid(g, verts, idx)
    q = rng.uniform(-2.9, 2.9, (2048, 2)).astype(np.float32)
    monkeypatch.setenv("ELAINA_PALLAS_INTERPRET", "1")
    dj, pj = (np.asarray(a) for a in jax_closest(
        g, jnp.asarray(verts), jnp.asarray(idx), jnp.asarray(q)))
    dp, pp = (a.numpy() for a in GT.grid_closest_point(gp, _t(q)))
    np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=1e-6)
    row = GT.grid_row_index(gp, _t(q)).numpy()
    tr = trunc[row]
    assert tr.sum() > 100
    np.testing.assert_array_equal(dp[tr], np.asarray(g.row_lbound)[row[tr]])
    a, b = verts[idx[:, 0]][None], verts[idx[:, 1]][None]
    d_true = np.asarray(jnp.min(
        seg_closest_point(q[:, None, :], a, b)[0], axis=1))
    assert np.all(dp <= d_true + 1e-4)
    np.testing.assert_allclose(dp[~tr], d_true[~tr], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pp[~tr], pj[~tr])


@pytest.mark.parametrize("name", ["bumpy3d_quick", "neumann3d_quick"])
def test_dirichlet_sdf_film_matches_jax(name, tmp_path, monkeypatch):
    """The shipped quick configs through the port's CLI with their
    channels and exports (SOLUTION and DIRICHLET_SDF; only the data
    paths, base_path and spp changed): the DIRICHLET_SDF film equals the
    JAX package's dirichlet_distance on the same grid within 1e-5, and
    neumann3d's equals the analytic distance to its cube."""
    from elaina_tpu.geometry.native import load_obj_native
    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid
    from elaina_tpu_torch.exec import run_expr
    from elaina_tpu_torch.solver import integrator as I
    from elaina_tpu_torch.utils.scenes import write_config_copy

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(P, "GRID_MAX_RES", 16)
    films = {}
    real_solve = I.UniformIntegrator.solve

    def solve(self):
        films["DIRICHLET_SDF"] = self.films["DIRICHLET_SDF"].pixels()
        return real_solve(self)

    monkeypatch.setattr(I.UniformIntegrator, "solve", solve)
    path = write_config_copy(str(tmp_path), name, 1)
    conf = json.loads(open(path).read())
    assert conf["integrator"]["channels"] == ["SOLUTION", "DIRICHLET_SDF"]
    result = run_expr(path, device="cpu")
    assert result["walk_steps"] > 0
    sdf = films["DIRICHLET_SDF"]
    w, h = conf["integrator"]["setting"]["frameSize"]
    assert sdf.shape == (h, w, 4) and np.isfinite(sdf).all()
    np.testing.assert_array_equal(sdf[..., 0], sdf[..., 2])

    verts, idx = load_obj_native(conf["scene"]["mesh"]["dirichlet_path"], 3)
    scene = conf["scene"]
    lo, hi = P.grid_bounds(verts, scene["aabb"]["min"], scene["aabb"]["max"])
    K, max_res = P.grid_size_for(len(idx))
    assert max_res == 16
    g = build_candidate_grid(verts, idx, lo, hi, K=K, max_res=max_res)
    pts = EvaluationGrid.from_json(scene["evaluation_grid"], 3).points(
        torch.arange(w * h), (w, h)).numpy()
    dj = np.asarray(jax_closest(g, jnp.asarray(verts), jnp.asarray(idx),
                                jnp.asarray(pts))[0])
    np.testing.assert_allclose(sdf[..., 0].reshape(-1), dj, rtol=1e-5,
                               atol=1e-5)
    if name == "neumann3d_quick":
        want = 1.3 - np.maximum(np.abs(pts[:, 0]), np.abs(pts[:, 1]))
        assert np.abs(pts[:, 2]).max() < 1e-6
        np.testing.assert_allclose(sdf[..., 0].reshape(-1), want, atol=1e-5)
