"""Candidate grid, FinePack and ``fine_decode`` of the PyTorch port against
``elaina_tpu/geometry/grid.py``.

The port builds the grid with the same native band passes, compiled from
``native/scene_build.cpp``, so the tables must be identical.  The FinePack
is built on the host in the port and by one jitted program in JAX; its
quantized bound goes through ``log2`` on both sides, which may round a
bound at a bucket edge into the neighbouring bucket.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import grid as G  # noqa: E402
from elaina_tpu_torch.geometry import grid as TG  # noqa: E402

CPU = torch.device("cpu")


def _lobed(n, lobes):
    t = np.linspace(0, 2 * math.pi, n, endpoint=False)
    r = 3 + np.sin(lobes * t)
    verts = np.stack([r * np.cos(t), r * np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(n), (np.arange(n) + 1) % n], -1).astype(np.int32)
    return verts, idx


# (n verts, lobes, K, max_res): a one-level grid and a 4+-level refinement
CASES = [(300, 5, 64, 256), (300, 7, 12, 512)]


@pytest.fixture(scope="module", params=CASES, ids=["K64", "K12"])
def grids(request):
    n, lobes, K, max_res = request.param
    verts, idx = _lobed(n, lobes)
    lo, hi = np.array([-5, -5], np.float32), np.array([5, 5], np.float32)
    gj = G.build_candidate_grid(verts, idx, lo, hi, K=K, max_res=max_res)
    ga = TG.build_candidate_grid(verts, idx, lo, hi, K=K, max_res=max_res)
    colors = np.zeros((n, 2, 3), np.float32)
    gp = TG.attach_coords(TG.grid_from_numpy(
        cand=ga.cand, meta=ga.meta, row_lbound=ga.row_lbound,
        row_diag=ga.row_diag, row_trunc=ga.row_trunc, origin=ga.origin,
        inv_cell=ga.inv_cell, res=ga.res, verts=verts, indices=idx,
        colors=colors, device=CPU))
    return gj, ga, gp, verts, idx


def test_build_candidate_grid_matches_jax(grids):
    gj, ga, _, _, _ = grids
    assert ga.res == gj.res
    np.testing.assert_array_equal(ga.cand, np.asarray(gj.cand))
    assert len(ga.meta) == len(gj.meta)
    for mp, mj in zip(ga.meta, gj.meta):
        np.testing.assert_array_equal(mp, np.asarray(mj))
    np.testing.assert_array_equal(ga.row_lbound, np.asarray(gj.row_lbound))
    np.testing.assert_array_equal(ga.row_diag, np.asarray(gj.row_diag))
    np.testing.assert_array_equal(ga.row_trunc, np.asarray(gj.row_trunc))
    np.testing.assert_array_equal(ga.origin, np.asarray(gj.origin))
    np.testing.assert_array_equal(ga.inv_cell, np.asarray(gj.inv_cell))


def test_build_candidate_grid_disk_cache(tmp_path):
    """A second build with the same inputs reads the cache file, under the
    reference's key and name, and returns the same tables."""
    verts, idx = _lobed(200, 3)
    lo, hi = np.array([-5, -5], np.float32), np.array([5, 5], np.float32)
    a = TG.build_candidate_grid(verts, idx, lo, hi, K=32, max_res=128,
                                cache_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("candgrid_")
    b = TG.build_candidate_grid(verts, idx, lo, hi, K=32, max_res=128,
                                cache_dir=str(tmp_path))
    np.testing.assert_array_equal(a.cand, b.cand)
    np.testing.assert_array_equal(a.row_lbound, b.row_lbound)
    for ma, mb in zip(a.meta, b.meta):
        np.testing.assert_array_equal(ma, mb)
    # the reference reads the port's cache file as its own
    gj = G.build_candidate_grid(verts, idx, lo, hi, K=32, max_res=128,
                                cache_dir=str(tmp_path))
    np.testing.assert_array_equal(np.asarray(gj.cand), a.cand)


@pytest.mark.parametrize("eps", [0.35, 0.05])
def test_fine_pack_matches_jax(grids, eps):
    gj, ga, gp, _, _ = grids
    fj = G.build_fine_pack(gj, eps)
    fp = TG.build_fine_pack(gp, eps)
    assert fp.res == fj.res and fp.eps == eps
    np.testing.assert_allclose(fp.r0, float(fj.r0), rtol=0)
    pj = np.asarray(fj.packed)
    pp = fp.packed.numpy()
    assert pp.shape == pj.shape
    np.testing.assert_array_equal(pp < 0, pj < 0)                 # need
    np.testing.assert_array_equal(pp & TG.FINE_ROW_MASK,
                                  pj & TG.FINE_ROW_MASK)          # row
    bp = (pp & 0x7FFFFFFF) >> 20
    bj = (pj & 0x7FFFFFFF) >> 20
    off = np.abs(bp - bj)
    assert off.max() <= 1
    assert (off > 0).mean() < 1e-3
    # the port's decoded bound stays a valid lower bound of its row
    rows = pp & TG.FINE_ROW_MASK
    rl_dec = np.where(bp == 0, 0.0, fp.r0 * np.exp2((bp - 1.0) / fp.s)
                      * (1.0 - 1.9e-6)).astype(np.float32)
    assert np.all(rl_dec <= ga.row_lbound[rows])


@pytest.mark.parametrize("eps", [0.35])
def test_fine_decode_matches_jax(grids, eps):
    gj, _, gp, _, _ = grids
    fj = G.build_fine_pack(gj, eps)
    # decode the same table on both sides
    fp = TG.fine_pack_from_numpy(
        packed=np.asarray(fj.packed), origin=np.asarray(fj.origin),
        inv_cell=np.asarray(fj.inv_cell), r0=float(fj.r0), res=fj.res,
        s=fj.s, eps=fj.eps, device=CPU)
    q = np.random.default_rng(7).uniform(-5.3, 5.3, (4000, 2)).astype(
        np.float32)
    rj, nj, lj, oj = (np.asarray(a) for a in G.fine_decode(fj,
                                                          jnp.asarray(q)))
    rp, n_p, lp, op = (a.numpy() for a in TG.fine_decode(fp,
                                                         torch.as_tensor(q)))
    assert op.any() and not op.all()
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(n_p, nj)
    np.testing.assert_array_equal(op, oj)
    np.testing.assert_allclose(lp, lj, rtol=1e-6, atol=0)


def test_device_tables_layout(grids):
    """The coordinate planes and color rows hold the right vertices."""
    _, ga, gp, verts, idx = grids
    R, K = ga.cand.shape
    Kp = gp.coords.shape[2]
    assert gp.coords.shape == (R, 4, Kp) and Kp % TG.WARP == 0 and Kp >= K
    c = ga.cand
    valid = c >= 0
    cs = np.maximum(c, 0)
    co = gp.coords.numpy()
    for plane, (k, d) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        want = np.where(valid, verts[idx[cs, k], d], TG.PAD_COORD)
        np.testing.assert_array_equal(co[:, plane, :K], want)
    assert (co[:, :, K:] == TG.PAD_COORD).all()
    colors = np.random.default_rng(3).uniform(0, 1, (len(verts), 2, 3))
    rows = TG.color_rows_from(torch.as_tensor(colors, dtype=torch.float32),
                              torch.as_tensor(idx, dtype=torch.int64)).numpy()
    assert rows.shape == (2 * len(idx), 6)
    for side in (0, 1):
        np.testing.assert_allclose(rows[side::2, :3], colors[idx[:, 0], side],
                                   rtol=1e-6)
        np.testing.assert_allclose(rows[side::2, 3:], colors[idx[:, 1], side],
                                   rtol=1e-6)
