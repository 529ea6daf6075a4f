"""Dirichlet-resolve kernels K1-K3 of the PyTorch port against the Pallas
kernels they replace (``elaina_tpu/ops/pallas_resolve.py``).

Both sides get the same scene (the JAX build, carried over with
``scene_from_numpy``) and the same lanes, made from a seed with numpy.
The Pallas kernels run in interpret mode; on CPU tensors the port's
wrappers take their plain PyTorch versions, which are what the CUDA
kernels are held against on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry.grid import fine_decode as jax_fine_decode  # noqa: E402
from elaina_tpu.ops.pallas_resolve import (compact_lanes,  # noqa: E402
                                           fetch_colors, kprime_for,
                                           pack_groups, sweep_resolve)
from elaina_tpu_torch.core.problem import scene_from_numpy  # noqa: E402
from elaina_tpu_torch.ops import resolve as R  # noqa: E402

EPS = 0.35
CPU = torch.device("cpu")


def port_scene_of(scene_jax, verts, idx):
    """The port's Scene holding exactly the JAX scene's grid and FinePack."""
    g = scene_jax.d_grid
    fp = g.fine
    grid = dict(cand=np.asarray(g.cand), meta=[np.asarray(m) for m in g.meta],
                row_lbound=np.asarray(g.row_lbound),
                row_diag=np.asarray(g.row_diag),
                row_trunc=np.asarray(g.row_trunc),
                origin=np.asarray(g.origin), inv_cell=np.asarray(g.inv_cell),
                res=g.res)
    fine = dict(packed=np.asarray(fp.packed), origin=np.asarray(fp.origin),
                inv_cell=np.asarray(fp.inv_cell), r0=float(fp.r0),
                res=fp.res, s=fp.s, eps=fp.eps)
    colors = np.asarray(scene_jax.dirichlet.colors)
    return scene_from_numpy(aabb_lo=scene_jax.aabb_lo,
                            aabb_hi=scene_jax.aabb_hi, device=CPU,
                            dirichlet=(verts, idx, colors), grid=grid,
                            fine=fine)


@pytest.fixture(scope="module")
def scenes():
    from test_grid import _fast_path_scene

    scene_jax, _, verts, idx = _fast_path_scene(EPS)
    return scene_jax, port_scene_of(scene_jax, verts, idx), {}


def _lanes(n, scene_jax):
    """Query points, candidate rows and the FinePack need mask (the
    kernels' real mask: need bit or out-of-grid on active lanes)."""
    rng = np.random.default_rng(17 + n)
    q = rng.uniform(-5.2, 5.2, (n, 2)).astype(np.float32)
    active = np.arange(n) % 7 != 0
    row, need_f, _, outside = (np.asarray(a) for a in
                               jax_fine_decode(scene_jax.d_grid.fine,
                                               jnp.asarray(q)))
    mask = active & (need_f | outside)
    assert 0 < mask.sum() < n
    return q, row.astype(np.int32), mask


def _jax_sweep(n, scenes):
    """(lanes, Pallas sweep_resolve outputs) at n lanes, computed once."""
    scene_jax, _, memo = scenes
    if n not in memo:
        g = scene_jax.d_grid
        q, row, mask = _lanes(n, scene_jax)
        K = g.cand.shape[1]
        out = tuple(np.asarray(a) for a in sweep_resolve(
            pack_groups(jnp.asarray(mask)), jnp.asarray(row),
            jnp.asarray(q), g.coords, g.cpack, rpp=-(-K // 128),
            kprime=kprime_for(K), interpret=True))
        memo[n] = (q, row, mask), out
    return memo[n]


def _k1_mask(n, case, scene_jax):
    """The mask of a K1 case: the FinePack need mask, or a random one."""
    if case in ("need", "cap1"):
        return _lanes(n, scene_jax)[2]
    if case == "clear":
        return np.zeros(n, bool)
    if case == "set":
        return np.ones(n, bool)
    return np.random.default_rng(n).uniform(size=n) < 0.3     # ragged


# (n, case): the FinePack need mask (ids "1024", "4096"); n off K1's
# 4,096-lane tile (5,000 a multiple of GROUP, 4,097 not); an all-clear and
# an all-set mask; cap = 1
K1_CASES = [pytest.param(1024, "need", id="1024"),
            pytest.param(4096, "need", id="4096"),
            pytest.param(5000, "ragged", id="ragged-5000"),
            pytest.param(4097, "ragged", id="ragged-4097"),
            pytest.param(4096, "clear", id="clear"),
            pytest.param(4096, "set", id="set"),
            pytest.param(1024, "cap1", id="cap1")]


@pytest.mark.parametrize("n,case", K1_CASES)
def test_compact_lanes_matches_pallas(n, case, scenes):
    """K1 against the Pallas compact_lanes (interpret mode) where n is a
    multiple of its GROUP, and against np.flatnonzero always."""
    from elaina_tpu.ops.pallas_resolve import GROUP

    scene_jax, _, _ = scenes
    mask = _k1_mask(n, case, scene_jax)
    cnt_true = int(mask.sum())
    # a cap above the count, and one below it (cnt keeps counting past cap)
    caps = (1,) if case == "cap1" else (n, max(8, cnt_true // 2))
    for cap in caps:
        lp, cp = R.compact_lanes(torch.as_tensor(mask), cap)
        assert lp.dtype == torch.int32 and tuple(lp.shape) == (cap,)
        assert cp.dtype == torch.int32 and tuple(cp.shape) == (1,)
        assert int(cp[0]) == cnt_true
        k = min(cap, cnt_true)
        np.testing.assert_array_equal(lp.numpy()[:k],
                                      np.flatnonzero(mask)[:k])
        if n % GROUP == 0:
            lj, cj = compact_lanes(pack_groups(jnp.asarray(mask)), cap=cap,
                                   interpret=True)
            assert int(cj[0]) == cnt_true
            np.testing.assert_array_equal(lp.numpy()[:k], np.asarray(lj)[:k])


@pytest.mark.parametrize("n", [1024, 4096])
def test_sweep_resolve_matches_pallas(n, scenes):
    scene_jax, scene_port, _ = scenes
    g = scene_jax.d_grid
    gp = scene_port.d_grid
    (q, row, mask), (dj, tj, sj, pj) = _jax_sweep(n, scenes)
    dp, tp, sp, pp = (a.numpy() for a in R.sweep_resolve(
        torch.as_tensor(mask), torch.as_tensor(row), torch.as_tensor(q),
        gp.coords, gp.cand))
    m = mask
    np.testing.assert_allclose(dp[m], dj[m], rtol=1e-5, atol=1e-5)
    # The winner is exact, except where the two best squared distances of
    # the row are within 1e-6 relative: such a tie (typically the shared
    # vertex of two neighbouring segments, t = 1 on one and t = 0 on the
    # other) rounds differently under XLA's contracted multiply-adds, and
    # the two sides may keep different segments.  t, side and pid belong
    # to the winner; d is checked on every lane above.
    verts = np.asarray(scene_jax.dirichlet.gs.verts)
    idx = np.asarray(scene_jax.dirichlet.gs.indices)
    cand = np.asarray(g.cand)[row[m]]
    a, b = verts[idx[np.maximum(cand, 0), 0]], verts[idx[np.maximum(cand, 0), 1]]
    e = b - a
    w = q[m][:, None, :] - a
    t = np.clip(np.sum(w * e, -1) / np.maximum(np.sum(e * e, -1), 1e-30), 0, 1)
    d2 = np.sum((w - t[..., None] * e) ** 2, -1)
    d2 = np.where(cand >= 0, d2, np.inf)
    two = np.sort(d2, axis=1)[:, :2]
    ok = two[:, 1] - two[:, 0] >= 1e-6 * np.maximum(two[:, 1], 1e-30)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(tp[m][ok], tj[m][ok], rtol=1e-5, atol=1e-5)
    big = ok & (np.abs(sj[m]) > 1e-5)
    np.testing.assert_array_equal(np.sign(sp[m][big]), np.sign(sj[m][big]))
    np.testing.assert_array_equal(pp[m][ok], pj[m][ok])
    # at a tie the port's winner is one of the tied candidates, and its t
    # is that candidate's
    slot = np.argmax(cand == pp[m][:, None], axis=1)
    lane = np.arange(slot.shape[0])
    assert (cand[lane, slot] == pp[m]).all()
    assert (d2[lane, slot] <= two[:, 0] * (1 + 1e-6) + 1e-12).all()
    np.testing.assert_allclose(tp[m], t[lane, slot], rtol=1e-5, atol=1e-5)
    assert (pp[m] >= 0).all()
    # unmasked lanes: the port's defined fill
    assert (pp[~m] == -1).all() and (dp[~m] == 0).all()


@pytest.mark.parametrize("n", [1024, 4096])
def test_fetch_colors_matches_pallas(n, scenes):
    scene_jax, scene_port, _ = scenes
    g = scene_jax.d_grid
    (_, _, mask), (d, t, side, pid) = _jax_sweep(n, scenes)
    ins = mask & (d < EPS) & (t > 0.0) & (t < 1.0)
    assert ins.any()
    cfi = np.where(ins, 2 * np.maximum(pid, 0) + (side < 0), 0).astype(
        np.int32)
    c0j, c1j = (np.asarray(a) for a in fetch_colors(
        pack_groups(jnp.asarray(ins)), jnp.asarray(cfi), g.crows,
        interpret=True))
    c0p, c1p = (a.numpy() for a in R.fetch_colors(
        torch.as_tensor(ins), torch.as_tensor(cfi),
        scene_port.d_grid.color_rows))
    np.testing.assert_array_equal(c0p[ins], c0j[ins])
    np.testing.assert_array_equal(c1p[ins], c1j[ins])
    assert (c0p[~ins] == 0).all() and (c1p[~ins] == 0).all()


def test_wrappers_reject_bad_inputs(scenes):
    """The wrappers check dtype, shape and device before any launch."""
    _, scene_port, _ = scenes
    gp = scene_port.d_grid
    n = 64
    mask = torch.ones(n, dtype=torch.bool)
    row = torch.zeros(n, dtype=torch.int32)
    q = torch.zeros((n, 2))
    with pytest.raises(TypeError):
        R.compact_lanes(mask.to(torch.int32), n)
    with pytest.raises(TypeError):
        R.sweep_resolve(mask, row.long(), q, gp.coords, gp.cand)
    with pytest.raises(ValueError):
        R.sweep_resolve(mask, row, q[:, :1].contiguous(), gp.coords, gp.cand)
    with pytest.raises(ValueError):
        R.sweep_resolve(mask, row, q.t().contiguous().t(), gp.coords,
                        gp.cand)
    with pytest.raises(ValueError):
        R.fetch_colors(mask[:-1], row, gp.color_rows)
    # a color table of another row width: K5's (2P, 9)
    with pytest.raises(ValueError):
        R.fetch_colors(mask, row, torch.zeros((gp.color_rows.shape[0], 9)))
    # CPU tensors take the plain versions: no launch is counted
    before = [k.launches for k in R.KERNELS]
    R.compact_lanes(mask, n)
    R.sweep_resolve(mask, row, q, gp.coords, gp.cand)
    R.fetch_colors(mask, row, gp.color_rows)
    assert [k.launches for k in R.KERNELS] == before
