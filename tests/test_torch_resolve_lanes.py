"""K2 and K4 in their lane-list form: the port's ``_fast_dirichlet``, which
hands the N-wide need mask, rows and points straight to ``sweep_resolve``
/ ``sweep_resolve_3d`` (the wrapper lists the need lanes with K1 and the
sweep writes by lane id), against ``elaina_tpu.solver.wost.
_fast_dirichlet`` (Pallas in interpret mode), in 2D and 3D, on a
scattered, an empty and a full need mask; and the sweeps as it calls them
(the N-wide mask) against the Pallas sweeps on those masks and on a
single lane at N - 1.

On CPU tensors the wrappers take their plain PyTorch versions, which the
CUDA kernels are held to on the card (``chip_smoke.py`` phases 2 and 5):
the lane list, its order and the kernels' off-list writes are checked
only there.  Inputs are made with numpy from a seed.  R_D and the sweeps'
distances agree with the JAX package to 1e-5 (rtol and atol: XLA
contracts products and sums into fused multiply-adds, which the port's
plain versions do not); the need mask exactly; the in-shell mask, the
winners' ids and corners exactly and the colors and t to 1e-5 on every
lane whose two nearest prims are not tied within 1e-6 relative (there the
contraction may keep the other prim); the lanes off the mask exactly the
port's 0 / -1 fill.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from elaina_tpu.solver import wost as W  # noqa: E402
from elaina_tpu_torch.geometry.grid import fine_decode  # noqa: E402
from elaina_tpu_torch.ops import resolve as R  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402

N = 1024
TOL = 1e-5
EPS = {2: 0.35, 3: 0.3}
MASKS = ("scattered", "empty", "full")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU ops gain nothing
    from more, and in a parallel test run the OpenMP pool's waits stall
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """dim -> (the JAX fast-path scene, the port's scene holding the same
    grid and FinePack, verts, idx): test_grid's circle of 300 segments and
    its soup of 120 triangles, K = 64."""
    from test_grid import _fast_path_scene, _fast_path_scene_3d
    from test_torch_resolve import port_scene_of

    out = {}
    for dim, make in ((2, _fast_path_scene), (3, _fast_path_scene_3d)):
        scene_jax, _, verts, idx = make(EPS[dim])
        out[dim] = (scene_jax, port_scene_of(scene_jax, verts, idx), verts,
                    idx)
    return out


def _lanes(dim, kind, verts, idx):
    """(q (N, dim), active (N,)) of a mask kind: ``scattered``, uniform
    points in the grid's box with ~70% of the lanes active; ``empty``, the
    same points with none active; ``full``, every lane active at a point
    within eps / 2 of a random prim (so every need bit fires)."""
    rng = np.random.default_rng(41 + 3 * dim + MASKS.index(kind))
    if kind == "full":
        prim = rng.integers(0, idx.shape[0], N)
        u = rng.uniform(0, 1, (N, dim - 1))
        if dim == 3:   # a uniform point of the triangle
            flip = u.sum(1) > 1
            u[flip] = 1 - u[flip]
        corners = verts[idx[prim]]                       # (N, dim, dim)
        p = corners[:, 0] + sum(u[:, k:k + 1] * (corners[:, k + 1]
                                                 - corners[:, 0])
                                for k in range(dim - 1))
        off = rng.normal(size=(N, dim))
        off *= (rng.uniform(0, 0.5 * EPS[dim], N)
                / np.linalg.norm(off, axis=1))[:, None]
        return (p + off).astype(np.float32), np.ones(N, bool)
    lim = 5.0 if dim == 2 else 4.4
    q = rng.uniform(-lim, lim, (N, dim)).astype(np.float32)
    if kind == "empty":
        return q, np.zeros(N, bool)
    return q, rng.uniform(0, 1, N) < 0.7


def _untied(q, verts, idx, dim):
    """Lanes whose two nearest prims of the whole set are not tied within
    1e-6 relative in d^2 (the port's plain distance functions)."""
    c = verts[idx]                                       # (P, dim, dim)
    # (N, P) planes, corner-major: ax ay [az] bx by ...
    planes = tuple(torch.as_tensor(np.ascontiguousarray(
        np.broadcast_to(c[None, :, k, d], (q.shape[0], c.shape[0]))))
        for k in range(dim) for d in range(dim))
    qc = tuple(torch.as_tensor(q[:, d:d + 1]) for d in range(dim))
    if dim == 2:
        ax, ay, bx, by = planes
        d2 = R.seg_d2(qc[0] - ax, qc[1] - ay, bx - ax, by - ay)[0]
    else:
        d2 = R.tri_d2_planes(qc, planes)
    two = np.sort(d2.numpy(), axis=1)[:, :2]
    return two[:, 1] - two[:, 0] >= 1e-6 * np.maximum(two[:, 1], 1e-30)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("dim", [2, 3])
def test_fast_dirichlet_matches_jax(dim, kind, scenes):
    scene_jax, scene_port, verts, idx = scenes[dim]
    eps = EPS[dim]
    q, act = _lanes(dim, kind, verts, idx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELAINA_PALLAS_INTERPRET", "1")
        assert W.fast_dirichlet_available(scene_jax, eps)
        RD_j, in_j, col_j, need_j = (np.asarray(a) for a in W._fast_dirichlet(
            scene_jax, jnp.asarray(q), jnp.asarray(act), eps))
    RD_p, in_p, col_p, need_p = (a.numpy() for a in TW._fast_dirichlet(
        scene_port, torch.as_tensor(q), torch.as_tensor(act), eps))

    np.testing.assert_array_equal(need_p, need_j)
    if kind == "empty":
        assert not need_p.any()
    elif kind == "full":
        assert need_p.all()
    else:
        assert 0 < need_p.sum() < act.sum()
    np.testing.assert_allclose(RD_p, RD_j, rtol=TOL, atol=TOL)
    ok = _untied(q, verts, idx, dim)
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(in_p[ok], in_j[ok])
    both = ok & in_p
    if kind != "empty":
        assert both.sum() > (0.2 * N if kind == "full" else 0)
    np.testing.assert_allclose(col_p[both], col_j[both], rtol=TOL, atol=TOL)
    assert (col_p[~in_p] == 0).all() and not (in_p & ~need_p).any()
    # lanes off the need mask keep the FinePack's lower bound
    rl = fine_decode(scene_port.d_grid.fine, torch.as_tensor(q))[2].numpy()
    np.testing.assert_array_equal(RD_p[~need_p], rl[~need_p])


def _sweep_inputs(dim, kind, scenes):
    """(mask, row, q) for the sweeps: the need mask of a kind, or only
    lane N - 1 set (``last``), with the port's FinePack rows."""
    _, scene_port, verts, idx = scenes[dim]
    q, act = _lanes(dim, "full" if kind == "last" else kind, verts, idx)
    q = torch.as_tensor(q)
    row, need_f, _, outside = fine_decode(scene_port.d_grid.fine, q)
    mask = torch.as_tensor(act) & (need_f | outside)
    if kind == "last":
        mask = torch.zeros(N, dtype=torch.bool)
        mask[-1] = True
    return mask, row, q


def _row_d2(dim, q, cand, verts, idx):
    """(n, K) squared distances from each point to its row's candidates
    (the port's plain distance functions), +inf on empty slots."""
    c = verts[idx[np.maximum(cand, 0)]]                  # (n, K, dim, dim)
    planes = tuple(torch.as_tensor(np.ascontiguousarray(c[..., k, d]))
                   for k in range(dim) for d in range(dim))
    qc = tuple(torch.as_tensor(q[:, d:d + 1]) for d in range(dim))
    if dim == 2:
        ax, ay, bx, by = planes
        d2 = R.seg_d2(qc[0] - ax, qc[1] - ay, bx - ax, by - ay)[0]
    else:
        d2 = R.tri_d2_planes(qc, planes)
    return np.where(cand >= 0, d2.numpy(), np.inf)


@pytest.mark.parametrize("kind", MASKS + ("last",))
@pytest.mark.parametrize("dim", [2, 3])
def test_sweep_matches_pallas_on_masks(dim, kind, scenes):
    """K2 / K4 as ``_fast_dirichlet`` calls them (the N-wide need mask,
    rows and points) against the Pallas sweeps (interpret mode) on the
    same mask: distances to 1e-5 on every listed lane; ids (and K4's
    corners, K2's t to 1e-5 and side's sign) exact where the row's two
    best are not tied within 1e-6 relative; the lanes off the mask exactly
    the plain contract's 0 / -1 / zero corners."""
    from elaina_tpu.ops.pallas_resolve import (kprime_for, pack_groups,
                                               sweep_resolve,
                                               sweep_resolve_3d)

    scene_jax, scene_port, verts, idx = scenes[dim]
    gj, gp = scene_jax.d_grid, scene_port.d_grid
    mask, row, q = _sweep_inputs(dim, kind, scenes)
    m = mask.numpy()
    assert m.sum() == {"empty": 0, "last": 1, "full": N}.get(kind, m.sum())
    K = gj.cand.shape[1]
    jax_sweep = sweep_resolve if dim == 2 else sweep_resolve_3d
    out_j = jax_sweep(pack_groups(jnp.asarray(m)), jnp.asarray(row.numpy()),
                      jnp.asarray(q.numpy()), gj.coords, gj.cpack,
                      rpp=-(-K // 128), kprime=kprime_for(K), interpret=True)
    port = R.sweep_resolve if dim == 2 else R.sweep_resolve_3d
    out_p = [a.numpy() for a in port(mask, row, q, gp.coords, gp.cand)]
    if dim == 2:
        dj, tj, sj, pj = (np.asarray(a) for a in out_j)
        dp, tp, sp, pp = out_p
    else:
        dj, pj = np.asarray(out_j[0]), np.asarray(out_j[1])
        cj = np.concatenate([np.asarray(c) for c in out_j[2]], axis=1)
        dp, pp, cp = out_p

    np.testing.assert_allclose(dp[m], dj[m], rtol=TOL, atol=TOL)
    cand = np.asarray(gp.cand)[row.numpy()[m]]
    two = np.sort(_row_d2(dim, q.numpy()[m], cand, verts, idx), axis=1)
    two = two[:, :2]
    ok = two[:, 1] - two[:, 0] >= 1e-6 * np.maximum(two[:, 1], 1e-30)
    if m.any():
        assert ok.mean() > 0.5
    np.testing.assert_array_equal(pp[m][ok], pj[m][ok])
    assert (pp[m] >= 0).all()
    if dim == 2:
        np.testing.assert_allclose(tp[m][ok], tj[m][ok], rtol=TOL, atol=TOL)
        big = ok & (np.abs(sj[m]) > TOL)
        np.testing.assert_array_equal(np.sign(sp[m][big]),
                                      np.sign(sj[m][big]))
        assert (tp[~m] == 0).all() and (sp[~m] == 0).all()
    else:
        np.testing.assert_array_equal(cp[m][ok], cj[m][ok])
        assert (cp[~m] == 0).all()
    assert (dp[~m] == 0).all() and (pp[~m] == -1).all()
