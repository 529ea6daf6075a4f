"""The port's balanced persistent solve (``elaina_tpu_torch/solver/
balanced.py``) and the step-0 reuse against ``elaina_tpu.solver.wost``.

- ``build_balanced_pieces`` equal to the JAX package's on seeded
  remainders and costs at several lane counts, also with the budgeted
  rounds' shuffle (two partitions from one generator), with the
  invariants of
  ``tests/test_wost_uniform.py::test_balanced_solve_matches_analytic``;
  ``oversub_lanes`` gives the JAX values on the cases of
  ``test_balanced_solve_lane_oversubscription``.
- ``compute_step0`` and ``_separate`` with ``step0`` (``_fast_dirichlet``
  on test_grid's circle of 300 segments with its FinePack,
  ``_dense_dirichlet`` on the 12-segment square without a grid) against
  the JAX functions: R_D, R_B and the colors to 1e-5, the in-shell and
  need masks exactly, and the fresh lanes out of need with R_D = rd0.
- The chunk's bookkeeping, exactly: the port's ``run_chunk`` and JAX's
  ``make_balanced_chunk(step_fn=...)`` run one deterministic fake step (a
  walk lives a pixel-dependent number of steps, some past the depth cap,
  and adds a pixel-dependent color and its step-0 distance), the host
  checking the loop condition every iteration and every CHECK_EVERY.
  With an iteration cap that lets every walk finish: the same sums,
  ``done``, ``lsteps``, steps and iterations.  With one that finds walks
  in flight: the JAX chunk drops them, the port's runs them to their end
  (samples start only before the cap); on both sides every committed
  sample is one whole walk, and the port commits every one the JAX
  chunk does and more.
- The drop's bias and the drain's lack of it: walks that die with
  probability 1/16 a step and add 1 a step, one sample a lane, cap 12:
  the JAX chunk's committed mean lies below 12 (it keeps the short
  walks), the port's within 4 standard errors of 16.
- ``flush_balanced`` against the JAX one.
- The mixed Dirichlet/Neumann square through the port's
  ``balanced_solve`` (6 points, 256 samples, 512 lanes: ~85 co-lanes a
  pixel) within 0.07 of u = (x + 1) / 2, each pixel completing exactly
  its samples; two solves with one seed bit-equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.geometry import grid as G  # noqa: E402
from elaina_tpu.solver import wost as W  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.solver import balanced as B  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402
from elaina_tpu_torch.utils.rng import stage_generators  # noqa: E402

CPU = torch.device("cpu")
TOL = 1e-5
EPS = 0.35


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_lanes, shuffled", [
    pytest.param(n, sh, id=f"{n}-shuffled" if sh else str(n))
    for sh in (False, True) for n in (1, 7, 64, 300)])
def test_build_balanced_pieces_matches_jax(n_lanes, shuffled):
    """Shuffled: both sides take a generator of the budgeted solve's seed,
    0xE1A, twice in a row (two rounds' partitions)."""
    rng = np.random.default_rng(11 + n_lanes)
    rem = rng.integers(0, 33, 200).astype(np.int64)
    rem[rng.random(200) < 0.2] = 0
    cost = rng.uniform(1, 20, 200)
    gens = [np.random.default_rng(0xE1A) if shuffled else None
            for _ in range(2)]
    for _ in range(1 + shuffled):
        pix, quota = B.build_balanced_pieces(rem, cost, n_lanes, s=4,
                                             shuffle=gens[0])
        pix_j, quota_j = W.build_balanced_pieces(rem, cost, n_lanes, s=4,
                                                 shuffle=gens[1])
        np.testing.assert_array_equal(pix, pix_j)
        np.testing.assert_array_equal(quota, quota_j)
    if shuffled and n_lanes >= 64:
        plain = B.build_balanced_pieces(rem, cost, n_lanes, s=4)[0]
        assert not np.array_equal(pix, plain)
    assigned = np.zeros(200, np.int64)
    np.add.at(assigned, pix.reshape(-1), quota.reshape(-1))
    assert np.all(assigned <= rem)
    if n_lanes >= 64:
        assert assigned.sum() >= 0.8 * rem.sum()
        lane_cost = (quota * cost[pix]).sum(0)
        target = (rem * cost).sum() / n_lanes
        assert lane_cost.max() <= 3.5 * target + cost.max() * 33
    empty = B.build_balanced_pieces(np.zeros(5, np.int64), np.ones(5), 3)
    assert not empty[1].any()


def test_oversub_lanes_matches_jax(monkeypatch):
    monkeypatch.setenv("ELAINA_LANE_TARGET", str(B.LANE_TARGET))
    for n, spp in ((16384, 8), (16384, 2), (262144, 64), (6, 1),
                   (1048576, 32), (65536, 64)):
        assert B.oversub_lanes(n, spp) == W.oversub_lanes(n, spp, 1)
    monkeypatch.setenv("ELAINA_LANE_TARGET", "512")
    assert B.oversub_lanes(6, 256, lane_target=512) == W.oversub_lanes(
        6, 256, 1) == 512


@pytest.fixture(scope="module")
def circle():
    """test_grid's circle of 300 segments with its grid and FinePack (the
    JAX scene, and the port's holding the same tables)."""
    from test_grid import _fast_path_scene
    from test_torch_resolve import port_scene_of

    scene_jax, _, verts, idx = _fast_path_scene(EPS)
    return scene_jax, port_scene_of(scene_jax, verts, idx)


def _square_scenes():
    """The 12-segment Dirichlet square of tests/test_wost_uniform.py (two
    sides, no grid), as the JAX and the port's scene."""
    from tests.test_wost_uniform import (_colors_from_fn, _scene,
                                         _square_boundary)
    from elaina_tpu.core.problem import Boundary
    from elaina_tpu.geometry.geomset import make_geom_set

    dv, di = _square_boundary(n_per_side=6, sides=(1, 3))
    dc = _colors_from_fn(dv, lambda v: (v[0] + 1.0) / 2.0)
    scene_j = _scene(dirichlet=Boundary(gs=make_geom_set(dv, di)[0],
                                        colors=jnp.asarray(dc)))
    scene_t = P.scene_from_numpy(aabb_lo=[-1, -1], aabb_hi=[1, 1],
                                 device=CPU, dirichlet=(dv, di, dc))
    return scene_j, scene_t


def _lanes(seed, n, lim):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-lim, lim, (n, 2)).astype(np.float32)
    active = rng.random(n) < 0.8
    fresh = active & (rng.random(n) < 0.4)
    return q, active, fresh


@pytest.mark.parametrize("route", ["grid", "nogrid"])
def test_step0_matches_jax(route, circle):
    """compute_step0 and one separation with step0 = (fresh, rd0): the
    fresh lanes leave need and take rd0, the rest as without step0.  The
    JAX side runs its FinePack resolve through the chain path (no Pallas
    kernel: the same need bits, the exact distance on the need lanes, the
    cell's bound elsewhere), which the port's K2 path is held to in
    tests/test_torch_resolve_lanes.py."""
    if route == "grid":
        scene_j, scene_t = circle
        eps, lim = EPS, 5.0
    else:
        scene_j, scene_t = _square_scenes()
        eps, lim = 0.05, 1.0
    n = 256
    q, active, fresh = _lanes(3, n, lim)
    mask = np.ones(n, bool)
    mask[::9] = False
    fresh &= mask           # a restart's pixel is never masked
    rd0_j, in0_j, c0_j = (np.asarray(a) for a in W.compute_step0(
        scene_j, jnp.asarray(q), jnp.asarray(mask), eps=eps, d_stack=32))
    rd0_t, in0_t, c0_t = (a.numpy() for a in TW.compute_step0(
        scene_t, torch.as_tensor(q), torch.as_tensor(mask), eps))
    fin = np.isfinite(rd0_j) & mask
    np.testing.assert_allclose(rd0_t[fin], rd0_j[fin], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(in0_t, in0_j)
    assert in0_t.any() and not in0_t.all()
    np.testing.assert_allclose(c0_t, c0_j, rtol=TOL, atol=TOL)

    rd0 = rd0_t.copy()
    st_j = W.init_walk_state(jnp.asarray(q), jnp.asarray(active))
    in_j, rb_j, col_j, rd_j = (np.asarray(a) for a in W._separate(
        scene_j, st_j, eps, 32, shrink=True,
        step0=(jnp.asarray(fresh), jnp.asarray(rd0))))
    st_t = TW.init_walk_state(torch.as_tensor(q), torch.as_tensor(active))
    in_t, rb_t, col_t, rd_t, need_t = (a.numpy() for a in TW._separate(
        scene_t, st_t, eps, True,
        step0=(torch.as_tensor(fresh), torch.as_tensor(rd0))))
    if route == "grid":
        _, need_f, _, outside = (np.asarray(a) for a in G.fine_decode(
            scene_j.d_grid.fine, jnp.asarray(q)))
        need_j = active & (need_f | outside) & ~fresh
    else:
        need_j = active & ~fresh
    np.testing.assert_array_equal(need_t, need_j)
    assert not need_t[fresh].any() and need_t.any()
    np.testing.assert_array_equal(rd_t[fresh], rd0[fresh])
    np.testing.assert_allclose(rd_t[active], rd_j[active], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(rb_t[active], rb_j[active], rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(in_t, in_j)
    assert in_t.any()
    np.testing.assert_allclose(col_t[in_t], col_j[in_t], rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------- #
# the chunk's bookkeeping under a deterministic step
# --------------------------------------------------------------------------- #

MAX_DEPTH = 5
SCALE = np.array([1.0, 2.0, 3.0], np.float32)


def _fake_step_jax(scene, extra, st, key, wstep, step0):
    """A walk at pixel p (pos[:, 0] = p) lives p % 7 + 1 steps, some past
    MAX_DEPTH; each step adds (p + 1) (1, 2, 3) (wstep + 1) / 8, and its
    first the step-0 distance: dyadic values, exact in float32 in any
    order of sums (XLA may contract a product and a sum into one fused
    multiply-add)."""
    fresh, rd0 = step0
    p = st.pos[:, 0]
    w = (wstep + 1).astype(jnp.float32)
    c = (p + 1.0)[:, None] * jnp.asarray(SCALE) * 0.125 * w[:, None]
    c = c + jnp.where(fresh, rd0, 0.0)[:, None]
    c = jnp.where(st.active[:, None], c, 0.0)
    alive = st.active & (w < jnp.mod(p, 7.0) + 1.0)
    return st._replace(active=alive), c


def _fake_step_port(scene, extra, st, gens, wstep, step0):
    fresh, rd0 = step0
    p = st.pos[:, 0]
    w = (wstep + 1).to(torch.float32)
    c = (p + 1.0)[:, None] * torch.as_tensor(SCALE) * 0.125 * w[:, None]
    c = c + torch.where(fresh, rd0, 0.0)[:, None]
    c = torch.where(st.active[:, None], c, 0.0)
    alive = st.active & (w < torch.remainder(p, 7.0) + 1.0)
    st.active = alive
    return st, c, torch.zeros((), dtype=torch.int64)


def _worklists():
    rng = np.random.default_rng(5)
    n_pix, n_lanes = 24, 16
    rem = rng.integers(0, 9, n_pix).astype(np.int64)
    cost = rng.uniform(1, 6, n_pix)
    pix, quota = B.build_balanced_pieces(rem, cost, n_lanes)
    pts = np.stack([np.arange(n_pix), np.zeros(n_pix)], 1).astype(np.float32)
    rd0 = (0.25 * np.arange(n_pix)).astype(np.float32)
    return pts, rd0, pix, quota


@pytest.fixture(scope="module")
def jax_chunk():
    return W.make_balanced_chunk(_fake_step_jax, eps=0.1,
                                 max_depth=MAX_DEPTH)


def _walk_total(p, rd0):
    """One whole walk of the fake step at pixel p."""
    steps = np.minimum(p % 7 + 1, MAX_DEPTH)
    return ((p + 1.0)[:, None] * SCALE * 0.125
            * (steps * (steps + 1) / 2)[:, None] + rd0[:, None])


@pytest.mark.parametrize("check_every", [1, B.CHECK_EVERY])
@pytest.mark.parametrize("iter_cap", [9, 400])
def test_chunk_bookkeeping_matches_jax(iter_cap, check_every, jax_chunk):
    pts, rd0, pix, quota = _worklists()
    acc_j, done_j, lsteps_j, steps_j, iters_j = (np.asarray(a) for a in
                                                 jax_chunk(
        None, None, tuple(jnp.asarray(pts[pix, d]) for d in range(2)),
        jnp.asarray(rd0[pix]), jnp.asarray(quota), jax.random.PRNGKey(0),
        jnp.int32(iter_cap)))
    acc_j = np.transpose(acc_j, (0, 2, 1))
    pieces = B.make_pieces(torch.as_tensor(pts), torch.as_tensor(rd0), pix,
                           quota)
    out = B.run_chunk(_fake_step_port, None, None, pieces,
                      max_depth=MAX_DEPTH, iter_cap=iter_cap, round_seed=1,
                      gens=stage_generators(CPU), check_every=check_every)
    acc, done = out.acc[..., :3].numpy(), out.done.numpy()
    whole = _walk_total(pix.reshape(-1).astype(np.float32),
                        rd0[pix.reshape(-1)]).reshape(acc.shape)
    for a, d in ((acc, done), (acc_j, done_j)):
        # every committed sample is one whole walk
        np.testing.assert_allclose(a, d[..., None] * whole, rtol=1e-6)
    # walks longer than MAX_DEPTH are capped alive
    assert int(out.capped) > 0
    assert (out.acc[..., 3:] >= 0).all()
    if iter_cap == 400:     # every walk finishes within the cap
        np.testing.assert_array_equal(acc, acc_j)
        np.testing.assert_array_equal(done, done_j)
        np.testing.assert_array_equal(out.lsteps.numpy(), lsteps_j)
        assert int(out.steps) == int(steps_j)
        assert int(out.iters) == int(iters_j) < iter_cap
        np.testing.assert_array_equal(done, quota)
        assert out.checks == -(-int(out.iters) // check_every)
    else:                   # walks in flight at the cap
        assert (done >= done_j).all() and done.sum() > done_j.sum()
        assert done.sum() < quota.sum() and int(iters_j) == iter_cap
        assert iter_cap < int(out.iters) <= iter_cap + MAX_DEPTH


def _geometric_jax(scene, extra, st, key, wstep, step0):
    alive = st.active & (jax.random.uniform(key, st.thp.shape) >= 1 / 16)
    c = jnp.where(st.active[:, None], 1.0, 0.0) * jnp.ones((1, 3))
    return st._replace(active=alive), c


def _geometric_port(scene, extra, st, gens, wstep, step0):
    u = torch.rand(st.thp.shape, generator=gens["walk"])
    c = torch.where(st.active[:, None], 1.0, 0.0).expand(-1, 3)
    st.active = st.active & (u >= 1 / 16)
    return st, c, torch.zeros((), dtype=torch.int64)


def test_drain_keeps_long_walks():
    n, cap = 2048, 12
    pix, quota = B.identity_pieces(n, np.ones(n, np.int32))
    pts = np.zeros((n, 2), np.float32)
    rd0 = np.zeros(n, np.float32)
    chunk = W.make_balanced_chunk(_geometric_jax, eps=0.1, max_depth=1000)
    acc_j, done_j, *_ = chunk(
        None, None, tuple(jnp.asarray(pts[pix, d]) for d in range(2)),
        jnp.asarray(rd0[pix]), jnp.asarray(quota), jax.random.PRNGKey(1),
        jnp.int32(cap))
    out = B.run_chunk(_geometric_port, None, None,
                      B.make_pieces(torch.as_tensor(pts),
                                    torch.as_tensor(rd0), pix, quota),
                      max_depth=1000, iter_cap=cap, round_seed=2,
                      gens=stage_generators(CPU))
    mean_j = float(np.asarray(acc_j)[:, 0].sum() / np.asarray(done_j).sum())
    assert np.asarray(done_j).sum() < 0.7 * n and mean_j < cap
    np.testing.assert_array_equal(out.done.numpy(), quota)
    lengths = out.acc[0, :, 0].numpy()
    assert abs(lengths.mean() - 16) < 4 * lengths.std() / np.sqrt(n)


def test_flush_matches_jax():
    rng = np.random.default_rng(8)
    S, M, n = 4, 32, 10
    pix = rng.integers(0, n, (S, M)).astype(np.int32)
    acc = rng.normal(size=(S, M, 6)).astype(np.float32)
    done = rng.integers(0, 5, (S, M)).astype(np.int32)
    image = rng.normal(size=(n, 6)).astype(np.float32)
    img_j, done_j = W.flush_balanced(
        jnp.asarray(image[:, :3]), jnp.asarray(np.transpose(acc[..., :3],
                                                            (0, 2, 1))),
        jnp.asarray(done), pix, n)
    img_t, done_t = B.flush_balanced(torch.as_tensor(image),
                                     torch.as_tensor(acc), torch.as_tensor(
                                         done), torch.as_tensor(pix).long(),
                                     n)
    np.testing.assert_allclose(img_t[:, :3].numpy(), np.asarray(img_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(done_t.numpy(), np.asarray(done_j))


# --------------------------------------------------------------------------- #
# the analytic square
# --------------------------------------------------------------------------- #


def mixed_square(device=CPU):
    """Dirichlet u = (x + 1) / 2 on the left and right sides, zero Neumann
    on the others (6 segments a side, no grid)."""
    from tests.test_wost_uniform import _colors_from_fn, _square_boundary

    dv, di = _square_boundary(n_per_side=6, sides=(1, 3))
    nv, ni = _square_boundary(n_per_side=6, sides=(0, 2))
    return P.scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=device,
        dirichlet=(dv, di, _colors_from_fn(dv, lambda v: (v[0] + 1) / 2)),
        neumann=(nv, ni, np.zeros((len(nv), 2, 3), np.float32)))


SQUARE_PTS = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8], [0.2, -0.1],
                       [-0.7, 0.3], [0.9, 0.0]], np.float32)


def _square_solve(seed: int):
    scene = mixed_square()
    pts = torch.as_tensor(SQUARE_PTS)
    mask = torch.ones(len(pts), dtype=torch.bool)
    rd0, in0, c0 = TW.compute_step0(scene, pts, mask, 0.02)

    def step(scene, extra, st, gens, wstep, step0):
        return TW.wost_depth_step(scene, st, gens, 0.02, step0=step0)

    return B.balanced_solve(step, scene, None, pts, rd0,
                            (in0 | ~mask).numpy(), c0, in0, spp=256,
                            max_depth=64, seed=seed, phase=0,
                            lane_target=512)


def test_balanced_solve_square_oversubscribed():
    out = _square_solve(0)
    np.testing.assert_array_equal(out.done, 256)
    assert out.rounds[0]["lanes"] == len(SQUARE_PTS)      # the probe
    assert max(r["lanes"] for r in out.rounds) == 512
    u = out.image[:, 0].numpy() / 256
    np.testing.assert_allclose(u, (SQUARE_PTS[:, 0] + 1) / 2, atol=0.07)
    assert out.steps > 256 * len(SQUARE_PTS)
    assert out.steps == sum(r["steps"] for r in out.rounds)
    assert (out.image_sq.numpy() >= 0).all()
    again = _square_solve(0)
    np.testing.assert_array_equal(again.image.numpy(), out.image.numpy())
    np.testing.assert_array_equal(again.image_sq.numpy(),
                                  out.image_sq.numpy())
    assert again.steps == out.steps
