"""The guided integrator's balanced route in the port (``solver/guided.py``
``TrainLoop``, ``_training_persistent``, ``_guiding_persistent``) against
``elaina_tpu.solver.guided`` and the analytic solution.

- ``guided_depth_step`` with each lane's walk depth and step 0, on the
  12-segment Dirichlet square without a grid and a tiny network carried
  from the JAX package, fed the JAX step's own uniforms (its key splits, as
  ``tests/test_torch_distributions.py`` draws them): depths on both sides
  of the max guided depth (6) and of ``TRAIN_DEPTH_CAP`` (3), some lanes
  fresh.  The live mask and the records' slot counts exactly; the
  contributions, the next positions, throughputs and the records' fields
  to 1e-4; lanes at or past the guided depth take the uniform direction
  and pdf, and only lanes below the cap write a record.
- ``_records_where`` bit-equal to the JAX function.
- The mixed Dirichlet/Neumann square through ``GuidedIntegrator.solve``
  on its default, balanced route (64 of 256 samples train,
  tests/test_guided.py's small network): u = (x + 1) / 2 within 0.07 at
  six points, the loss finite, optimizer steps taken.
- The iterations after a chunk's drain change nothing: the training
  chunk (a pass every 2 iterations) and the guide chunk give bit-equal
  trainers and sums with the host's check every iteration and every
  ``CHECK_EVERY``.
- Route selection follows the JAX package: the default is balanced;
  metric frames, or the uniform ``spp_chunk``, take the per-sample route.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.nn import network as NJ  # noqa: E402
from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu.solver import wost as WJ  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.nn import network as NT  # noqa: E402
from elaina_tpu_torch.solver import balanced as B  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402
from elaina_tpu_torch.solver import integrator as I  # noqa: E402
from elaina_tpu_torch.solver import wost as TW  # noqa: E402
from elaina_tpu_torch.solver.distributions import (  # noqa: E402
    VM_TRIALS, n_dim_output)
from elaina_tpu_torch.utils.rng import (sample_generators,  # noqa: E402
                                        stage_generators)
from tests.test_torch_guide_net import SMALL, _jax_params  # noqa: E402
from tests.test_torch_guided import TINY, _mixed_problem  # noqa: E402

CPU = torch.device("cpu")
EPS = 0.05
MGD = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_uniforms(key, n):
    """The uniforms a Dirichlet-only 2D guided step draws from ``key``:
    (k_sel, k_src, k_neu, k_uni, k_gui, k_walk) = split(key, 6); the
    uniform direction's angle from split(k_uni)[0], the route from k_sel,
    the mixture sample's (component, trials, fallback) from k_gui's
    splits."""
    k_sel, _, _, k_uni, k_gui, _ = jax.random.split(key, 6)
    u_uni = jax.random.uniform(jax.random.split(k_uni)[0], (n,))
    u_route = jax.random.uniform(k_sel, (n,))
    k_s, k_d = jax.random.split(k_gui)
    k_a, k_b = jax.random.split(k_d)
    return {"uniform": [u_uni], "route": [u_route],
            "guide": [jax.random.uniform(k_s, (n,)),
                      jax.random.uniform(k_a, (n, VM_TRIALS, 3)),
                      jax.random.uniform(k_b, (n,))]}


def test_guided_depth_step_per_lane_matches_jax(monkeypatch):
    from tests.test_torch_balanced import _square_scenes

    scene_j, scene_t = _square_scenes()
    spec_j = NJ.make_network(2, n_dim_output(2), TINY)
    spec_t = NT.make_network(2, n_dim_output(2), TINY)
    p = _jax_params(spec_j, 7, table_scale=1.0)
    n = 64
    rng = np.random.default_rng(4)
    pos = rng.uniform(-0.98, 0.98, (n, 2)).astype(np.float32)
    active = rng.random(n) < 0.85
    wstep = rng.integers(0, 12, n).astype(np.int32)
    wstep[:8] = 0
    fresh = active & (wstep == 0)
    rd0 = TW.compute_step0(scene_t, _t(pos), _t(active), EPS)[0].numpy()
    st = dict(pos=pos, thp=np.ones(n, np.float32), active=active,
              on_neumann=np.zeros(n, bool),
              n_normal=np.zeros((n, 2), np.float32))
    key = jax.random.PRNGKey(9)
    st_j, rec_j, c_j = GJ.guided_depth_step(
        scene_j, spec_j, {k: jnp.asarray(v) for k, v in p.items()},
        WJ.WalkState(**{k: jnp.asarray(v) for k, v in st.items()}),
        GJ.init_records(n, 2), key, jnp.asarray(wstep), True, True, 0.5,
        MGD, eps=EPS, d_stack=32, n_stack=32,
        step0=(jnp.asarray(fresh), jnp.asarray(rd0)))

    gens = sample_generators(0, 0, CPU)
    feed = {id(gens[k]): [_t(u) for u in v]
            for k, v in _jax_uniforms(key, n).items()}
    rand = torch.rand

    def fed(*size, generator=None, **kw):
        out = feed[id(generator)].pop(0)
        shape = size[0] if len(size) == 1 else size
        assert tuple(out.shape) == tuple(np.atleast_1d(shape))
        return out

    monkeypatch.setattr(torch, "rand", fed)
    st_t, rec_t, c_t, _ = GT.guided_depth_step(
        scene_t, spec_t, NT.trainer_from_numpy(p).params,
        GT.guide_box(scene_t, CPU),
        TW.WalkState(**{k: _t(v) for k, v in st.items()}),
        GT.init_records(n, 2, CPU), gens, _t(wstep), True, True, 0.5, MGD,
        eps=EPS, step0=(_t(fresh), _t(rd0)))
    monkeypatch.setattr(torch, "rand", rand)
    assert not any(feed.values())

    live = st_t.active.numpy()
    np.testing.assert_array_equal(live, np.asarray(st_j.active))
    assert 0 < live.sum() < active.sum()
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4,
                               atol=1e-4)
    for name in ("pos", "thp"):
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(rec_t.cur.numpy(), np.asarray(rec_j.cur))
    for name in ("pos", "dir", "dir_pdf", "thp", "sol"):
        np.testing.assert_allclose(getattr(rec_t, name).numpy(),
                                   np.asarray(getattr(rec_j, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the per-lane depths: uniform past the guided depth, records below
    # the cap only
    deep = live & (wstep >= MGD)
    shallow = live & (wstep < MGD)
    np.testing.assert_allclose(st_t.thp.numpy()[deep], 1.0, rtol=1e-6)
    assert (np.abs(st_t.thp.numpy()[shallow] - 1.0) > 1e-3).any()
    np.testing.assert_array_equal(rec_t.cur.numpy(),
                                  (live & (wstep < GT.TRAIN_DEPTH_CAP)))
    assert (live & (wstep < GT.TRAIN_DEPTH_CAP)).any() and (
        live & (wstep >= GT.TRAIN_DEPTH_CAP)).any() and deep.any()


def test_records_where_matches_jax():
    from tests.test_torch_guide_net import _records

    a, b = _records(1, N=256), _records(2, N=256)
    mask = np.random.default_rng(3).random(256) < 0.5
    got = GT._records_where(_t(mask),
                            GT.WalkRecords(**{k: _t(v) for k, v in a.items()}),
                            GT.WalkRecords(**{k: _t(v) for k, v in b.items()}))
    want = GJ._records_where(
        jnp.asarray(mask), GJ.WalkRecords(**{k: jnp.asarray(v)
                                             for k, v in a.items()}),
        GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in b.items()}))
    for name in GJ.WalkRecords._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


PTS = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8], [0.2, -0.1],
                [-0.7, 0.3], [0.9, 0.0]], np.float32)


def _guided(spp=256, train=64, **kw):
    settings = IntegratorSettings(frameSize=(len(PTS), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=48,
                                  epsilonShell=0.02, trainSppCount=train,
                                  **kw)
    integ = GT.GuidedIntegrator(_mixed_problem(), settings, "unused",
                                points=_t(PTS))
    integ.reset_network(SMALL)
    return integ


def test_guided_square_on_the_balanced_route():
    integ = _guided()
    integ.prepare()
    integ.solve()
    u = integ.films["SOLUTION"].pixels()[0, :, 0]
    np.testing.assert_allclose(u, (PTS[:, 0] + 1) / 2, atol=0.07)
    assert integ.balance_rounds["train"] and integ.balance_rounds["guide"]
    assert np.isfinite(integ.loss_history).all()
    assert len(integ.loss_history) >= 1 and integ._net_trained
    assert int(integ.trainer.opt.count) > 0
    ps = integ.phase_stats
    assert ps["train_steps"] + ps["guide_steps"] == integ.total_walk_steps


def _drain_run(check_every: int, guide: bool):
    """One training (or guide) chunk of the square over 12 lanes, run past
    its drain; returns its sums, committed counts, counts and trainer."""
    integ = _guided(train=8)
    rd0, in0, c0 = TW.compute_step0(integ.problem.scene, integ.eval_points,
                                    integ.mask, 0.02)
    rem = np.full(len(PTS), 3)
    pix, quota = B.build_balanced_pieces(rem, np.ones(len(PTS)), 12)
    pieces = B.make_pieces(integ.eval_points, rd0, pix, quota)
    loop = GT.TrainLoop(integ, integ.trainer, 12, 2)
    step = (integ._guide_step(integ.trainer.ema_params, 0.5, 10) if guide
            else loop.step)
    out = B.run_chunk(step, integ.problem.scene, None, pieces,
                      max_depth=48, iter_cap=400, round_seed=3,
                      gens=stage_generators(CPU), check_every=check_every,
                      hooks=None if guide else loop)
    return out, loop.trainer


@pytest.mark.parametrize("guide", [False, True])
def test_no_change_after_the_drain(guide):
    (o1, tr1), (o8, tr8) = (_drain_run(c, guide)
                            for c in (1, B.CHECK_EVERY))
    iters = int(o1.iters)
    assert int(o8.iters) == iters and o1.checks == iters
    # the late run went past the drain, through an optimizer pass
    assert o8.checks * B.CHECK_EVERY > iters
    assert any((j + 1) % 2 == 0 for j in range(iters,
                                               o8.checks * B.CHECK_EVERY))
    for f in ("acc", "done", "lsteps", "steps", "resolved", "capped"):
        np.testing.assert_array_equal(getattr(o8, f).numpy(),
                                      getattr(o1, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(o1.done.numpy().sum(), 3 * len(PTS))
    a, b = NT.trainer_to_numpy(tr1), NT.trainer_to_numpy(tr8)
    assert a["count"] == b["count"] and (guide or a["count"] > 0)
    for field in ("params", "ema_params", "mu", "nu"):
        for k in a[field]:
            np.testing.assert_array_equal(a[field][k], b[field][k])


def test_route_selection_follows_jax(monkeypatch):
    """The uniform and the guided solve take the balanced route by
    default, the per-sample route with metric frames (no frame is
    written: saveSppMetricsUntil 0), and the uniform one also with
    ``spp_chunk``."""
    calls = []
    for cls in (I.UniformIntegrator, GT.GuidedIntegrator):
        for route in ("_solve_persistent", "_solve_per_sample"):
            monkeypatch.setattr(cls, route, (lambda r: lambda self, *a: (
                calls.append((type(self).__name__, r)) or 0))(route))
    frames = dict(saveSppMetricsDuration=1, saveSppMetricsUntil=0)
    problem = _mixed_problem()
    for kw, arg, want in (({}, {}, "_solve_persistent"),
                          (frames, {}, "_solve_per_sample"),
                          ({}, {"spp_chunk": 4}, "_solve_per_sample"),
                          ({"saveTimeMetricsDuration": 100}, {},
                           "_solve_per_sample")):
        settings = IntegratorSettings(frameSize=(len(PTS), 1),
                                      samplesPerPixel=2, **kw)
        I.UniformIntegrator(problem, settings, "unused",
                            points=_t(PTS)).solve(**arg)
        assert calls.pop() == ("UniformIntegrator", want)
        if not arg:
            _guided(spp=2, train=1, **kw).solve()
            assert calls.pop() == ("GuidedIntegrator", want)
