"""The port's time budget (``solver/balanced.BudgetSlicer``,
``solver/guided.budget_train_policy``, ``solve(time_budget_s=...)`` of
both integrators) and the hint cache (``core/problem.Problem``'s
``hint_cache_load`` / ``hint_cache_save``) against ``elaina_tpu``.

- ``BudgetSlicer.plan``, ``update``, ``expired`` and, without a measured
  iteration, ``bound_cap`` equal to the JAX package's on the
  cases of ``tests/test_policy.py`` (no budget, the rateless probe, a rate
  without a cost, proportional quotas, the minimum-dispatch stop at round
  2 and at round 1 with and without a trusted prior, a spent budget), the
  clock frozen by patching ``time.time``, which both read; a simulated
  budgeted run keeps the per-pixel completion even (harmonic / arithmetic
  mean > 0.9) on both sides alike.  The port's own ``bound_cap`` contract:
  the capped round's start window fits the slice, its drain past it;
  its minimum-round stop is JAX's minimum-dispatch stop where no
  iteration was measured.
- ``budget_train_policy`` and its constants equal to the JAX package's.
- Solves of bench.py's square at 16^2 (its 2,048-segment curve, no grid;
  ``tests/test_wost_uniform.py``'s and ``tests/test_guided.py``'s budget
  scene) under a fake clock that advances a fixed time a round (a sample
  on the per-sample route), so that where the budget cuts does not depend
  on the host's speed: a generous budget completes every sample, a tight
  one interrupts, rescales, leaves no pixel without a sample and keeps
  the image mean within the JAX tests' tolerance of the generous run's
  (0.1 of it uniform, 0.15 guided); on the per-sample route the samples
  run equal the first ones of an unbroken run.  The guided training
  phase reaches its spp target under a generous budget, and the skip
  decision (``_train_spp_wall`` patched to 1e9) leaves it untrained.
- The hint file round-trips, a corrupt or truncated file is ignored, its
  key is the JAX package's for a Dirichlet set alone and another file for
  another Neumann set or a source, and a fresh problem on the same scene
  loads a solve's hints and skips the probe round.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu.solver.wost import BudgetSlicer as SlicerJ  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid  # noqa: E402
from elaina_tpu_torch.core.problem import Problem, scene_from_numpy  # noqa: E402
from elaina_tpu_torch.solver import balanced as B  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402
from elaina_tpu_torch.solver import integrator as I  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402

CPU = torch.device("cpu")
T0 = 1.0e6          # the frozen clock's start
NET = {"encoding": {"base_resolution": 4, "n_levels": 2,
                    "n_features_per_level": 2, "per_level_scale": 1.5},
       "network": {"n_neurons": 16, "n_hidden_layers": 1}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    """A fake ``time.time``: stands still until ``tick``."""

    def __init__(self, now: float = T0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def tick(self, dt: float) -> None:
        self.now += dt


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c)
    return c


def _ticking(fn, clock: Clock, dt: float):
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        clock.tick(dt)
        return out

    return run


@pytest.fixture
def per_round(clock, monkeypatch):
    """The clock advances 1 s each balanced round (each ``run_chunk``)."""
    wrapped = _ticking(B.run_chunk, clock, 1.0)
    monkeypatch.setattr(B, "run_chunk", wrapped)
    monkeypatch.setattr(GT, "run_chunk", wrapped)
    return clock


@pytest.fixture
def per_sample(clock, monkeypatch):
    """The clock advances 1 s each per-sample-route sample."""
    monkeypatch.setattr(I, "run_one_sample",
                        _ticking(I.run_one_sample, clock, 1.0))
    monkeypatch.setattr(GT, "run_one_guided_sample",
                        _ticking(GT.run_one_guided_sample, clock, 1.0))
    return clock


# --------------------------------------------------------------------------- #
# BudgetSlicer and budget_train_policy against the JAX package
# --------------------------------------------------------------------------- #


def _slicers(budget, rate0=None, elapsed=0.0):
    return (B.BudgetSlicer(budget, T0 - elapsed, rate0),
            SlicerJ(budget, T0 - elapsed, rate0))


def _same_plan(pair, *args, **kwargs):
    (rem_t, stop_t), (rem_j, stop_j) = (sl.plan(*args, **kwargs)
                                         for sl in pair)
    np.testing.assert_array_equal(rem_t, rem_j)
    assert rem_t.dtype == rem_j.dtype and stop_t == stop_j
    assert pair[0].slice_s == pair[1].slice_s
    return rem_t, stop_t


_RNG = np.random.default_rng(5)
REM = _RNG.integers(5, 60, 256).astype(np.int64)
COST = _RNG.uniform(2, 10, 256)
FULL8 = np.full(8, 50, np.int64)
# (budget, rate0, elapsed, plan's arguments, its keywords, stop expected)
PLAN_CASES = {
    "no_budget": (None, None, 0.0, (REM, COST, 0, 4, True), {}, False),
    "rateless_probe": (10.0, None, 0.0, (REM, COST, 0, 4, False), {},
                       False),
    "rate_without_cost": (10.0, 1000.0, 0.0, (REM, COST, 0, 8, False), {},
                          False),
    "proportional": (10.0, 1000.0, 0.0, (REM, COST, 1, 4, True), {}, False),
    "all_fit": (10.0, 1e9, 0.0, (REM, COST, 1, 4, True), {}, False),
    "stop_round2": (10.0, 100.0, 0.0, (FULL8, np.ones(8), 2, 4, True),
                    dict(n_lanes=1000, floor=64), True),
    "stop_round1_trusted": (10.0, 100.0, 0.0,
                            (FULL8, np.ones(8), 1, 4, True),
                            dict(n_lanes=1000, floor=64), True),
    "spent": (10.0, 1000.0, 10.5, (REM, COST, 3, 4, True), {}, True),
    "spent_round0": (10.0, 1000.0, 10.5, (REM, COST, 0, 4, False), {},
                     False),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_matches_jax(case, clock):
    budget, rate0, elapsed, args, kw, stop = PLAN_CASES[case]
    pair = _slicers(budget, rate0, elapsed)
    rem_round, got_stop = _same_plan(pair, *args, **kw)
    assert got_stop == stop
    if case == "rateless_probe":
        assert rem_round.max() <= 2
    if case == "proportional":
        # the cut branch ran, and every pixel moves
        assert (REM * COST).sum() > 0.5 * 10.0 * 1000.0
        assert (rem_round >= 1).all() and (rem_round < REM).any()


def test_round1_stop_needs_a_trusted_prior(clock):
    """A rate measured on the solve's own round 0 (``update``) does not
    stop round 1; round 2 stops."""
    pair = _slicers(10.0)
    for sl in pair:
        sl.update(1000, 10.0)
    kw = dict(n_lanes=1000, floor=64)
    assert not _same_plan(pair, FULL8, np.ones(8), 1, 4, True, **kw)[1]
    assert _same_plan(pair, FULL8, np.ones(8), 2, 4, True, **kw)[1]


def test_iteration_walls_seeded():
    """``iter0`` seeds the seconds an iteration (the port's hints); a
    width without one takes n_lanes / rate and at least any seeded one."""
    sl = B.BudgetSlicer(10.0, T0, 1e6, {4096: 0.01})
    assert sl.iteration_wall(4096) == 0.01
    assert sl.iteration_wall(1024) == 0.01
    assert sl.iteration_wall(1 << 20) == (1 << 20) / 1e6


def test_update_and_expired_match_jax(clock):
    pair = _slicers(5.0, 2000.0)
    for steps, wall in ((12345, 0.5), (999, 2.0), (0, 1.0), (7, 1e-3)):
        pair[0].update(steps, wall, 10, 4096)
        pair[1].update(steps, wall)
        assert pair[0].rate == pair[1].rate
    # the port's seconds an iteration at its width, an EMA as the rate
    want = None
    for wall in (0.5, 2.0, 1.0, 1e-3):
        want = wall / 10 if want is None else 0.4 * want + 0.6 * wall / 10
    assert pair[0].iter_s == {4096: pytest.approx(want, rel=1e-12)}
    # the rate a later solve starts from (wost.py:1396-1400): the larger
    # of round 0's and the later rounds' together
    assert pair[0].solve_rate() == max(12345 / 0.5,
                                       (999 + 0 + 7) / (2.0 + 1.0 + 1e-3))
    assert B.BudgetSlicer(None, T0).solve_rate() is None
    for dt, expired in ((4.0, False), (1.0, False), (0.5, True)):
        clock.tick(dt)
        assert pair[0].expired() == pair[1].expired() == expired
    assert not B.BudgetSlicer(None, T0).expired()


def test_completion_stays_even_as_jax(clock):
    """tests/test_policy.py's simulated run on both slicers: each round
    spends its planned share of the budget at the slicer's own rate; the
    quotas agree round by round, and the per-pixel completion keeps a
    harmonic / arithmetic mean ratio above 0.9."""
    rate = 1000.0
    pair = _slicers(8.0, rate)
    rng = np.random.default_rng(7)
    rem = rng.integers(16, 64, 512).astype(np.int64)
    goal = rem.copy()
    cost = rng.uniform(1, 12, 512)
    elapsed = 0.0
    for round_i in range(1, 40):
        for sl in pair:
            sl.start = T0 - elapsed
        out, stop = _same_plan(pair, rem, cost, round_i, 4, True)
        if stop or rem.sum() == 0:
            break
        rem = rem - out
        elapsed += float((out * np.maximum(cost, 1.0)).sum()) / rate
        if elapsed >= 8.0:
            break
    done = (goal - rem).astype(np.float64)
    assert rem.sum() > 0 and done.min() > 0
    assert done.size / (1.0 / done).sum() / done.mean() > 0.9


@pytest.mark.parametrize("cap, n_lanes, floor", [
    (10_000, 50, 8), (10_000, 10_000_000, 8), (3, 50, 1), (150, 50, 120),
    (10_000, 7, 64)])
def test_bound_cap_matches_jax(cap, n_lanes, floor, clock):
    """Without a measured iteration the port's bound is the JAX
    package's."""
    pair = _slicers(10.0, 1000.0)
    _same_plan(pair, np.full(4, 1000, np.int64), np.full(4, 100.0), 1, 4,
               True)
    assert (pair[0].bound_cap(cap, n_lanes, floor)
            == pair[1].bound_cap(cap, n_lanes, floor))
    # nothing to bound without a slice
    fresh = _slicers(10.0, 1000.0)
    assert fresh[0].bound_cap(cap, n_lanes, floor) == cap


@pytest.mark.parametrize("measured, host_s", [
    ({}, 0.0), ({4096: 1e-4}, 0.0), ({65536: 5e-3}, 0.3),
    ({262144: 0.2, 4096: 2e-3}, 1.5)])
def test_bound_cap_fits_the_window(measured, host_s, clock):
    """The port's contract, once an iteration was measured: where the
    bound cuts above its floor, the round's start window, the host's part
    before its chunk and its cap at ``iteration_wall`` (the seconds an
    iteration measured at that width; else n_lanes / rate and at least
    any width's), fits the slice, and one iteration more would not; its
    predicted wall overshoots the slice by its drain at most."""
    sl = B.BudgetSlicer(10.0, T0, 1e6)
    sl.iter_s, sl.host_s = dict(measured), host_s
    sl.plan(np.full(64, 1000, np.int64), np.full(64, 50.0), 1, 4, True)
    for n_lanes in (4096, 65536, 262144, 1048576):
        t_it = measured.get(n_lanes, max([n_lanes / sl.rate,
                                          *measured.values()]))
        assert sl.iteration_wall(n_lanes) == t_it
        if not measured:
            t_it, host_s = n_lanes / sl.rate, 0.0    # JAX's, no host part
        cap = sl.bound_cap(10_000, n_lanes, B.CHECK_EVERY)
        window = host_s + cap * t_it
        if cap == B.CHECK_EVERY:
            assert window + t_it > sl.slice_s
            continue
        assert window <= sl.slice_s * (1 + 1e-12)
        if cap < 10_000:
            assert window + t_it > sl.slice_s
        for drain in (40, 72):
            assert window + drain * t_it <= sl.slice_s + drain * t_it


def test_fit_quota(clock):
    """The port's quotas: at most 1.3x what the cap can start (cap x
    lanes steps), proportional, every pixel with samples left keeping at
    least one; plan's where they fit, and without a budget."""
    rng = np.random.default_rng(3)
    rem = rng.integers(0, 40, 4096).astype(np.int64)
    cost = rng.uniform(1, 30, 4096)
    sl = B.BudgetSlicer(10.0, T0, 1e6)
    rem_round, _ = sl.plan(rem, cost, 1, 4, True)
    for cap, lanes in ((8, 4096), (40, 4096), (10_000, 65536)):
        fit = sl.fit_quota(rem, rem_round, cost, cap, lanes)
        assert (fit <= rem_round).all() and (fit[rem > 0] >= 1).all()
        assert (fit[rem == 0] == 0).all()
        total = float((rem * cost).sum())
        if total <= 1.3 * cap * lanes:
            np.testing.assert_array_equal(fit, rem_round)
        else:
            frac = 1.3 * cap * lanes / total
            np.testing.assert_array_equal(
                fit, np.minimum(rem_round, np.ceil(rem * frac)))
    assert B.BudgetSlicer(None, T0).fit_quota(rem, rem, cost, 8,
                                              16) is rem


@pytest.mark.parametrize("elapsed", [0.0, 3.0, 6.0, 9.9])
def test_min_round_stop(elapsed, clock):
    """The port's minimum-round stop: JAX's minimum-dispatch decision
    where no iteration was measured (``iters`` = its floor), at the
    measured seconds an iteration once one was; never at round 0, nor at
    round 1 on the solve's own rate, nor without a budget or a rate."""
    kw = dict(n_lanes=1000, floor=64)
    for rate0, round_i in ((100.0, 1), (100.0, 2), (1e4, 2), (1e4, 1)):
        pair = _slicers(10.0, rate0, elapsed)
        _, stop_j = pair[1].plan(FULL8, np.ones(8), round_i, 4, True, **kw)
        stop_t = pair[0].plan(FULL8, np.ones(8), round_i, 4, True)[1] or \
            pair[0].min_round_stop(round_i, 1000, 64)
        assert stop_t == stop_j
        pair[0].iter_s = {1000: 0.01}
        assert pair[0].min_round_stop(round_i, 1000, 64) == (
            10.0 - elapsed < 0.5 * 64 * 0.01)
    own = B.BudgetSlicer(10.0, T0 - elapsed)
    own.update(10, 1e3)
    assert not own.min_round_stop(1, 1000, 64)
    assert own.min_round_stop(2, 1000, 64)
    assert not own.min_round_stop(0, 1000, 64)
    assert not B.BudgetSlicer(10.0, T0, None).min_round_stop(2, 1000, 64)
    assert not B.BudgetSlicer(None, T0, 1.0).min_round_stop(2, 1000, 64)


def test_train_policy_matches_jax():
    assert (GT.TRAIN_SPP_TARGET, GT.TRAIN_KNEE_SPP, GT.TRAIN_SHARE_DEEP,
            GT.TRAIN_SHARE_SHALLOW) == (GJ.TRAIN_SPP_TARGET,
                                        GJ.TRAIN_KNEE_SPP,
                                        GJ.TRAIN_SHARE_DEEP,
                                        GJ.TRAIN_SHARE_SHALLOW)
    for count in (0, 1, 8, 16, 23, 24, 32, 64, 1000):
        for budget in (0.5, 10.0, 600.0):
            for wall in (None, 0.0, 0.01, 0.99 * 0.15 * budget,
                         1.01 * 0.15 * budget, 0.99 * 0.45 * budget,
                         1.01 * 0.45 * budget, 1e9):
                assert (GT.budget_train_policy(count, budget, wall)
                        == GJ.budget_train_policy(count, budget, wall))


# --------------------------------------------------------------------------- #
# budgeted solves of the bench square
# --------------------------------------------------------------------------- #


def _square(cache_dir=None) -> Problem:
    """bench.py's square at 16^2 (``_build_square_problem``), the port's."""
    verts, idx, colors = S.bench_square_scene()
    problem = Problem(2, CPU, verbose=False)
    problem.probe = EvaluationGrid.from_json(
        {"mData": {"pos": list(S.CENTER), "scale": 250, "up": [-1.0, 0.0]}},
        2)
    problem.scene = scene_from_numpy(
        aabb_lo=[-100, -100], aabb_hi=[600, 600], device=CPU,
        dirichlet=(verts, idx, colors))
    problem.cache_dir = cache_dir
    return problem


def _uniform(spp=16, problem=None, **kw):
    settings = IntegratorSettings(frameSize=(16, 16), samplesPerPixel=spp,
                                  maxWalkingDepth=32, epsilonShell=1.0, **kw)
    return I.UniformIntegrator(problem or _square(), settings, "unused")


def _guided(spp=24, train=8, **kw):
    settings = IntegratorSettings(
        frameSize=(16, 16), samplesPerPixel=spp, maxWalkingDepth=32,
        epsilonShell=1.0, trainSppCount=train,
        uniformFractionInTrainingPhase=0.5,
        uniformFractionInGuidingPhase=0.5,
        maxGuidedDepthInTrainingPhase=6, maxGuidedDepthInGuidingPhase=6,
        **kw)
    integ = GT.GuidedIntegrator(_square(), settings, "unused")
    integ.reset_network(NET)
    return integ


def _image(integ) -> np.ndarray:
    img = integ.films["SOLUTION"].pixels()
    assert np.isfinite(img).all()
    return img


def _unresolved(integ) -> np.ndarray:
    return ~integ._balanced_inputs()[3]


def test_uniform_budget_balanced(per_round):
    """A generous budget completes every sample; one of 1.5 rounds runs
    the probe and one sliced round, rescales, and leaves every pixel a
    sample (the JAX test: within 0.1 of the full image's mean)."""
    full = _uniform()
    full.prepare()
    full.solve(time_budget_s=1e6)
    assert full.done_per_pixel is None and full.spp == 16
    assert full.balance_rounds[0]["probe"]
    ref = _image(full)

    cut = _uniform()
    cut.prepare()
    cut.solve(time_budget_s=1.5)
    rounds = cut.balance_rounds
    assert rounds[0]["probe"] and not rounds[1]["probe"]
    assert len(rounds) in (2, 3)     # 3: the floor round for zero pixels
    done = cut.done_per_pixel
    assert done is not None and done[_unresolved(cut)].min() >= 1
    assert done.sum() < 16 * done.size
    img = _image(cut)
    assert abs(img.mean() - ref.mean()) < 0.1 * abs(ref.mean())
    se = cut.standard_error()
    assert np.isfinite(se).all() and (se[_unresolved(cut)] > 0).any()


def test_uniform_budget_per_sample(per_sample):
    """The per-sample route stops between samples once the budget is
    spent: 2.5 s at 1 s a sample runs 3, and those equal the first 3 of an
    unbroken run bit for bit."""
    cut = _uniform()
    cut.solve(spp_chunk=1, time_budget_s=2.5)
    assert cut.spp == 3
    three = _uniform(spp=3)
    three.solve(spp_chunk=1)
    np.testing.assert_array_equal(cut.sum.numpy(), three.sum.numpy())
    np.testing.assert_array_equal(_image(cut), _image(three))
    full = _uniform(spp=4)
    full.solve(spp_chunk=1, time_budget_s=1e6)
    assert full.spp == 4


def test_guided_budget_balanced(per_round):
    """Under a generous budget the training phase reaches its target,
    min(TRAIN_SPP_TARGET, trainSppCount), trains the guide, and the solve
    completes every sample; under 3.5 rounds the training share (0.15 of
    the budget) cuts training after its probe, guiding gets one sliced
    round, and every pixel keeps a sample (the JAX test: within 0.15 of
    the full image's mean)."""
    full = _guided()
    full.prepare()
    full.solve(time_budget_s=1e6)
    policy = full.train_policy
    assert not policy["skip"] and policy["t_target"] == 8
    assert policy["share_cap"] == GT.TRAIN_SHARE_SHALLOW
    assert full.train_spp_achieved == pytest.approx(8, abs=0.5)
    assert full.phase_stats["train_steps"] > 0 and full._net_trained
    assert full.spp == 24 and full.done_per_pixel is None
    ref = _image(full)

    cut = _guided()
    cut.prepare()
    cut.solve(time_budget_s=3.5)
    train, guide = (cut.balance_rounds[k] for k in ("train", "guide"))
    assert len(train) == 1 and train[0]["probe"]
    assert cut.train_spp_achieved < 8 and guide
    done = cut.done_per_pixel
    assert done is not None and done[_unresolved(cut)].min() >= 1
    img = _image(cut)
    assert abs(img.mean() - ref.mean()) < 0.15 * abs(ref.mean())


def test_guided_budget_skips_training(per_round, monkeypatch):
    """The skip decision: a predicted training wall above its share skips
    the phase; the guide stays untrained and the guiding phase samples
    uniformly."""
    monkeypatch.setattr(GT.GuidedIntegrator, "_train_spp_wall",
                        lambda self, t: 1e9)
    integ = _guided()
    integ.solve(time_budget_s=30.0)
    assert integ.train_policy["skip"]
    assert integ.phase_stats["train_steps"] == 0
    assert not integ._net_trained and int(integ.trainer.opt.count) == 0
    assert integ.balance_rounds["guide"] and integ.spp == 24
    _image(integ)


def test_guided_budget_per_sample(per_sample):
    """With metric frames (none written) the guided solve takes the
    per-sample route and stops between samples: 4.5 s at 1 s a sample
    runs 5, equal bit for bit to an unbroken 5-sample run."""
    frames = dict(saveSppMetricsDuration=1, saveSppMetricsUntil=0)
    cut = _guided(spp=12, **frames)
    cut.solve(time_budget_s=4.5)
    assert cut.spp == 5 and cut.spp_done == 5
    five = _guided(spp=5, **frames)
    five.solve()
    np.testing.assert_array_equal(cut.sum.numpy(), five.sum.numpy())
    np.testing.assert_array_equal(_image(cut), _image(five))
    assert cut.loss_history == five.loss_history


# --------------------------------------------------------------------------- #
# the hint cache
# --------------------------------------------------------------------------- #


def _hinted(tmp_path) -> Problem:
    p = _square(str(tmp_path))
    p._cost_cache = {(256, 1.0, 32): np.linspace(1, 9, 256),
                     (64, 0.01, 64): np.full(64, 3.5)}
    p._rate_cache = {256: 1.5e6, 64: 2.25e5, ("train", 256): 3.0e5,
                     ("iter", 0, 4096): 2.5e-3, ("iter", 2, 256): 0.125}
    return p


def test_hint_cache_round_trip(tmp_path):
    saved = _hinted(tmp_path)
    saved.hint_cache_save()
    assert saved._hint_path().startswith(str(tmp_path))
    loaded = _square(str(tmp_path))
    loaded.hint_cache_load()
    assert loaded._rate_cache == saved._rate_cache
    assert set(loaded._cost_cache) == set(saved._cost_cache)
    for k, v in saved._cost_cache.items():
        np.testing.assert_array_equal(loaded._cost_cache[k],
                                      v.astype(np.float32))
    # an entry this process measured stays
    again = _square(str(tmp_path))
    again._rate_cache = {256: 7.0}
    again.hint_cache_load()
    assert again._rate_cache[256] == 7.0
    # no cache dir: no file
    assert _square()._hint_path() is None


def test_hint_key_is_the_scene(tmp_path):
    """The hint file's key: the JAX package's (sha1 of the first 64
    Dirichlet vertices, their count and the dimension) for a scene with no
    Neumann set and no source; another Neumann set or a source makes
    another file."""
    import hashlib

    from elaina_tpu_torch.core.problem import source_from_numpy

    plain = _square(str(tmp_path))
    verts = S.bench_square_scene()[0].astype(np.float32)
    key = hashlib.sha1(verts[:64].tobytes() + np.int64(
        [verts.shape[0], 2]).tobytes()).hexdigest()[:16]
    assert plain._hint_path() == str(tmp_path / f"hints_{key}.npz")
    paths = {plain._hint_path()}
    for n_box in (4, 64):
        nv = S.neumann_box(n_box)
        ni = np.stack([np.arange(len(nv)), (np.arange(len(nv)) + 1)
                       % len(nv)], -1).astype(np.int32)
        p = _square(str(tmp_path))
        p.scene = scene_from_numpy(
            aabb_lo=[-100, -100], aabb_hi=[600, 600], device=CPU,
            dirichlet=S.bench_square_scene(),
            neumann=(nv, ni, np.zeros((len(nv), 2, 3), np.float32)))
        paths.add(p._hint_path())
    p = _square(str(tmp_path))
    p.scene.source = source_from_numpy(np.ones((4, 4, 3)), [0, 0], [1, 1],
                                       CPU)
    paths.add(p._hint_path())
    assert len(paths) == 4


@pytest.mark.parametrize("damage", ["garbage", "truncated"])
def test_hint_cache_ignores_a_corrupt_file(tmp_path, damage):
    saved = _hinted(tmp_path)
    saved.hint_cache_save()
    path = saved._hint_path()
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(b"not an npz archive" if damage == "garbage"
                else data[:len(data) // 2])
    loaded = _square(str(tmp_path))
    loaded.hint_cache_load()          # must not raise
    assert not loaded.__dict__.get("_cost_cache") or damage == "truncated"


def test_hints_skip_the_probe(tmp_path):
    """A solve saves its cost and rate; a fresh problem on the same scene
    loads them at the integrator's construction and starts balanced."""
    first = _uniform(spp=4, problem=_square(str(tmp_path)))
    first.solve()
    assert first.balance_rounds[0]["probe"]
    fresh = _uniform(spp=4, problem=_square(str(tmp_path)))
    assert fresh.problem._hints_loaded
    assert (256, 1.0, 32) in fresh.problem._cost_cache
    assert fresh.n_pixels in fresh.problem._rate_cache
    walls = fresh._iter_walls(0)
    assert walls and set(walls) <= {r["lanes"] for r in
                                    first.balance_rounds}
    fresh.solve()
    assert not fresh.balance_rounds[0]["probe"]
    _image(fresh)
