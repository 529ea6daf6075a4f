"""The PyTorch port's guided integrator (``elaina_tpu_torch/solver/
guided.py``) against ``elaina_tpu.solver.guided`` and the analytic
solution.

- ``_backfill`` and ``_increment`` on seeded records, state and masks:
  bit-equal to the JAX functions.
- ``train_on_records`` on the same numpy records and initial weights,
  two batches: the step count equal, the metric to 1e-4 relative, and
  99% of each leaf's parameters within 2e-4 of JAX's (its EMA within
  2e-5).  The two sides' gradients differ by the MLP's bf16 boundary
  flips (``tests/test_torch_guide_net.py``), and Adam's normalized step
  (about lr = 8e-3 whatever the gradient's size) turns a gradient whose
  two batches nearly cancel into a step set by that difference, up to
  2 lr apart: the parameters' largest gap is as large as two steps can
  make it, and bounds nothing.  The Adam moments carry the gradients unnormalized: every entry of ``mu``
  and ``nu`` lies within 0.07 of its leaf's largest magnitude in JAX,
  twice the worst gap (0.033) over records seeds 0-7 with init keys 7
  and 42, so a fault in a few entries' gradients still fails.
- ``tests/test_guided.py``'s checks in the port: the mixed-BC square with
  online training then guiding, u = (x + 1) / 2 within 0.08; the
  training-pixel stride (records only on the selected lanes, the same
  contributions); the untrained-net fallback of ``_phase`` (and
  ``query_network`` after a solve).
- ``run_expr(..., device="cpu")`` on a small lobed_n: ``result.json``
  holds ``loss_history``, ``phase_stats`` and ``walk_steps``, and the
  guided SOLUTION film agrees with the uniform film of the same scene
  within 4 combined standard errors on >= 99% of pixel channels.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from elaina_tpu.nn import network as NJ  # noqa: E402
from elaina_tpu.solver import guided as GJ  # noqa: E402
from elaina_tpu.solver.wost import WalkState as WalkStateJ  # noqa: E402
from elaina_tpu_torch.core import problem as P  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.nn import network as NT  # noqa: E402
from elaina_tpu_torch.solver import guided as GT  # noqa: E402
from elaina_tpu_torch.solver.distributions import n_dim_output  # noqa: E402
from elaina_tpu_torch.solver.wost import WalkState  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402
from elaina_tpu_torch.utils.rng import sample_generators  # noqa: E402
from tests.test_torch_guide_net import SMALL, _records  # noqa: E402

CPU = torch.device("cpu")
TINY = {"encoding": {"base_resolution": 4, "n_levels": 2,
                     "n_features_per_level": 2, "per_level_scale": 1.5},
        "network": {"n_neurons": 16, "n_hidden_layers": 1}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _state(seed: int, n: int):
    rng = np.random.default_rng(seed)
    nth = rng.uniform(-np.pi, np.pi, n)
    return dict(pos=rng.uniform(-1, 1, (n, 2)).astype(np.float32),
                thp=rng.uniform(0.5, 2, n).astype(np.float32),
                active=rng.random(n) < 0.8,
                on_neumann=rng.random(n) < 0.3,
                n_normal=np.stack([np.cos(nth), np.sin(nth)],
                                  -1).astype(np.float32))


def test_backfill_and_increment_match_jax():
    rec = _records(10, N=512)
    st = _state(11, 512)
    rng = np.random.default_rng(12)
    contrib = rng.normal(size=(512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 2)).astype(np.float32)
    pdf = rng.uniform(0.1, 1, 512).astype(np.float32)
    mask = rng.random(512) < 0.6
    rj = GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in rec.items()})
    rt = GT.WalkRecords(**{k: _t(v) for k, v in rec.items()})
    sj = WalkStateJ(**{k: jnp.asarray(v) for k, v in st.items()})
    stt = WalkState(**{k: _t(v) for k, v in st.items()})
    outs = []
    for inclusive in (False, True):
        outs.append((GJ._backfill(rj, jnp.asarray(contrib), inclusive),
                     GT._backfill(rt, _t(contrib), inclusive)))
    outs.append((GJ._increment(rj, sj, jnp.asarray(d), jnp.asarray(pdf),
                               jnp.asarray(mask)),
                 GT._increment(rt, stt, _t(d), _t(pdf), _t(mask))))
    for a, b in outs:
        for name in GJ.WalkRecords._fields:
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)),
                                          err_msg=name)
    inc = outs[2][1]
    assert (inc.cur.numpy() > rec["cur"]).any() and (
        inc.cur.numpy() <= GT.MAX_TRAIN_DEPTH).all()


def test_normalize_coord_in_unit_box():
    lo, hi = _t([-100.0, -100.0]), _t([600.0, 600.0])
    p = _t([[-100.0, -100.0], [600.0, 600.0], [250.0, 250.0]])
    x = GT.normalize_coord(p, lo, hi)
    assert float(x.min()) > 0.0 and float(x.max()) < 1.0
    np.testing.assert_allclose(x[2].numpy(), 0.5, atol=1e-6)
    want = np.asarray(GJ.normalize_coord(jnp.asarray(p.numpy()),
                                         jnp.asarray(lo.numpy()),
                                         jnp.asarray(hi.numpy())))
    # XLA contracts the map into fused multiply-adds: float32 rounding
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-6, atol=1e-7)


class _BoxScene:
    """What the JAX package's ``train_on_records`` reads of a scene."""

    dim = 2
    aabb_lo = jnp.asarray([-1.0, -1.0])
    aabb_hi = jnp.asarray([1.0, 1.0])


def test_train_on_records_matches_jax():
    spec_j = NJ.make_network(2, 33, SMALL)
    spec_t = NT.make_network(2, 33, SMALL)
    tr_j = NJ.init_trainer(jax.random.PRNGKey(42), spec_j)
    p0 = {k: np.asarray(v) for k, v in tr_j.params.items()}
    rec = _records(5)
    tr_j2, m_j = GJ.train_on_records(
        tr_j, spec_j, NJ.AdamConfig(), _BoxScene(),
        GJ.WalkRecords(**{k: jnp.asarray(v) for k, v in rec.items()}),
        batch_size=4096, n_batches=2)
    box = GT.GuideBox(_t([-1.0, -1.0]), _t([1.0, 1.0]))
    tr_t2, m_t = GT.train_on_records(
        NT.trainer_from_numpy(p0), spec_t, NT.AdamConfig(), box,
        GT.WalkRecords(**{k: _t(v) for k, v in rec.items()}),
        batch_size=4096, n_batches=2)
    got = NT.trainer_to_numpy(tr_t2)
    assert got["count"] == int(tr_j2.opt.count) == 2
    assert float(m_t) == pytest.approx(float(m_j), rel=1e-4)
    for k in p0:
        moved = np.abs(np.asarray(tr_j2.params[k]) - p0[k]).max()
        assert moved > 1e-3, k
        for field, tree, tol in (("params", tr_j2.params, 2e-4),
                                 ("ema_params", tr_j2.ema_params, 2e-5)):
            diff = np.abs(got[field][k] - np.asarray(tree[k]))
            assert np.mean(diff <= tol) >= 0.99, (field, k)
        for field, tree in (("mu", tr_j2.opt.mu), ("nu", tr_j2.opt.nu)):
            want = np.asarray(tree[k])
            gap = np.abs(got[field][k] - want).max() / np.abs(want).max()
            assert gap <= 0.07, (field, k, gap)


def _mixed_problem():
    """tests/test_guided.py's mixed-BC square: Dirichlet u = (x + 1) / 2 on
    the left and right sides, zero Neumann on the others (6 segments a
    side, no candidate grid)."""
    from tests.test_wost_uniform import _colors_from_fn, _square_boundary

    dv, di = _square_boundary(n_per_side=6, sides=(1, 3))
    nv, ni = _square_boundary(n_per_side=6, sides=(0, 2))
    problem = P.Problem(2, CPU, verbose=False)
    problem.scene = P.scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=CPU,
        dirichlet=(dv, di, _colors_from_fn(dv, lambda v: (v[0] + 1) / 2)),
        neumann=(nv, ni, np.zeros((len(nv), 2, 3), np.float32)))
    return problem


def test_guided_matches_analytic_with_online_training():
    """tests/test_guided.py:35 in the port: 64 training samples (each
    followed by one optimizer step on its records) then 192 guided ones
    stay unbiased: u = (x + 1) / 2 at three points within 0.08."""
    problem = _mixed_problem()
    scene = problem.scene
    spec = NT.make_network(2, n_dim_output(2), SMALL)
    trainer = NT.init_trainer(spec, CPU)
    box = GT.guide_box(scene, CPU)
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8]], np.float32)
    total = torch.zeros((3, 3))
    losses = []
    for s in range(256):
        training = s < 64
        contrib, records, _, _, _ = GT.run_one_guided_sample(
            scene, spec, trainer.ema_params, box, _t(pts),
            torch.ones(3, dtype=torch.bool), sample_generators(3, s, CPU),
            True, training, 0.5, 10, eps=0.02, max_depth=48)
        total += contrib
        if training:
            trainer, metric = GT.train_on_records(
                trainer, spec, NT.AdamConfig(), box, records, batch_size=16,
                n_batches=1)
            losses.append(float(metric))
    u = (total / 256).numpy()
    np.testing.assert_allclose(u[:, 0], (pts[:, 0] + 1.0) / 2.0, atol=0.08)
    assert np.isfinite(losses).all() and int(trainer.opt.count) > 0


def test_train_pixel_stride_masks_records():
    """isTrainingPixel (guided.h:101-109): with stride 3 and offset 1 only
    the selected lanes write records; every lane walks and contributes as
    without the stride (the same draws)."""
    scene = _mixed_problem().scene
    spec = NT.make_network(2, n_dim_output(2), TINY)
    params = NT.init_trainer(spec, CPU).ema_params
    box = GT.guide_box(scene, CPU)
    n = 8
    pts = torch.stack([torch.linspace(-0.8, 0.8, n),
                       torch.linspace(-0.5, 0.5, n)], -1)
    tsel = _t((np.arange(n) - 1) % 3 == 0)
    out = [GT.run_one_guided_sample(
        scene, spec, params, box, pts, torch.ones(n, dtype=torch.bool),
        sample_generators(7, 0, CPU), True, True, 0.5, 6, eps=0.05,
        max_depth=16, train_sel=sel) for sel in (tsel, None)]
    (c_sel, rec_sel, *_), (c_all, rec_all, *_) = out
    sel = tsel.numpy()
    assert (rec_sel.cur.numpy()[~sel] == 0).all()
    np.testing.assert_array_equal(rec_sel.cur.numpy()[sel],
                                  rec_all.cur.numpy()[sel])
    assert rec_all.cur.sum() > 0
    np.testing.assert_array_equal(c_sel.numpy(), c_all.numpy())


def test_untrained_net_fallback_in_phase(tmp_path):
    """With no optimizer step run, the guiding phase samples uniformly
    (max guided depth 0); once trained, it guides to its depth.  A solve
    whose training phase ran sets the flag from the step count."""
    problem = _mixed_problem()
    settings = IntegratorSettings(
        frameSize=(4, 1), samplesPerPixel=3, maxWalkingDepth=8,
        epsilonShell=0.05, trainSppCount=0,
        uniformFractionInGuidingPhase=0.5, maxGuidedDepthInGuidingPhase=6)
    pts = _t([[0.0, 0.0], [0.3, 0.2], [-0.4, 0.5], [0.6, -0.6]])
    integ = GT.GuidedIntegrator(problem, settings, str(tmp_path),
                                points=pts)
    integ.reset_network(TINY)
    assert not integ._net_trained
    _, mgd, training = integ._phase(0)
    assert not training and mgd == 0
    integ._net_trained = True
    assert integ._phase(0)[1] == 6
    integ.reset_training()
    integ.settings.trainSppCount = 1
    assert integ._phase(0)[2]
    integ.solve()
    assert integ._net_trained and len(integ.loss_history) == 1
    assert integ._phase(1) == (0.5, 6, False)
    vmm = integ.query_network([0.1, -0.2])      # print_network's query
    np.testing.assert_allclose(vmm.weight.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert integ.phase_stats["train_steps"] + integ.phase_stats[
        "guide_steps"] == integ.total_walk_steps > 0


def test_guided_cli_matches_uniform(tmp_path, monkeypatch):
    """A small lobed_n (512 Dirichlet segments, 16^2, 16 samples of which 6
    train, the tiny network) on the per-sample route and its uniform
    config (the balanced route) through ``run_expr`` on the CPU:
    result.json carries the guided keys, and the two films agree within 4
    combined standard errors on >= 99% of pixel channels."""
    from elaina_tpu_torch.exec import run_expr
    from elaina_tpu_torch.solver import integrator as I

    monkeypatch.setattr(P, "GRID_MAX_RES", 64)
    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    conf_n = S.write_lobed_n(str(tmp_path), 16, 6, segments=512, frame=16,
                             network=TINY)
    # one loss a training sample is the per-sample route's: ask for it
    # with the metric-frames switch (saveSppMetricsUntil 0: no frame)
    conf_n = S.write_per_sample(conf_n, "lobed_n")
    conf_u = os.path.join(str(tmp_path), "lobed_u.json")
    made = []
    init = I.BaseIntegrator.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(I.BaseIntegrator, "__init__", record)
    rn = run_expr(conf_n, device="cpu")
    ru = run_expr(conf_u, device="cpu")
    with open(os.path.join(str(tmp_path), "exp", "lobed_n",
                           "result.json")) as f:
        saved = json.load(f)
    for key in ("loss_history", "phase_stats", "walk_steps"):
        assert key in saved and key in rn
    assert len(saved["loss_history"]) == 6
    assert np.isfinite(saved["loss_history"]).all()
    ps = saved["phase_stats"]
    assert ps["train_steps"] + ps["guide_steps"] == saved["walk_steps"]
    assert os.path.exists(os.path.join(str(tmp_path), "exp", "lobed_n",
                                       "solution.exr"))
    assert ru["walk_steps"] > 0 and "loss_history" not in ru
    gi, ui = made
    assert isinstance(gi, GT.GuidedIntegrator)
    assert np.isfinite(gi.films["SOLUTION"].pixels()).all()
    a, b = ((i.sum / i.spp).numpy() for i in (gi, ui))
    se = np.hypot(gi.standard_error(), ui.standard_error())
    within = np.abs(a - b) <= 4 * se + 1e-6
    assert within.mean() >= 0.99
