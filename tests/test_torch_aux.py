"""The port's small auxiliaries against the JAX package's: the loss EMA
(``utils/ema.Ema``), the stage timer and the profiler trace
(``utils/profiling``), the walk tracer (``solver/debug.trace_walk``) and
the ``models`` import point."""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import elaina_tpu.models as jax_models
from elaina_tpu.utils.ema import Ema as JaxEma
from elaina_tpu_torch.core.problem import scene_from_numpy
from elaina_tpu_torch.solver.debug import trace_walk
from elaina_tpu_torch.utils.ema import Ema
from elaina_tpu_torch.utils.profiling import StageTimer, profile_trace
from tests.test_wost_uniform import _colors_from_fn, _square_boundary

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("half_life", [1.0, 3.5, 50.0])
def test_ema_step_mode_matches_jax(half_life):
    xs = np.random.default_rng(int(half_life)).normal(size=40).tolist()
    a, b = Ema(Ema.STEP, half_life), JaxEma(JaxEma.STEP, half_life)
    for x in xs:
        assert a.update(x) == b.update(x)
    assert a.ema_val() == b.ema_val()


def test_ema_time_mode_matches_jax(monkeypatch):
    """The wall-time mode on a clock that both read: a step of 0, of a
    half-life and of ten; a clock that runs backwards decays nothing."""
    now = [1000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    a, b = Ema(), JaxEma()
    assert (a.mode, a.half_life) == (b.mode, b.half_life) == ("time", 50.0)
    for dt, x in [(0.0, 2.0), (0.0, 1.0), (0.05, 3.0), (0.5, -1.0),
                  (-0.2, 4.0), (0.013, 0.5)]:
        now[0] += dt
        assert a.update(x) == b.update(x)
    assert a.value == b.value


def test_stage_timer_report(tmp_path):
    """JAX's keys and rounding: total_s to 4 places, mean_ms to 3, sorted
    by name; a stage with a CPU tensor syncs nothing."""
    t = StageTimer()
    for name, n in (("solve", 3), ("load", 1)):
        for _ in range(n):
            with t.stage(name, torch.ones(3)):
                pass
    t.totals["solve"] = 0.123456789
    rep = t.report()
    assert list(rep) == ["load", "solve"]
    assert rep["solve"] == {"total_s": 0.1235, "count": 3,
                            "mean_ms": round(1000 * 0.123456789 / 3, 3)}
    assert set(rep["load"]) == {"total_s", "count", "mean_ms"}
    t.dump(str(tmp_path / "stages.json"))
    assert json.loads((tmp_path / "stages.json").read_text()) == rep
    assert StageTimer(sync=False).sync is False


def test_profile_trace(tmp_path):
    """No log_dir: nothing is profiled or written.  A log_dir: a Chrome
    trace of the block's CPU ops is written there."""
    for off in (None, ""):
        with profile_trace(off):
            torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    d = str(tmp_path / "trace")
    with profile_trace(d):
        (torch.arange(64.0).reshape(8, 8) @ torch.ones(8, 8)).sum()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_trace_walk_square():
    """tests/test_aux.py's square (Dirichlet value 1): the first entry
    starts at the point, the walk ends inactive in the shell within the
    depth, and its contributions sum to 1."""
    verts, idx = _square_boundary(n_per_side=4)
    colors = _colors_from_fn(verts, lambda v: 1.0)
    scene = scene_from_numpy(aabb_lo=[-1, -1], aabb_hi=[1, 1], device=CPU,
                             dirichlet=(verts, idx, colors))
    trace = trace_walk(scene, [0.0, 0.0], eps=0.05, max_depth=32)
    assert 1 <= len(trace) <= 32
    assert trace[0]["pos"] == [0.0, 0.0] and trace[0]["depth"] == 0
    assert not trace[-1]["active"]
    assert all(e["active"] for e in trace[:-1])
    assert set(trace[0]) == {"depth", "pos", "next_pos", "contribution",
                             "thp", "active", "on_neumann", "neumann_normal"}
    for a, b in zip(trace, trace[1:]):
        assert b["pos"] == a["next_pos"]
    total = sum(e["contribution"][0] for e in trace)
    assert total == pytest.approx(1.0, abs=1e-4)
    # the streams are the seed's: one seed, one walk
    assert trace_walk(scene, [0.0, 0.0], eps=0.05, max_depth=32) == trace
    assert trace_walk(scene, [0.0, 0.0], 7, eps=0.05, max_depth=32) != trace


def test_models_names():
    """elaina_tpu_torch.models has the JAX package's __all__, each name
    its solver's or network's object."""
    import elaina_tpu_torch.models as models
    from elaina_tpu_torch.nn import network
    from elaina_tpu_torch.solver import guided, integrator, wost

    assert models.__all__ == jax_models.__all__
    for name in models.__all__:
        assert getattr(models, name) is not None, name
    assert models.UniformIntegrator is integrator.UniformIntegrator
    assert models.GuidedIntegrator is guided.GuidedIntegrator
    assert models.run_one_sample is wost.run_one_sample
    assert models.run_one_guided_sample is guided.run_one_guided_sample
    assert models.make_network is network.make_network
    assert models.CHANNELS == jax_models.CHANNELS
