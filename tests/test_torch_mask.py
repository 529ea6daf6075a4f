"""Scene masks (``scene.mask_path``) in the port against the JAX package.

The mask image is read as the JAX ``Problem`` reads it, and resized to
the frame as its ``_frame_mask`` resizes it.  Then ``tests/test_exec.py``'s
masked scene (the circle, the left half of the frame on) goes through the
port's ``run_expr`` on the CPU, uniform and guided, on the balanced
route, the per-sample route and under a time budget (a fake clock that
ticks 1 s a round or a sample, as ``tests/test_torch_budget.py`` runs
it).  The circle's colors vary along it here (``tests/test_exec.py``'s are
constant, which makes every walk's value the same), so the comparison
with the unmasked run has a variance to work with.  Masked pixels are
exactly 0 and walk no step; the others match the unmasked run within 4
combined standard errors on >= 99% of pixel channels.
"""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from elaina_tpu.core.problem import Problem as JaxProblem
from elaina_tpu.solver.integrator import BaseIntegrator as JaxBase
from elaina_tpu_torch.core.problem import Problem
from elaina_tpu_torch.exec import run_expr
from elaina_tpu_torch.output.image_io import read_exr
from elaina_tpu_torch.solver import balanced as B
from elaina_tpu_torch.solver import guided as GT
from elaina_tpu_torch.solver import integrator as I
from tests.test_exec import _base_conf

CPU = torch.device("cpu")
FRAME = 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in tests/test_torch_dense.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _varying_colors(path, n=64):
    """The circle's vertex colors, varying along it (``_write_circle_obj``
    puts vertex i at angle 2 pi i / n)."""
    t = 2 * np.pi * np.arange(n) / n
    c = np.stack([0.5 + 0.4 * np.cos(t), 0.5 + 0.4 * np.sin(2 * t),
                  np.full(n, 0.3)], 1).astype(np.float32)
    np.savez(path, left=c, right=c)


def _mask_png(path, shape=(FRAME, FRAME)):
    """test_exec.py's mask: the left half of the frame on."""
    mask = np.zeros(shape + (3,), np.uint8)
    mask[:, :shape[1] // 2] = 255
    Image.fromarray(mask).save(str(path))
    return np.any(mask != 0, axis=-1)


def _conf(tmp_path, integrator: str, name: str, route: str,
          masked: bool) -> str:
    conf = _base_conf(tmp_path, name, integrator)
    _varying_colors(str(tmp_path / "colors.npz"))
    s = conf["integrator"]["setting"]
    s.update(samplesPerPixel=16, trainSppCount=4)
    if route == "per_sample":
        s.update(saveSppMetricsDuration=1, saveSppMetricsUntil=0)
    else:
        s.update(saveSppMetricsDuration=-1)
    if masked:
        _mask_png(tmp_path / "mask.png")
        conf["scene"]["mask_path"] = "mask.png"     # relative: base_dir
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(conf))
    return str(path)


def _run(conf_path, monkeypatch, budget=None):
    """run_expr on the CPU from the config's directory; returns (result,
    the integrator it made)."""
    made = []
    init = I.BaseIntegrator.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(I.BaseIntegrator, "__init__", record)
    if budget is not None:
        for cls in (I.UniformIntegrator, GT.GuidedIntegrator):
            solve = cls.solve
            monkeypatch.setattr(
                cls, "solve",
                lambda self, _s=solve, **k: _s(self, time_budget_s=budget))
    root = conf_path.rsplit("/", 1)[0]
    monkeypatch.setenv("ELAINA_CACHE_DIR", root + "/cache")
    monkeypatch.chdir(root)
    result = run_expr(conf_path, device="cpu")
    monkeypatch.undo()
    return result, made[0]


class Clock:
    def __init__(self):
        self.now = 1.0e6

    def __call__(self):
        return self.now


def _fake_clock(monkeypatch):
    """``time.time`` stands still but for 1 s each balanced round and
    each per-sample-route sample (tests/test_torch_budget.py)."""
    c = Clock()

    def ticking(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            c.now += 1.0
            return out
        return run

    monkeypatch.setattr(time, "time", c)
    monkeypatch.setattr(B, "run_chunk", ticking(B.run_chunk))
    monkeypatch.setattr(GT, "run_chunk", ticking(GT.run_chunk))
    monkeypatch.setattr(I, "run_one_sample", ticking(I.run_one_sample))
    monkeypatch.setattr(GT, "run_one_guided_sample",
                        ticking(GT.run_one_guided_sample))


# --------------------------------------------------------------------------- #
# the mask image and its resize, against the JAX package
# --------------------------------------------------------------------------- #


def test_problem_mask_matches_jax(tmp_path):
    """Both problems read one PNG (grey, odd values, a relative path) to
    the same (H, W) bool mask."""
    conf = _base_conf(tmp_path, "m", "uniform")["scene"]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 3, (12, 20)).astype(np.uint8)
    Image.fromarray(img).save(str(tmp_path / "grey.png"))
    conf["mask_path"] = "grey.png"
    jp = JaxProblem(2, verbose=False).load_config(conf, base_dir=str(tmp_path))
    tp = Problem(2, CPU, verbose=False).load_config(conf,
                                                    base_dir=str(tmp_path))
    assert tp.mask.dtype == bool and tp.mask.shape == (12, 20)
    np.testing.assert_array_equal(tp.mask, jp.mask)
    np.testing.assert_array_equal(tp.mask, img != 0)


@pytest.mark.parametrize("shape", [(16, 24), (40, 57), (5, 7), (16, 9)])
def test_frame_mask_matches_jax(shape):
    """The nearest resize of a mask equal to, larger than and smaller than
    a 24x16 frame (and of one larger in one axis only)."""
    m = np.random.default_rng(shape[0]).random(shape) < 0.5
    me = SimpleNamespace(settings=SimpleNamespace(frameSize=(24, 16)),
                         problem=SimpleNamespace(mask=m))
    want = JaxBase._frame_mask(me)
    got = I.BaseIntegrator._frame_mask(me)
    assert got.shape == (24 * 16,) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    me.problem.mask = None
    assert I.BaseIntegrator._frame_mask(me).all()


# --------------------------------------------------------------------------- #
# masked solves through run_expr
# --------------------------------------------------------------------------- #


_REFS = {}


def _reference(tmp_path_factory, integrator: str):
    """The unmasked balanced run of the scene, once a module."""
    if integrator not in _REFS:
        mp = pytest.MonkeyPatch()
        d = tmp_path_factory.mktemp(f"ref_{integrator}")
        _, integ = _run(_conf(d, integrator, "ref", "balanced", False), mp)
        _REFS[integrator] = dict(
            mean=(integ.sum / integ.spp).numpy(), se=integ.standard_error(),
            steps=integ.total_walk_steps)
    return _REFS[integrator]


@pytest.mark.parametrize("route", ["balanced", "per_sample", "budget"])
@pytest.mark.parametrize("integrator", ["uniform", "guided"])
def test_masked_run_expr(tmp_path, tmp_path_factory, monkeypatch,
                         integrator, route):
    ref = _reference(tmp_path_factory, integrator)
    path = _conf(tmp_path, integrator, "masked", route, True)
    budget = None
    if route == "budget":
        # 3.5 rounds: 10 of 16 samples a pixel (uniform), 9 (guided), so
        # that each pixel's standard error has samples to come from
        _fake_clock(monkeypatch)
        budget = 3.5
    result, integ = _run(path, monkeypatch, budget)
    on = np.zeros((FRAME, FRAME), bool)
    on[:, :FRAME // 2] = True
    on = on.reshape(-1)
    np.testing.assert_array_equal(integ.mask.numpy(), on)

    # masked pixels: exactly 0 in the sums, the film and the file
    assert (integ.sum.numpy()[~on] == 0).all()
    assert (integ.sum_sq.numpy()[~on] == 0).all()
    sol = read_exr(str(tmp_path / "exp" / "masked" / "solution.exr"))
    assert (sol.reshape(-1, sol.shape[-1])[~on, :3] == 0).all()
    assert (sol.reshape(-1, sol.shape[-1])[on, :3] > 0).any()

    # a masked pixel counts as done, never as a pixel without a sample
    done = integ.done_per_pixel
    if route == "budget":
        assert done is not None
        assert (done[~on] == integ.spp).all()
        assert done[on].min() >= 1 and done[on].sum() < integ.spp * on.sum()
    else:
        assert done is None

    # the unmasked pixels agree with the unmasked run
    mean = (integ.sum / integ.spp).numpy()
    se = integ.standard_error()
    assert (se[~on] == 0).all()
    within = np.abs(mean - ref["mean"]) <= 4.0 * np.hypot(se, ref["se"]) \
        + 1e-6
    assert within[on].mean() >= 0.99, within[on].mean()

    # walk steps fall with the masked share (half the frame)
    ratio = result["walk_steps"] / ref["steps"]
    if route != "budget":
        assert 0.3 < ratio < 0.7, ratio
    else:
        assert ratio < 0.7, ratio

