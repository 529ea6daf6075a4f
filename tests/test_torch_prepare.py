"""The port's kernel build stays out of the solve's clock.

``UniformIntegrator.prepare`` loads the CUDA kernel libraries of the
scene's route (building them when ``_build/`` holds none of these
sources) on a CUDA device and
loads nothing on the CPU (on both it also computes the step-0 tables of
the balanced route), and ``exec.run_expr`` calls it before any
channel, so ``result.json``'s duration never counts nvcc.  Nothing here
builds a kernel: the library loader is replaced by one that records the
names it is asked for.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from elaina_tpu_torch.ops import cuda as C  # noqa: E402
from elaina_tpu_torch.solver.integrator import UniformIntegrator  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: a parallel test run's OpenMP pool stalls the
    small CPU ops of a run (see tests/test_torch_dense.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def loads(monkeypatch):
    """The names ``ops.cuda.load_library`` is asked for; nothing is built."""
    names = []
    monkeypatch.setattr(C, "load_library",
                        lambda name, source, signatures: names.append(name))
    return names


def _integrator_on(device, accel="grid"):
    """A bare integrator on ``device`` whose step-0 tables (the rest of
    ``prepare``'s work) are already there, so only the loads remain; its
    problem names only the scene's route (``Scene.accel``)."""
    integ = UniformIntegrator.__new__(UniformIntegrator)
    integ.device = torch.device(device)
    integ._step0_cache = ()
    integ.problem = SimpleNamespace(scene=SimpleNamespace(accel=accel))
    return integ


def test_prepare_loads_both_libraries_on_cuda(loads):
    _integrator_on("cuda:0").prepare()
    assert sorted(loads) == ["elaina_queries", "elaina_resolve"]


def test_prepare_loads_the_bvh_library_on_the_bvh_route(loads):
    _integrator_on("cuda:0", accel="bvh").prepare()
    assert sorted(loads) == ["elaina_bvh", "elaina_queries",
                             "elaina_resolve"]


def test_prepare_does_nothing_on_the_cpu(loads):
    _integrator_on("cpu").prepare()
    assert loads == []


def test_run_expr_prepares_before_the_solve(tmp_path, monkeypatch, loads):
    """run_expr calls prepare() before solve(), here on the CPU."""
    from elaina_tpu_torch.exec import run_expr

    monkeypatch.setenv("ELAINA_CACHE_DIR", str(tmp_path / "cache"))
    calls = []
    prepare, solve = UniformIntegrator.prepare, UniformIntegrator.solve

    def record(name, fn):
        def wrapped(self):
            calls.append(name)
            return fn(self)
        return wrapped

    monkeypatch.setattr(UniformIntegrator, "prepare",
                        record("prepare", prepare))
    monkeypatch.setattr(UniformIntegrator, "solve", record("solve", solve))
    path = S.write_scene(str(tmp_path), 1, segments=64, frame=4)
    result = run_expr(path, device="cpu")
    assert calls == ["prepare", "solve"]
    assert result["walk_steps"] > 0 and loads == []
