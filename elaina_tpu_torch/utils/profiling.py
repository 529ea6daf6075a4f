"""Stage timers and a profiler trace around a solve.

The port's counterpart of ``elaina_tpu/utils/profiling.py``.  The
reference only wall-clocks solve() into result.json; ``StageTimer`` adds
per-stage wall times that wait for the device, and ``profile_trace`` a
``torch.profiler`` trace (CPU and CUDA activities) that TensorBoard or
chrome://tracing opens.  Both are opt-in: no step of the solver calls
them, so a solve makes no host wait for them.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time per named stage; with ``sync`` a stage ends
    once the CUDA devices of its tensors finished their queued work (as
    ``jax.block_until_ready`` waits for arrays)."""

    def __init__(self, sync: bool = True):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors: torch.Tensor):
        t0 = time.perf_counter()
        yield
        if self.sync:
            for dev in {t.device for t in sync_tensors}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(self.counts[k], 1), 3)}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """A ``torch.profiler`` scope (CPU, and CUDA where PyTorch sees a
    card) that writes its Chrome trace, ``<worker>.<time>.pt.trace.json``,
    into ``log_dir`` on exit; does nothing when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
