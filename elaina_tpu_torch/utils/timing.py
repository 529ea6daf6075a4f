"""Kernel timings on the card: call ms and device ms.

``cuda_ms`` times one call with the device idle, between two CUDA events,
so the host's enqueue is inside it: what a caller that launches one op at
a time pays.  ``device_ms`` times the same call on the device alone: the
median over many calls enqueued behind a device-side wait that outlasts
the host's enqueue, with an event between consecutive calls, and the
host's enqueue time per call over the same run.  The two together say
which side of a call costs what.  Both need a CUDA device; ``chip_smoke.py``
and ``utils/ab.py`` use them.
"""

from __future__ import annotations

import statistics
import time

import torch

TIMED_RUNS = 20              # runs per call-ms timing (median kept)
DEVICE_LAUNCHES = 100        # calls per device-ms run (median kept)
SLEEP_CYCLES_S = 2.0e9       # the H100's top SM clock, rounded up: a wait of
#                              s * SLEEP_CYCLES_S cycles lasts >= s seconds


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Call ms: the median of ``fn()`` between two CUDA events with the
    device idle, over ``runs`` runs (the host's enqueue is inside it)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, launches: int = DEVICE_LAUNCHES) -> tuple:
    """(device ms, host us, hidden): the median device time per call over
    ``launches`` calls enqueued behind a device-side wait
    (``torch.cuda._sleep``) long enough to hide the host's enqueue, with an
    event between consecutive calls; the host's mean enqueue microseconds
    per call over the same run; and whether the wait outlasted the
    enqueue.  A call that waits for the device (``torch.nonzero`` reads its
    count back) cannot be hidden: its device ms then holds its round trip
    to the host."""
    host_est = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_est.append(time.perf_counter() - t0)
    wait_s = 2.0 * launches * min(host_est) + 1e-3
    for _ in range(2):       # once more with a longer wait if it fell short
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(launches + 1)]
        torch.cuda._sleep(int(wait_s * SLEEP_CYCLES_S))
        ev[0].record()
        host = 0.0
        for k in range(launches):
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            ev[k + 1].record()
        hidden = not ev[0].query()
        torch.cuda.synchronize()
        if hidden:
            break
        wait_s *= 4.0
    per = [ev[k].elapsed_time(ev[k + 1]) for k in range(launches)]
    return statistics.median(per), host / launches * 1e6, hidden
