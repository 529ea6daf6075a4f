"""Random streams: one ``torch.Generator`` per (sample, stage).

The JAX reference folds threefry keys on (sample, depth, stage, lane).
Here each sample owns one generator per stage of the depth step, seeded
from (run seed, sample, stage) by a SplitMix64 mix; every depth step draws
its uniforms from the stage's generator in a fixed order, so a run is
reproducible for a given seed and device.  On CUDA the generators are
Philox.  The two frameworks give different numbers from the same seed:
parity tests feed identical numpy uniforms to both sides instead.

``ELAINA_SEED=<int>`` sets the run seed (default 0), as in the reference.
A stage's stream depends on its index in ``STAGES``: new stages go at the
end, so the streams of the existing ones (and a run's images) stay.  The
guided depth step adds three: "route" (the guided-or-uniform choice),
"guide" (the mixture sample) and "uniform" (the uniform direction it
draws before the route is chosen).
"""

from __future__ import annotations

import os

import torch

STAGES = ("neumann", "walk", "source", "route", "guide", "uniform")
_MASK64 = (1 << 64) - 1


def run_seed() -> int:
    return int(os.environ.get("ELAINA_SEED", "0") or 0)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, sample: int, stage: int) -> int:
    """63-bit seed of the (run seed, sample, stage) stream."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (sample & _MASK64))
    h = _splitmix64(h ^ stage)
    return h >> 1


def sample_generators(seed: int, sample: int,
                      device: torch.device) -> dict[str, torch.Generator]:
    """The stage generators of one sample, keyed by stage name."""
    gens = {}
    for i, name in enumerate(STAGES):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, sample, i))
        gens[name] = g
    return gens
