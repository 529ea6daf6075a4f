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

The balanced persistent solve (``solver/balanced.py``) has no per-sample
streams: every lane restarts with its next sample when its walk dies.
Each of its iterations seeds the stage generators from (run seed,
phase, round, iteration) under a root of its own (``balanced_seed``),
so its streams never meet the per-sample route's.  Each lane draws its
own numbers, so the lanes that share a pixel sample independently.

Across the ranks of a group (``parallel/dp.py``) each rank draws from its
own streams: ``fold_rank`` folds the rank into a seed, the counterpart of
the JAX package's ``fold_in(key, axis_index)``.
"""

from __future__ import annotations

import os

import torch

STAGES = ("neumann", "walk", "source", "route", "guide", "uniform")
_MASK64 = (1 << 64) - 1
BALANCED_ROOT = 0xBA1A9CED   # mixed into every balanced-solve seed
RANK_ROOT = 0x5EED0F4A       # mixed into every rank's seed but rank 0's


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


def balanced_seed(seed: int, phase: int, round_i: int) -> int:
    """The seed of one round of a balanced solve's ``phase`` (the uniform
    solve, the guided training or guiding phase), from which
    ``reseed`` draws each iteration's stage streams."""
    h = _splitmix64(_splitmix64(seed & _MASK64) ^ BALANCED_ROOT)
    h = _splitmix64(h ^ (phase & _MASK64))
    return _splitmix64(h ^ (round_i & _MASK64)) >> 1


def fold_rank(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s streams.  Rank 0 keeps ``seed``, so
    that a group of one rank draws what no group draws; every other rank
    draws from a seed mixed with its rank."""
    if rank == 0:
        return seed
    h = _splitmix64(_splitmix64(seed & _MASK64) ^ RANK_ROOT)
    return _splitmix64(h ^ (rank & _MASK64)) >> 1


def stage_generators(device: torch.device) -> dict[str, torch.Generator]:
    """One generator a stage, to be seeded with ``reseed``."""
    return {name: torch.Generator(device=device) for name in STAGES}


def reseed(gens: dict[str, torch.Generator], round_seed: int,
           iteration: int) -> dict[str, torch.Generator]:
    """Seed the stage generators for one iteration of a round: the
    streams of ``sample_generators`` with the iteration as the sample,
    under the round's seed.  Seeding touches only the host."""
    for i, g in enumerate(gens.values()):
        g.manual_seed(stream_seed(round_seed, iteration, i))
    return gens
