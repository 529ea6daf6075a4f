"""Dry run of the multi-rank path on tiny shapes: the counterpart of the
JAX package's ``dryrun_multichip(n)`` (``__graft_entry__.py``).

Five steps over a group of ranks, each checked finite: (1) one sharded
uniform sample and (2) one sharded guided sample with records on a
circle of 64 Dirichlet segments in a 4-segment Neumann box, 16 lanes a
rank; (3) two data-parallel training batches on those records
(``sharded_train_on_records``); (4) the balanced uniform solve and (5)
the guided solve with its training phase, both sharded, on bench.py's
square scene at 16 x 16 pixels.  The trainers must be equal on every
rank after (3) and after (5).

    python -m elaina_tpu_torch.parallel.dryrun 2 --device cpu
    python -m elaina_tpu_torch.parallel.dryrun 2 --device cuda   # NCCL
    python -m elaina_tpu_torch.parallel.dryrun 2 --device cuda --backend gloo

The last runs both ranks on ``cuda:0`` (two ranks on one card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..core.config import IntegratorSettings
from ..core.evaluation_grid import EvaluationGrid
from ..core.problem import Problem, scene_from_numpy
from ..nn.network import (AdamConfig, init_trainer, make_network,
                          trainer_to_numpy)
from ..solver.distributions import n_dim_output
from ..solver.guided import GuidedIntegrator, guide_box
from ..solver.integrator import UniformIntegrator
from ..utils import scenes as S
from .dp import (Group, make_group, replicate, shard_lanes,
                 sharded_guided_spp, sharded_train_on_records,
                 sharded_uniform_sample)

TINY_NET = {"encoding": {"base_resolution": 4, "n_levels": 2,
                         "n_features_per_level": 2, "per_level_scale": 1.5},
            "network": {"n_neurons": 16, "n_hidden_layers": 1}}


def tiny_scene(device):
    """The JAX dry run's scene: a unit circle of 64 segments with seeded
    colors (Dirichlet) in the box [-1.2, 1.2]^2 of 4 segments (Neumann,
    zero)."""
    t = np.linspace(0, 2 * np.pi, 65)[:-1]
    verts = np.stack([np.cos(t), np.sin(t)], -1).astype(np.float32)
    idx = np.stack([np.arange(64), (np.arange(64) + 1) % 64],
                   -1).astype(np.int32)
    colors = np.random.default_rng(0).uniform(
        0, 1, (64, 2, 3)).astype(np.float32)
    box = np.array([[-1.2, -1.2], [1.2, -1.2], [1.2, 1.2], [-1.2, 1.2]],
                   np.float32)
    box_idx = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], np.int32)
    return scene_from_numpy(
        aabb_lo=[-1.2, -1.2], aabb_hi=[1.2, 1.2], device=device,
        dirichlet=(verts, idx, colors),
        neumann=(box, box_idx, np.zeros((4, 2, 3), np.float32)))


def square_problem(device, res: int = 16) -> Problem:
    """bench.py's square scene (its curve at 2,048 segments, no grid, no
    Neumann set) over a ``res`` x ``res`` frame of its evaluation grid."""
    verts, idx, colors = S.bench_square_scene()
    problem = Problem(2, device, verbose=False)
    problem.probe = EvaluationGrid.from_json(
        {"mData": {"pos": list(S.CENTER), "scale": 250, "up": [-1.0, 0.0]}},
        2)
    problem.scene = scene_from_numpy(
        aabb_lo=[-100, -100], aabb_hi=[600, 600], device=device,
        dirichlet=(verts, idx, colors))
    return problem


def trainer_hash(trainer) -> int:
    """A 60-bit digest of a trainer's every array and its step count."""
    h = hashlib.sha1()
    t = trainer_to_numpy(trainer)
    for field in ("params", "ema_params", "mu", "nu"):
        for k in sorted(t[field]):
            h.update(np.ascontiguousarray(t[field][k]).tobytes())
    h.update(str(t["count"]).encode())
    return int(h.hexdigest()[:15], 16)


def same_on_every_rank(group: Group, trainer, label: str) -> int:
    """The trainer's digest, after checking that every rank has it."""
    hashes = group.by_rank(trainer_hash(trainer))
    if len(set(hashes)) != 1:
        raise RuntimeError(f"{label}: the ranks' trainers differ: {hashes}")
    return hashes[0]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def run_steps(group: Group) -> dict:
    """The five steps on this rank of ``group``; returns rank 0's
    summary (the same numbers on every rank)."""
    dev = group.device
    scene = tiny_scene(dev)
    spec = make_network(2, n_dim_output(2), TINY_NET)
    trainer = replicate(group, init_trainer(spec, dev))
    box = guide_box(scene, dev)
    n = 16 * group.size
    pts = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.9, 0.9, (n, 2)).astype(np.float32)).to(dev)
    pts, mask = shard_lanes(group, pts, torch.ones(n, dtype=torch.bool,
                                                   device=dev))
    # 1) the uniform walk: a pure map, the step count summed
    contrib_u, steps = sharded_uniform_sample(group, scene, pts, mask, 0, 0,
                                              eps=0.05, max_depth=4)
    # 2) the guided walk with records, which stay on their rank
    contrib_g, records, steps_g = sharded_guided_spp(
        group, scene, spec, trainer.ema_params, box, pts, mask, 1, 0, True,
        0.5, 10, eps=0.05, max_depth=4)
    # 3) the data-parallel training step
    trainer2, metric = sharded_train_on_records(
        group, trainer, spec, AdamConfig(), box, records, batch_size=64,
        n_batches=2)
    _check(bool(torch.isfinite(contrib_u).all()
                and torch.isfinite(contrib_g).all()
                and torch.isfinite(metric)), "a sample or the metric is "
           "not finite")
    h3 = same_on_every_rank(group, trainer2, "sharded_train_on_records")
    # 4) the balanced uniform solve, sharded
    problem = square_problem(dev)
    st = IntegratorSettings(frameSize=(16, 16), samplesPerPixel=4,
                            maxWalkingDepth=8, epsilonShell=1.0)
    integ = UniformIntegrator(problem, st, "unused")
    integ.group = group
    integ.prepare()
    integ.solve()
    _check(bool(torch.isfinite(integ.sum).all()), "the uniform solve's "
           "film is not finite")
    # 5) the guided solve, sharded, training included (in lockstep)
    stg = IntegratorSettings(frameSize=(16, 16), samplesPerPixel=4,
                             maxWalkingDepth=8, epsilonShell=1.0,
                             trainSppCount=2,
                             uniformFractionInTrainingPhase=0.5,
                             uniformFractionInGuidingPhase=0.5,
                             maxGuidedDepthInTrainingPhase=4,
                             maxGuidedDepthInGuidingPhase=4)
    gi = GuidedIntegrator(problem, stg, "unused")
    gi.group = group
    gi.reset_network(TINY_NET)
    gi.prepare()
    gi.solve()
    _check(bool(torch.isfinite(gi.sum).all()), "the guided solve's film is "
           "not finite")
    _check(gi.phase_stats["train_steps"] > 0 and gi._net_trained,
           "the guided solve did not train")
    h5 = same_on_every_rank(group, gi.trainer, "the guided solve")
    return {"ranks": group.size, "backend": group.backend,
            "device": str(dev), "uniform_steps": int(steps),
            "guided_steps": int(steps_g), "train_metric": float(metric),
            "solve_steps": int(integ.total_walk_steps),
            "guided_solve_steps": int(gi.total_walk_steps),
            "guided_train_steps": int(gi.phase_stats["train_steps"]),
            "trainer_hashes": [h3, h5]}


def _rank(i: int, n: int, device: str, backend, store: str,
          out: str) -> None:
    torch.set_num_threads(1)
    group = make_group(n, backend, device=device, rank=i, local_rank=i,
                       init_method=f"file://{store}")
    try:
        summary = run_steps(group)
        if group.rank == 0:
            with open(out, "w") as f:
                json.dump(summary, f)
    finally:
        group.close()


def dryrun(n_ranks: int = 2, device: str = "cuda",
           backend: str | None = None) -> dict:
    """Spawn ``n_ranks`` ranks on ``device`` ("cuda", the default: NCCL,
    one card a rank, or ``backend="gloo"`` with every rank on ``cuda:0``;
    "cpu": gloo), run the five steps, and return rank 0's summary."""
    import torch.multiprocessing as mp

    dev = device
    if device == "cuda" and backend == "gloo":
        dev = "cuda:0"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "summary.json")
        mp.start_processes(_rank, args=(n_ranks, dev, backend,
                                        os.path.join(d, "store"), out),
                           nprocs=n_ranks, start_method="spawn")
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elaina_tpu_torch.parallel.dryrun")
    parser.add_argument("ranks", type=int)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    args = parser.parse_args(argv)
    summary = dryrun(args.ranks, args.device, args.backend)
    print(f"dryrun({args.ranks}): ok — {json.dumps(summary)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
