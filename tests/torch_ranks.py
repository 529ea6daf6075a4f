"""Rank bodies of ``tests/test_torch_parallel.py``: what each of two gloo
ranks on the CPU runs, and the spawner that runs them.

Imports ``torch`` and the port only, never JAX: a spawned rank starts
from a fresh interpreter and imports this module.  Its name does not
start with ``test_``, so pytest collects nothing here.  Each item writes
``<name>_<rank>.npz`` into the run's directory; the parent reads them.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from elaina_tpu_torch.core import problem as P
from elaina_tpu_torch.core.config import IntegratorSettings
from elaina_tpu_torch.nn import network as NT
from elaina_tpu_torch.parallel import dp
from elaina_tpu_torch.parallel.dryrun import run_steps
from elaina_tpu_torch.solver import balanced as B
from elaina_tpu_torch.solver import guided as GT
from elaina_tpu_torch.solver.integrator import UniformIntegrator
from elaina_tpu_torch.solver.wost import compute_step0, wost_depth_step
from elaina_tpu_torch.utils.rng import stage_generators

CPU = torch.device("cpu")
N_RANKS = 2
JOIN_S = 120          # a spawn's hard limit: a hang fails the test
SMALL = {"encoding": {"base_resolution": 4, "n_levels": 4,
                      "n_features_per_level": 2, "per_level_scale": 1.5},
         "network": {"n_neurons": 32, "n_hidden_layers": 2}}
PTS = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8], [0.2, -0.1],
                [-0.7, 0.3], [0.9, 0.0]], np.float32)
SQUARE_SPP = 256
GUIDED_SPP, GUIDED_TRAIN = 128, 32
BUDGET_S, BUDGET_SPP = 0.4, 256
REC_FIELDS = ("pos", "dir", "dir_pdf", "thp", "sol", "on_neumann", "normal")


def square_side(sides, n_per_side=6):
    """tests/test_wost_uniform.py's ``_square_boundary``: sides of the CCW
    square [-1, 1]^2 (0 bottom, 1 right, 2 top, 3 left)."""
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    verts, idx = [], []
    for s in sides:
        a, b = corners[s], corners[(s + 1) % 4]
        base = len(verts)
        verts.extend(a[None] + np.linspace(0, 1, n_per_side + 1)[:, None]
                     * (b - a)[None])
        idx.extend([(base + i, base + i + 1) for i in range(n_per_side)])
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def mixed_problem():
    """tests/test_guided.py's mixed-BC square: Dirichlet u = (x + 1) / 2
    on the left and right sides, zero Neumann on the others."""
    dv, di = square_side((1, 3))
    nv, ni = square_side((0, 2))
    dc = np.repeat(((dv[:, 0] + 1) / 2)[:, None, None], 2, 1)
    dc = np.repeat(dc, 3, 2).astype(np.float32)
    problem = P.Problem(2, CPU, verbose=False)
    problem.scene = P.scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=CPU, dirichlet=(dv, di, dc),
        neumann=(nv, ni, np.zeros((len(nv), 2, 3), np.float32)))
    return problem


def uniform_square(pts=PTS, spp=SQUARE_SPP, group=None):
    settings = IntegratorSettings(frameSize=(len(pts), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=48,
                                  epsilonShell=0.02)
    integ = UniformIntegrator(mixed_problem(), settings, "unused",
                              points=torch.from_numpy(pts))
    integ.group = group
    integ.prepare()
    return integ


def guided_square(group=None, spp=GUIDED_SPP, train=GUIDED_TRAIN):
    settings = IntegratorSettings(frameSize=(len(PTS), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=48,
                                  epsilonShell=0.02, trainSppCount=train)
    integ = GT.GuidedIntegrator(mixed_problem(), settings, "unused",
                                points=torch.from_numpy(PTS))
    integ.group = group
    integ.reset_network(SMALL)
    integ.prepare()
    return integ


def flat_trainer(tr, prefix: str) -> dict:
    t = NT.trainer_to_numpy(tr)
    out = {f"{prefix}count": np.asarray(t["count"])}
    for field in ("params", "ema_params", "mu", "nu"):
        for k, v in t[field].items():
            out[f"{prefix}{field}.{k}"] = v
    return out


def local_records(group, d: str):
    """The parent's records (``train_inputs.npz``), this rank's lanes."""
    with np.load(os.path.join(d, "train_inputs.npz")) as z:
        sl = group.lanes(z["cur"].shape[0])
        rec = GT.WalkRecords(
            **{k: torch.from_numpy(z[k][:, sl]) for k in REC_FIELDS},
            cur=torch.from_numpy(z["cur"][sl]))
        p0 = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    return rec, p0


# --------------------------------------------------------------------------- #
# the items
# --------------------------------------------------------------------------- #


def item_train(group, d: str) -> dict:
    """Both training forms on this rank's half of the parent's records."""
    rec, p0 = local_records(group, d)
    spec = NT.make_network(2, 33, SMALL)
    box = GT.GuideBox(torch.tensor([-1.0, -1.0]), torch.tensor([1.0, 1.0]))
    tr_s, m_s = dp.sharded_train_on_records(
        group, NT.trainer_from_numpy(p0), spec, NT.AdamConfig(), box, rec,
        batch_size=4096, n_batches=2)
    tr_g, m_g = GT.train_on_records(
        NT.trainer_from_numpy(p0), spec, NT.AdamConfig(), box, rec,
        batch_size=4096, n_batches=2, group=group)
    return {**flat_trainer(tr_s, "sharded."), **flat_trainer(tr_g, "group."),
            "sharded_metric": float(m_s), "group_metric": float(m_g)}


def item_square(group, d: str) -> dict:
    integ = uniform_square(group=group)
    integ.solve()
    return {"mean": (integ.sum / integ.spp).numpy(),
            "se": integ.standard_error(), "steps": integ.total_walk_steps,
            "rank_steps": integ.rank_walk_steps}


def item_rng(group, d: str) -> dict:
    """The same worklist on both ranks, each on its own streams."""
    problem = mixed_problem()
    pts = torch.from_numpy(np.random.default_rng(5).uniform(
        -0.9, 0.9, (32, 2)).astype(np.float32))
    mask = torch.ones(32, dtype=torch.bool)
    rd0, _, _ = compute_step0(problem.scene, pts, mask, 0.02)
    quota = np.zeros((B.N_PIECES, 32), np.int32)
    quota[0] = 2
    pix = np.zeros((B.N_PIECES, 32), np.int32)
    pix[:] = np.arange(32)
    pieces = B.make_pieces(pts, rd0, pix, quota)
    out = B.run_chunk(
        lambda sc, ex, st, g, w, s0: wost_depth_step(sc, st, g, 0.02,
                                                     step0=s0),
        problem.scene, None, pieces, max_depth=16, iter_cap=64,
        round_seed=B.round_seed(0, 0, 0, group), gens=stage_generators(CPU))
    return {"lsteps": out.lsteps.numpy(), "steps": int(out.steps)}


def item_guided(group, d: str) -> dict:
    integ = guided_square(group=group)
    integ.solve()
    return {**flat_trainer(integ.trainer, "trainer."),
            "mean": (integ.sum / integ.spp).numpy(),
            "train_steps": integ.phase_stats["train_steps"],
            "trained": integ._net_trained,
            "loss": np.asarray(integ.loss_history, np.float64)}


def item_empty_rank(group, d: str) -> dict:
    """A lockstep training chunk in which rank 1 has no sample at all."""
    integ = guided_square(group=group, train=8)
    scene = integ.problem.scene
    rd0, _, _ = compute_step0(scene, integ.eval_points, integ.mask, 0.02)
    n = len(PTS)
    pix, quota = B.build_balanced_pieces(np.full(n, 3), np.ones(n), n)
    if group.rank == 1:
        quota[:] = 0
    pieces = B.make_pieces(integ.eval_points, rd0, pix, quota)
    loop = GT.TrainLoop(integ, integ.trainer, n, 2, group=group)
    out = B.run_chunk(loop.step, scene, None, pieces, max_depth=48,
                      iter_cap=400, round_seed=B.round_seed(3, 2, 0, group),
                      gens=stage_generators(CPU), hooks=loop, group=group)
    return {**flat_trainer(loop.trainer, "trainer."), "ran": out.ran,
            "checks": out.checks, "iters": int(out.iters),
            "done": int(out.done.sum()), "steps": int(out.steps)}


def item_budget(group, d: str) -> dict:
    """A budgeted solve: every slicer decision on rank 0's clock."""
    g = np.linspace(-0.8, 0.8, 8, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    integ = uniform_square(pts, BUDGET_SPP, group)
    ms = integ.solve(time_budget_s=BUDGET_S)
    done = integ.done_per_pixel
    return {"rounds": json.dumps(integ.balance_rounds), "ms": ms,
            "done": np.full(len(pts), BUDGET_SPP) if done is None else done,
            "mean": (integ.sum / integ.spp).numpy()}


def item_dryrun(group, d: str) -> dict:
    return {"summary": json.dumps(run_steps(group))}


ITEMS = ("train", "square", "rng", "guided", "empty_rank", "budget",
         "dryrun")


def _rank(i: int, n: int, store: str, d: str) -> None:
    torch.set_num_threads(1)
    group = dp.make_group(n, "gloo", device="cpu", rank=i, local_rank=i,
                          init_method=f"file://{store}", timeout_s=60)
    try:
        times = {}
        for name in ITEMS:
            t0 = time.time()
            res = globals()[f"item_{name}"](group, d)
            times[name] = time.time() - t0
            np.savez(os.path.join(d, f"{name}_{i}.npz"),
                     **{k: np.asarray(v) for k, v in res.items()})
        with open(os.path.join(d, f"times_{i}.json"), "w") as f:
            json.dump(times, f)
    finally:
        group.close()


def start_ranks(d: str, n: int = N_RANKS):
    """Start every item on ``n`` gloo ranks, spawned, rendezvous through a
    file in ``d``; returns the processes' context for ``wait_ranks``."""
    import torch.multiprocessing as mp

    return mp.start_processes(_rank, args=(n, os.path.join(d, "store"), d),
                              nprocs=n, join=False, start_method="spawn")


def wait_ranks(ctx, deadline: float) -> None:
    """Join the ranks: raise where one failed, or kill them all and raise
    where they have not ended by ``deadline`` (a ``time.time()``)."""
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError("the ranks are still running after "
                               f"{JOIN_S} s")
