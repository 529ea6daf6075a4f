"""Experiment runner: config JSON -> problem -> integrator -> exports.

Port of ``elaina_tpu/exec.py`` (reference: exec.cu run_expr): copies the
config next to the outputs, loads the CUDA kernels (``prepare``), runs
the uniform or the guided integrator's channels, performs the
export list and writes ``result.json`` with the solve duration, the walk
steps, the exactly resolved lane-steps and the walks that met the depth
cap, for a guided run the training loss of each training sample and each
phase's seconds and walk steps, the scene tables' sizes, the solve's peak
device memory on CUDA, and a timestamp.

The device is the caller's: ``"cuda"`` (the default; ``CUDA_VISIBLE_DEVICES``
picks the card) or ``"cpu"``, the counterpart of the JAX runner's platform
switch.  With no visible card a CUDA run raises; it never falls back to
the CPU.

``devices`` N > 1 (``ELAINA_DEVICES=N`` where the caller gives none, as
the JAX runner reads it, exec.py:91-113) runs this process as one rank of
N (``parallel/dp.make_group``: ``cuda:<local rank>`` under NCCL, or gloo
on the CPU), the balanced route's lanes sharded over the ranks.  Rank 0
loads the problem first (the grid and hint caches written once), then the
others; rank 0 alone writes the config copy, the exports and
``result.json``, which gains ``devices`` and ``walk_steps_by_rank`` (its
``walk_steps`` is their sum).  Fewer visible cards than N, or a frame
whose pixel count does not divide by N, raises where the JAX runner runs
single-device.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch

from .core.config import ExperimentConfig
from .core.logger import log_error, log_info, log_success
from .core.problem import Problem
from .parallel.dp import make_group
from .solver.guided import GuidedIntegrator
from .solver.integrator import CHANNELS, UniformIntegrator


def _cache_dir() -> str:
    """On-disk candidate-grid cache, overridable with ELAINA_CACHE_DIR."""
    d = os.environ.get("ELAINA_CACHE_DIR",
                       os.path.expanduser("~/.cache/elaina_tpu_torch"))
    os.makedirs(d, exist_ok=True)
    return d


def env_devices() -> int:
    """``ELAINA_DEVICES`` (default 1): the ranks a run takes."""
    raw = os.environ.get("ELAINA_DEVICES") or "1"
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"ELAINA_DEVICES={raw!r} is not an integer") \
            from None


def run_expr(conf_path: str, device: str = "cuda", accel: str = "auto",
             devices: int | None = None, group=None) -> dict:
    """Run one config: its channels and exports, as the JAX package's
    ``run_expr``.  ``accel`` is ``Problem.load_config``'s route ("auto" is
    the grid route; "bvh" builds no grid).  ``devices`` > 1 (default
    ``ELAINA_DEVICES``) runs this process as one rank of a group: the
    caller's ``group`` (a ``parallel/dp.Group`` of that size), else
    ``make_group(devices, device=device)`` from the environment
    (``torchrun``'s), closed at the end."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: PyTorch sees no CUDA device "
                           f"(run on the CPU with device='cpu', or "
                           f"--device cpu)")
    n_dev = (group.size if group is not None and devices is None
             else devices if devices is not None else env_devices())
    if group is not None and group.size != n_dev:
        raise ValueError(f"devices={n_dev} with a group of {group.size}")
    own = group is None and n_dev > 1
    if own:
        group = make_group(n_dev, device=device)
    try:
        return _run(conf_path, dev if group is None else group.device,
                    accel, group)
    finally:
        if own:
            group.close()


def _run(conf_path: str, dev: torch.device, accel: str, group) -> dict:
    lead = group is None or group.rank == 0
    conf_path = os.path.abspath(conf_path)
    if not os.path.exists(conf_path):
        log_error("Configuration file does not exist: %s", conf_path)
        return {}
    cfg = ExperimentConfig.from_file(conf_path)
    if cfg.integrator_type not in ("uniform", "guided"):
        raise ValueError(f"unrecognized integrator type "
                         f"{cfg.integrator_type!r}")
    for channel in set(cfg.channels) | {e.channel for e in cfg.exports}:
        if channel not in CHANNELS:
            raise ValueError(f"unknown channel {channel!r}: one of "
                             f"{CHANNELS}")
    out_dir = os.path.join(cfg.base_path, cfg.exp_name)
    os.makedirs(out_dir, exist_ok=True)
    if lead:
        with open(conf_path) as f:
            raw_conf = json.load(f)
        with open(os.path.join(out_dir, "conf.json"), "w") as f:
            json.dump(raw_conf, f, indent=4)
        log_success("Configuration file copied to %s",
                    os.path.join(out_dir, "conf.json"))

    if not lead:
        group.barrier()          # rank 0 builds and caches the grids first
    problem = Problem(cfg.dimensionality, dev).load_config(
        cfg.scene, base_dir=os.getcwd(), cache_dir=_cache_dir(), accel=accel)
    if group is not None and lead:
        group.barrier()
    if cfg.integrator_type == "guided":
        integrator = GuidedIntegrator(problem, cfg.settings, out_dir)
    else:
        integrator = UniformIntegrator(problem, cfg.settings, out_dir)
    if group is not None:
        integrator.group = group
        log_success("Sharding lanes over %d ranks (rank %d, %s)", group.size,
                    group.rank, group.device)
    if cfg.integrator_type == "guided":
        integrator.reset_network(cfg.network)
    # build and load the kernels before any timed channel, so that
    # result.json's duration measures walking (on every CUDA run; the JAX
    # runner's ELAINA_PREPARE is opt-in because its compile is optional)
    t_prep = time.time()
    integrator.prepare()
    log_info("prepare (kernel libraries): %.1fs", time.time() - t_prep)

    result: dict = {}
    if problem.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(problem.device)
    for channel in sorted(set(cfg.channels), key=CHANNELS.index):
        if channel == "SOLUTION":
            result["duration"] = integrator.solve()
            result["walk_steps"] = integrator.total_walk_steps
            result["resolved_lanes"] = integrator.total_resolved
            result["capped_walks"] = integrator.total_capped
        elif channel == "DIRICHLET_SDF":
            integrator.render_dirichlet_sdf()
        elif channel == "NEUMANN_SDF":
            integrator.render_silhouette_sdf()
        else:
            integrator.render_source()
    if cfg.print_network and cfg.integrator_type == "guided" and lead:
        integrator.query_network(np.zeros(problem.dim, np.float32))
    for e in cfg.exports:
        if e.type == "image":
            integrator.export_image(e.channel, e.file_name)
        elif e.type == "energy":
            integrator.export_energy(e.channel, e.tone, e.file_name)
        else:
            log_error("Unrecognized export type %r, skipping...", e.type)
    # the guided integrator's training curve and per-phase breakdown, as
    # the JAX runner exports them
    if getattr(integrator, "loss_history", None):
        result["loss_history"] = [float(v) for v in integrator.loss_history]
    if getattr(integrator, "phase_stats", None):
        result["phase_stats"] = integrator.phase_stats
    result["device"] = str(problem.device)
    if group is not None:
        result["devices"] = group.size
        if "walk_steps" in result:
            result["walk_steps_by_rank"] = group.by_rank(
                integrator.rank_walk_steps)
    result["table_bytes"] = problem.table_bytes()
    if problem.device.type == "cuda":
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated(
            problem.device)
    result["timestamp"] = datetime.datetime.now().strftime(
        "%Y-%m-%d %H:%M:%S")
    if lead:
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(result, f, indent=4)
        log_success("Result file written to %s",
                    os.path.join(out_dir, "result.json"))
    return result


def _rank(i: int, n: int, conf: str, device: str, accel: str,
          store: str) -> None:
    """One spawned rank of ``spawn_ranks``: its group, then the run."""
    group = make_group(n, device=device, rank=i, local_rank=i,
                       init_method=f"file://{store}")
    try:
        run_expr(conf, device=device, accel=accel, devices=n, group=group)
    finally:
        group.close()


def spawn_ranks(conf_path: str, device: str = "cuda", n: int = 2,
                accel: str = "auto") -> None:
    """``run_expr`` on ``n`` ranks spawned from this process (the
    ``spawn`` start method), meeting through a file in a temporary
    directory: rank i on ``cuda:i`` under NCCL (fewer visible cards than
    ``n`` raises before any spawn), or on the CPU under gloo."""
    import torch.multiprocessing as mp

    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks on {torch.cuda.device_count()} "
                           f"visible CUDA device(s): one card a rank")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(n, os.path.abspath(conf_path),
                                        device, accel,
                                        os.path.join(d, "store")),
                           nprocs=n, start_method="spawn")
