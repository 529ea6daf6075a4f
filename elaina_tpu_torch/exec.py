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
"""

from __future__ import annotations

import datetime
import json
import os
import time

import numpy as np
import torch

from .core.config import ExperimentConfig
from .core.logger import log_error, log_info, log_success
from .core.problem import Problem
from .solver.guided import GuidedIntegrator
from .solver.integrator import CHANNELS, UniformIntegrator


def _cache_dir() -> str:
    """On-disk candidate-grid cache, overridable with ELAINA_CACHE_DIR."""
    d = os.environ.get("ELAINA_CACHE_DIR",
                       os.path.expanduser("~/.cache/elaina_tpu_torch"))
    os.makedirs(d, exist_ok=True)
    return d


def run_expr(conf_path: str, device: str = "cuda",
             accel: str = "auto") -> dict:
    """Run one config: its channels and exports, as the JAX package's
    ``run_expr``.  ``accel`` is ``Problem.load_config``'s route ("auto" is
    the grid route; "bvh" builds no grid)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: PyTorch sees no CUDA device "
                           f"(run on the CPU with device='cpu', or "
                           f"--device cpu)")
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
    with open(conf_path) as f:
        raw_conf = json.load(f)
    with open(os.path.join(out_dir, "conf.json"), "w") as f:
        json.dump(raw_conf, f, indent=4)
    log_success("Configuration file copied to %s",
                os.path.join(out_dir, "conf.json"))

    problem = Problem(cfg.dimensionality, dev).load_config(
        cfg.scene, base_dir=os.getcwd(), cache_dir=_cache_dir(), accel=accel)
    if cfg.integrator_type == "guided":
        integrator = GuidedIntegrator(problem, cfg.settings, out_dir)
        integrator.reset_network(cfg.network)
    else:
        integrator = UniformIntegrator(problem, cfg.settings, out_dir)
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
    if cfg.print_network and cfg.integrator_type == "guided":
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
    result["table_bytes"] = problem.table_bytes()
    if problem.device.type == "cuda":
        result["peak_device_bytes"] = torch.cuda.max_memory_allocated(
            problem.device)
    result["timestamp"] = datetime.datetime.now().strftime(
        "%Y-%m-%d %H:%M:%S")
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=4)
    log_success("Result file written to %s",
                os.path.join(out_dir, "result.json"))
    return result
