"""Uniform integrator: the solve's two routes and the exports.

Port of ``BaseIntegrator`` / ``UniformIntegrator`` of
``elaina_tpu/solver/integrator.py``.  The solve takes the JAX package's
default route, the balanced persistent solve (``solver/balanced.py``,
integrator.py:250-372): lanes restart with their next sample as their
walks die, over cost-balanced worklists.  It takes the per-sample route
(integrator.py:188-249) exactly where the JAX package does: when the
config asks for per-spp or timed metric frames, or when the caller passes
``spp_chunk``; there each sample walks every pixel's lane to the maximum
depth, and the loop accumulates the samples and dumps the frames.  Both
routes take a time budget (``solve(time_budget_s=...)``, counted from the
call, after ``prepare()``): the balanced route slices its rounds
(``balanced.BudgetSlicer``), the per-sample route stops between samples.
The problem's hint cache (``Problem.hint_cache_load``, at construction)
seeds the balanced route with the per-pixel costs and walk rates of
earlier solves of the scene, and each solve saves its own.  The
one-shot channels fill their films from one query over the
frame's points (integrator.py:96-131): DIRICHLET_SDF the distance to the
Dirichlet boundary (the chain path, K10 / K11; without a grid
``closest_point``, K13 in 2D), NEUMANN_SDF the exact
distance to the nearest Neumann silhouette, SOURCE the source's value;
a scene without the boundary or the source gets inf or zeros there.
The problem's mask image (``mask_path``), nearest-resized to the frame
(``_frame_mask``), leaves each masked pixel unwalked at exactly 0 on
every route: it never starts a walk, trains nothing, and counts as done
with every sample under a budget; the one-shot channels ignore it, as
the JAX package's do.

``group`` (a ``parallel/dp.Group``, the JAX package's ``mesh``,
integrator.py:48, 262-363) shards the balanced route's lanes over the
group's ranks; every rank builds the same problem and integrator and
calls the same methods.  The frame's pixel count must divide by the
group's size (it raises; the JAX package runs single-device there).  The
one-shot channels, the exports, the hint file and the per-sample route
(metric frames, ``spp_chunk``, checkpoints), which the JAX package runs
without its mesh, run on rank 0; on the per-sample route the other ranks
wait, then take rank 0's sums.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..core.config import IntegratorSettings
from ..core.logger import log_info
from ..core.problem import Problem
from ..geometry.grid import build_fine_pack
from ..geometry import queries as Q
from ..output.film import Film
from ..utils.rng import run_seed, sample_generators
from .balanced import balanced_solve
from .wost import (check_neumann, compute_step0, dirichlet_distance,
                   run_one_sample, wost_depth_step)

# ExportImageChannel order (the film slots of the reference)
CHANNELS = ("DIRICHLET_SDF", "NEUMANN_SDF", "SOURCE", "SOLUTION")


def _progress(i, n, label="Solving"):
    if n <= 0:
        return
    width = 30
    done = int(width * (i / n))
    sys.stderr.write(f"\r{label}... [{'#' * done}{'.' * (width - done)}] "
                     f"{i}/{n}")
    if i == n:
        sys.stderr.write("\n")
    sys.stderr.flush()


class BaseIntegrator:
    group = None     # parallel/dp.Group: the lanes sharded over its ranks

    def __init__(self, problem: Problem, settings: IntegratorSettings,
                 base_path: str, points: torch.Tensor | None = None):
        """``points`` (optional, (W*H, 2)) replaces the evaluation grid's
        pixel points, e.g. to solve at a few probe positions."""
        self.problem = problem
        self.settings = settings
        self.base_path = base_path
        self.films = {c: Film(settings.frameSize) for c in CHANNELS}
        self.device = problem.device

        # bake the epsilon-shell need bit into the FinePack: the integrator
        # is the first place eps is known
        eps = float(settings.epsilonShell)
        grid = problem.scene.d_grid
        if grid is not None and (grid.fine is None or grid.fine.eps != eps):
            grid.fine = build_fine_pack(grid, eps)

        w, h = settings.frameSize
        self.n_pixels = w * h
        if points is None:
            pix = torch.arange(self.n_pixels, device=self.device)
            points = problem.probe.points(pix, settings.frameSize)
        if tuple(points.shape) != (self.n_pixels, problem.dim):
            raise ValueError(f"points {tuple(points.shape)} for a {w}x{h} "
                             f"frame")
        self.eval_points = points.to(self.device, torch.float32).contiguous()
        self.mask = torch.from_numpy(self._frame_mask()).to(self.device)
        # completed samples a pixel, where a time budget left them uneven
        self.done_per_pixel = None
        # cost and walk-rate hints of earlier processes on this scene
        problem.hint_cache_load()

    def _frame_mask(self) -> np.ndarray:
        """(W*H,) host bool: the problem's mask image nearest-resized to
        the frame (reference integrator.py:81-90), every pixel without
        one.  A masked pixel never walks and its solution is 0."""
        w, h = self.settings.frameSize
        m = self.problem.mask
        if m is None:
            return np.ones((w * h,), bool)
        if m.shape != (h, w):
            yi = np.arange(h) * m.shape[0] // h
            xi = np.arange(w) * m.shape[1] // w
            m = m[yi][:, xi]
        return np.ascontiguousarray(m).reshape(-1)

    def prepare(self) -> None:
        """Work before the solve's clock starts (the JAX integrator's
        ``prepare`` compiles its programs there): on a CUDA device load
        the kernel libraries, ``ops/resolve`` and ``ops/queries`` and, on
        the BVH route, ``ops/bvh``, which builds them if ``_build/`` holds
        no library of these sources (on the CPU there is nothing to
        load); then each pixel's first separation (``_step0``), which the
        balanced route reuses.  Under a group it checks that the frame
        divides over the ranks and makes the group's first collective
        (NCCL builds its communicator then), which the JAX integrator's
        compiles for the mesh's widths stand for: PyTorch compiles nothing
        a width."""
        self._check_group()
        if self.group is not None:
            self.group.barrier()
        if self.device.type == "cuda":
            from ..ops import bvh, queries, resolve

            resolve.library()
            queries.library()
            if self.problem.scene.accel == "bvh":
                bvh.library()
        self._step0()

    def _lead(self) -> bool:
        """Whether this process writes the outputs: rank 0, or no group."""
        return self.group is None or self.group.rank == 0

    def _clock(self) -> float:
        """The solve's clock: ``time.time()``, rank 0's under a group."""
        return time.time() if self.group is None else self.group.clock()

    def _check_group(self) -> None:
        g = self.group
        if g is not None and self.n_pixels % g.size:
            raise ValueError(f"a frame of {self.n_pixels} pixels does not "
                             f"divide over {g.size} ranks")

    def _on_lead(self, solve) -> int:
        """``solve()`` on rank 0 alone while the other ranks wait; then
        every rank takes rank 0's sums (``_share_from_lead``).  Without a
        group, ``solve()``."""
        if self.group is None:
            return solve()
        duration_ms = solve() if self._lead() else 0
        self._share_from_lead()
        self.rank_walk_steps = self.total_walk_steps if self._lead() else 0
        return duration_ms

    def _share_from_lead(self):
        """Rank 0's sums, counts and SOLUTION film on every rank."""
        g = self.group
        shape = (self.n_pixels, 3)
        if not self._lead():
            self.sum = torch.zeros(shape, device=self.device)
            self.sum_sq = torch.zeros(shape, device=self.device)
            self.spp = self.total_walk_steps = 0
            self.total_resolved = self.total_capped = 0
            self.done_per_pixel = None
        self.sum = g.broadcast(self.sum.contiguous())
        self.sum_sq = g.broadcast(self.sum_sq.contiguous())
        (self.spp, self.total_walk_steps, self.total_resolved,
         self.total_capped) = (int(v) for v in g.host_sum(
            [v if self._lead() else 0 for v in (
                self.spp, self.total_walk_steps, self.total_resolved,
                self.total_capped)]))
        if not self._lead():
            self._put("SOLUTION", self.sum.cpu().numpy() / max(self.spp, 1))

    def _save_hints(self) -> None:
        """The problem's hint file, written by rank 0 alone."""
        if self._lead():
            self.problem.hint_cache_save()

    def _step0(self):
        """Each pixel's first separation, (rd0, in_shell0, contrib0), once
        an integrator (reference integrator.py:265-273)."""
        if getattr(self, "_step0_cache", None) is None:
            self._step0_cache = compute_step0(
                self.problem.scene, self.eval_points, self.mask,
                float(self.settings.epsilonShell))
        return self._step0_cache

    def _balanced_inputs(self):
        """The step-0 tables and the host mask of the pixels the balanced
        route bakes analytically (in the shell at step 0, or masked)."""
        rd0, in_shell0, contrib0 = self._step0()
        resolved = (in_shell0 | ~self.mask).cpu().numpy()
        return rd0, in_shell0, contrib0, resolved

    def _cost_cache(self) -> tuple[dict, tuple]:
        """The per-pixel cost cache kept on the problem (reference
        integrator.py:345): a later solve of the same frame, eps and depth
        starts balanced without the probe round.  Returns (cache, key)."""
        s = self.settings
        cache = self.problem.__dict__.setdefault("_cost_cache", {})
        return cache, (self.n_pixels, float(s.epsilonShell),
                       int(s.maxWalkingDepth))

    def _rate_cache(self) -> dict:
        """The walk-rate cache kept on the problem (reference
        integrator.py:347): walk-steps/s by lane count (``n_pixels``), and
        the guided training phase's under ``("train", n_pixels)``; a later
        budgeted solve slices its first round with it.  The port also
        keeps the seconds an iteration under ``("iter", phase, lanes)``."""
        return self.problem.__dict__.setdefault("_rate_cache", {})

    def _iter_walls(self, phase: int) -> dict:
        """The seconds an iteration, by lane width, that this problem's
        solves measured in ``phase`` (0 uniform; the guided phases')."""
        return {k[2]: v for k, v in self._rate_cache().items()
                if isinstance(k, tuple) and k[:2] == ("iter", phase)}

    def _keep_iter_walls(self, phase: int, walls: dict) -> None:
        self._rate_cache().update({("iter", phase, w): t
                                   for w, t in walls.items()})

    def _put(self, channel: str, vals: np.ndarray):
        film = self.films[channel]
        film.reset()
        film.put_frame(vals)

    def render_dirichlet_sdf(self):
        if not self._lead():
            return
        scene = self.problem.scene
        if scene.dirichlet is not None:
            d, _ = dirichlet_distance(scene, self.eval_points)
            vals = d.cpu().numpy()
        else:
            vals = np.full((self.n_pixels,), np.inf, np.float32)
        self._put("DIRICHLET_SDF", np.repeat(vals[:, None], 3, -1))

    def render_silhouette_sdf(self):
        if not self._lead():
            return
        scene = self.problem.scene
        if scene.neumann is not None:
            vals = Q.closest_silhouette(scene.neumann.gs,
                                        self.eval_points).cpu().numpy()
        else:
            vals = np.full((self.n_pixels,), np.inf, np.float32)
        self._put("NEUMANN_SDF", np.repeat(vals[:, None], 3, -1))

    def render_source(self):
        if not self._lead():
            return
        scene = self.problem.scene
        if scene.source is not None:
            vals = (scene.source.sample(self.eval_points)
                    * scene.source_intensity).cpu().numpy()
        else:
            vals = np.zeros((self.n_pixels, 3), np.float32)
        self._put("SOURCE", vals)

    def export_image(self, channel: str, file_name: str):
        if not self._lead():
            return
        for ext in (".exr", ".png"):
            path = os.path.join(self.base_path, file_name + ext)
            log_info("Exporting image to %s", path)
            self.films[channel].save(path)

    def export_energy(self, channel: str, tone: str, file_name: str):
        if not self._lead():
            return
        for ext in (".exr", ".png"):
            path = os.path.join(self.base_path, file_name + ext)
            log_info("Exporting energy to %s", path)
            self.films[channel].save_energy(path, tone)

    def _dump_frames(self, solution_sum: torch.Tensor, spp_done: int,
                     subdir: str, stem: str):
        film = self.films["SOLUTION"]
        film.reset()
        film.put_frame(solution_sum.cpu().numpy() / max(spp_done, 1))
        base = os.path.join(self.base_path, subdir)
        film.save(os.path.join(base, stem + ".exr"))
        film.save(os.path.join(base, stem + ".png"))

    def standard_error(self) -> np.ndarray:
        """Per-pixel Monte Carlo standard error of the mean, (N, 3), over
        each pixel's completed samples (``done_per_pixel`` where a time
        budget left them uneven: the sums are rescaled to ``spp``)."""
        mean = self.sum / self.spp
        var = torch.clamp(self.sum_sq / self.spp - mean * mean, min=0.0)
        n = self.spp
        if self.done_per_pixel is None:
            var = var * (n / max(n - 1, 1))
        else:
            n = torch.as_tensor(self.done_per_pixel, dtype=torch.float32,
                                device=mean.device)[:, None]
            var = var * (n / torch.clamp(n - 1, min=1.0))
        return torch.sqrt(var / n).cpu().numpy()


def metrics_on(settings) -> bool:
    """Whether the config asks for per-spp or timed metric frames, which
    only the per-sample route writes."""
    return (settings.saveSppMetricsDuration > 0
            or settings.saveTimeMetricsDuration > 0)


class UniformIntegrator(BaseIntegrator):
    def solve(self, spp_chunk: int | None = None,
              time_budget_s: float | None = None) -> int:
        """Run every sample, or as many as ``time_budget_s`` seconds allow;
        returns wall-clock milliseconds.  Leaves the mean in the SOLUTION
        film, the per-pixel sums in ``sum`` / ``sum_sq`` (over ``spp``
        samples), the live lane-steps in ``total_walk_steps``, the
        lane-steps whose Dirichlet distance was resolved exactly (the
        K2 / K4 sweep's lanes) in ``total_resolved`` and the walks that
        met the depth cap alive in ``total_capped``.

        The route is the JAX package's choice (integrator.py:185-189):
        the balanced persistent solve, unless the config asks for metric
        frames or the caller passes ``spp_chunk``, which take the
        per-sample route (the port dispatches it one sample at a time,
        so the value of ``spp_chunk`` sets nothing else).  Under a budget
        the balanced route rescales each pixel's sums by its completed
        samples (``done_per_pixel``) and the per-sample route stops
        between samples once one ran and the budget is spent, its mean
        over the samples it ran (``spp``).  Under a group the balanced
        route shards its lanes over the ranks, and the per-sample route
        runs on rank 0 (``_on_lead``)."""
        self._check_group()
        if metrics_on(self.settings) or spp_chunk is not None:
            return self._on_lead(lambda: self._solve_per_sample(
                time_budget_s))
        return self._solve_persistent(time_budget_s)

    def _solve_persistent(self, time_budget_s: float | None = None) -> int:
        """The balanced persistent solve (reference integrator.py:325-372):
        the probe round measures each pixel's cost, which is cached on
        the problem for later solves, as is the walk rate (by lane count);
        both seed a budgeted solve and reach the hint file at the end.
        ``balance_rounds`` keeps each round's record (lanes, cap,
        iterations, steps, host checks, wall, occupancy)."""
        s = self.settings
        scene = self.problem.scene
        check_neumann(scene)
        eps = float(s.epsilonShell)
        spp = int(s.samplesPerPixel)
        start = self._clock()
        rd0, in_shell0, contrib0, resolved = self._balanced_inputs()
        cache, key = self._cost_cache()
        rates = self._rate_cache()

        def step(scene, extra, state, gens, wstep, step0):
            return wost_depth_step(scene, state, gens, eps, step0=step0)

        out = balanced_solve(
            step, scene, None, self.eval_points, rd0, resolved, contrib0,
            in_shell0, spp=spp, max_depth=int(s.maxWalkingDepth),
            seed=run_seed(), phase=0, cost0=cache.get(key),
            cost_sink=lambda c: cache.__setitem__(key, c),
            progress=_progress, time_budget_s=time_budget_s,
            start_time=start, rate0=rates.get(self.n_pixels),
            rate_sink=lambda r: rates.__setitem__(self.n_pixels, r),
            iter0=self._iter_walls(0),
            iter_sink=lambda w: self._keep_iter_walls(0, w),
            group=self.group)
        self.sum, self.sum_sq, self.spp = out.image, out.image_sq, spp
        self.done_per_pixel = out.done if (out.done < spp).any() else None
        self.total_walk_steps = out.steps
        self.rank_walk_steps = sum(r["rank_steps"] for r in out.rounds)
        self.total_resolved = out.resolved
        self.total_capped = out.capped
        self.balance_rounds = out.rounds
        sol = out.image.cpu().numpy()              # waits for the device
        duration_ms = int((time.time() - start) * 1000)
        self._save_hints()
        self._put("SOLUTION", sol / max(spp, 1))
        return duration_ms

    def _solve_per_sample(self, time_budget_s: float | None = None) -> int:
        """The per-sample route (reference integrator.py:188-249): each
        sample walks every lane to the depth cap; writes the metric
        frames the config asks for.  Under a budget it stops between
        samples once one ran and the wall passed the budget; sample ``i``
        draws from the streams of (run seed, ``i``) either way."""
        s = self.settings
        scene = self.problem.scene
        spp = int(s.samplesPerPixel)
        seed = run_seed()
        start = time.time()
        total = torch.zeros((self.n_pixels, 3), device=self.device)
        total_sq = torch.zeros_like(total)
        steps = torch.zeros((), dtype=torch.int64, device=self.device)
        resolved = torch.zeros_like(steps)
        capped = torch.zeros_like(steps)
        done = 0
        for i in range(spp):
            if (time_budget_s is not None and done > 0
                    and time.time() - start > time_budget_s):
                log_info("uniform solve interrupted at %d/%d spp (time "
                         "budget %.1f s)", done, spp, time_budget_s)
                break
            contrib, st, res, cap = run_one_sample(
                scene, self.eval_points, self.mask,
                sample_generators(seed, i, self.device),
                eps=float(s.epsilonShell), max_depth=int(s.maxWalkingDepth))
            total += contrib
            total_sq += contrib * contrib
            steps += st
            resolved += res
            capped += cap
            done = i + 1
            if (s.saveSppMetricsDuration > 0
                    and i % s.saveSppMetricsDuration == 0
                    and i < s.saveSppMetricsUntil):
                self._dump_frames(total, i + 1, "frames", str(i))
            if s.saveTimeMetricsDuration > 0 and \
                    i % s.saveTimeMetricsDuration == 0:
                self._dump_frames(total, i + 1, "frames_time",
                                  str(int((time.time() - start) * 1000)))
            _progress(i + 1, spp)
        self.total_walk_steps = int(steps)      # waits for the device
        self.rank_walk_steps = self.total_walk_steps
        self.total_resolved = int(resolved)
        self.total_capped = int(capped)
        duration_ms = int((time.time() - start) * 1000)
        self.sum, self.sum_sq, self.spp = total, total_sq, done
        self.done_per_pixel = None
        self._put("SOLUTION", total.cpu().numpy() / max(done, 1))
        return duration_ms
