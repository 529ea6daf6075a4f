#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``elaina_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the script exits non-zero
and never prints its last line:

0. Device: the card's name and power limit from ``nvidia-smi``.  Exits
   non-zero when PyTorch sees no CUDA device.
1. Build, all at once: the resolve kernels (nvcc, ``csrc/resolve.cu``),
   the Neumann band kernels (nvcc, ``csrc/queries.cu``) and the scene
   library (g++, ``native/scene_build.cpp``).
2. 2D kernels K1-K3 against their plain PyTorch versions, on the card, at
   the 2D main path's shapes: 1024^2 lanes, the synthetic scene's
   candidate rows, lanes whose FinePack need bits fired after a few depth
   steps.
3. The mixed Dirichlet/Neumann square, u = (x + 1) / 2, through
   ``UniformIntegrator``: 256 walks of depth 64 at three points (64 lanes
   a point, 4 samples), each point within 0.07 of u.
4. The 2D main path at full scale through ``exec.run_expr`` (the code of
   ``python -m elaina_tpu_torch run``): a 65,536-segment Dirichlet
   boundary (a lobed outline and 62 lobed spots inside it) in a 4-segment
   Neumann box, 1024^2 frame, depth 64, eps 1.  The kernels' launch counts
   are zeroed just before it and K1-K3's must rise.
5. 3D kernels K1, K4, K5, K6, K9 against their plain versions, at the 3D
   main path's shapes: the neumann3d scene (768-triangle Dirichlet cube,
   20,480-triangle Neumann blob) loaded with its grids (each build's
   seconds printed), 65,536 lanes after a few depth steps.
6. The mixed cube, u = (x + 1) / 2 (Dirichlet x = +-1, zero Neumann on the
   other faces), through ``Problem.load_config`` and ``UniformIntegrator``:
   1,024 walks at each of three points, depth 256 (walks stall by the
   Neumann-Neumann edges), each within 0.07 of u.  It runs K6 and K9 too.
7. bumpy3d_u through ``exec.run_expr`` from a copy of
   ``configs/bumpy3d_u.json`` (20,480 triangles, 256^2, eps 0.01, 64 spp,
   SOLUTION), at the config's depth 64 and at depth 256: RMSE and mean
   error against the analytic h = 0.5 + 0.4 (x^2 - y^2), printed for
   both, within 0.05 and 0.015 at depth 256.  At depth 64 enough walks
   meet the cap to leave the mean low (the FinePack's cell-wide bounds
   slow the walks near the surface, as the reference's do; PERF.md).
8. The 3D main path, neumann3d_u, through ``exec.run_expr`` from a copy
   of ``configs/neumann3d_u.json`` (256^2, depth 64, eps 0.01, 64 spp,
   SOLUTION): finite, mean in (0.2, 0.8); the launch counts are zeroed
   just before it and K1, K4, K5, K6 and K9's must rise.

The lines before the last hold the card's name and power limit and one
JSON object with each kernel's launches, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SPP = 32                     # samples of the 2D main path (phase 4)
SPP_3D = 64                  # samples of bumpy3d_u and neumann3d_u (the
#                              configs')
BUMPY_DEPTH = 256            # bumpy3d_u's depth in phase 7 (the config: 64)
WARM_STEPS = 3               # depth steps before the kernel phases take lanes
TIMED_RUNS = 20              # CUDA-event runs per timing (median kept)
TOL = 1e-5                   # rtol and atol of distances; ids and colors exact
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_S = 67e12          # H100 SXM float32 rate outside the tensor cores
RESOLVE_SOURCE = "elaina_tpu_torch/csrc/resolve.cu"
QUERIES_SOURCE = "elaina_tpu_torch/csrc/queries.cu"
KERNELS = {   # name -> (source, TPU kernel it replaces)
    "compact_lanes": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:594"),
    "sweep_resolve": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:194"),
    "fetch_colors": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:540"),
    "sweep_resolve_3d": (RESOLVE_SOURCE,
                         "elaina_tpu/ops/pallas_resolve.py:352"),
    "fetch_colors3": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:554"),
    "band_neumann_walk": (QUERIES_SOURCE,
                          "elaina_tpu/ops/pallas_queries.py:1043"),
    "sil_band": (QUERIES_SOURCE, "elaina_tpu/ops/pallas_queries.py:622"),
}
MAIN_2D = ("compact_lanes", "sweep_resolve", "fetch_colors")
MAIN_3D = ("compact_lanes", "sweep_resolve_3d", "fetch_colors3",
           "band_neumann_walk", "sil_band")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def all_kernels():
    from elaina_tpu_torch.ops import queries, resolve

    return {k.__name__: k for k in resolve.KERNELS + queries.KERNELS}


def reset_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


# --------------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------------- #


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of ``fn()`` over CUDA-event-timed runs."""
    import torch

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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it: the
    bytes the function must move at the memory rate, or its float32
    operations at the peak rate outside the tensor cores."""
    t_b = n_bytes / HBM_BYTES_S * 1e3
    t_f = flops / F32_FLOPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def n_unique(x) -> int:
    import torch

    return int(torch.unique(x).numel())


class Kernels:
    """The ``kernels`` line: one record per kernel checked."""

    def __init__(self, card: str):
        self.card = card
        self.records: dict[str, dict] = {}

    def add(self, name, err, fn, plain, library, n_bytes, flops):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain)
        library_ms = cuda_ms(library) if library is not None else None
        bound_ms, bound_by = bound(n_bytes, flops)
        source, replaces = KERNELS[name]
        self.records[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"    {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} ms "
            f"({bound_by}; median of {TIMED_RUNS}; {self.card})")


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_build() -> None:
    from elaina_tpu_torch.geometry import native
    from elaina_tpu_torch.ops import queries, resolve

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        futures = [pool.submit(timed, f) for f in (
            resolve.library, queries.library, native.library)]
        secs = [f.result() for f in futures]
    log(f"[1] build: nvcc resolve kernels {secs[0]:.1f} s, nvcc band "
        f"kernels {secs[1]:.1f} s, g++ scene library {secs[2]:.1f} s (in "
        f"parallel)")
    for lib in (resolve, queries):
        for line in lib.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def warm_state(problem, integ, eps: float):
    """The walk state after WARM_STEPS depth steps of one sample."""
    from elaina_tpu_torch.solver.wost import init_walk_state, wost_depth_step
    from elaina_tpu_torch.utils.rng import sample_generators

    state = init_walk_state(integ.eval_points, integ.mask)
    gens = sample_generators(0, 0, problem.device)
    for _ in range(WARM_STEPS):
        state, _, _ = wost_depth_step(problem.scene, state, gens, eps)
    return state


def need_lanes(g, state, n: int):
    """The FinePack need mask of a state and its compacted lanes (K1)."""
    import torch

    from elaina_tpu_torch.geometry.grid import fine_decode
    from elaina_tpu_torch.ops import resolve as R

    row, need_f, _, outside = fine_decode(g.fine, state.pos)
    need = state.active & (need_f | outside)
    n_need = int(need.sum())
    log(f"    after {WARM_STEPS} steps: {int(state.active.sum())} live "
        f"lanes of {n}, {n_need} need an exact resolve "
        f"({n_need / n:.4f} of all lanes)")
    if n_need == 0:
        raise RuntimeError("no lane needs a resolve: the mask is empty")
    lanes, cnt = R.compact_lanes(need, n)
    lanes_p, cnt_p = R.compact_lanes_plain(need, n)
    if int(cnt) != n_need or int(cnt_p) != n_need:
        raise RuntimeError(f"compact_lanes count {int(cnt)} != {n_need}")
    if not torch.equal(lanes[:n_need], lanes_p[:n_need]):
        raise RuntimeError("compact_lanes ids differ from the plain version")
    cap = n_need // 2
    l2, c2 = R.compact_lanes(need, cap)
    if int(c2) != n_need or not torch.equal(l2, lanes_p[:cap]):
        raise RuntimeError("compact_lanes past cap differs")
    valid = torch.arange(n, device=need.device) < cnt
    safe = torch.where(valid, lanes, 0).long()
    return need, n_need, valid, state.pos[safe].contiguous(), \
        row[safe].contiguous()


def check_sweep(d, d_p, pid, pid_p, v, label: str) -> float:
    """Distances within TOL; the same prim except at an exact tie."""
    import torch

    err = float((d[v] - d_p[v]).abs().max())
    if not torch.allclose(d[v], d_p[v], rtol=TOL, atol=TOL):
        raise RuntimeError(f"{label} distances differ: {err}")
    differ = v & (pid != pid_p)
    if bool((differ & (d != d_p)).any()):
        raise RuntimeError(f"{label} picked another prim")
    log(f"    {label}: {int(differ.sum())} exact ties picked another prim "
        f"of {int(v.sum())}")
    return err


def phase_kernels(conf_path: str, device, kernels: Kernels) -> None:
    """K1-K3 against their plain versions on the 2D main path's lanes."""
    import torch

    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.utils import scenes as S

    cfg = ExperimentConfig.from_file(conf_path)
    t0 = time.time()
    problem = Problem(2, device, verbose=False).load_config(
        cfg.scene, cache_dir=os.environ["ELAINA_CACHE_DIR"])
    integ = UniformIntegrator(problem, cfg.settings, "unused")
    torch.cuda.synchronize()
    g = problem.scene.d_grid
    log(f"[2] scene: {problem.stats['dirichlet_grid']}, fine res "
        f"{g.fine.res}, tables {problem.table_bytes()} bytes, built in "
        f"{time.time() - t0:.1f} s")
    state = warm_state(problem, integ, S.EPS)
    n = state.pos.shape[0]
    need, n_need, valid, q_c, row_c = need_lanes(g, state, n)
    kernels.add("compact_lanes", 0.0, lambda: R.compact_lanes(need, n),
                lambda: R.compact_lanes_plain(need, n),
                lambda: torch.nonzero(need), n + 4 * n_need + 4, 0.0)

    # K2: the compacted lanes, as _fast_dirichlet hands them over
    args = (valid, row_c, q_c, g.coords, g.cand)
    d, t, side, pid = R.sweep_resolve(*args)
    d_p, t_p, side_p, pid_p = R.sweep_resolve_plain(*args)
    v = valid
    err = max(check_sweep(d, d_p, pid, pid_p, v, "sweep_resolve"),
              float((t[v] - t_p[v]).abs().max()))
    if not torch.allclose(t[v], t_p[v], rtol=TOL, atol=TOL):
        raise RuntimeError(f"sweep_resolve t differs: {err}")
    big = v & (side_p.abs() > TOL) & (pid == pid_p)
    if bool((torch.sign(side[big]) != torch.sign(side_p[big])).any()):
        raise RuntimeError("sweep_resolve side differs")
    Kp = g.coords.shape[2]
    rows = n_unique(row_c[v])
    kernels.add("sweep_resolve", err, lambda: R.sweep_resolve(*args),
                lambda: R.sweep_resolve_plain(*args), None,
                n + n_need * (4 + 8 + 4 + 16) + rows * 4 * Kp * 4,
                20.0 * n_need * g.cand.shape[1])

    # K3: the in-shell lanes' colors, exact
    ins = v & (d < S.EPS) & (t > 0.0) & (t < 1.0)
    cfi = torch.where(ins, 2 * torch.clamp(pid, min=0) + (side < 0).int(),
                      0).to(torch.int32)
    cargs = (ins, cfi, g.color_rows)
    c0, c1 = R.fetch_colors(*cargs)
    c0_p, c1_p = R.fetch_colors_plain(*cargs)
    if not (torch.equal(c0, c0_p) and torch.equal(c1, c1_p)):
        raise RuntimeError("fetch_colors differs from the plain version")
    n_ins = int(ins.sum())
    log(f"    fetch_colors: {n_ins} in-shell lanes")
    kernels.add("fetch_colors", 0.0, lambda: R.fetch_colors(*cargs),
                lambda: R.fetch_colors_plain(*cargs),
                lambda: g.color_rows[cfi],
                n * 5 + n_unique(cfi[ins]) * 24 + n_ins * 24, 0.0)


def square_side(sides, n_per_side=6):
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    verts, idx = [], []
    for s in sides:
        a, b = corners[s], corners[(s + 1) % 4]
        base = len(verts)
        verts.extend(a + np.linspace(0, 1, n_per_side + 1)[:, None] * (b - a))
        idx.extend((base + i, base + i + 1) for i in range(n_per_side))
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def solve_points(problem, pts: np.ndarray, reps: int, spp: int, depth: int,
                 eps: float):
    """Means at ``pts`` over reps x spp walks through UniformIntegrator."""
    import torch

    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0),
                            device=problem.device)
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=depth,
                                  epsilonShell=eps)
    integ = UniformIntegrator(problem, settings, "unused", points=lanes)
    ms = integ.solve()
    if integ.sum.device.type != "cuda":
        raise RuntimeError("the analytic solve did not run on the card")
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(len(pts), reps)
    return u.mean(1), ms, integ.total_capped / (len(lanes) * spp)


def phase_analytic(device, card: str) -> None:
    """Dirichlet u = (x+1)/2 on two walls, zero Neumann on the others."""
    from elaina_tpu_torch.core.problem import (Problem, grid_bounds,
                                               grid_size_for,
                                               scene_from_numpy)
    from elaina_tpu_torch.geometry.grid import build_candidate_grid

    dv, di = square_side((1, 3))
    nv, ni = square_side((0, 2))
    dc = np.broadcast_to(((dv[:, 0] + 1) / 2)[:, None, None],
                         (len(dv), 2, 3)).astype(np.float32)
    lo, hi = grid_bounds(dv, [-1, -1], [1, 1])
    K, max_res = grid_size_for(len(di))
    ga = build_candidate_grid(dv, di, lo, hi, K=K, max_res=max_res)
    problem = Problem(2, device, verbose=False)
    problem.scene = scene_from_numpy(
        aabb_lo=[-1, -1], aabb_hi=[1, 1], device=device,
        dirichlet=(dv, di, dc), neumann=(nv, ni, np.zeros((len(nv), 2, 3))),
        grid=vars(ga))
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8]], np.float32)
    u, ms, _ = solve_points(problem, pts, 64, 4, 64, 0.02)
    want = (pts[:, 0] + 1) / 2
    log(f"[3] mixed-BC square: u {np.round(u, 4).tolist()} vs "
        f"{want.tolist()} (atol 0.07), {ms} ms ({card})")
    if not np.all(np.abs(u - want) <= 0.07):
        raise RuntimeError("analytic square out of bound")


def check_solution(conf_path: str) -> tuple:
    """The exported 2D solution: finite, not all zero, and nonzero on
    average both inside the curve and in the Neumann region between curve
    and box.  Returns (mean |u| inside, pixels, mean |u| between, pixels)."""
    import torch

    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid
    from elaina_tpu_torch.utils import scenes as S

    sol = read_solution(conf_path)
    with open(conf_path) as f:
        conf = json.load(f)
    w, h = conf["integrator"]["setting"]["frameSize"]
    if not (sol != 0).any():
        raise RuntimeError("solution is all zero")
    probe = EvaluationGrid.from_json(conf["scene"]["evaluation_grid"], 2)
    rel = probe.points(torch.arange(w * h), (w, h)).numpy() - S.CENTER
    r = np.hypot(rel[:, 0], rel[:, 1])
    r_curve = S.outline_radius(np.arctan2(rel[:, 1], rel[:, 0]))
    flat = np.abs(sol.reshape(-1, 3))
    inside, between = r < r_curve - 2, r > r_curve + 2
    m_in = float(flat[inside].mean())
    m_out = float(flat[between].mean())
    if not (inside.mean() > 0.1 and between.mean() > 0.1
            and m_in > 0.05 and m_out > 0.05):
        raise RuntimeError(f"a region was not walked: inside {m_in}, "
                           f"Neumann region {m_out}")
    return m_in, int(inside.sum()), m_out, int(between.sum())


def read_solution(conf_path: str) -> np.ndarray:
    """The exported solution image (H, W, 3), checked finite."""
    from elaina_tpu_torch.output.image_io import read_exr

    with open(conf_path) as f:
        conf = json.load(f)
    w, h = conf["integrator"]["setting"]["frameSize"]
    sol = read_exr(os.path.join(conf["base_path"], conf["exp_name"],
                                "solution.exr"))[..., :3]
    if sol.shape != (h, w, 3) or not np.isfinite(sol).all():
        raise RuntimeError(f"solution {sol.shape} is not finite")
    return sol


def run_main(conf_path: str, expect: tuple, label: str, card: str) -> tuple:
    """``run_expr`` with the launch counts zeroed just before it; the
    kernels of ``expect`` must all have launched."""
    import torch

    from elaina_tpu_torch.exec import run_expr

    reset_counts()
    t0 = time.time()
    result = run_expr(conf_path)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    if result.get("device", "").split(":")[0] != "cuda":
        raise RuntimeError(f"{label} ran on {result.get('device')}")
    if not all(launches[k] for k in expect):
        raise RuntimeError(f"a kernel of {label} was never launched: "
                           f"{launches}")
    with open(conf_path) as f:
        st = json.load(f)["integrator"]["setting"]
    steps = result["walk_steps"]
    rate = steps / (result["duration"] / 1e3)
    walks = st["frameSize"][0] * st["frameSize"][1] * st["samplesPerPixel"]
    log(f"    {label} ({card}): {st['samplesPerPixel']} spp, "
        f"{st['frameSize'][0]}x{st['frameSize'][1]}, depth "
        f"{st['maxWalkingDepth']}, solve {result['duration']} ms, wall "
        f"{wall:.1f} s (load + solve + export)")
    log(f"    walk steps {steps}, {rate:.6g} walk-steps/s ({card}); need "
        f"fraction {result['resolved_lanes'] / steps:.4f} of live "
        f"lane-steps; depth-capped walks {result['capped_walks']} of "
        f"{walks} ({result['capped_walks'] / walks:.4f})")
    log(f"    tables {result['table_bytes']} bytes; peak device memory "
        f"{result['peak_device_bytes']} bytes ({card})")
    log(f"    launches {launches}")
    return launches, result


def phase_main(conf_path: str, card: str) -> dict:
    log("[4] 2D main path")
    launches, _ = run_main(conf_path, MAIN_2D, "lobed_u", card)
    m_in, n_in, m_out, n_out = check_solution(conf_path)
    log(f"    mean |u| inside the curve {m_in:.4f} ({n_in} px), in the "
        f"Neumann region {m_out:.4f} ({n_out} px)")
    return launches


def phase_kernels_3d(conf_path: str, device, kernels: Kernels) -> None:
    """K1, K4, K5 on the cube's need lanes and K6, K9 on every lane over
    the blob's grids, against their plain versions."""
    import torch

    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.geometry.primitives import prim_project, prim_side
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.solver.wost import _sample_direction, _separate

    cfg = ExperimentConfig.from_file(conf_path)
    eps = float(cfg.settings.epsilonShell)
    t0 = time.time()
    problem = Problem(3, device, verbose=False).load_config(
        cfg.scene, cache_dir=os.environ["ELAINA_CACHE_DIR"])
    integ = UniformIntegrator(problem, cfg.settings, "unused")
    torch.cuda.synchronize()
    log(f"[5] neumann3d scene loaded in {time.time() - t0:.1f} s")
    for key in ("dirichlet_grid", "neumann_sil_grid", "neumann_band_grid"):
        log(f"    build {key}: {problem.stats[key]}")
    scene = problem.scene
    g = scene.d_grid
    log(f"    fine res {g.fine.res}, tables {problem.table_bytes()} bytes")
    state = warm_state(problem, integ, eps)
    n = state.pos.shape[0]

    # K4 on the need lanes, compacted by K1 as _fast_dirichlet does
    need, n_need, valid, q_c, row_c = need_lanes(g, state, n)
    args = (valid, row_c, q_c, g.coords, g.cand)
    d, pid, corners = R.sweep_resolve_3d(*args)
    d_p, pid_p, corners_p = R.sweep_resolve_3d_plain(*args)
    v = valid
    err = check_sweep(d, d_p, pid, pid_p, v, "sweep_resolve_3d")
    same = v & (pid == pid_p)
    if not torch.equal(corners[same], corners_p[same]):
        raise RuntimeError("sweep_resolve_3d corners differ")
    Kp = g.coords.shape[2]
    kernels.add("sweep_resolve_3d", err, lambda: R.sweep_resolve_3d(*args),
                lambda: R.sweep_resolve_3d_plain(*args), None,
                n + n_need * (4 + 12 + 4 + 4 + 36)
                + n_unique(row_c[v]) * 9 * Kp * 4,
                120.0 * n_need * g.cand.shape[1])

    # K5 on the in-shell lanes
    pv = (corners[:, 0:3], corners[:, 3:6], corners[:, 6:9])
    uv = prim_project(3, q_c, pv)
    side = prim_side(3, q_c, pv)
    ins = v & (d < eps) & (uv[:, 0] > 0) & (uv[:, 1] > 0) & (uv.sum(1) < 1)
    cfi = torch.where(ins, 2 * torch.clamp(pid, min=0) + (side < 0).int(),
                      0).to(torch.int32)
    cargs = (ins, cfi, g.color_rows)
    if not all(torch.equal(a, b) for a, b in zip(
            R.fetch_colors3(*cargs), R.fetch_colors3_plain(*cargs))):
        raise RuntimeError("fetch_colors3 differs from the plain version")
    n_ins = int(ins.sum())
    log(f"    fetch_colors3: {n_ins} in-shell lanes")
    kernels.add("fetch_colors3", 0.0, lambda: R.fetch_colors3(*cargs),
                lambda: R.fetch_colors3_plain(*cargs),
                lambda: g.color_rows[cfi],
                n * 5 + n_unique(cfi[ins]) * 36 + n_ins * 36, 0.0)

    # K9 on every lane, as _separate calls it
    sg, bg = scene.n_sgrid, scene.n_bgrid
    lin, outside = Q.band_cell(sg, state.pos)
    cell = torch.where(outside, -1, lin).to(torch.int32)
    q = state.pos.contiguous()
    d2 = QK.sil_band(cell, q, sg.coords)
    d2_p = QK.sil_band_plain(cell, q, sg.coords)
    fin = torch.isfinite(d2_p)
    if not torch.equal(torch.isfinite(d2), fin):
        raise RuntimeError("sil_band: found / none differ")
    err = float((d2[fin] - d2_p[fin]).abs().max())
    if not torch.allclose(d2[fin], d2_p[fin], rtol=TOL, atol=0.0):
        raise RuntimeError(f"sil_band differs: {err}")
    n_in = int((cell >= 0).sum())
    log(f"    sil_band: {n_in} lanes in the grid of {n}")
    sKp = sg.coords.shape[2]
    kernels.add("sil_band", err, lambda: QK.sil_band(cell, q, sg.coords),
                lambda: QK.sil_band_plain(cell, q, sg.coords), None,
                n * (4 + 12 + 4) + n_unique(cell[cell >= 0]) * 12 * sKp * 4,
                40.0 * n_in * sKp)

    # K6 on every lane with this step's star radii, fresh uniforms and
    # directions, as _neumann_walk_fused calls it; then on the same lanes
    # with radii of 0.05 to 1, which reach the blob: the star radii stay
    # below the distance to the blob (its band cells' r_cap clamps them),
    # so at the main path's radii the sample and the rays find nothing
    _, R_B, _, _, _ = _separate(scene, state, eps, shrink=True)
    rcap = Q.band_r_cap(bg, state.pos)
    log(f"    star radii: median {float(R_B.median()):.5f}, at the 1e-4 "
        f"floor {float((R_B < 1.0001e-4).float().mean()):.4f} of the "
        f"lanes; band r_cap below 2 eps at "
        f"{float((rcap < 2 * eps).float().mean()):.4f} of the lanes")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    u_sel = torch.rand(n, generator=gen, device=device)
    u_pt = torch.rand((n, 2), generator=gen, device=device)
    direction, _, _ = _sample_direction(gen, state, 3, True)
    lin, outside = Q.band_cell(bg, state.pos)
    cell = torch.where(outside, -1, lin).to(torch.int32)
    inn = cell >= 0
    n_in = int(inn.sum())

    def band_args(radii):
        return (cell, q, radii.contiguous(), state.on_neumann.contiguous(),
                state.n_normal.contiguous(), u_sel, u_pt,
                direction.contiguous(), eps, bg.coords)

    err = 0.0
    wide = 0.05 + 0.95 * torch.rand(n, generator=gen, device=device)
    for label, radii in (("star radii", R_B), ("radii 0.05-1", wide)):
        kargs = band_args(radii)
        out, slot = QK.band_neumann_walk(*kargs)
        out_p, slot_p = QK.band_neumann_walk_plain(*kargs)
        same = inn & (slot == slot_p)
        flips = int((inn & ~same).sum())
        if flips > 0.005 * n_in:
            raise RuntimeError(f"band_neumann_walk: {flips} CDF slots "
                               f"differ")
        a, b = out[same], out_p[same]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise RuntimeError("band_neumann_walk: inf / finite differ")
        both = torch.isfinite(a)
        e = float((a[both] - b[both]).abs().max())
        if not torch.allclose(a[both], b[both], rtol=TOL, atol=1e-6):
            raise RuntimeError(f"band_neumann_walk differs: {e}")
        err = max(err, e)
        log(f"    band_neumann_walk, {label}: {n_in} lanes in the grid, "
            f"{int(((out[:, 0] > 0) & inn).sum())} with a sample, "
            f"{int((out[:, 9] > 0).sum())} occluded, "
            f"{int((out[:, 10] > 0).sum())} walk hits, {flips} CDF slots "
            f"flipped against the plain cumsum")
    kargs = band_args(R_B)
    bKp = bg.coords.shape[2]
    kernels.add("band_neumann_walk", err,
                lambda: QK.band_neumann_walk(*kargs),
                lambda: QK.band_neumann_walk_plain(*kargs), None,
                n * (4 + 12 + 4 + 1 + 12 + 4 + 8 + 12 + 60 + 4)
                + n_unique(cell[inn]) * 9 * bKp * 4,
                200.0 * n_in * bKp)


def phase_analytic_3d(root: str, device, card: str) -> None:
    """The mixed cube through the 3D loader and UniformIntegrator."""
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.utils import scenes as S

    problem = Problem(3, device, verbose=False).load_config(
        S.write_mixed_cube(root), cache_dir=os.environ["ELAINA_CACHE_DIR"])
    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [-0.6, 0.3, 0.4]],
                   np.float32)
    u, ms, capped = solve_points(problem, pts, 1024, 1, 256, 0.02)
    want = (pts[:, 0] + 1) / 2
    log(f"[6] mixed-BC cube: u {np.round(u, 4).tolist()} vs "
        f"{want.tolist()} (atol 0.07), {ms} ms, depth-capped share "
        f"{capped:.4f} ({card})")
    if not np.all(np.abs(u - want) <= 0.07):
        raise RuntimeError("analytic cube out of bound")


def bumpy_errors(conf_path: str) -> tuple[float, float]:
    """(RMSE, mean error) of the exported bumpy3d solution against h."""
    sol = read_solution(conf_path)
    n = sol.shape[0]
    xs = 2 * np.arange(n) / n - 1.0
    X, Y = np.meshgrid(xs * 0.6, xs * 0.6, indexing="xy")
    err = sol[..., 0] - (0.5 + 0.4 * (X ** 2 - Y ** 2))
    return float(np.sqrt((err ** 2).mean())), float(err.mean())


def phase_bumpy(conf_path: str, card: str) -> None:
    """bumpy3d_u at the config's depth (a reading) and at BUMPY_DEPTH
    (bounded)."""
    log("[7] bumpy3d_u")
    with open(conf_path) as f:
        conf = json.load(f)
    for depth in (conf["integrator"]["setting"]["maxWalkingDepth"],
                  BUMPY_DEPTH):
        conf["integrator"]["setting"]["maxWalkingDepth"] = depth
        with open(conf_path, "w") as f:
            json.dump(conf, f)
        run_main(conf_path, ("sweep_resolve_3d",), "bumpy3d_u", card)
        rmse, bias = bumpy_errors(conf_path)
        log(f"    depth {depth} against h: RMSE {rmse:.5f}, mean error "
            f"{bias:.5f} ({card})")
    scale = (64 / SPP_3D) ** 0.5
    log(f"    bounds at depth {BUMPY_DEPTH}: RMSE {0.05 * scale}, mean "
        f"error {0.015 * scale}")
    if not (rmse < 0.05 * scale and abs(bias) < 0.015 * scale):
        raise RuntimeError("bumpy3d_u out of its analytic bounds")


def phase_main_3d(conf_path: str, card: str) -> dict:
    log("[8] 3D main path")
    launches, _ = run_main(conf_path, MAIN_3D, "neumann3d_u", card)
    mean = float(read_solution(conf_path).mean())
    log(f"    mean u {mean:.5f} (within (0.2, 0.8))")
    if not 0.2 < mean < 0.8:
        raise RuntimeError("neumann3d_u mean out of the boundary data's hull")
    return launches


def main() -> int:
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from elaina_tpu_torch.utils import scenes  # fails outside a checkout

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    log(f"[0] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    kernels = Kernels(card)
    with tempfile.TemporaryDirectory() as root:
        os.environ["ELAINA_CACHE_DIR"] = os.path.join(root, "cache")
        conf_2d = scenes.write_scene(root, SPP)
        phase_kernels(conf_2d, device, kernels)
        torch.cuda.empty_cache()
        phase_analytic(device, card)
        launches_2d = phase_main(conf_2d, card)
        torch.cuda.empty_cache()
        conf_3d = scenes.write_config_copy(root, "neumann3d_u", SPP_3D)
        phase_kernels_3d(conf_3d, device, kernels)
        torch.cuda.empty_cache()
        phase_analytic_3d(root, device, card)
        phase_bumpy(scenes.write_config_copy(root, "bumpy3d_u", SPP_3D),
                    card)
        torch.cuda.empty_cache()
        launches_3d = phase_main_3d(conf_3d, card)
    for name, rec in kernels.records.items():
        rec["launches"] = (launches_2d if name in MAIN_2D
                           else launches_3d)[name]
    log(f"[9] chip_smoke.py: {time.time() - t_start:.1f} s in all ({card})")
    print(card)
    print(json.dumps({"kernels": [kernels.records[k] for k in KERNELS
                                  if k in kernels.records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
