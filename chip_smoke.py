#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``elaina_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the script exits non-zero
and never prints its last line:

0. Device: the card's name and power limit from ``nvidia-smi``.  Exits
   non-zero when PyTorch sees no CUDA device.
1. Build: the Dirichlet-resolve kernels (nvcc, ``csrc/resolve.cu``) and
   the scene library (g++, ``native/scene_build.cpp``).
2. Kernels against their plain PyTorch versions, on the card, at the
   main path's shapes: 1024^2 lanes, the synthetic scene's candidate rows,
   lanes whose FinePack need bits fired after a few depth steps.
3. The mixed Dirichlet/Neumann square, u = (x + 1) / 2, through
   ``UniformIntegrator`` on the card: 256 samples of depth 64 at three
   points, each within 0.07 of u.
4. The main path at full scale through ``exec.run_expr`` (the code of
   ``python -m elaina_tpu_torch run``): a 65,536-segment Dirichlet
   boundary (a lobed outline and 62 lobed spots inside it) in a 4-segment
   Neumann box, 1024^2 frame, depth 64, eps 1.
   The kernels' launch counts are zeroed just before it and must all rise.

The lines before the last hold the card's name and power limit and one
JSON object with each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SPP = 32                     # samples of the full-scale run (phase 4)
WARM_STEPS = 3               # depth steps before phase 2 takes its mask
TIMED_RUNS = 20              # CUDA-event runs per timing (median kept)
TOL = 1e-5                   # rtol and atol of K2's d and t; K1, K3 exact
KERNEL_SOURCE = "elaina_tpu_torch/csrc/resolve.cu"
REPLACES = {"compact_lanes": "elaina_tpu/ops/pallas_resolve.py:594",
            "sweep_resolve": "elaina_tpu/ops/pallas_resolve.py:194",
            "fetch_colors": "elaina_tpu/ops/pallas_resolve.py:540"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_build() -> None:
    from elaina_tpu_torch.geometry import native
    from elaina_tpu_torch.ops import resolve

    t0 = time.time()
    resolve.library()
    t1 = time.time()
    native.library()
    t2 = time.time()
    log(f"[1] build: nvcc resolve kernels {t1 - t0:.1f} s, g++ scene "
        f"library {t2 - t1:.1f} s")
    for line in resolve.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")


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


def phase_kernels(conf_path: str, device, card: str) -> list[dict]:
    """K1-K3 against their plain versions on the main path's lanes."""
    import torch

    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.geometry.grid import fine_decode
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.solver.wost import init_walk_state, wost_depth_step
    from elaina_tpu_torch.utils import scenes as S
    from elaina_tpu_torch.utils.rng import sample_generators

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

    # lanes after a few depth steps: the need bits the main path sees
    state = init_walk_state(integ.eval_points, integ.mask)
    gens = sample_generators(0, 0, device)
    for _ in range(WARM_STEPS):
        state, _, _ = wost_depth_step(problem.scene, state, gens, S.EPS)
    row, need_f, _, outside = fine_decode(g.fine, state.pos)
    need = state.active & (need_f | outside)
    n = need.shape[0]
    n_need = int(need.sum())
    log(f"    after {WARM_STEPS} steps: {int(state.active.sum())} live "
        f"lanes of {n}, {n_need} need an exact resolve "
        f"({n_need / n:.4f} of all lanes)")
    if n_need == 0:
        raise RuntimeError("no lane needs a resolve: the mask is empty")

    results = []

    def record(name, err, ms, plain_ms):
        results.append({"name": name, "route": "cuda",
                        "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        log(f"    {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms (median of {TIMED_RUNS}; {card})")

    # K1: exact ids and count, with cap = n (the main path) and cap < count
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
    record("compact_lanes", 0.0, cuda_ms(lambda: R.compact_lanes(need, n)),
           cuda_ms(lambda: R.compact_lanes_plain(need, n)))

    # K2: the compacted lanes, as _fast_dirichlet hands them over
    valid = torch.arange(n, device=device) < cnt
    safe = torch.where(valid, lanes, 0).long()
    q_c = state.pos[safe].contiguous()
    row_c = row[safe].contiguous()
    args = (valid, row_c, q_c, g.coords, g.cand)
    d, t, side, pid = R.sweep_resolve(*args)
    d_p, t_p, side_p, pid_p = R.sweep_resolve_plain(*args)
    v = valid
    err = max(float((d[v] - d_p[v]).abs().max()),
              float((t[v] - t_p[v]).abs().max()))
    if not (torch.allclose(d[v], d_p[v], rtol=TOL, atol=TOL)
            and torch.allclose(t[v], t_p[v], rtol=TOL, atol=TOL)):
        raise RuntimeError(f"sweep_resolve d/t differ: {err}")
    # the winner: same prim, except at an exact tie of distances
    differ = v & (pid != pid_p)
    if bool((differ & (d != d_p)).any()):
        raise RuntimeError("sweep_resolve picked another prim")
    big = v & (side_p.abs() > TOL) & (pid == pid_p)
    if bool((torch.sign(side[big]) != torch.sign(side_p[big])).any()):
        raise RuntimeError("sweep_resolve side differs")
    log(f"    sweep_resolve: {int(differ.sum())} exact ties picked another "
        f"prim of {n_need}")
    record("sweep_resolve", err, cuda_ms(lambda: R.sweep_resolve(*args)),
           cuda_ms(lambda: R.sweep_resolve_plain(*args)))

    # K3: the in-shell lanes' colors, exact
    ins = v & (d < S.EPS) & (t > 0.0) & (t < 1.0)
    cfi = torch.where(ins, 2 * torch.clamp(pid, min=0) + (side < 0).int(),
                      0).to(torch.int32)
    cargs = (ins, cfi, g.color_rows)
    c0, c1 = R.fetch_colors(*cargs)
    c0_p, c1_p = R.fetch_colors_plain(*cargs)
    if not (torch.equal(c0, c0_p) and torch.equal(c1, c1_p)):
        raise RuntimeError("fetch_colors differs from the plain version")
    log(f"    fetch_colors: {int(ins.sum())} in-shell lanes")
    record("fetch_colors", 0.0, cuda_ms(lambda: R.fetch_colors(*cargs)),
           cuda_ms(lambda: R.fetch_colors_plain(*cargs)))
    return results


def square_side(sides, n_per_side=6):
    corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    verts, idx = [], []
    for s in sides:
        a, b = corners[s], corners[(s + 1) % 4]
        base = len(verts)
        verts.extend(a + np.linspace(0, 1, n_per_side + 1)[:, None] * (b - a))
        idx.extend((base + i, base + i + 1) for i in range(n_per_side))
    return np.asarray(verts, np.float32), np.asarray(idx, np.int32)


def phase_analytic(device, card: str) -> None:
    """Dirichlet u = (x+1)/2 on two walls, zero Neumann on the others."""
    import torch

    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.core.problem import (Problem, grid_bounds,
                                               grid_size_for,
                                               scene_from_numpy)
    from elaina_tpu_torch.geometry.grid import build_candidate_grid
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

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
    settings = IntegratorSettings(frameSize=(3, 1), samplesPerPixel=256,
                                  maxWalkingDepth=64, epsilonShell=0.02)
    integ = UniformIntegrator(problem, settings, "unused",
                              points=torch.as_tensor(pts, device=device))
    ms = integ.solve()
    if integ.sum.device.type != "cuda":
        raise RuntimeError("the analytic solve did not run on the card")
    u = integ.films["SOLUTION"].pixels()[0, :, 0]
    want = (pts[:, 0] + 1) / 2
    log(f"[3] mixed-BC square: u {np.round(u, 4).tolist()} vs "
        f"{want.tolist()} (atol 0.07), {ms} ms ({card})")
    if not np.all(np.abs(u - want) <= 0.07):
        raise RuntimeError("analytic square out of bound")


def check_solution(conf_path: str) -> tuple:
    """The exported solution: finite, not all zero, and nonzero on average
    both inside the curve and in the Neumann region between curve and box.
    Returns (mean |u| inside, pixels, mean |u| between, pixels)."""
    import torch

    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid
    from elaina_tpu_torch.output.image_io import read_exr
    from elaina_tpu_torch.utils import scenes as S

    with open(conf_path) as f:
        conf = json.load(f)
    w, h = conf["integrator"]["setting"]["frameSize"]
    out = os.path.join(conf["base_path"], conf["exp_name"])
    sol = read_exr(os.path.join(out, "solution.exr"))[..., :3]
    if sol.shape != (h, w, 3) or not np.isfinite(sol).all():
        raise RuntimeError(f"solution {sol.shape} is not finite")
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


def phase_main(conf_path: str, card: str) -> dict:
    import torch

    from elaina_tpu_torch.exec import run_expr
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.utils import scenes as S

    R.reset_launch_counts()
    t0 = time.time()
    result = run_expr(conf_path)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k.__name__: k.launches for k in R.KERNELS}
    if result.get("device", "").split(":")[0] != "cuda":
        raise RuntimeError(f"main path ran on {result.get('device')}")
    if not all(launches.values()):
        raise RuntimeError(f"a kernel was never launched: {launches}")
    m_in, n_in, m_out, n_out = check_solution(conf_path)
    steps = result["walk_steps"]
    rate = steps / (result["duration"] / 1e3)
    log(f"[4] main path ({card}): {SPP} spp, {S.FRAME}x{S.FRAME}, depth "
        f"{S.DEPTH},"
        f" solve {result['duration']} ms, wall {wall:.1f} s (load + solve +"
        f" export)")
    log(f"    walk steps {steps}, {rate:.6g} walk-steps/s ({card}); need "
        f"fraction {result['resolved_lanes'] / steps:.4f} of live lane-steps")
    log(f"    tables {result['table_bytes']} bytes; peak device memory "
        f"{result['peak_device_bytes']} bytes ({card})")
    log(f"    mean |u| inside the curve {m_in:.4f} ({n_in} px), in the "
        f"Neumann region {m_out:.4f} ({n_out} px)")
    log(f"    launches {launches}")
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
    with tempfile.TemporaryDirectory() as root:
        os.environ["ELAINA_CACHE_DIR"] = os.path.join(root, "cache")
        conf_path = scenes.write_scene(root, SPP)
        kernels = phase_kernels(conf_path, device, card)
        torch.cuda.empty_cache()
        phase_analytic(device, card)
        launches = phase_main(conf_path, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[5] chip_smoke.py: {time.time() - t_start:.1f} s in all ({card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
