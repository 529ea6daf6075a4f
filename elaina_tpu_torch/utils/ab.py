"""A/B of two checkouts of the port on one card, in turns.

    python -m elaina_tpu_torch.utils.ab --tree parent=<dir> \\
        --tree change=<dir> \\
        --order parent,change,change,parent,parent,change [--out <file>] \\
        [--gathered parent]

Each tree is a checkout of the repository, for example ``git archive`` of
a commit unpacked into a directory that ``.gitignore`` lists.  At every
turn of ``--order`` the named tree runs, each in a process of its own:

1. lobed_u (``utils/scenes.write_scene``, 32 spp), neumann3d_u
   (``configs/neumann3d_u.json`` as shipped, 64 spp), nogrid_u
   (``chip_smoke.py``'s: bench.py's curve at 256 segments, no grid, in
   the 4-segment box, 8 spp), neumann3d_source (neumann3d_u with a
   volumetric source, ``utils/scenes.write_neumann3d_source``, 64 spp),
   wavy8192_u (the lobed scene in a wavy Neumann box of 8,192 segments,
   its 2D band grids, 8 spp) and neumann3d_unfused (neumann3d_u at 64 spp
   with ``ELAINA_FUSED_BAND=0``: K8 and K7 in place of K6) through
   ``python -m elaina_tpu_torch run``: walk_steps / duration of
   ``result.json``.  A tree's first turn starts on a cold ``_build/``;
2. bench.py's own scene (``bench_square``: 2,048 segments, no grid,
   1024^2, depth 64, 4 spp) and nogrid_u through the tree's
   ``UniformIntegrator`` in a process of their own, each solved twice:
   the first solve (``walk_steps_s``, what a fresh process pays, as the
   CLI's) and the second (``warm_walk_steps_s``, as ``chip_smoke.py``'s
   solves after its earlier phases);
3. its K1 ``compact_lanes``, K3 ``fetch_colors`` and K5 ``fetch_colors3``
   on the same seeded inputs at the main paths' shapes (K1 and K3 on
   1024^2 lanes with lobed_u's 187,567 set and 72,062 in-shell, K1 and K5
   on 65,536 lanes with neumann3d_u's 3,876 and 304), each color table
   made by the tree's own ``color_rows_from``; K13 on the 1024^2 frame
   points (every lane) and on the walks after 16 depth steps
   (``*_lanes``: the lane-list form, K1 included, where the tree has one,
   else what its path runs there, the full form), over the bench square's
   2,048 segments and over nogrid_u's 256 (``*_nogrid*``), with K1 alone
   on nogrid_u's walks; ``grid_closest_point`` on a bare candidate grid
   of the bench square's curve (K = 64, no coordinate table) over the
   1024^2 frame points (``bare_grid``: K12 and, in a tree from before it
   read the rows itself, the gathers that fed it); K6 and K8 on
   neumann3d_u's lanes after 3 depth steps with their star radii (with
   the tree's skip and live mask where it has them), K8 also at radii
   of 0.05 to 1 (``band_ball_wide``), which reach the blob; K2 and
   K4 on lobed_u's and neumann3d_u's need lanes after 3 depth steps, as
   the tree's ``_fast_dirichlet`` runs them (N-wide mask, rows and points
   to the wrapper, which lists the lanes itself; or, for a tree named by
   ``--gathered``, one from before that form, K1, the gather of rows and
   points, the sweep of the compacted lanes and one scatter of its
   outputs back by lane id):
   call ms and device ms as ``utils/timing.py`` takes them, with the live
   lanes the lane-list form swept; and the form's launches apart, K1
   alone (``*_k1``) and the sweep alone (``*_alone_k1``: the gathered
   form's wrapper on the gathered lanes, the lane-list form's launch over
   K1's list, which in that form also runs over the list sorted by row
   and shuffled, ``_list_orders``: whether the rows' re-reads set its
   time); then the DIRICHLET_SDF channel (``render_dirichlet_sdf``: the
   chain path, K10 or K11, and the film) of lobed channels (the lobed
   scene at 256^2, ``chip_smoke.py`` [4b]'s frame), lobed_u (1024^2, K10
   at [2]'s shape), neumann3d_u and bumpy3d_u as shipped
   (``dirichlet_sdf_*``), timed, with a digest of each film.

A tree that runs guided WoSt in 3D (``_guided_3d``) also runs, on each
turn, bumpy3d_n (``configs/bumpy3d_n.json`` as shipped: 64 spp of which
16 train) and neumann3d_n (``utils/scenes.write_neumann3d_n``: the
scene of neumann3d_u with bumpy3d_n's guided integrator and network, 64
spp of which 16 train) through the CLI, on both routes: their rates
only (their films are not held bit-equal: the table's gradient is a
scatter-add).

Each CLI scene also runs from a copy of its config that takes the
per-sample route (``utils/scenes.write_per_sample``: metric frames asked
for, none written; ``<scene>_per_sample``), so a tree whose default
route is the balanced one is timed on both.  Each CLI run records a
digest of its SOLUTION film (the exported float32 ``solution.exr``), and
each DIRICHLET_SDF case one of its film, so the medians line can say
whether the trees' films are equal bit for bit (``films_equal``): the
per-sample films of every tree, and a tree's default film where its
default is the per-sample route.  In its first turn a tree whose
``UniformIntegrator.solve`` takes ``spp_chunk`` (the balanced route is
its default) also solves the six CLI configs in one process on both
routes (``routes``): both walk-steps/s, the share of pixel channels whose
means agree within 4 combined standard errors, the balanced rounds and
both routes' film digests; the last line says per scene whether the
trees' balanced rounds are equal and by how much their balanced means
differ (``balanced``).

The trees share one grid cache, so only the first run of a scene builds
its grids (before the solve's clock in both trees); the balanced solve's
hint files are removed before every run.  One JSON line per
turn, then the medians per tree; ``--out`` also writes them to a file.
The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

# the main paths' shapes (PERF.md): lanes, set lanes, in-shell lanes, prims
LOBED = (1048576, 187567, 72062, 65536)
NEUMANN3D = (65536, 3876, 304, 768)
SPP_2D, SPP_3D, SPP_SQUARE, SPP_NOGRID, SPP_WAVY = 32, 64, 4, 8, 8
TRAIN_SPP_3D = 16            # bumpy3d_n's training samples (the config's)
ROUND_KEYS = ("lanes", "cap", "iters", "steps", "resolved", "capped")


def bench_square(dev, spp: int):
    """bench.py's own scene as bench builds it (2,048 segments, no grid,
    no Neumann set) and a UniformIntegrator over its 1024^2 frame; also
    ``chip_smoke.py``'s."""
    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid
    from elaina_tpu_torch.core.problem import Problem, scene_from_numpy
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.utils import scenes as S

    verts, idx, colors = S.bench_square_scene()
    problem = Problem(2, dev, verbose=False)
    problem.probe = EvaluationGrid.from_json(
        {"mData": {"pos": list(S.CENTER), "scale": 250, "up": [-1.0, 0.0]}},
        2)
    problem.scene = scene_from_numpy(
        aabb_lo=[-100, -100], aabb_hi=[600, 600], device=dev,
        dirichlet=(verts, idx, colors))
    settings = IntegratorSettings(frameSize=(S.FRAME, S.FRAME),
                                  samplesPerPixel=spp, maxWalkingDepth=S.DEPTH,
                                  epsilonShell=S.EPS)
    return problem, UniformIntegrator(problem, settings, "unused")


def load_integrator(conf: str, dev, spp: int | None = None,
                    accel: str = "auto"):
    """The problem and the integrator of a config (uniform, or guided with
    its network reset), as ``run_expr`` makes them (``spp`` overrides its
    samples per pixel; ``accel`` is ``Problem.load_config``'s)."""
    import dataclasses

    from elaina_tpu_torch.core.config import ExperimentConfig
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

    cfg = ExperimentConfig.from_file(conf)
    settings = cfg.settings if spp is None else dataclasses.replace(
        cfg.settings, samplesPerPixel=spp)
    problem = Problem(cfg.dimensionality, dev, verbose=False).load_config(
        cfg.scene, cache_dir=os.environ["ELAINA_CACHE_DIR"], accel=accel)
    if cfg.integrator_type == "guided":
        # imported here: a tree from before the guided port runs this
        # module's uniform paths in its A/B turns
        from elaina_tpu_torch.solver.guided import GuidedIntegrator

        integ = GuidedIntegrator(problem, settings, "unused")
        integ.reset_network(cfg.network)
        return problem, integ
    return problem, UniformIntegrator(problem, settings, "unused")


def top_ops(fn) -> int:
    """The PyTorch ops that one call of ``fn`` enqueues (torch.profiler on
    the host: aten ops not inside another); also ``chip_smoke.py``'s."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def warm_state(problem, integ, steps: int):
    """The walk state after ``steps`` depth steps of one sample; also
    ``chip_smoke.py``'s."""
    from elaina_tpu_torch.solver.wost import init_walk_state, wost_depth_step
    from elaina_tpu_torch.utils.rng import sample_generators

    state = init_walk_state(integ.eval_points, integ.mask)
    gens = sample_generators(0, 0, problem.device)
    eps = float(integ.settings.epsilonShell)
    for _ in range(steps):
        state, _, _ = wost_depth_step(problem.scene, state, gens, eps)
    return state


def _solve_twice(conf: str | None) -> dict:
    """The bench square (no ``conf``) or a config, solved twice in the
    tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, integ = (bench_square(dev, SPP_SQUARE) if conf is None
                else load_integrator(conf, dev))
    integ.prepare()
    ms = integ.solve()
    steps = integ.total_walk_steps
    warm_ms = integ.solve()
    warm_steps = integ.total_walk_steps
    return {"walk_steps": steps, "duration_ms": ms,
            "walk_steps_s": steps / (ms / 1e3), "warm_duration_ms": warm_ms,
            "warm_walk_steps_s": warm_steps / (warm_ms / 1e3)}


def _routes(confs: dict, out_dir: str) -> dict:
    """Each config solved in this tree on its default route and on the
    per-sample one (``solve(spp_chunk=1)``): both walk-steps/s, and the
    share of pixel channels where the two means agree within 4 combined
    standard errors; the default route's rounds (lanes, cap, iterations,
    live steps, resolved lanes, capped walks: the walks' own counts, which
    no summation order moves) and a digest of each route's mean, which is
    also saved as ``<out_dir>/<scene>.npy``.  ``confs``: scene ->
    (config, ELAINA_FUSED_BAND)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}
    for scene, (conf, fused) in confs.items():
        os.environ["ELAINA_FUSED_BAND"] = fused
        _clear_hints(os.environ.get("ELAINA_CACHE_DIR"))  # scenes share sets
        _, integ = load_integrator(conf, dev)
        integ.prepare()
        got = []
        rounds = []
        for kw in ({}, {"spp_chunk": 1}):
            ms = integ.solve(**kw)
            rounds = rounds or integ.balance_rounds
            got.append(((integ.sum / integ.spp).cpu().numpy(),
                        integ.standard_error(),
                        integ.total_walk_steps / (ms / 1e3)))
        (ma, sa, ra), (mb, sb, rb) = got
        within = np.abs(ma - mb) <= 4.0 * np.hypot(sa, sb) + 1e-6
        np.save(os.path.join(out_dir, scene + ".npy"), ma)
        out[scene] = {"walk_steps_s": ra, "per_sample_walk_steps_s": rb,
                      "within_4se": float(within.mean()),
                      "rounds": [[r[k] for k in ROUND_KEYS]
                                 for r in rounds],
                      "balanced_sha256": hashlib.sha256(
                          ma.tobytes()).hexdigest(),
                      "per_sample_sha256": hashlib.sha256(
                          mb.tobytes()).hexdigest()}
        del integ
        torch.cuda.empty_cache()
    os.environ["ELAINA_FUSED_BAND"] = "1"
    return out


def _balanced_compare(routes: dict, films_dir: dict) -> dict:
    """Per scene of ``--routes``, across the trees that ran it: whether
    their balanced rounds are equal, whether their balanced and per-sample
    means are equal bit for bit, and the largest difference of their
    balanced means (a float sum's order, scatter-adds included, moves its
    last bits)."""
    import numpy as np

    names = [n for n in routes if routes[n]]
    out = {}
    for scene in (routes[names[0]] if names else {}):
        recs = [routes[n][scene] for n in names if scene in routes[n]]
        means = [np.load(os.path.join(films_dir[n], scene + ".npy"))
                 for n in names if scene in routes[n]]
        out[scene] = {
            "rounds_equal": all(r.get("rounds") == recs[0].get("rounds")
                                for r in recs),
            "balanced_bits_equal": len({r.get("balanced_sha256")
                                        for r in recs}) == 1,
            "per_sample_bits_equal": len({r.get("per_sample_sha256")
                                          for r in recs}) == 1,
            "balanced_max_abs_diff": float(max(
                np.abs(m - means[0]).max() for m in means))}
    return out


def _k13_kernels(problem, integ, a, b, tag: str, timed) -> dict:
    """K13 over the frame points (every lane) and, as the tree's path
    calls it, on the walks after 16 depth steps."""
    import inspect

    from elaina_tpu_torch.ops import queries as QK

    q = integ.eval_points.contiguous()
    walks = warm_state(problem, integ, 16)
    qw, act = walks.pos.contiguous(), walks.active.contiguous()
    listed = "active" in inspect.signature(QK.closest_point_dense).parameters
    full = timed(lambda: QK.closest_point_dense(q, a, b))
    path = timed((lambda: QK.closest_point_dense(qw, a, b, act)) if listed
                 else (lambda: QK.closest_point_dense(qw, a, b)))
    path["live"] = int(act.sum())
    return {f"closest_point_dense{tag}": full,
            f"closest_point_dense_lanes{tag}": path}


def _band_kernels(conf_3d: str, conf_ng: str, dev, timed) -> dict:
    """K13 on the bench square and on nogrid_u, K1 on nogrid_u's walks,
    the bare grid's chain path (K12), and K6 and K8 on neumann3d_u's
    lanes, each as the tree's path calls it."""
    import inspect

    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver.wost import _sample_direction, _separate
    from elaina_tpu_torch.utils import scenes as S

    problem, integ = bench_square(dev, 1)
    verts, idx, _ = S.bench_square_scene()
    a = torch.as_tensor(verts[idx[:, 0]], device=dev)
    b = torch.as_tensor(verts[idx[:, 1]], device=dev)
    out = _k13_kernels(problem, integ, a, b, "", timed)
    out["bare_grid"] = _bare_grid(integ.eval_points, dev, timed)
    problem, integ = load_integrator(conf_ng, dev, 1)
    gs = problem.scene.dirichlet.gs
    a = gs.verts[gs.indices[:, 0]].contiguous()
    b = gs.verts[gs.indices[:, 1]].contiguous()
    out.update(_k13_kernels(problem, integ, a, b, "_nogrid", timed))
    act = warm_state(problem, integ, 16).active.contiguous()
    out["compact_lanes_nogrid"] = timed(
        lambda: R.compact_lanes(act, act.shape[0]))
    del problem, integ, act

    problem, integ = load_integrator(conf_3d, dev)
    eps = float(integ.settings.epsilonShell)
    scene = problem.scene
    state = warm_state(problem, integ, 3)
    in_shell, R_B, _, _, _ = _separate(scene, state, eps, shrink=True)
    live = (state.active & ~in_shell & torch.isfinite(R_B)).contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    n = state.pos.shape[0]
    u_sel = torch.rand(n, generator=gen, device=dev)
    u_pt = torch.rand((n, 2), generator=gen, device=dev)
    direction, _, _ = _sample_direction(gen, state, 3, True)
    bg = scene.n_bgrid
    lin, outside = Q.band_cell(bg, state.pos)
    cell = torch.where(outside, -1, lin).to(torch.int32)
    args = (cell, state.pos.contiguous(), R_B.contiguous(),
            state.on_neumann.contiguous(), state.n_normal.contiguous(), u_sel,
            u_pt, direction.contiguous(), eps, bg.coords)
    if "skip_r" in inspect.signature(QK.band_neumann_walk).parameters:
        args += (bg.skip_r, live)
    out["band_neumann_walk"] = timed(lambda: QK.band_neumann_walk(*args))
    wide = (0.05 + 0.95 * torch.rand(n, generator=gen, device=dev))
    skip = "skip_r" in inspect.signature(QK.band_ball).parameters
    for key, radii in (("band_ball", R_B), ("band_ball_wide", wide)):
        bargs = (cell, state.pos.contiguous(), radii.contiguous(), u_sel,
                 bg.coords) + ((bg.skip_r, live, 0.0) if skip else ())
        out[key] = timed(lambda a=bargs: QK.band_ball(*a))
    return out


def _bare_grid(q, dev, timed) -> dict:
    """``grid_closest_point`` over the points q on a bare candidate grid
    of the bench square's curve (K = 64), as the tree builds and sweeps
    it."""
    from elaina_tpu_torch.core.problem import grid_bounds
    from elaina_tpu_torch.geometry.grid import (build_candidate_grid,
                                                grid_closest_point,
                                                grid_from_numpy)
    from elaina_tpu_torch.utils import scenes as S

    verts, idx, colors = S.bench_square_scene()
    lo, hi = grid_bounds(verts, [-100, -100], [600, 600])
    ga = build_candidate_grid(verts, idx, lo, hi, K=64, max_res=2048,
                              cache_dir=os.environ["ELAINA_CACHE_DIR"])
    bare = grid_from_numpy(**{k: getattr(ga, k) for k in (
        "cand", "meta", "row_lbound", "row_diag", "row_trunc", "origin",
        "inv_cell", "res")}, verts=verts, indices=idx, colors=colors,
        device=dev)
    q = q.contiguous()
    return timed(lambda: grid_closest_point(bare, q))


def _dirichlet_sdf(confs: dict, dev, timed) -> dict:
    """The DIRICHLET_SDF channel (``render_dirichlet_sdf``: the chain
    path, K10 in 2D and K11 in 3D, and the film) of each config, as the
    tree renders it: its times and a SHA-256 of its film."""
    out = {}
    for key, conf in confs.items():
        problem, integ = load_integrator(conf, dev, 1)
        rec = timed(integ.render_dirichlet_sdf)
        film = integ.films["DIRICHLET_SDF"].pixels()
        rec["film_sha256"] = hashlib.sha256(film.tobytes()).hexdigest()
        out[f"dirichlet_sdf_{key}"] = rec
        del problem, integ
    return out


def _resolve_kernels(conf_2d: str, conf_3d: str, dev, timed,
                     gathered: bool) -> dict:
    """K2 on lobed_u's and K4 on neumann3d_u's need lanes after 3 depth
    steps, each as the tree's ``_fast_dirichlet`` runs it (``gathered``:
    around a gather and a scatter); the PyTorch ops
    that one ``_fast_dirichlet`` and one depth step enqueue there, and the
    first statement of each (and of that form) that waits for the
    device."""
    import torch

    from elaina_tpu_torch.geometry.grid import fine_decode
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver import wost as W
    from elaina_tpu_torch.utils.rng import sample_generators

    def first_sync(fn):
        """Where one call of ``fn`` first makes the host wait for the
        device (``torch.cuda.set_sync_debug_mode``), or None."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            tb = traceback.extract_tb(e.__traceback__)
            f = [t for t in tb if "elaina_tpu_torch" in t.filename][-1]
            return f"{os.path.basename(f.filename)}:{f.lineno} {f.line}"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return None

    def gather(need, row, q):
        """K1 and the gather of the parent's form: (lanes, the valid
        slots, their rows, their points)."""
        n = need.shape[0]
        lanes, cnt = R.compact_lanes(need, n)
        valid = torch.arange(n, device=dev) < cnt
        safe = torch.where(valid, lanes, 0).long()
        return lanes, valid, row[safe].contiguous(), q[safe].contiguous()

    def compacted(sweep, need, row, q, g):
        """The parent's form: K1, gather, sweep, one scatter back."""
        n = need.shape[0]
        lanes, valid, row_c, q_c = gather(need, row, q)
        out = sweep(valid, row_c, q_c, g.coords, g.cand)
        flat = torch.cat([o.reshape(n, -1).to(torch.float32) for o in out],
                         dim=1)
        back = torch.zeros((n + 1, flat.shape[1]), dtype=torch.float32,
                           device=dev)
        back[torch.where(valid, lanes.long(), n)] = flat
        return back[:n]

    out = {}
    for name, conf in (("sweep_resolve", conf_2d),
                       ("sweep_resolve_3d", conf_3d)):
        problem, integ = load_integrator(conf, dev, 1)
        g = problem.scene.d_grid
        state = warm_state(problem, integ, 3)
        q = state.pos
        row, need_f, _, outside = fine_decode(g.fine, q)
        need = state.active & (need_f | outside)
        sweep = getattr(R, name)
        args = (need, row, q, g.coords, g.cand)
        form = ((lambda: compacted(sweep, *args[:3], g)) if gathered else
                (lambda: sweep(*args)))
        out[name] = timed(form)
        out[name]["need"] = int(need.sum())
        # the form's launches apart: K1, then the sweep alone (the
        # parent's on the gathered lanes, the change's over K1's list)
        n = need.shape[0]
        out[f"{name}_k1"] = timed(lambda: R.compact_lanes(need, n))
        if gathered:
            c_args = (*gather(need, row, q)[1:], g.coords, g.cand)
            out[f"{name}_alone_k1"] = timed(lambda: sweep(*c_args))
        else:
            out.update(_list_orders(name, need, row, q, g, timed))
        eps = float(integ.settings.epsilonShell)
        gens = sample_generators(0, 0, dev)
        resolve = (lambda: W._fast_dirichlet(problem.scene, q, state.active,
                                             eps))
        step = (lambda: W.wost_depth_step(problem.scene, state, gens, eps))
        out[name].update(
            fast_dirichlet_ops=top_ops(resolve), step_ops=top_ops(step),
            form_sync=first_sync(form),
            fast_dirichlet_sync=first_sync(resolve),
            step_sync=first_sync(step))
        del problem, integ
    return out


def _list_orders(name: str, need, row, q, g, timed) -> dict:
    """K2 or K4 alone (``ops.resolve._sweep_lanes``) over K1's list of
    ``need``, over that list sorted by row (lanes that share a row side by
    side) and over a seeded permutation of it (neighbours rarely share
    one), each equal to the wrapper's output: how far the rows' re-reads
    set the sweep's time.  Keys ``<name>_alone_<order>``."""
    import torch

    from elaina_tpu_torch.ops import resolve as R

    n = need.shape[0]
    lanes, cnt = R.compact_lanes(need, n)
    k = int(cnt)
    ids = lanes[:k].long()
    gen = torch.Generator(device=need.device)
    gen.manual_seed(5)
    orders = {"k1": lanes,
              "by_row": torch.cat([ids[torch.sort(row[ids], stable=True)[1]]
                                   .int(), lanes[k:]]),
              "shuffled": torch.cat([ids[torch.randperm(
                  k, generator=gen, device=need.device)].int(), lanes[k:]])}
    dim = 2 if name == "sweep_resolve" else 3
    want = getattr(R, name)(need, row, q, g.coords, g.cand)
    out = {}
    for key, order in orders.items():
        order = order.contiguous()
        args = (dim, need, order.data_ptr(), cnt.data_ptr(), row, q,
                g.coords, g.cand)
        if not all(torch.equal(a, b) for a, b in zip(R._sweep_lanes(*args),
                                                     want)):
            raise RuntimeError(f"{name} over the {key} list differs")
        out[f"{name}_alone_{key}"] = timed(
            lambda a=args, o=order: R._sweep_lanes(*a))
    return out


def _kernel_times(conf_2d: str, conf_3d: str, conf_ng: str, form: str,
                  conf_channels: str, conf_bumpy: str) -> dict:
    """K1, K3 and K5 of the tree in the working directory, on seeded
    inputs, then K13 and K6 (``_band_kernels``), K2 and K4
    (``_resolve_kernels``, in the ``gathered`` or ``listed`` form) and the
    DIRICHLET_SDF channel of lobed channels, lobed_u, neumann3d_u and
    bumpy3d_u (``_dirichlet_sdf``); run as a file there: ``timing`` is
    this file's neighbour."""
    sys.path.insert(0, os.getcwd())
    import torch
    from timing import cuda_ms, device_ms

    from elaina_tpu_torch.geometry.grid import color_rows_from
    from elaina_tpu_torch.ops import resolve as R

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def timed(fn):
        d_ms, host_us, hidden = device_ms(fn)
        return {"ms": cuda_ms(fn), "device_ms": d_ms, "host_us": host_us,
                "hidden": hidden}

    def pick(n, k):
        """A mask of n lanes with exactly k set, at seeded places."""
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        m[torch.randperm(n, generator=gen, device=dev)[:k]] = True
        return m

    out = {}
    for label, (n, n_set, n_ins, P), nc in (("2d", LOBED, 2),
                                            ("3d", NEUMANN3D, 3)):
        mask = pick(n, n_set)
        ins = pick(n, n_ins)
        n_verts = P + 1
        idx = (torch.arange(P, device=dev)[:, None]
               + torch.arange(nc, device=dev)[None, :]) % n_verts
        colors = torch.rand((n_verts, 2, 3), generator=gen, device=dev)
        rows = color_rows_from(colors, idx)
        cfi = torch.where(ins, torch.randint(0, 2 * P, (n,), generator=gen,
                                             device=dev), 0).to(torch.int32)
        fetch = R.fetch_colors if nc == 2 else R.fetch_colors3
        for name, fn in ((f"compact_lanes_{label}",
                          lambda m=mask, n=n: R.compact_lanes(m, n)),
                         (fetch.__name__,
                          lambda i=ins, c=cfi, r=rows, f=fetch: f(i, c, r))):
            out[name] = timed(fn)
    return {**out, **_band_kernels(conf_3d, conf_ng, dev, timed),
            **_resolve_kernels(conf_2d, conf_3d, dev, timed,
                               form == "gathered"),
            **_dirichlet_sdf({"lobed_channels": conf_channels,
                              "lobed_u": conf_2d, "neumann3d_u": conf_3d,
                              "bumpy3d_u": conf_bumpy}, dev, timed)}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _clear_hints(cache: str | None) -> None:
    """Remove the balanced solve's hint files from the cache (the grids
    stay)."""
    if cache and os.path.isdir(cache):
        for name in os.listdir(cache):
            if name.startswith("hints_"):
                os.remove(os.path.join(cache, name))


def _run(cmd: list, tree: str, env: dict) -> str:
    """Run ``cmd`` in ``tree``; its stdout, or raise with its stderr.  The
    hint files of earlier runs are removed first (the grids stay): every
    run solves as a first process on its scene does, so that a tree that
    keeps hints and one that does not take the same rounds."""
    _clear_hints(env.get("ELAINA_CACHE_DIR"))
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {tree} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def _run_scene(tree: str, conf: str, env: dict) -> dict:
    """One CLI run of ``conf`` in ``tree``: its rate and film digest."""
    from ..output.image_io import read_exr

    _run([sys.executable, "-m", "elaina_tpu_torch", "run", conf, "--device",
          "cuda"], tree, env)
    with open(conf) as f:
        c = json.load(f)
    out = os.path.join(c["base_path"], c["exp_name"])
    with open(os.path.join(out, "result.json")) as f:
        r = json.load(f)
    film = read_exr(os.path.join(out, "solution.exr")).astype("float32")
    return {"walk_steps": r["walk_steps"], "duration_ms": r["duration"],
            "walk_steps_s": r["walk_steps"] / (r["duration"] / 1e3),
            "solution_sha256": hashlib.sha256(film.tobytes()).hexdigest()}


def _guided_3d(tree: str, env: dict) -> bool:
    """Whether the tree's port runs guided WoSt in 3D (a tree from before
    it raises on such a config)."""
    out = _run([sys.executable, "-c", "import elaina_tpu_torch.solver."
                "guided as g; print(not hasattr(g, 'no_guided_3d'))"],
               tree, env)
    return out.strip().splitlines()[-1] == "True"


def _renamed(conf: str, exp_name: str) -> str:
    """The config at ``conf`` with its ``exp_name`` set; returns its path."""
    with open(conf) as f:
        c = json.load(f)
    c["exp_name"] = exp_name
    with open(conf, "w") as f:
        json.dump(c, f)
    return conf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elaina_tpu_torch.utils.ab")
    ap.add_argument("--tree", action="append", required=True,
                    help="name=directory of a checkout")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one per turn")
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--gathered", action="append", default=[],
                    help="a tree whose _fast_dirichlet gathers the need "
                    "lanes around K2/K4 and scatters back (before the "
                    "lane-list form)")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    order = args.order.split(",")
    here = os.path.dirname(os.path.abspath(__file__))
    from . import scenes

    lines = [_card()]
    print(lines[0], flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as root:
        env = dict(os.environ, ELAINA_CACHE_DIR=os.path.join(root, "cache"))
        for sub in ("nogrid", "source", "wavy", "unfused", "channels",
                    "bumpy", "guided"):
            os.makedirs(os.path.join(root, sub))
        conf_ng = _renamed(scenes.write_scene(
            os.path.join(root, "nogrid"), SPP_NOGRID, segments=256),
            "nogrid_u")
        confs = {"lobed_u": scenes.write_scene(root, SPP_2D),
                 "neumann3d_u": scenes.write_config_copy(root, "neumann3d_u",
                                                         SPP_3D),
                 "nogrid_u": conf_ng,
                 "neumann3d_source": scenes.write_neumann3d_source(
                     os.path.join(root, "source"), SPP_3D),
                 "wavy8192_u": _renamed(scenes.write_scene(
                     os.path.join(root, "wavy"), SPP_WAVY,
                     neumann_segments=8192), "wavy8192_u"),
                 "neumann3d_unfused": _renamed(scenes.write_config_copy(
                     os.path.join(root, "unfused"), "neumann3d_u", SPP_3D),
                     "neumann3d_unfused")}
        conf_channels = scenes.write_scene(os.path.join(root, "channels"),
                                           1, frame=256)
        conf_bumpy = scenes.write_config_copy(os.path.join(root, "bumpy"),
                                              "bumpy3d_u", 1)
        guided = {"bumpy3d_n": scenes.write_config_copy(
            os.path.join(root, "guided"), "bumpy3d_n", SPP_3D, TRAIN_SPP_3D),
                  "neumann3d_n": scenes.write_neumann3d_n(
            os.path.join(root, "guided"), SPP_3D, TRAIN_SPP_3D)}
        envs = {scene: env for scene in (*confs, *guided)}
        envs["neumann3d_unfused"] = dict(env, ELAINA_FUSED_BAND="0")
        per_sample = {scene + "_per_sample": scenes.write_per_sample(
            conf, scene + "_per_sample") for scene, conf in confs.items()}
        guided_ps = {scene + "_per_sample": scenes.write_per_sample(
            conf, scene + "_per_sample") for scene, conf in guided.items()}
        for scene in (*confs, *guided):
            envs[scene + "_per_sample"] = envs[scene]
        has_guided = {name: _guided_3d(tree, env)
                      for name, tree in trees.items()}
        routes_done = set()
        films_dir = {name: os.path.join(root, "routes_" + name)
                     for name in trees}
        for i, name in enumerate(order):
            t0 = time.time()
            turn = {"turn": i, "tree": name}
            runs = {**confs, **per_sample}
            if has_guided[name]:
                runs.update(guided, **guided_ps)
            for scene, conf in runs.items():
                # the first: a cold _build/
                turn[scene] = _run_scene(trees[name], conf, envs[scene])
            if name not in routes_done:
                routes_done.add(name)
                os.makedirs(films_dir[name])
                out = _run([sys.executable, os.path.join(here, "ab.py"),
                            "--routes", json.dumps(
                                {s: (c, envs[s].get("ELAINA_FUSED_BAND",
                                                    "1"))
                                 for s, c in confs.items()}),
                            films_dir[name]], trees[name], env)
                routes = json.loads(out.strip().splitlines()[-1])
                if routes:
                    turn["routes"] = routes
            for scene, extra in (("bench_square", []),
                                 ("nogrid_u_twice", [conf_ng])):
                out = _run([sys.executable, os.path.join(here, "ab.py"),
                            "--solve-twice", *extra], trees[name], env)
                turn[scene] = json.loads(out.strip().splitlines()[-1])
            out = _run([sys.executable, os.path.join(here, "ab.py"),
                        "--kernels", confs["lobed_u"], confs["neumann3d_u"],
                        conf_ng, "gathered" if name in args.gathered
                        else "listed", conf_channels, conf_bumpy],
                       trees[name], env)
            turn["kernels"] = json.loads(out.strip().splitlines()[-1])
            turn["seconds"] = time.time() - t0
            turns.append(turn)
            lines.append(json.dumps(turn))
            print(lines[-1], flush=True)
        routes = {t["tree"]: t["routes"] for t in turns if "routes" in t}
        balanced = _balanced_compare(routes, films_dir)  # reads root
    summary = {}
    for name in trees:
        mine = [t for t in turns if t["tree"] == name]
        summary[name] = {
            scene: statistics.median(t[scene]["walk_steps_s"] for t in mine)
            for scene in (*confs, *per_sample, *guided, *guided_ps,
                          "bench_square", "nogrid_u_twice")
            if scene in mine[0]}
        for scene in ("bench_square", "nogrid_u_twice"):
            summary[name][f"{scene}_warm"] = statistics.median(
                t[scene]["warm_walk_steps_s"] for t in mine)
        for k in mine[0]["kernels"]:
            for key in ("ms", "device_ms", "host_us"):
                summary[name][f"{k}_{key}"] = statistics.median(
                    t["kernels"][k][key] for t in mine)
    films = {scene: {name: sorted({t[scene]["solution_sha256"]
                                   for t in turns if t["tree"] == name})
                     for name in trees} for scene in per_sample}
    for scene in confs:   # a tree whose default is the per-sample route
        for name in trees:
            mine = [t for t in turns if t["tree"] == name]
            if "routes" not in mine[0]:
                films[scene + "_per_sample"][name] = sorted(
                    set(films[scene + "_per_sample"][name])
                    | {t[scene]["solution_sha256"] for t in mine})
    sdf = {k: {name: sorted({t["kernels"][k]["film_sha256"]
                             for t in turns if t["tree"] == name})
               for name in trees}
           for k in turns[0]["kernels"] if k.startswith("dirichlet_sdf_")}
    equal = {scene: len({d for ds in by.values() for d in ds}) == 1
             for scene, by in {**films, **sdf}.items()}
    lines.append(json.dumps({"medians": summary, "solution_sha256": films,
                             "dirichlet_sdf_sha256": sdf,
                             "films_equal": equal, "routes": routes,
                             "balanced": balanced}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernels"]:
        print(json.dumps(_kernel_times(*sys.argv[2:8])))
    elif sys.argv[1:2] == ["--routes"]:
        import inspect

        sys.path.insert(0, os.getcwd())
        from elaina_tpu_torch.solver.integrator import UniformIntegrator

        has = "spp_chunk" in inspect.signature(
            UniformIntegrator.solve).parameters
        print(json.dumps(_routes(json.loads(sys.argv[2]), sys.argv[3])
                         if has else {}))
    elif sys.argv[1:2] == ["--solve-twice"]:
        print(json.dumps(_solve_twice(sys.argv[2] if sys.argv[2:] else None)))
    else:
        sys.exit(main())
