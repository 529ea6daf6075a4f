#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``elaina_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the script exits non-zero
and never prints its last line:

0. Device: the card's name and power limit from ``nvidia-smi``.  Exits
   non-zero when PyTorch sees no CUDA device.
1. Build, all at once: the resolve kernels (nvcc, ``csrc/resolve.cu``),
   the Neumann band kernels (nvcc, ``csrc/queries.cu``), the BVH
   traversal kernels (nvcc, ``csrc/bvh.cu``) and the scene library (g++,
   ``native/scene_build.cpp``).
2. 2D kernels K1-K3 and K10 against their plain PyTorch versions, on the
   card, at the 2D main path's shapes: 1024^2 lanes, the synthetic scene's
   candidate rows, lanes whose FinePack need bits fired after a few depth
   steps (K10: every pixel's row through ``grid_row_index``, bit for bit,
   with that lookup and the whole ``grid_closest_point`` timed; then on a
   tie table: one segment at several slots of a row, a row whose every
   d^2 overflows, rows -1: the smallest tied slot, slot 0).  K1 also
   back to back on 1024^2, 65,536 and 1024^2 lanes, with its edge cases
   (a cap below the count and of 1, N off its tile, a mask off 16 bytes,
   all-clear and all-set masks), ids and count exact.  K2 as
   ``_fast_dirichlet`` calls it (the N-wide need mask, rows and points,
   K1 inside the wrapper), and on an empty mask, every lane set and lane
   N - 1 alone: ids exact, distances and t within TOL, the lanes off the
   mask 0 / -1; then the wrapper's two launches apart (K1, and K2 alone
   over its list: device ms and host us of each).
2c. K13, K12 and K9's 2D form against their plain versions: K13 on the
   1024^2 frame points x bench.py's 2,048 segments, and on a point at a
   shared vertex (a tie at 0: the smaller index wins), distances bit-equal
   and ids exact; its lane-list form on the bench square's walks after
   LANES_STEPS depth steps (~15% live, the lanes K1 compacts, as
   ``_dense_dirichlet`` hands them over), on every lane and on none of
   that state, the same way; K12 on the same
   points over a bare candidate grid of that curve (K = 64, no coordinate
   table) through ``grid_closest_point``, whose one launch is K12's path,
   held to K13's distances (equal on untruncated rows, at most K13's on
   truncated ones), then alone on every point's row against its plain
   version (the gathered rows' K12), distances bit-equal and prim ids
   equal, and the whole ``grid_closest_point`` timed; K9-2D on the lanes
   of the lobed scene in a wavy Neumann box of 8,192 segments after a few
   depth steps, with the walks' live mask as ``_separate`` passes it,
   without a mask, on every lane, on none and on lane N - 1 alone,
   bit-equal to its plain version, timed on the live lanes and on every
   lane.
3. The mixed Dirichlet/Neumann square, u = (x + 1) / 2, through
   ``UniformIntegrator``: 256 walks of depth 64 at three points (64 lanes
   a point, 4 samples), each point within 0.07 of u, on the balanced
   route (the default) and on the per-sample one (``spp_chunk``).
3b. The same square through ``GuidedIntegrator``: 16 training samples
   then 48 guided ones, depth 48, eps 0.02, tests/test_guided.py's small
   network, at seven points of 256 lanes each, each point within 0.07 of
   u, the loss finite, on the balanced route (the optimizer every 10
   iterations) and on the per-sample one (metric frames asked for, none
   written: ``train_on_records`` after each training sample).
4. The 2D main path at full scale through ``exec.run_expr`` (the code of
   ``python -m elaina_tpu_torch run``, its default balanced route, whose
   rounds, iterations, host checks and occupancy are printed): a
   65,536-segment Dirichlet boundary (a lobed outline and 62 lobed spots
   inside it) in a 4-segment Neumann box, 1024^2 frame, depth 64, eps 1.  The kernels' launch counts
   are zeroed just before it and K1-K3's must rise.
4g. The 2D guided main path, lobed_n: the scene of phase 4 with the
   guided integrator and network of ``configs/ladybug_n.json``
   (``utils/scenes.write_lobed_n``; DenseGrid 8 x 4, MLP 64 x 3, Adam +
   EMA, uniform fraction 0.5, max guided depth 10) at 1024^2, depth 64,
   eps 1, SPP samples of which 8 train (the config: 1,024 of which 256),
   through ``run_expr`` (the balanced route): K1-K3 launch; each phase's
   walk-steps/s, rounds and occupancy, the depth-capped share, the loss
   history's ends (one value a training round) and the peak memory are
   printed; the SOLUTION film agrees with phase 4's at equal spp within 4
   combined standard errors on >= 99% of pixel channels (the guided /
   uniform variance of the mean printed as a reading).  Then, two
   training-phase depth steps into a sample: one guided inference
   (encoding, MLP, mixture sample, two pdfs) over the frame's lanes and
   one ``train_on_records`` batch of the solve's 524,288 records timed
   (call ms and device ms), and the PyTorch ops of each and of one guided
   depth step with and without records counted (torch.profiler).
4b. The 2D channels: the same scene at 256^2, depth 64, 4 spp, with
   ``configs/data/ladybug_source.nvdb`` as its source (a real NanoVDB
   file over the scene's frame) and the channels DIRICHLET_SDF,
   NEUMANN_SDF, SOURCE and SOLUTION, through ``run_expr``: K10 must
   launch, the SOURCE film equals a plain bilinear sample of the grid,
   the DIRICHLET_SDF film is finite and >= 0 and K10 equals its plain
   version bit for bit on the frame's pixels.
4c. No candidate grid, through ``run_expr``: bench.py's curve cut into 256
   segments (the largest set ``Problem`` leaves without a grid) in the
   4-segment box, 1024^2, depth 64, eps 1, 8 spp, SOLUTION and
   DIRICHLET_SDF: K13 launches on every depth step and the DIRICHLET_SDF
   film equals K13's plain distance (1e-5); then the scene solved without
   and with a candidate grid at depth 256, 4 spp, agrees within 4 combined
   standard errors on >= 99% of the pixel channels.
4d. bench.py's own scene as bench builds it (2,048 segments, no grid, no
   Neumann set) through ``UniformIntegrator``, 1024^2, depth 64, eps 1,
   4 spp: K13 launches on every step and the film is finite.
4e. A 2D Neumann set of 2,048 segments (the lobed scene in the wavy box)
   through ``run_expr``, 256^2, depth 64, 4 spp: the dense silhouette and
   the chunked ray and in-ball sweeps, a finite film; the same scene with
   its 2D SilGrid and prim-band grid given explicitly agrees with the
   chunked sweeps (8 spp each, 4 combined standard errors, >= 99%).
4f. The wavy box of 8,192 segments through ``run_expr`` (its SilGrid and
   prim-band grid built), 1024^2, depth 64, eps 1, 8 spp: K9-2D launches
   on every step; on warmed lanes the SilGrid's R_N is at most the dense
   silhouette distance and equal to it (1e-5) wherever that lies below
   the cell's r_cap.
5. 3D kernels K1, K4, K5, K6, K7, K8, K9 and K11 against their plain
   versions, at the 3D main path's shapes: the neumann3d scene
   (768-triangle Dirichlet cube, 20,480-triangle Neumann blob) loaded with
   its grids (each build's seconds printed), 65,536 lanes after a few
   depth steps (K4 with K2's cases and its launches apart, its corners
   exact; K11: the frame's 65,536 plane points through
   ``grid_row_index``, and its tie table, as K10's); K6 on that step's
   live lanes and star radii from ``_separate``, with its skip (the share
   of lanes it took printed) and
   without; K7 with its skip (reach tmax + eps) on the step's live lanes,
   without a mask, on every lane, on none and on lane N - 1 alone (slots
   exact, t within TOL), and equal bit for bit to the unskipped kernel on
   those lanes; K8 the same way (reach R), with and without its skip, the
   lanes it does not sweep bit-equal (slot Kp, zeros), the rest's slots
   equal but for CDF_FLIPS and w_sel and total within TOL; K6-K8 also at
   radii 0.05-1, which reach the blob, and K6 there on the table padded
   to 128 slots (its instantiation for wide rows).
5b. The fused depth step (K6) against the unfused one (K8 + K7) on
   neumann3d's lanes, 3 steps with the same generators, held to
   ``tests/test_fused_band.py``'s lane thresholds.
5c. One depth step from those lanes with K6's skip and without it, the
   same generators: contributions and next walk states equal on every
   lane.
6. The mixed cube, u = (x + 1) / 2 (Dirichlet x = +-1, zero Neumann on the
   other faces), through ``Problem.load_config`` and ``UniformIntegrator``:
   1,024 lanes of CUBE_U_SPP samples at each of three points, depth 256
   (walks stall by the Neumann-Neumann edges), each within 0.07 of u, on
   both routes.  It runs K6 and K9 too.
6b. The mixed cube with a unit source, u = (x + 1) / 2 + (1 - x^2) / 2,
   the same way (CUBE_SPP samples) at depth 128, fused and unfused (``ELAINA_FUSED_BAND=0``),
   on both routes: each point within 0.07; the source term's K7 launches
   in every run.
7. bumpy3d_u through ``exec.run_expr`` from a copy of
   ``configs/bumpy3d_u.json`` with its channels and exports (20,480
   triangles, 256^2, eps 0.01, 64 spp, SOLUTION and DIRICHLET_SDF), at the
   config's depth 64 and at depth 256: RMSE and mean error against the
   analytic h = 0.5 + 0.4 (x^2 - y^2), printed for both, within 0.05 and
   0.015 at depth 256.  At depth 64 enough walks meet the cap to leave the
   mean low (the FinePack's cell-wide bounds slow the walks near the
   surface, as the reference's do; PERF.md).  The DIRICHLET_SDF film is
   finite and equals the row's lower bound on truncated-row pixels, and
   K11 equals its plain version bit for bit on the 2-level grid.
7g. bumpy3d_n, the 3D guided path, through ``exec.run_expr`` from a copy
   of ``configs/bumpy3d_n.json`` as shipped (256^2, depth 64, eps 0.01,
   64 spp of which 16 train, DenseGrid 8 x 4 as tri-plane levels, MLP 64
   x 3), on the balanced route: K1, K4 and K5 launch; each phase's
   walk-steps/s, rounds and occupancy, the loss history and the peak
   memory are printed, the RMSE and mean error against h of its film and
   of [7]'s depth-64 bumpy3d_u film, and the guided / uniform variance of
   the mean (a reading); the film agrees with bumpy3d_u's within 4
   combined standard errors on >= 99% of pixel channels.
8. The 3D main path, neumann3d_u, through ``exec.run_expr`` from a copy
   of ``configs/neumann3d_u.json`` with its channels and exports (256^2,
   depth 64, eps 0.01, 64 spp, SOLUTION and DIRICHLET_SDF): finite, mean
   in (0.2, 0.8), the DIRICHLET_SDF film within 1e-5 of the distance to
   the cube, 1.3 - max(|x|, |y|), at every pixel; the launch counts are
   zeroed just before it and K1, K4, K5, K6, K9 and K11's must rise.
8b. neumann3d_u with a volumetric source (``utils/scenes.
   write_neumann3d_source``: a smooth 64^3 RGB grid, SOURCE and SOLUTION)
   at SOURCE_3D_SPP: finite, and K7 must launch.
8c. neumann3d_u unfused (``ELAINA_FUSED_BAND=0``, K8 and K7 in place of
   K6) and fused, 8 spp each: both walk-steps/s printed, K8 must launch,
   and the two means agree within 4 combined standard errors on >= 99%
   of the pixels.
8g. neumann3d_n, the 3D guided path with a Neumann set
   (``utils/scenes.write_neumann3d_n``: neumann3d_u's scene, channels and
   exports with bumpy3d_n's integrator settings and network,
   NEUMANN3D_N_SPP of which 16 train), as [7g] against [8]'s neumann3d_u
   film, with [8]'s DIRICHLET_SDF bound; K1, K4, K5, K6, K9 and K11
   launch.  Then one guiding-phase depth step of the trained guide on the
   frame's lanes, GUIDED_WARM_STEPS guided steps in: K6 launches once, on
   the guide's directions, and equals its plain version on that launch's
   inputs (as [5]); and the guide's costs at the 65,536 lanes, as
   [4g]'s.
8r. lobed_u, lobed_n, neumann3d_u and bumpy3d_n on the per-sample route
   (copies of their configs with metric frames asked for and none
   written) at half the spp of [4], [4g], [8] and [7g] (ROUTES_SPP_CUT;
   the guided paths' training samples as configured): each film within 4
   combined standard errors of its balanced film on >= 99% of pixel
   channels; both routes' walk-steps/s, depth-capped share and peak
   memory printed, and for the guided paths each phase's walk-steps/s,
   the loss and the guided / uniform variance of the mean on each route
   (a reading).
8d. One depth step each of lobed_u, neumann3d_u, neumann3d_u with a
   source and wavy8192_u (1 spp, after one step outside the probe) under
   ``torch.cuda.set_sync_debug_mode("error")``: the phase fails where a
   step makes the host wait for the device.  Then lobed_n and
   neumann3d_n (the fused band step on the guide's directions): one
   guided depth step in the training phase (records on), one in the
   guiding phase and one ``train_on_records`` batch, the same way.  Then a whole
   balanced chunk of lobed_u and one of lobed_n's training phase (an
   optimizer pass every 4 iterations), the probe lifted only around the
   host's reads of the loop condition (one every CHECK_EVERY
   iterations): no iteration waits for the device between them.

9. Equal time (the budgets of ``solve(time_budget_s=...)``, from the
   call, after ``prepare()``; the problems and integrators made as
   ``run_expr`` makes them, so each loads the hints the earlier runs of
   its scene saved): each run's rounds (lanes, cap, iterations run, wall,
   seconds an iteration and the JAX package's lanes / rate), walk-steps/s
   and launches printed.
9a. lobed_u under a budget set from [4]'s own solve: its host partitions'
   seconds (the rounds' ``host_s``, a fixed cost) plus BUDGET_SPP times
   its seconds a sample (the rest of its wall over its samples), so that
   it buys >= 12 samples a pixel of [4]'s SPP (the samples bought
   printed): the wall within the budget
   and its longest round and under twice the budget, every pixel not
   baked with a completed sample, the harmonic / arithmetic mean of the
   completed samples >= 0.9, the film within 4 combined standard errors
   of [4]'s on >= 99% of pixel channels; then, on a fresh problem, ten
   times [4]'s wall: the saved hints loaded, round 0 not a probe, every
   sample completed.
9b. lobed_n under the same budget: the training policy (skip, t_target,
   share cap), the training samples achieved, each phase's seconds and
   walk-steps/s; every pixel with a sample and the film within 4 combined
   standard errors of [4g]'s on >= 99%; the equal-time variance of the
   mean, guided over [9a]'s uniform film (a reading).
9c. neumann3d_u under half of [8]'s solve wall, gated as [9a] against
   [8]'s film (K1, K4, K5, K6 and K9 launch).
9d. [3b]'s guided square on the per-sample route: 32 samples with a
   checkpoint every 16, then a new integrator resumed from it to 64: the
   checkpoint's trainer bit-equal to the first run's, 32 samples run
   after the resume, each point within 0.07 of u.

10. The small modules.
10a. Scene masks (``scene.mask_path``), through ``exec.run_expr``: a mask
   PNG written with the port's ``write_png`` at 256^2 (the left half of
   the frame on, a disc in it off).  lobed_u at 256^2 (MASK_SPP samples)
   without the mask, then with it on the balanced route, on the
   per-sample route and under a time budget (MASK_BUDGET_SHARE of the
   masked balanced solve's seconds); lobed_n cut as [4g] (MASK_SPP
   samples of which MASK_TRAIN_SPP train) with it, held to the unmasked
   lobed_u run as [4g] holds lobed_n to lobed_u; neumann3d_u as shipped
   (256^2, MASK_SPP samples) without and with it.  Each masked run: every masked pixel exactly 0 (sums, squares,
   film and exported file) and, where a budget left samples uneven,
   counted done with every sample; >= 99% of the unmasked pixel channels
   within 4 combined standard errors of the unmasked run; its walk steps
   a sample over the unmasked run's between 0.5 and 1.5 times the
   unmasked share of the frame (the ratio printed; under the budget, at most 1.5 times);
   its path's kernels launch.
10b. ``utils/profiling``: ``profile_trace`` around one 1-spp solve of
   that lobed_u at depth PROFILE_DEPTH: the Chrome trace file exists and
   names the port's own kernels (``sweep_resolve`` and
   ``compact_lanes``); ``StageTimer``'s report of the load,
   ``prepare()`` and the solve printed.
10c. ``solver/debug.trace_walk`` from the lobed_u pixel farthest from the
   Dirichlet set, on the card: the walk starts at the pixel, ends
   inactive within TRACE_DEPTH steps, and its contributions are finite.

11. The BVH route (``Problem.load_config(accel="bvh")``: no grid, every
   set with its trees; kernels B1-B4 of ``csrc/bvh.cu``).
11a. B1-B4 against their plain versions (``ops/bvh.py``): B1 on lobed_u's
   1,048,576 frame points x its 65,536 segments (the plain version on a
   strided subset of BVH_PLAIN_LANES lanes) and on bumpy3d_5's 65,536
   frame points x 20,480 triangles; B2 (closest hit and any hit), B3 and
   B4 on neumann3d_u's 65,536 lanes after WARM_STEPS depth steps of the
   BVH route, with their live mask and star radii from ``_separate`` x
   the blob's 20,480 triangles and 30,720 silhouette edges.  Distances
   and t within TOL, hit flags exact, ids exact but where two distances
   tie within TOL; B3's ids on >= 1 - CDF_FLIPS of the lanes and its pdf
   within TOL where they agree; B4 also against the port's dense sweep.
   Edge cases: no lane live, lane N - 1 alone (for B1 on EDGE_LANES of
   its subset), rays whose hits lie past tmax, balls that hold no prim.  Each record: call and device ms, host
   us, the plain version's ms on its lanes, the bound (the lanes' inputs
   and outputs and the tree's fields read once, or the operations of
   the mean nodes a lane visits, ``bound_ms``; and the bytes at those
   visits, ``bound_visits_ms``) and its launches on [11b] (B1) and [11d]
   (B2-B4); B1 in 3D has its own record (``closest_point_bvh_3d``,
   launches on [11c]).  The visits are the kernel's own count for B1 and
   B4 (``visits=``; the plain versions count pruned pops, or level
   pairs, beside it as ``plain_mean_visits``) and the plain version's
   pops in the kernel's order for B2 and B3.  B1 and B4 read the packed
   trees (``ops/bvh.pack_trees``): their records add the ``-Xptxas -v``
   registers and local memory of their entries (a stack frame or a
   spill fails the phase) and the packs' bytes and the ms of building
   them anew.
11b. lobed_u (1024^2, depth 64, eps 1, BVH_SPP samples) on the BVH route
   through ``run_expr(accel="bvh")`` (the balanced route): B1 launches and
   K1-K3 do not; the film within 4 combined standard errors of [4]'s
   grid-route film on >= 99% of pixel channels; one depth step under the
   sync probe, as [8d]; its walk-steps/s against [4]'s.
11c. The mixed cube cut finer (33 x 33 squares a face: 4,356 Dirichlet
   and 8,712 Neumann triangles) on the BVH route: [6]'s three points,
   1,024 lanes of CUBE_FINE_SPP samples each, depth 256, each within
   0.07 of u on the balanced and per-sample routes; B1-B4 launch.
11d. neumann3d_u as shipped (256^2, depth 64, BVH_SPP samples) on the BVH
   route (the unfused step: no band grid): a finite film, B2-B4 launch;
   printed, not gated: its depth-capped share and walk-steps/s against
   [8]'s band route, and its share of pixel channels within 4 combined
   standard errors of [8]'s film; then the device ms by kernel of
   BVH_TRACE_STEPS depth steps of its walks under
   ``utils/profiling.profile_trace``.

12. The multi-rank path (``parallel/dp.py``; the lanes sharded over the
   ranks of a process group), after every kernel is built.
12a. A one-rank NCCL group: lobed_n's lockstep training chunk over it
   under [8d]'s sync probe (its all-reduces make the host wait for
   nothing).  Then MULTI_RANKS ranks spawned under gloo, both on cuda:0
   (correct, but no scaling to read), run ``parallel/dryrun.py``'s five
   steps: equal on both ranks.
12b-12d. The same ranks run lobed_u (1024^2, MULTI_SPP samples), lobed_n
   (MULTI_N_SPP of which MULTI_TRAIN_SPP train) and neumann3d_u (256^2,
   MULTI_3D_SPP) through ``run_expr(devices=2, group=)``: each rank's launch
   counts, zeroed just before each run, printed, and each kernel of the
   path above 0 on every rank (K11, the one-shot DIRICHLET_SDF channel, on
   rank 0, which alone renders it); ``walk_steps`` the sum of the ranks';
   each film within 4 combined standard errors of [4]'s, [4g]'s and [8]'s
   on >= 99% of pixel channels; lobed_n's trainers equal on both ranks
   (their digests); walk-steps/s printed as a reading.

Each phase ends with a line of its wall seconds (``[4d]: 3.2 s wall``),
and ``[total]`` gives the whole run's.  The lines before the last hold
the card's name and power limit and one
JSON object with each kernel's launches, error, times and bound; the last
line is ``{"ok": true, "device": {...}}``.  Each record names the inputs
its figures were taken at (``shape``; K13's lane-list form and K6 without
its skip have their own keys).  Each kernel and library call has two
times: call ms (``ms``, ``library_ms``: one call with the device
idle, between two CUDA events, the host's enqueue inside) and device ms
(``device_ms``, ``library_device_ms``: the median per call of 100 calls
enqueued behind a device-side wait), with the host's enqueue us per call
over those 100 (``host_us``, ``library_host_us``).
"""

from __future__ import annotations

import contextlib
import json
import os
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
CUBE_SPP = 8                 # samples of each of the source cube's 1,024
#                              lanes a point (phase 6b): its standard
#                              error at one sample (~0.019) left its
#                              depth-128 mean (~0.03 under u) ~2 SE from
#                              the 0.07 bound
CUBE_U_SPP = 4               # the same for the cube without a source
#                              (phase 6; 8 before PR 19: its points lay
#                              within 0.014 of u at 8, no bias to absorb)
SOURCE_3D_SPP = 16           # [8b]'s samples (64 before PR 19; its gates
#                              are a finite film and K7's launches)
NEUMANN3D_N_SPP = 32         # [8g]'s samples, GUIDED_3D_TRAIN_SPP of them
#                              training (64 before PR 19; the film gate
#                              combines both films' standard errors, and
#                              neumann3d_u on two ranks at 16 spp met it)
SOURCE_CUBE_DEPTH = 128      # the source cube's depth (phase 6b): a walk
#                              that crosses a Neumann face drifts away
#                              geometrically, and past depth ~240 its
#                              R^2 / 6 source weight overflows to inf
GUIDED_TRAIN_SPP = 8         # lobed_n's training samples of its SPP
#                              (phase 4g; the config: 256 of 1,024)
GUIDED_3D_TRAIN_SPP = 16     # bumpy3d_n's and neumann3d_n's training
#                              samples (phases 7g, 8g: the config's 16 of
#                              64; [8g] runs 32)
SQUARE_SPP, SQUARE_TRAIN_SPP = 64, 16    # the guided square (phase 3b;
#                              128 and 32 before PR 18: 7 x 256 lanes x 64
#                              samples leave a standard error of ~0.004
#                              against the 0.07 bound)
SQUARE_NET = {"encoding": {"base_resolution": 4, "n_levels": 4,
                           "n_features_per_level": 2,
                           "per_level_scale": 1.5},
              "network": {"n_neurons": 32, "n_hidden_layers": 2}}
#                              (tests/test_guided.py's network)
NOGRID_SPP = 8               # samples of the no-grid run (phase 4c)
ROUTE_DEPTH = 256            # depth of the grid / no-grid comparison (4c)
AGREE_SPP = 8                # samples a side of the chunked / band check
#                              (4e; 16 before PR 18: the 4-SE gate combines
#                              both sides' standard errors at any count)
WAVY_SPP = 8                 # samples of the wavy box of 8,192 segments (4f)
WARM_STEPS = 3               # depth steps before the kernel phases take lanes
GUIDED_WARM_STEPS = 8        # guided steps before [8g]'s K6 check (below
#                              the max guided depth, 10)
LANES_STEPS = 16             # bench-square steps before K13's lane-list
#                              check: ~15% of the lanes live, as on average
K1_SIZES = (1048576, 65536, 1048576)   # K1's back-to-back edge cases: the
#                              2D main path's lanes, the 3D one's, the 2D again
TOL = 1e-5                   # rtol and atol of distances; ids and colors exact
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_S = 67e12          # H100 SXM float32 rate outside the tensor cores
RESOLVE_SOURCE = "elaina_tpu_torch/csrc/resolve.cu"
QUERIES_SOURCE = "elaina_tpu_torch/csrc/queries.cu"
BVH_SOURCE = "elaina_tpu_torch/csrc/bvh.cu"
KERNELS = {   # name -> (source, TPU kernel or JAX function it replaces)
    "compact_lanes": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:594"),
    "sweep_resolve": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:194"),
    "fetch_colors": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:540"),
    "sweep_resolve_3d": (RESOLVE_SOURCE,
                         "elaina_tpu/ops/pallas_resolve.py:352"),
    "fetch_colors3": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_resolve.py:554"),
    "band_neumann_walk": (QUERIES_SOURCE,
                          "elaina_tpu/ops/pallas_queries.py:1043"),
    "band_ray": (QUERIES_SOURCE, "elaina_tpu/ops/pallas_queries.py:792"),
    "band_ball": (QUERIES_SOURCE, "elaina_tpu/ops/pallas_queries.py:1189"),
    "sil_band": (QUERIES_SOURCE, "elaina_tpu/ops/pallas_queries.py:622"),
    "grid_band_2d": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_queries.py:136"),
    "grid_band_3d": (RESOLVE_SOURCE, "elaina_tpu/ops/pallas_queries.py:316"),
    "sil_band_2d": (QUERIES_SOURCE, "elaina_tpu/ops/pallas_queries.py:622"),
    "candidate_rows": (QUERIES_SOURCE,
                       "elaina_tpu/ops/pallas_queries.py:499"),
    "closest_point_dense": (QUERIES_SOURCE,
                            "elaina_tpu/ops/pallas_queries.py:421"),
    # the BVH route's traversals: vmap-ed while loops in the JAX package,
    # not Pallas kernels
    "closest_point_bvh": (BVH_SOURCE, "elaina_tpu/geometry/queries.py:109"),
    "closest_point_bvh_3d": (BVH_SOURCE,
                             "elaina_tpu/geometry/queries.py:109"),
    "ray_bvh": (BVH_SOURCE, "elaina_tpu/geometry/queries.py:385"),
    "sample_in_ball_bvh": (BVH_SOURCE, "elaina_tpu/geometry/queries.py:527"),
    "closest_silhouette_bvh": (BVH_SOURCE,
                               "elaina_tpu/geometry/queries.py:295"),
}
# a record whose launches are another wrapper's count
COUNTER_OF = {"closest_point_bvh_3d": "closest_point_bvh"}
MAIN_2D = ("compact_lanes", "sweep_resolve", "fetch_colors")
MAIN_3D = ("compact_lanes", "sweep_resolve_3d", "fetch_colors3",
           "band_neumann_walk", "sil_band", "grid_band_3d")
BUMPY_3D = ("compact_lanes", "sweep_resolve_3d", "fetch_colors3")
# each guided path's uniform counterpart (the film it is held to)
UNIFORM_OF = {"lobed_n": "lobed_u", "bumpy3d_n": "bumpy3d_u",
              "neumann3d_n": "neumann3d_u"}
# the run whose launches each kernel's record reports: its own path
PATH_OF = {**{k: "lobed_u" for k in MAIN_2D},
           **{k: "neumann3d_u" for k in MAIN_3D},
           "grid_band_2d": "channels_2d", "band_ray": "neumann3d_source",
           "band_ball": "neumann3d_unfused", "sil_band_2d": "wavy8192_u",
           "candidate_rows": "bare_grid", "closest_point_dense": "nogrid_u",
           "closest_point_bvh": "lobed_u_bvh",
           "closest_point_bvh_3d": "cube_bvh",
           **{k: "neumann3d_u_bvh" for k in ("ray_bvh", "sample_in_ball_bvh",
                                             "closest_silhouette_bvh")}}
BVH_KERNELS = ("closest_point_bvh", "ray_bvh", "sample_in_ball_bvh",
               "closest_silhouette_bvh")
CDF_FLIPS = 0.005            # K6 / K8 CDF slot flips allowed, share of lanes
BUDGET_SHARE = 0.5           # [9c]'s budget: this share of [8]'s solve wall
BUDGET_SPP = 28              # [9a] / [9b]: the budget is the host
#                              partitions' seconds of [4]'s solve plus
#                              this many of its seconds a sample.  The
#                              budgeted rounds pay their partitions and
#                              drains again and ran their iterations
#                              ~1.4x slower than [4]'s (20 bought ~7.3 a
#                              pixel in a PR 18 card run), so 28 buys
#                              ~12-16 of SPP's 32 (at ~4 a 4-SE film gate
#                              fails ~3% of channels by chance)
GENEROUS = 10.0              # [9a]'s generous budget, times [4]'s solve wall
RESUME_SPP, RESUME_EVERY = 32, 16   # [9d]: the samples before the resume,
#                              and the checkpoint interval (half of
#                              SQUARE_SPP, as before PR 18)
MASK_FRAME = 256             # [10a]: the masked runs' frame (neumann3d_u's
#                              as shipped)
MASK_SPP, MASK_TRAIN_SPP = 8, 2   # [10a]: samples of each run, of which the
#                              guided ones train ([4g]'s 1 in 4); a 4-SE
#                              gate on standard errors of 4 samples a side
#                              (Welch's t at ~6 degrees of freedom) fails
#                              ~0.7% of channels by chance, and more under
#                              a budget
MASK_BUDGET_SHARE = 0.75     # [10a]'s budget: this share of the masked
#                              balanced solve's seconds
PROFILE_DEPTH = 8            # [10b]: the profiled solve's depth
TRACE_DEPTH = 1024           # [10c]: the traced walk's depth cap
BUDGET_3D = ("compact_lanes", "sweep_resolve_3d", "fetch_colors3",
             "band_neumann_walk", "sil_band")   # [9c]'s solve's kernels
ROUTES_SPP_CUT = 2           # [8r]: the per-sample runs take 1 / this of
#                              their balanced runs' samples
#                              (PR 18, to keep the run within 900 s on
#                              the card; the 4-SE gate combines both
#                              films' standard errors, but not below 16
#                              samples of neumann3d_u: see MULTI_3D_SPP)
BVH_PLAIN_LANES = 65536      # [11a]: lanes of each plain traversal
EDGE_LANES = 8192            # [11a]: B1's lanes under the edge masks (the
#                              plain B1 in 3D takes seconds at 65,536)
BVH_SPP = 8                  # [11b], [11d]: samples of the BVH route's runs
CUBE_FINE = 33               # [11c]: the cube's squares a face side
CUBE_FINE_SPP = 4            # [11c]: samples of each of its 1,024 lanes a
#                              point (4,096 walks: a standard error of at
#                              most 0.008 against the 0.07 bound)
BVH_TRACE_STEPS = 2          # [11d]: depth steps under profile_trace
BVH_TRACE_TOP = 12           # [11d]: kernels printed, by device ms
FLOPS_PER_VISIT = 36         # [11a]'s bound: float32 operations a node
#                              visit takes at the least (three box
#                              distances in 3D, 12 each)
MULTI_RANKS = 2              # [12]: gloo ranks, both on cuda:0 (two ranks
#                              on one card check the sharded path; they
#                              measure no scaling)
MULTI_SPP = 8                # [12b]: lobed_u's samples
MULTI_3D_SPP = 16            # [12d]: neumann3d_u's: at 8 a pixel whose
#                              walks the depth cap mostly kills can keep 8
#                              zeros (standard error 0), and one rank's
#                              film fails the 4-SE gate against [8]'s on
#                              ~2% of channels (0.97960 in a PR 19 card
#                              run; 0.99669 on two ranks at 16)
MULTI_N_SPP, MULTI_TRAIN_SPP = 10, 8   # [12c]: lobed_n's samples, and its
#                              training ones: with [4g]'s hints a training
#                              phase of 2 or 4 samples (~10 steps each)
#                              has no round above the depth, and its tail
#                              rounds train nothing
MULTI_TIMEOUT_S = 300        # [12]: the ranks' collectives and their join
# [12b]-[12d]: each run's kernels, which every rank must launch; K11 (the
# one-shot DIRICHLET_SDF channel) runs on rank 0 alone
MULTI_PATHS = {"lobed_u": MAIN_2D, "lobed_n": MAIN_2D,
               "neumann3d_u": MAIN_3D}
RANK0_ONLY = ("grid_band_3d",)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(label: str, fn, *args):
    """Run one phase and log its wall seconds, so that a slow run shows
    where its time went."""
    t0 = time.time()
    out = fn(*args)
    log(f"    {label}: {time.time() - t0:.1f} s wall")
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def all_kernels():
    from elaina_tpu_torch.ops import bvh, queries, resolve

    return {k.__name__: k
            for k in resolve.KERNELS + queries.KERNELS + bvh.KERNELS}


def reset_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


@contextlib.contextmanager
def capture_integrators():
    """The integrators that ``run_expr`` makes inside the block, so a
    phase can read the films and sums that the run keeps in memory."""
    from elaina_tpu_torch.solver import integrator as I

    made = []
    init = I.BaseIntegrator.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    I.BaseIntegrator.__init__ = record
    try:
        yield made
    finally:
        I.BaseIntegrator.__init__ = init


@contextlib.contextmanager
def fused_band(on: bool):
    """ELAINA_FUSED_BAND for the block: the fused K6 step or K8 + K7."""
    old = os.environ.get("ELAINA_FUSED_BAND")
    os.environ["ELAINA_FUSED_BAND"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ELAINA_FUSED_BAND"]
        else:
            os.environ["ELAINA_FUSED_BAND"] = old


def frame_points(conf_path: str) -> np.ndarray:
    """The config's pixel points (N, dim), in film order."""
    import torch

    from elaina_tpu_torch.core.evaluation_grid import EvaluationGrid

    with open(conf_path) as f:
        conf = json.load(f)
    w, h = conf["integrator"]["setting"]["frameSize"]
    probe = EvaluationGrid.from_json(conf["scene"]["evaluation_grid"],
                                     conf["dimensionality"])
    return probe.points(torch.arange(w * h), (w, h)).numpy()


# --------------------------------------------------------------------------- #
# measurement helpers
# --------------------------------------------------------------------------- #


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

    def add(self, name, err, fn, plain, library, n_bytes, flops, shape,
            plain_ms=None, **extra):
        """Time a kernel, its plain version and its library call: call ms
        (``cuda_ms``) for all three, device ms and host us (``device_ms``)
        for the kernel and the library call, at the inputs that ``shape``
        names (``plain_ms``, where given, is the plain version's time,
        measured by the caller); ``extra`` goes into the record as it
        is."""
        from elaina_tpu_torch.utils.timing import (DEVICE_LAUNCHES,
                                                   TIMED_RUNS, cuda_ms,
                                                   device_ms)

        ms = cuda_ms(fn)
        dev_ms, host_us, hidden = device_ms(fn)
        if plain_ms is None:
            plain_ms = cuda_ms(plain)
        lib = {"library_ms": None, "library_device_ms": None,
               "library_host_us": None, "library_hidden": None}
        if library is not None:
            lib["library_ms"] = cuda_ms(library)
            (lib["library_device_ms"], lib["library_host_us"],
             lib["library_hidden"]) = device_ms(library)
        bound_ms, bound_by = bound(n_bytes, flops)
        source, replaces = KERNELS[name]
        self.records[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "host_us": host_us,
            "hidden": hidden, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **lib, "shape": shape, **extra}
        lib_s = "none" if library is None else (
            f"{lib['library_ms']:.4f} ms (device "
            f"{lib['library_device_ms']:.4f} ms, host "
            f"{lib['library_host_us']:.1f} us"
            f"{'' if lib['library_hidden'] else ', not hidden'})")
        log(f"    {name}: max_abs_err {err:.3g}, kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms, host {host_us:.1f} us"
            f"{'' if hidden else ', not hidden'}), plain {plain_ms:.4f} ms, "
            f"library {lib_s}, bound {bound_ms:.4f} ms ({bound_by}; call ms "
            f"median of {TIMED_RUNS}, device ms of {DEVICE_LAUNCHES}; "
            f"{shape}; {self.card})")


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_build() -> None:
    from elaina_tpu_torch.geometry import native
    from elaina_tpu_torch.ops import bvh, queries, resolve

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(timed, f) for f in (
            resolve.library, queries.library, bvh.library, native.library)]
        secs = [f.result() for f in futures]
    log(f"[1] build: nvcc resolve kernels {secs[0]:.1f} s, nvcc band "
        f"kernels {secs[1]:.1f} s, nvcc BVH kernels {secs[2]:.1f} s, g++ "
        f"scene library {secs[3]:.1f} s (in parallel)")
    for lib in (resolve, queries, bvh):
        for line in lib.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def need_lanes(g, state, n: int):
    """The FinePack need mask and rows of a state, with K1 checked on it."""
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
    return need, n_need, row


def check_compact_cases(need) -> None:
    """K1 back to back on N = 1,048,576, 65,536 and 1,048,576 lanes (the
    2D main path's need mask, then a seeded mask at the 3D main path's
    density of 3,876 in 65,536): each mask with cap = N, cap = cnt / 2
    and cap = 1, cut to N - 13 lanes (off the 4,096-lane tile) and viewed
    from lane 13 (off 16 bytes), and all-clear and all-set masks of N
    lanes.  Every call is enqueued before any is read, so a status word
    left by one call would show in the next; ids and cnt must equal the
    plain version's exactly."""
    import torch

    from elaina_tpu_torch.ops import resolve as R

    gen = torch.Generator(device=need.device)
    gen.manual_seed(3)
    calls = []
    for n in K1_SIZES:
        if n == need.shape[0]:
            m = need
        else:
            m = torch.rand(n, generator=gen, device=need.device) < 3876 / n
        cnt = int(m.sum())
        for mask, cap in ((m, n), (m, max(cnt // 2, 1)), (m, 1),
                          (m[:n - 13], n), (m[13:], n),
                          (torch.zeros_like(m), n), (torch.ones_like(m), n),
                          (torch.ones_like(m), n // 3)):
            calls.append((mask, cap, R.compact_lanes(mask, cap)))
    for mask, cap, (lanes, cnt) in calls:
        lanes_p, cnt_p = R.compact_lanes_plain(mask, cap)
        k = min(int(cnt_p), cap)
        if not (torch.equal(cnt, cnt_p) and torch.equal(lanes[:k],
                                                        lanes_p[:k])):
            raise RuntimeError(f"compact_lanes differs on {mask.shape[0]} "
                               f"lanes, {int(cnt_p)} set, cap {cap}: cnt "
                               f"{int(cnt)}")
    log(f"    compact_lanes: {len(calls)} calls back to back on "
        f"{', '.join(str(n) for n in K1_SIZES)} lanes (cap N, cnt/2 and 1; "
        f"N - 13 lanes; a view off 16 bytes; all clear; all set) equal the "
        f"plain version")


def check_resolve(name: str, mask, row, q, g, label: str) -> float:
    """K2 or K4 as the path calls it (the N-wide mask, K1 inside the
    wrapper) against its plain version on ``mask``: ids exact, K4's
    corners exact, distances within TOL (the count of those that differ in
    their bits logged), K2's t within TOL and its side's sign where |side|
    > TOL, and the lanes off the mask exactly 0 (pid -1); returns the
    largest distance difference."""
    import torch

    from elaina_tpu_torch.ops import resolve as R

    args = (mask, row, q, g.coords, g.cand)
    out = getattr(R, name)(*args)
    out_p = getattr(R, name + "_plain")(*args)
    d, d_p = out[0], out_p[0]
    pid, pid_p = (out[3], out_p[3]) if name == "sweep_resolve" else \
        (out[1], out_p[1])
    v = mask
    err = float((d[v] - d_p[v]).abs().max()) if bool(v.any()) else 0.0
    if not torch.allclose(d[v], d_p[v], rtol=TOL, atol=TOL):
        raise RuntimeError(f"{name} distances differ on {label}: {err}")
    if not torch.equal(pid, pid_p):
        raise RuntimeError(f"{name} picked another prim on "
                           f"{int((pid != pid_p).sum())} lanes of {label}")
    off = ~mask
    if name == "sweep_resolve":
        t, t_p, side, side_p = out[1], out_p[1], out[2], out_p[2]
        err = max(err, float((t[v] - t_p[v]).abs().max()) if bool(v.any())
                  else 0.0)
        if not torch.allclose(t[v], t_p[v], rtol=TOL, atol=TOL):
            raise RuntimeError(f"sweep_resolve t differs on {label}: {err}")
        big = v & (side_p.abs() > TOL)
        if bool((torch.sign(side[big]) != torch.sign(side_p[big])).any()):
            raise RuntimeError(f"sweep_resolve side differs on {label}")
        zero = (d[off] == 0).all() & (t[off] == 0).all() & \
            (side[off] == 0).all()
    else:
        if not torch.equal(out[2], out_p[2]):
            raise RuntimeError(f"sweep_resolve_3d corners differ on {label}")
        zero = (d[off] == 0).all() & (out[2][off] == 0).all()
    if not bool(zero & (pid[off] == -1).all()):
        raise RuntimeError(f"{name}: a lane off the mask of {label} is not "
                           f"0 / -1")
    log(f"    {name} on {label}: {int(v.sum())} of {v.shape[0]} lanes "
        f"listed, ids exact, {int((d[v] != d_p[v]).sum())} distances "
        f"differ in their bits, the other lanes 0 / -1")
    return err


def check_resolve_cases(name: str, need, row, q, g, label: str) -> float:
    """check_resolve on the path's need mask, then on an empty mask, every
    lane set, and lane N - 1 alone."""
    import torch

    last = torch.zeros_like(need)
    last[-1] = True
    err = check_resolve(name, need, row, q, g, f"{label}'s need lanes")
    for mask, case in ((torch.zeros_like(need), "an empty mask"),
                       (torch.ones_like(need), "every lane"),
                       (last, "lane N - 1 alone")):
        err = max(err, check_resolve(name, mask, row, q, g,
                                     f"{label}, {case}"))
    return err


def resolve_split(dim: int, need, row, q, g) -> dict:
    """The wrapper's two launches apart: K1 alone on ``need`` and K2 / K4
    alone over K1's list (``ops.resolve._sweep_lanes``), each equal to the
    wrapper's output; device ms and host us of each (``device_ms``)."""
    import torch

    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.utils.timing import device_ms

    n = need.shape[0]
    lanes, cnt = R.compact_lanes(need, n)
    args = (dim, need, lanes.data_ptr(), cnt.data_ptr(), row, q, g.coords,
            g.cand)
    wrapper = R.sweep_resolve if dim == 2 else R.sweep_resolve_3d
    want = wrapper(need, row, q, g.coords, g.cand)
    if not all(torch.equal(a, b) for a, b in zip(R._sweep_lanes(*args),
                                                 want)):
        raise RuntimeError(f"{wrapper.__name__} alone over K1's list "
                           f"differs from the wrapper")
    out = {}
    for key, fn in (("k1", lambda: R.compact_lanes(need, n)),
                    ("sweep", lambda: R._sweep_lanes(*args))):
        out[f"{key}_device_ms"], out[f"{key}_host_us"], _ = device_ms(fn)
    log(f"    {wrapper.__name__}'s launches apart: K1 {out['k1_device_ms']:.4f}"
        f" ms device, {out['k1_host_us']:.1f} us host; the sweep alone over "
        f"its list {out['sweep_device_ms']:.4f} ms device, "
        f"{out['sweep_host_us']:.1f} us host; equal to the wrapper's")
    return out


def check_band_bits(name: str, out, ref, label: str) -> None:
    """K10 / K11's (d^2, slot, corners) equal to the plain version's bit
    for bit on every lane, the fill of lanes without a row included."""
    import torch

    for what, a, b in zip(("d^2", "slots", "corners"), out, ref):
        if not torch.equal(a, b):
            bad = (a != b) if a.dim() == 1 else (a != b).any(1)
            raise RuntimeError(f"{name} on {label}: {int(bad.sum())} lanes' "
                               f"{what} differ from the plain version's")


def check_grid_band(name: str, row, q, g, kernels: Kernels | None,
                    label: str) -> None:
    """K10 / K11 on every lane's candidate row against the plain version:
    d^2, slot (the smallest on equal d^2, the plain argmin's first
    minimum, so the prim id too) and corners equal bit for bit.  With
    ``kernels``, its record (times, bound, and the row lookup
    ``grid_row_index`` and the whole chain path ``grid_closest_point``
    timed at the same points) is added."""
    from elaina_tpu_torch.geometry.grid import (grid_closest_point,
                                                grid_row_index)
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.utils.timing import cuda_ms, device_ms

    kern, plain = getattr(R, name), getattr(R, name + "_plain")
    args = (row.contiguous(), q.contiguous(), g.coords)
    out = kern(*args)
    check_band_bits(name, out, plain(*args), label)
    v = row >= 0
    K = g.cand.shape[1]
    n = int(v.sum())
    rows = n_unique(row[v])
    log(f"    {name} on {label}: {n} lanes over {rows} rows of K = {K}, "
        f"bit-equal")
    if kernels is None:
        return
    dim, Kp = q.shape[1], g.coords.shape[2]
    lookup = {}
    for key, fn in (("row_index", lambda: grid_row_index(g, q)),
                    ("chain", lambda: grid_closest_point(g, q))):
        lookup[f"{key}_ms"] = cuda_ms(fn)
        (lookup[f"{key}_device_ms"], lookup[f"{key}_host_us"],
         _) = device_ms(fn)
    log(f"    {label}: grid_row_index {lookup['row_index_ms']:.4f} ms "
        f"(device {lookup['row_index_device_ms']:.4f} ms, host "
        f"{lookup['row_index_host_us']:.1f} us), grid_closest_point "
        f"{lookup['chain_ms']:.4f} ms (device "
        f"{lookup['chain_device_ms']:.4f} ms, host "
        f"{lookup['chain_host_us']:.1f} us) ({kernels.card})")
    kernels.add(name, 0.0, lambda: kern(*args), lambda: plain(*args), None,
                n * (4 + 4 * dim + 4 + 4 + 4 * dim * dim)
                + rows * dim * dim * Kp * 4,
                (20.0 if dim == 2 else 120.0) * n * K,
                f"{label}: {n} lanes over {rows} rows of K = {K}", **lookup)


TIE_SLOTS = (5, 6, 8, 9, 12, 37, 66, 130)   # the tie case's repeated slots


def check_grid_band_ties(name: str, Kp: int, device) -> None:
    """K10 / K11 on a made-up table of Kp slots: row 0 holds one segment
    (triangle) at TIE_SLOTS and slot Kp - 1, slots in other threads'
    strides (at 4 threads a lane, slot 5 falls to the second thread, 8
    to the third, 66 and 130 to the first), among candidates 100 units
    away; every slot of row 1 holds a
    prim at 1e20, whose d^2 overflows.  4,096 points within a unit of the
    repeated prim, on rows 0, 1 and -1: d^2, slot and corners bit-equal
    to the plain version's, slot 5 (the smallest tied) on row 0, slot 0
    on row 1."""
    import torch

    from elaina_tpu_torch.ops import resolve as R

    dim = 2 if name == "grid_band_2d" else 3
    npl = dim * dim
    rng = np.random.default_rng(5)
    tab = rng.uniform(100.0, 110.0, (2, npl, Kp)).astype(np.float32)
    tied = [s for s in TIE_SLOTS if s < Kp] + [Kp - 1]
    tab[0][:, tied] = rng.uniform(0.0, 1.0, (npl, 1)).astype(np.float32)
    tab[1] = 1e20
    n = 4096
    row = np.array([0, 0, 1, 0, -1, 0, 0, 1], np.int32)[np.arange(n) % 8]
    q = rng.uniform(0.0, 1.0, (n, dim)).astype(np.float32)
    coords = torch.as_tensor(tab, device=device)
    args = (torch.as_tensor(row, device=device),
            torch.as_tensor(q, device=device), coords)
    out = getattr(R, name)(*args)
    ref = getattr(R, name + "_plain")(*args)
    check_band_bits(name, out, ref, f"the tie table (Kp = {Kp})")
    slot = out[1].cpu().numpy()
    if not ((slot[row == 0] == min(tied)).all()
            and (slot[row != 0] == 0).all()
            and np.isinf(out[0].cpu().numpy()[row != 0]).all()):
        raise RuntimeError(f"{name}: a tie or an overflow took another slot")
    log(f"    {name} on the tie table (Kp = {Kp}, slots {tied} tied, a row "
        f"that overflows, rows -1): bit-equal, slot {min(tied)} on every "
        f"tied lane")


def bilinear_np(data, origin, inv_voxel, p):
    """A plain bilinear sample of an (X, Y, C) grid at points p (N, 2),
    clamped at the border, as numpy float32."""
    f = ((p - origin) * inv_voxel).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    fr = f - i0.astype(np.float32)
    hi = np.asarray(data.shape[:2]) - 1
    out = np.zeros((p.shape[0], data.shape[2]), np.float32)
    for cx in (0, 1):
        for cy in (0, 1):
            ii = np.clip(i0 + np.asarray([cx, cy]), 0, hi)
            w = ((fr[:, 0] if cx else 1.0 - fr[:, 0])
                 * (fr[:, 1] if cy else 1.0 - fr[:, 1]))
            out += w[:, None] * data[ii[:, 0], ii[:, 1]]
    return out


def phase_kernels(conf_path: str, device, kernels: Kernels) -> None:
    """K1-K3 against their plain versions on the 2D main path's lanes."""
    import torch

    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.utils import scenes as S
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state

    t0 = time.time()
    problem, integ = load_integrator(conf_path, device)
    torch.cuda.synchronize()
    g = problem.scene.d_grid
    log(f"[2] scene: {problem.stats['dirichlet_grid']}, fine res "
        f"{g.fine.res}, tables {problem.table_bytes()} bytes, built in "
        f"{time.time() - t0:.1f} s")
    state = warm_state(problem, integ, WARM_STEPS)
    n = state.pos.shape[0]
    need, n_need, row = need_lanes(g, state, n)
    check_compact_cases(need)
    kernels.add("compact_lanes", 0.0, lambda: R.compact_lanes(need, n),
                lambda: R.compact_lanes_plain(need, n),
                lambda: torch.nonzero(need), n + 4 * n_need + 4, 0.0,
                f"lobed_u's need mask after {WARM_STEPS} steps: {n} lanes, "
                f"{n_need} set")

    # K2 as _fast_dirichlet calls it: the N-wide need mask, K1 inside
    q = state.pos
    err = check_resolve_cases("sweep_resolve", need, row, q, g, "lobed_u")
    args = (need, row, q, g.coords, g.cand)
    d, t, side, pid = R.sweep_resolve(*args)
    Kp = g.coords.shape[2]
    rows = n_unique(row[need])
    split = resolve_split(2, need, row, q, g)
    reread = n_need * 4 * Kp * 4
    log(f"    sweep_resolve: {n_need} lanes over {rows} rows read "
        f"{reread / 1e6:.1f} MB of rows, {reread / rows / Kp / 16:.1f} "
        f"reads a row; alone that is "
        f"{reread / split['sweep_device_ms'] / 1e9:.2f} TB/s")
    kernels.add("sweep_resolve", err, lambda: R.sweep_resolve(*args),
                lambda: R.sweep_resolve_plain(*args), None,
                n + n_need * (4 + 8 + 4 + 16) + rows * 4 * Kp * 4,
                20.0 * n_need * g.cand.shape[1],
                f"lobed_u's {n_need} need lanes of {n}, rows of K = "
                f"{g.cand.shape[1]} (K1 inside)", rows=rows, **split)

    # K3: the in-shell lanes' colors, exact
    ins = need & (d < S.EPS) & (t > 0.0) & (t < 1.0)
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
                n * 5 + n_unique(cfi[ins]) * 24 + n_ins * 24, 0.0,
                f"lobed_u: {n_ins} in-shell lanes of {n}")

    # K10: every pixel's row through the chain path, as the DIRICHLET_SDF
    # channel hands them over
    from elaina_tpu_torch.geometry.grid import grid_row_index

    q_pix = integ.eval_points
    check_grid_band("grid_band_2d", grid_row_index(g, q_pix), q_pix, g,
                    kernels, "the 1024^2 pixels")
    check_grid_band_ties("grid_band_2d", g.coords.shape[2], device)


def check_bits(name: str, d, d_p, ids, ids_p) -> None:
    """Distances bit-equal to the plain version's, ids exactly equal."""
    import torch

    if not torch.equal(d, d_p):
        raise RuntimeError(f"{name}: {int((d != d_p).sum())} distances "
                           f"differ in their bits")
    if not torch.equal(ids, ids_p):
        raise RuntimeError(f"{name}: {int((ids != ids_p).sum())} ids differ")


def check_exact(name: str, d, d_p, ids, ids_p) -> float:
    """Finite distances within TOL of the plain version's (inf where it is
    inf), ids or slots exactly equal; returns the largest difference."""
    import torch

    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d), fin):
        raise RuntimeError(f"{name}: inf / finite differ")
    err = float((d[fin] - d_p[fin]).abs().max())
    if not torch.allclose(d[fin], d_p[fin], rtol=TOL, atol=TOL):
        raise RuntimeError(f"{name} distances differ: {err}")
    if not torch.equal(ids, ids_p):
        raise RuntimeError(f"{name}: {int((ids != ids_p).sum())} ids differ")
    return err


def phase_kernels_2c(conf_2d: str, conf_wavy: str, device,
                     kernels: Kernels) -> dict:
    """[2c] K13 and K12 on the frame points over bench.py's curve, K9-2D on
    the wavy box's warmed lanes; returns the launches of the bare-grid
    ``grid_closest_point`` call (K12's path)."""
    import torch

    from elaina_tpu_torch.core.problem import grid_bounds
    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.geometry.grid import (build_candidate_grid,
                                                grid_closest_point,
                                                grid_from_numpy,
                                                grid_row_index)
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.utils import scenes as S
    from elaina_tpu_torch.utils.ab import (bench_square, load_integrator,
                                           warm_state)

    log("[2c] K13, K12 and K9-2D")
    q = torch.as_tensor(frame_points(conf_2d), device=device).contiguous()
    n = q.shape[0]
    verts, idx, colors = S.bench_square_scene()
    a = torch.as_tensor(verts[idx[:, 0]], device=device)
    b = torch.as_tensor(verts[idx[:, 1]], device=device)
    P = a.shape[0]

    # K13: every frame point against every segment of bench.py's curve
    d13, pid = QK.closest_point_dense(q, a, b)
    d_p, pid_p = QK.closest_point_dense_plain(q, a, b)
    check_bits("closest_point_dense", d13, d_p, pid, pid_p)
    # vertex 5 ends segment 4 and starts segment 5: d = 0 for both
    dv, pv = QK.closest_point_dense(torch.as_tensor(verts[5:6], device=device),
                                    a, b)
    log(f"    closest_point_dense: {n} points x {P} segments, distances "
        f"bit-equal and ids equal to the plain version's; at the shared "
        f"vertex 5: distance {float(dv[0])}, segment {int(pv[0])} (want 0, "
        f"4)")
    if float(dv[0]) != 0.0 or int(pv[0]) != 4:
        raise RuntimeError("closest_point_dense broke the tie at a vertex")
    # its lane-list form on the bench square's walks a few steps in (K1
    # compacts the live lanes, as _dense_dirichlet hands them over), and
    # on every lane of that state
    from elaina_tpu_torch.utils.timing import cuda_ms, device_ms

    problem, integ = bench_square(device, 1)
    walks = warm_state(problem, integ, LANES_STEPS)
    qw = walks.pos.contiguous()
    act = walks.active.contiguous()
    cnt = int(act.sum())
    for label, m in (("live lanes", act), ("every lane", torch.ones_like(act)),
                     ("no lane", torch.zeros_like(act))):
        dl, pl = QK.closest_point_dense(qw, a, b, m)
        dl_p, pl_p = QK.closest_point_dense_plain(qw, a, b, m)
        check_bits(f"closest_point_dense ({label})", dl, dl_p, pl, pl_p)
        log(f"    closest_point_dense, lane list, {label} ({int(m.sum())} of "
            f"{n}): bit-equal, ids equal")
    del problem, integ

    def listed():
        return QK.closest_point_dense(qw, a, b, act)

    l_dev, l_host, _ = device_ms(listed)
    l_bound, l_by = bound(n + 4 * cnt + 4 + n + cnt * 12 + P * 16 + n * 8,
                          14.0 * cnt * P)
    lanes = {"lanes_shape": f"the bench square after {LANES_STEPS} steps: "
                            f"{cnt} live of {n} lanes x {P} segments (K1 "
                            f"and K13)",
             "lanes_ms": cuda_ms(listed), "lanes_device_ms": l_dev,
             "lanes_host_us": l_host,
             "lanes_plain_ms": cuda_ms(
                 lambda: QK.closest_point_dense_plain(qw, a, b, act)),
             "lanes_bound_ms": l_bound, "lanes_bound_by": l_by}
    log(f"    closest_point_dense, lane list: {lanes['lanes_ms']:.4f} ms "
        f"(device {l_dev:.4f} ms, host {l_host:.1f} us), plain "
        f"{lanes['lanes_plain_ms']:.4f} ms, bound {l_bound:.4f} ms ({l_by}; "
        f"{lanes['lanes_shape']}; {kernels.card})")
    kernels.add("closest_point_dense", 0.0,
                lambda: QK.closest_point_dense(q, a, b),
                lambda: QK.closest_point_dense_plain(q, a, b), None,
                n * 8 + P * 16 + n * 8, 14.0 * n * P,
                f"{n} frame points x {P} segments (every lane)", **lanes)

    # K12: a bare candidate grid of the same curve, through the chain path
    lo, hi = grid_bounds(verts, [-100, -100], [600, 600])
    t0 = time.time()
    ga = build_candidate_grid(verts, idx, lo, hi, K=64, max_res=2048,
                              cache_dir=os.environ["ELAINA_CACHE_DIR"])
    bare = grid_from_numpy(**{k: getattr(ga, k) for k in (
        "cand", "meta", "row_lbound", "row_diag", "row_trunc", "origin",
        "inv_cell", "res")}, verts=verts, indices=idx, colors=colors,
        device=device)
    if bare.coords is not None:
        raise RuntimeError("the bare grid has a coordinate table")
    log(f"    bare candidate grid: res {ga.res}, {len(ga.meta)} levels, "
        f"{ga.cand.shape[0]} rows of K = 64, coverage {ga.coverage:.4f}, "
        f"{int(ga.row_trunc.sum())} truncated rows, built in "
        f"{time.time() - t0:.1f} s")
    reset_counts()
    d12, _ = grid_closest_point(bare, q)
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["candidate_rows"] != 1:
        raise RuntimeError(f"the bare grid launched K12 "
                           f"{launches['candidate_rows']} times, not once: "
                           f"{launches}")
    row = grid_row_index(bare, q)
    tr = bare.row_trunc[row.long()]
    same = torch.isclose(d12, d13, rtol=TOL, atol=TOL)
    below = d12 <= d13 * (1 + TOL) + TOL
    log(f"    grid_closest_point on the bare grid: {int(tr.sum())} of {n} "
        f"points in truncated rows (at most K13's distance there: "
        f"{bool(below[tr].all())}), the rest equal to K13's (1e-5): "
        f"{bool(same[~tr].all())}; {launches['candidate_rows']} K12 "
        f"launch")
    if not (same[~tr].all() and below[tr].all()):
        raise RuntimeError("the bare chain path disagrees with K13")

    # K12 as grid_closest_point calls it: every frame point's row, the
    # grid's rows and segment table
    args = (q, row, bare.cand, bare.seg)
    dk, pk = QK.candidate_rows(*args)
    dk_p, pk_p = QK.candidate_rows_plain(*args)
    check_bits("candidate_rows", dk, dk_p, pk, pk_p)
    Kw = bare.cand.shape[1]
    cand = bare.cand[row.long()]
    n_valid = int((cand >= 0).sum())
    rows = n_unique(row)
    del cand
    path_ms = cuda_ms(lambda: grid_closest_point(bare, q))
    path_dev = device_ms(lambda: grid_closest_point(bare, q))[0]
    log(f"    candidate_rows: {n} lanes x K = {Kw}, {n_valid} slots with an "
        f"id, {rows} distinct rows; bit-equal to the plain version; "
        f"grid_closest_point on the bare grid {path_ms:.4f} ms (device "
        f"{path_dev:.4f} ms; {kernels.card})")
    # each lane reads its point and row index and writes dist and pid;
    # the rows the lanes name and the segment table are read once (the
    # per-lane count, each lane's row read for it, is an extra key)
    kernels.add("candidate_rows", 0.0, lambda: QK.candidate_rows(*args),
                lambda: QK.candidate_rows_plain(*args), None,
                n * (8 + 4 + 8) + rows * 4 * Kw + P * 16, 14.0 * n_valid,
                f"{n} frame points' rows of a bare grid, K = {Kw}, "
                f"{n_valid} slots with an id, {rows} distinct rows",
                path_ms=path_ms, path_device_ms=path_dev,
                per_lane_rows_bound_ms=bound(
                    n * (8 + 4 + 4 * Kw + 8) + P * 16, 14.0 * n_valid)[0])

    # K9-2D on the wavy box's lanes after a few depth steps
    t0 = time.time()
    problem, integ = load_integrator(conf_wavy, device)
    torch.cuda.synchronize()
    log(f"    wavy box of 8,192 segments loaded in {time.time() - t0:.1f} s: "
        f"{problem.stats['neumann_sil_grid']}; "
        f"{problem.stats['neumann_band_grid']}")
    state = warm_state(problem, integ, WARM_STEPS)
    check_sil_band_2d(problem.scene.n_sgrid, state, kernels)
    return launches


def lane_masks(live):
    """The masks a lane-masked kernel is held to its plain version on: the
    step's live lanes, every lane, no lane and lane N - 1 alone."""
    import torch

    last = torch.zeros_like(live)
    last[-1] = True
    return (("the step's live lanes", live),
            ("every lane", torch.ones_like(live)),
            ("no lane", torch.zeros_like(live)), ("lane N - 1 alone", last))


def check_sil_band_2d(sg, state, kernels: Kernels) -> None:
    """K9-2D as ``_separate`` calls it (the walks' live mask) on
    wavy8192_u's lanes, bit-equal to its plain version on every mask of
    ``lane_masks`` and without a mask; timed on the live lanes and on
    every lane."""
    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.utils.timing import device_ms

    lin, outside = Q.band_cell(sg, state.pos)
    cell = torch.where(outside, -1, lin).to(torch.int32)
    q2 = state.pos.contiguous()
    live = state.active.contiguous()
    n2 = cell.shape[0]
    for label, m in (("no mask", None), *lane_masks(live)):
        d2 = QK.sil_band_2d(cell, q2, sg.coords, m)
        d2_p = QK.sil_band_2d_plain(cell, q2, sg.coords, m)
        if not torch.equal(d2, d2_p):
            raise RuntimeError(f"sil_band_2d differs from its plain version "
                               f"({label}): {int((d2 != d2_p).sum())} lanes")
        n_m = n2 if m is None else int(m.sum())
        log(f"    sil_band_2d, {label} ({n_m} of {n2}): bit-equal, "
            f"{int((d2 < 1e17).sum())} with a silhouette in their row")
    all_ms = device_ms(lambda: QK.sil_band_2d(cell, q2, sg.coords))[0]
    log(f"    sil_band_2d, every lane: device {all_ms:.4f} ms "
        f"({kernels.card})")
    n_in = int((cell >= 0).sum())
    work = live & (cell >= 0)
    n_work = int(work.sum())
    sKp = sg.coords.shape[2]
    row_bytes = 6 * sKp * 4
    all_bound, _ = bound(n2 * (4 + 8 + 4)
                         + n_unique(cell[cell >= 0]) * row_bytes,
                         12.0 * n_in * sKp)
    kernels.add("sil_band_2d", 0.0,
                lambda: QK.sil_band_2d(cell, q2, sg.coords, live),
                lambda: QK.sil_band_2d_plain(cell, q2, sg.coords, live), None,
                n2 * (1 + 4) + int(live.sum()) * 4 + n_work * 8
                + n_unique(cell[work]) * row_bytes, 12.0 * n_work * sKp,
                f"wavy8192_u after {WARM_STEPS} steps, the walks' live mask: "
                f"{n2} lanes, {n_in} in the grid, {n_work} of them live, Kp = "
                f"{sKp}", all_lanes_device_ms=all_ms,
                all_lanes_bound_ms=all_bound)


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
                 eps: float, spp_chunk: int | None = None):
    """Means at ``pts`` over reps x spp walks through UniformIntegrator, on
    the balanced route, or with ``spp_chunk`` the per-sample one."""
    import torch

    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0),
                            device=problem.device)
    settings = IntegratorSettings(frameSize=(len(lanes), 1),
                                  samplesPerPixel=spp, maxWalkingDepth=depth,
                                  epsilonShell=eps)
    integ = UniformIntegrator(problem, settings, "unused", points=lanes)
    ms = integ.solve(spp_chunk)
    if integ.sum.device.type != "cuda":
        raise RuntimeError("the analytic solve did not run on the card")
    u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(len(pts), reps)
    return u.mean(1), ms, integ.total_capped / (len(lanes) * spp)


def square_problem(device):
    """Dirichlet u = (x+1)/2 on two walls, zero Neumann on the others,
    with a candidate grid (the K1-K3 resolve)."""
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
    return problem


def phase_analytic(device, card: str) -> None:
    """Dirichlet u = (x+1)/2 on two walls, zero Neumann on the others, on
    the balanced and on the per-sample route."""
    problem = square_problem(device)
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8]], np.float32)
    want = (pts[:, 0] + 1) / 2
    for route, chunk in (("balanced", None), ("per-sample", 1)):
        u, ms, _ = solve_points(problem, pts, 64, 4, 64, 0.02, chunk)
        log(f"[3] mixed-BC square, {route} route: u "
            f"{np.round(u, 4).tolist()} vs {want.tolist()} (atol 0.07), "
            f"{ms} ms ({card})")
        if not np.all(np.abs(u - want) <= 0.07):
            raise RuntimeError(f"analytic square out of bound ({route})")


def phase_analytic_guided(device, card: str) -> None:
    """[3b] The mixed-BC square through GuidedIntegrator: online training
    (SQUARE_TRAIN_SPP samples, each followed by the optimizer on its
    records), then guiding, at seven points of 256 lanes each, depth 48,
    eps 0.02 (tests/test_guided.py:35 runs three points of one lane, 256
    samples)."""
    import torch

    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.solver.guided import GuidedIntegrator

    problem = square_problem(device)
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8], [0.8, 0.0],
                    [-0.8, 0.3], [0.2, -0.5], [-0.3, 0.6]], np.float32)
    reps = 256
    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0), device=device)
    want = (pts[:, 0] + 1) / 2
    # the per-sample route: metric frames asked for, none written
    for route, frames in (("balanced", {}),
                          ("per-sample", {"saveSppMetricsDuration": 1,
                                          "saveSppMetricsUntil": 0})):
        settings = IntegratorSettings(
            frameSize=(len(lanes), 1), samplesPerPixel=SQUARE_SPP,
            maxWalkingDepth=48, epsilonShell=0.02,
            trainSppCount=SQUARE_TRAIN_SPP, **frames)
        integ = GuidedIntegrator(problem, settings, "unused", points=lanes)
        integ.reset_network(SQUARE_NET)
        ms = integ.solve()
        u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(
            len(pts), reps).mean(1)
        loss = integ.loss_history
        log(f"[3b] guided mixed-BC square, {route} route: u "
            f"{np.round(u, 4).tolist()} vs {want.tolist()} (atol 0.07), "
            f"{SQUARE_SPP} samples of which {SQUARE_TRAIN_SPP} train, "
            f"{reps} lanes a point, {ms} ms; loss {len(loss)} values, "
            f"{loss[0]:.4f} -> {loss[-1]:.4f}; optimizer steps "
            f"{int(integ.trainer.opt.count)} ({card})")
        if integ.sum.device.type != "cuda":
            raise RuntimeError("the guided square did not run on the card")
        # one loss a training sample on the per-sample route, one a
        # training round on the balanced one
        if not (integ._net_trained and np.isfinite(loss).all() and (
                len(loss) == SQUARE_TRAIN_SPP if frames else loss)):
            raise RuntimeError(f"the guided square's training ({route}): "
                               f"{loss}")
        if not np.all(np.abs(u - want) <= 0.07):
            raise RuntimeError(f"guided analytic square out of bound "
                               f"({route})")


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


def run_main(conf_path: str, expect: tuple, label: str, card: str,
             accel: str = "auto") -> tuple:
    """``run_expr`` (on the route ``accel``) with the launch counts zeroed
    just before it; the kernels of ``expect`` must all have launched."""
    import torch

    from elaina_tpu_torch.exec import run_expr

    reset_counts()
    t0 = time.time()
    with capture_integrators() as made:
        result = run_expr(conf_path, accel=accel)
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
    return launches, result, made[-1]


def route_keep(result: dict, integ) -> dict:
    """What the route comparison ([8r]) reads of a run: its per-pixel mean
    and standard error, walk-steps/s, depth-capped share, peak device
    memory, and the guided run's phases and loss and the balanced run's
    round records; [10a] its walk steps and samples a pixel."""
    walks = integ.n_pixels * integ.spp
    return {"mean": (integ.sum / integ.spp).cpu().numpy(),
            "se": integ.standard_error(),
            "steps": result["walk_steps"], "spp": integ.spp,
            "solve_s": result["duration"] / 1e3,
            "rate": result["walk_steps"] / (result["duration"] / 1e3),
            "capped": result["capped_walks"] / walks,
            "peak": result["peak_device_bytes"],
            "phase_stats": result.get("phase_stats"),
            "loss": result.get("loss_history"),
            "rounds": getattr(integ, "balance_rounds", None)}


def solve_steps(integ) -> int:
    """The depth steps the last solve ran: its iterations on the balanced
    route (``balance_rounds``), spp x depth on the per-sample route.  A
    kernel of the step launches at least once each."""
    rounds = getattr(integ, "balance_rounds", None)
    if rounds is None:
        return integ.spp * int(integ.settings.maxWalkingDepth)
    if isinstance(rounds, dict):
        rounds = [r for phase in rounds.values() for r in phase]
    return sum(r["iters"] for r in rounds)


def log_rounds(label: str, rounds: list) -> None:
    """A balanced run's rounds: iterations, host checks and each round's
    occupancy, steps / (iterations x lanes)."""
    log(f"    {label}: {len(rounds)} rounds, "
        f"{sum(r['iters'] for r in rounds)} iterations, "
        f"{sum(r['checks'] for r in rounds)} host checks; by round "
        f"(lanes, cap, iterations, occupancy): "
        + ", ".join(f"({r['lanes']}, {r['cap']}, {r['iters']}, "
                    f"{r['occupancy']:.4f})" for r in rounds))


def phase_main(conf_path: str, card: str, keep: dict) -> dict:
    """[4] lobed_u through run_expr (the balanced route); keeps its
    per-pixel mean and standard error in ``keep`` for [4g] and [8r]."""
    log("[4] 2D main path")
    launches, result, integ = run_main(conf_path, MAIN_2D, "lobed_u", card)
    m_in, n_in, m_out, n_out = check_solution(conf_path)
    log(f"    mean |u| inside the curve {m_in:.4f} ({n_in} px), in the "
        f"Neumann region {m_out:.4f} ({n_out} px)")
    keep["lobed_u"] = route_keep(result, integ)
    log_rounds("balanced route", integ.balance_rounds)
    return launches


def guided_run(conf_path: str, expect: tuple, label: str, card: str,
               keep: dict) -> tuple:
    """A guided path through ``run_main``: the walk-steps/s of each phase,
    its rounds and occupancy, the training loss; its SOLUTION film against
    its uniform path's kept film (``UNIFORM_OF``) at equal spp (4
    combined standard errors on >= 99% of pixel channels; the guided /
    uniform variance of the mean as a reading).  Keeps its own film in
    ``keep``.  Returns run_main's (launches, result, integrator)."""
    launches, result, integ = run_main(conf_path, expect, label, card)
    read_solution(conf_path)
    keep[label] = route_keep(result, integ)
    for phase, rounds in integ.balance_rounds.items():
        log_rounds(f"balanced {phase} phase", rounds)
    ps = result["phase_stats"]
    loss = result["loss_history"]
    log(f"    training phase {ps['train_steps']} walk steps in "
        f"{ps['train_s']:.3f} s ({ps['train_steps'] / ps['train_s']:.6g} "
        f"walk-steps/s), guiding phase {ps['guide_steps']} in "
        f"{ps['guide_s']:.3f} s ({ps['guide_steps'] / ps['guide_s']:.6g} "
        f"walk-steps/s) ({card})")
    log(f"    loss history (one value a training round): {len(loss)} "
        f"values, first {loss[0]:.6g}, last {loss[-1]:.6g}; optimizer "
        f"steps {int(integ.trainer.opt.count)}")
    if not (loss and np.isfinite(loss).all() and integ._net_trained):
        raise RuntimeError(f"{label}'s training loss: {loss}")
    uniform = UNIFORM_OF[label]
    mean_u, se_u = keep[uniform]["mean"], keep[uniform]["se"]
    mean_g, se_g = keep[label]["mean"], keep[label]["se"]
    within = np.abs(mean_g - mean_u) <= 4.0 * np.hypot(se_g, se_u) + 1e-6
    ratio = float(np.mean(se_g ** 2) / np.mean(se_u ** 2))
    log(f"    against {uniform} at {integ.spp} spp: {within.mean():.5f} of "
        f"pixel channels within 4 combined standard errors; guided / "
        f"uniform variance of the mean {ratio:.4f} (a reading)")
    if within.mean() < 0.99:
        raise RuntimeError(f"{label} disagrees with {uniform}")
    return launches, result, integ


def phase_guided(conf_path: str, card: str, keep: dict) -> dict:
    """[4g] lobed_n, the 2D guided main path, through run_expr
    (``guided_run``); then the guide's own costs at the frame's lanes."""
    log("[4g] 2D guided main path (lobed_n)")
    launches, _, integ = guided_run(conf_path, MAIN_2D, "lobed_n", card,
                                    keep)
    check_solution(conf_path)
    guide_costs(integ, card)
    return launches


def device_split(fn, top: int = 10) -> list:
    """The device time of one call of ``fn`` by CUDA kernel
    (torch.profiler, after a warm call): the ``top`` kernels by total
    time, each with its launches, and the sum over all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in kernels) / 1e3
    lines = [f"{e.device_time_total / 1e3:.4f} ms, {e.count} x "
             f"{e.key[:90]}" for e in kernels[:top]]
    return lines + [f"{total:.4f} ms in all over {len(kernels)} kernels"]


def gather_and_scan_forms(integ, card: str) -> None:
    """The two PyTorch forms behind the guide's layout, at the frame's
    lanes: one corner's gather of the encoding (8 levels x 4 features a
    lane) as ``torch.take`` of the flat table (the port's) and as
    ``index_select`` of its rows, and the mixture's CDF scan over 8
    components along a leading axis (the port's) and along the innermost
    one; call ms, and the two scans' largest difference."""
    import torch

    from elaina_tpu_torch.utils.timing import cuda_ms

    table = integ.trainer.params["table"]
    n, nl, nf = integ.n_pixels, integ.spec.encoding.n_levels, table.shape[1]
    g = torch.Generator(device=table.device).manual_seed(0)
    rows = torch.randint(0, table.shape[0], (n, nl), generator=g,
                         device=table.device)
    ids = torch.arange(nf, device=table.device)
    flat = table.reshape(-1)
    w = torch.rand((n, 8), generator=g, device=table.device)
    forms = {
        "corner gather, take": lambda: torch.take(flat,
                                                  rows[..., None] * nf + ids),
        "corner gather, index_select": lambda: torch.index_select(
            table, 0, rows.reshape(-1)),
        "CDF scan, leading axis": lambda: torch.cumsum(
            w.movedim(-1, 0).contiguous(), dim=0),
        "CDF scan, innermost axis": lambda: torch.cumsum(w, dim=-1)}
    log("    " + ", ".join(f"{k} {cuda_ms(f):.4f} ms" for k, f in forms.items())
        + f" ({n} lanes; {card})")
    scan_gap = (forms["CDF scan, leading axis"]().movedim(0, -1)
                - forms["CDF scan, innermost axis"]()).abs().max()
    log(f"    CDF scans' largest difference {float(scan_gap):.6g}")


def guide_costs(integ, card: str) -> None:
    """The guide's costs at the frame's lanes, two training-phase depth
    steps in: one guided inference (encoding, MLP, mixture, sample, the
    two pdfs), one ``train_on_records`` batch of the solve's batch size
    (call ms and device ms, ``utils/timing.py``), and the PyTorch ops that
    one guided depth step enqueues in each phase, beside the uniform
    step's."""
    from elaina_tpu_torch.solver import guided as G
    from elaina_tpu_torch.solver.wost import (_sample_direction,
                                              init_walk_state,
                                              wost_depth_step)
    from elaina_tpu_torch.utils.ab import top_ops
    from elaina_tpu_torch.utils.rng import sample_generators
    from elaina_tpu_torch.utils.timing import cuda_ms, device_ms

    scene, s = integ.problem.scene, integ.settings
    eps, n, dim = float(s.epsilonShell), integ.n_pixels, integ.problem.dim
    has_neumann = scene.neumann is not None
    uf = float(s.uniformFractionInTrainingPhase)
    mgd = int(s.maxGuidedDepthInTrainingPhase)
    params = integ.trainer.ema_params
    gens = sample_generators(0, 1, integ.device)
    state = init_walk_state(integ.eval_points, integ.mask)
    records = G.init_records(n, dim, integ.device)
    for depth in range(2):
        state, records, _, _ = G.guided_depth_step(
            scene, integ.spec, params, integ.box, state, records, gens,
            depth, True, True, uf, mgd, eps=eps)
    d_uni, pdf_uni, _ = _sample_direction(gens["uniform"], state, dim,
                                          has_neumann)
    batch, n_batches = G._train_batch_policy(n)

    def infer():
        return G.guided_direction(integ.spec, params, integ.box, state,
                                  d_uni, pdf_uni, gens, uf, has_neumann)

    def train():
        return G.train_on_records(integ.trainer, integ.spec, integ.adam_cfg,
                                  integ.box, records, batch_size=batch,
                                  n_batches=1)

    def step(training: bool):
        return lambda: G.guided_depth_step(
            scene, integ.spec, params, integ.box, state,
            records if training else None, gens, 2, True, training, uf, mgd,
            eps=eps)

    for label, fn in ((f"guided inference, {n} lanes", infer),
                      (f"train_on_records, one batch of {batch}", train)):
        ms = cuda_ms(fn)
        dev_ms, host_us, hidden = device_ms(fn)
        log(f"    {label}: {ms:.4f} ms a call, device {dev_ms:.4f} ms, "
            f"host {host_us:.1f} us{'' if hidden else ' (not hidden)'} "
            f"({card})")
    for label, fn in (("inference", infer), ("batch", train)):
        for line in device_split(fn):
            log(f"    {label}, device time by kernel: {line}")
    if dim == 2:
        gather_and_scan_forms(integ, card)
    log(f"    aten ops: guided inference {top_ops(infer)}, one batch "
        f"{top_ops(train)} (the solve runs {n_batches} a training sample), "
        f"guided depth step with records {top_ops(step(True))}, without "
        f"{top_ops(step(False))}, uniform depth step "
        f"{top_ops(lambda: wost_depth_step(scene, state, gens, eps))}")


def phase_channels_2d(root: str, card: str) -> dict:
    """[4b] The lobed scene at 256^2 with a NanoVDB source and every
    channel, through run_expr."""
    from elaina_tpu_torch.utils import scenes as S
    from elaina_tpu_torch.utils.build import REPO_DIR

    sub = os.path.join(root, "channels")
    os.makedirs(sub)
    path = S.write_scene(sub, 4, frame=256)
    with open(path) as f:
        conf = json.load(f)
    conf["exp_name"] = "lobed_channels"
    conf["integrator"]["channels"] = ["SOLUTION", "SOURCE", "NEUMANN_SDF",
                                      "DIRICHLET_SDF"]
    conf["scene"]["source_path"] = os.path.join(
        REPO_DIR, "configs", "data", "ladybug_source.nvdb")
    conf["scene"]["source_intensity"] = 1.0
    with open(path, "w") as f:
        json.dump(conf, f)
    log("[4b] 2D channels")
    launches, _, integ = run_main(path, ("grid_band_2d", "sweep_resolve"),
                                  "lobed_channels", card)
    film = {c: integ.films[c].pixels()[..., :3].reshape(-1, 3)
            for c in ("SOLUTION", "SOURCE", "NEUMANN_SDF", "DIRICHLET_SDF")}
    src = integ.problem.scene.source
    want = bilinear_np(src.data.cpu().numpy(), src.origin.cpu().numpy(),
                       src.inv_voxel.cpu().numpy(), frame_points(path))
    err = float(np.abs(film["SOURCE"] - want).max())
    log(f"    SOURCE: grid {tuple(src.data.shape)}, film in "
        f"[{film['SOURCE'].min():.4g}, {film['SOURCE'].max():.4g}], "
        f"max |film - plain bilinear| {err:.3g}")
    if not (np.allclose(film["SOURCE"], want, rtol=1e-5, atol=1e-12)
            and film["SOURCE"].max() > 0):
        raise RuntimeError("the SOURCE film is not the bilinear sample")
    for c in ("DIRICHLET_SDF", "SOLUTION"):
        x = film[c]
        log(f"    {c}: in [{x.min():.5g}, {x.max():.5g}], mean "
            f"{x.mean():.5g}")
        if not np.isfinite(x).all():
            raise RuntimeError(f"the {c} film is not finite")
    if (film["DIRICHLET_SDF"] < 0).any():
        raise RuntimeError("negative DIRICHLET_SDF")
    # no corner of the convex Neumann box is a silhouette from inside it
    nsdf = film["NEUMANN_SDF"]
    log(f"    NEUMANN_SDF: +inf at {int(np.isinf(nsdf).all(1).sum())} of "
        f"{len(nsdf)} pixels (every pixel lies inside the convex box)")
    if not np.isinf(nsdf).all():
        raise RuntimeError("a box corner was a silhouette from inside")
    # K10 as the DIRICHLET_SDF channel ran it, against its plain version
    from elaina_tpu_torch.geometry.grid import grid_row_index

    g, q_pix = integ.problem.scene.d_grid, integ.eval_points
    check_grid_band("grid_band_2d", grid_row_index(g, q_pix), q_pix, g, None,
                    "the channels' 256^2 pixels")
    return launches


def within_se(a, b) -> float:
    """The share of pixel channels where two integrators' means agree
    within 4 combined standard errors."""
    ma, mb = ((i.sum / i.spp).cpu().numpy() for i in (a, b))
    se = np.sqrt(a.standard_error() ** 2 + b.standard_error() ** 2)
    return float((np.abs(ma - mb) <= 4.0 * se + 1e-6).mean())


def solve_settings(integ, spp: int, depth: int):
    from elaina_tpu_torch.core.config import IntegratorSettings

    s = integ.settings
    return IntegratorSettings(frameSize=tuple(s.frameSize),
                              samplesPerPixel=spp, maxWalkingDepth=depth,
                              epsilonShell=s.epsilonShell)


def solve_report(integ, label: str, card: str) -> None:
    """Solve and print walk-steps/s and the capped share."""
    ms = integ.solve()
    walks = integ.n_pixels * integ.spp
    log(f"    {label}: {integ.spp} spp, depth "
        f"{integ.settings.maxWalkingDepth}, {ms} ms, "
        f"{integ.total_walk_steps / (ms / 1e3):.6g} walk-steps/s, "
        f"depth-capped share {integ.total_capped / walks:.4f} ({card})")


def phase_nogrid(root: str, device, card: str) -> dict:
    """[4c] bench.py's curve at 256 segments without a grid, through
    run_expr; then its two routes against each other."""
    import torch

    from elaina_tpu_torch.core.problem import (grid_bounds, grid_size_for,
                                               scene_from_numpy)
    from elaina_tpu_torch.geometry.grid import build_candidate_grid
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.utils import scenes as S

    sub = os.path.join(root, "nogrid")
    os.makedirs(sub)
    path = S.write_scene(sub, NOGRID_SPP, segments=256)
    with open(path) as f:
        conf = json.load(f)
    conf["exp_name"] = "nogrid_u"
    conf["integrator"]["channels"] = ["SOLUTION", "DIRICHLET_SDF"]
    with open(path, "w") as f:
        json.dump(conf, f)
    log("[4c] no candidate grid: bench.py's curve at 256 segments")
    launches, _, integ = run_main(path, ("closest_point_dense",), "nogrid_u",
                                  card)
    problem = integ.problem
    scene = problem.scene
    steps = solve_steps(integ)
    log(f"    {problem.stats['dirichlet_grid']}; K13 launches "
        f"{launches['closest_point_dense']} for {steps} depth steps and one "
        f"DIRICHLET_SDF render")
    if scene.d_grid is not None or launches["closest_point_dense"] < steps:
        raise RuntimeError("the no-grid scene did not take K13 every step")
    m_in, _, m_out, _ = check_solution(path)
    gs = scene.dirichlet.gs
    want, _ = QK.closest_point_dense_plain(
        integ.eval_points, gs.verts[gs.indices[:, 0]].contiguous(),
        gs.verts[gs.indices[:, 1]].contiguous())
    sdf = torch.as_tensor(integ.films["DIRICHLET_SDF"].pixels()[..., 0]
                          .reshape(-1), device=device)
    err = float((sdf - want).abs().max())
    log(f"    mean |u| inside {m_in:.4f}, in the Neumann region {m_out:.4f}; "
        f"DIRICHLET_SDF against K13's plain distance: max error {err:.3g}")
    if not torch.allclose(sdf, want, rtol=TOL, atol=TOL):
        raise RuntimeError("the no-grid DIRICHLET_SDF film")

    # the same scene with a candidate grid, both at ROUTE_DEPTH
    settings = solve_settings(integ, 4, ROUTE_DEPTH)
    del integ
    plain = UniformIntegrator(problem, settings, "unused")
    solve_report(plain, "no grid (K13)", card)
    v, idx = gs.verts.cpu().numpy(), gs.indices.cpu().numpy()
    nb = scene.neumann.gs
    lo, hi = grid_bounds(v, scene.aabb_lo, scene.aabb_hi)
    K, max_res = grid_size_for(len(idx))
    ga = build_candidate_grid(v, idx, lo, hi, K=K, max_res=max_res)
    problem.scene = scene_from_numpy(
        aabb_lo=scene.aabb_lo, aabb_hi=scene.aabb_hi, device=device,
        dirichlet=(v, idx, scene.dirichlet.colors.cpu().numpy()),
        neumann=(nb.verts.cpu().numpy(), nb.indices.cpu().numpy(),
                 scene.neumann.colors.cpu().numpy()), grid=vars(ga))
    gridded = UniformIntegrator(problem, settings, "unused")
    solve_report(gridded, f"candidate grid (K = {K})", card)
    share = within_se(plain, gridded)
    log(f"    no grid vs candidate grid: within 4 combined standard errors "
        f"on {share:.5f} of the pixel channels (>= 0.99)")
    if share < 0.99:
        raise RuntimeError("the grid and no-grid routes disagree")
    return launches


def phase_bench_square(device, card: str) -> None:
    """[4d] bench.py's own scene, as bench builds it."""
    import torch

    from elaina_tpu_torch.utils.ab import bench_square

    log("[4d] bench.py's scene: 2,048 segments, no grid, no Neumann set")
    reset_counts()
    _, integ = bench_square(device, 4)
    solve_report(integ, "bench square", card)
    torch.cuda.synchronize()
    n_k13 = read_counts()["closest_point_dense"]
    film = integ.films["SOLUTION"].pixels()
    log(f"    K13 launches {n_k13} for {solve_steps(integ)} depth steps, "
        f"{integ.total_walk_steps} live lane-steps; film mean "
        f"{float(film.mean()):.5f}")
    if n_k13 < solve_steps(integ) or not np.isfinite(film).all():
        raise RuntimeError("bench.py's scene")


def phase_neumann2d_chunked(root: str, device, card: str) -> None:
    """[4e] The wavy box of 2,048 segments: the chunked sweeps through
    run_expr, then against the 2D band grids."""
    from dataclasses import replace

    from elaina_tpu_torch.geometry.grid import (band_grid_from_numpy,
                                                sil_grid_from_numpy)
    from elaina_tpu_torch.solver.integrator import UniformIntegrator
    from elaina_tpu_torch.utils import scenes as S

    sub = os.path.join(root, "wavy2048")
    os.makedirs(sub)
    path = S.write_scene(sub, 4, frame=256, neumann_segments=2048)
    with open(path) as f:
        conf = json.load(f)
    conf["exp_name"] = "wavy2048_u"
    with open(path, "w") as f:
        json.dump(conf, f)
    log("[4e] 2D Neumann set of 2,048 segments: the chunked sweeps")
    _, _, integ = run_main(path, MAIN_2D, "wavy2048_u", card)
    read_solution(path)
    problem = integ.problem
    scene = problem.scene
    if scene.n_sgrid is not None or scene.n_bgrid is not None:
        raise RuntimeError("a 2,048-segment Neumann set built band grids")
    settings = solve_settings(integ, AGREE_SPP, S.DEPTH)
    del integ
    chunked = UniformIntegrator(problem, settings, "unused")
    solve_report(chunked, "chunked sweeps", card)
    gs = scene.neumann.gs
    nv, ni = gs.verts.cpu().numpy(), gs.indices.cpu().numpy()
    sgrid, bgrid = problem.neumann_grids(
        nv, ni, np.asarray(conf["scene"]["aabb"]["min"], np.float32),
        np.asarray(conf["scene"]["aabb"]["max"], np.float32),
        os.environ["ELAINA_CACHE_DIR"], every=True)
    problem.scene = replace(
        scene, n_sgrid=sil_grid_from_numpy(sgrid, gs, device),
        n_bgrid=band_grid_from_numpy(bgrid, nv, ni, device))
    reset_counts()
    banded = UniformIntegrator(problem, settings, "unused")
    solve_report(banded, "2D band grids", card)
    if not read_counts()["sil_band_2d"]:
        raise RuntimeError("the band route did not launch K9-2D")
    share = within_se(chunked, banded)
    log(f"    chunked vs band grids: within 4 combined standard errors on "
        f"{share:.5f} of the pixel channels (>= 0.99)")
    if share < 0.99:
        raise RuntimeError("the chunked and band routes disagree")


def phase_neumann2d_band(path: str, card: str) -> dict:
    """[4f] The wavy box of 8,192 segments through run_expr."""
    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.utils.ab import warm_state

    log("[4f] 2D Neumann set of 8,192 segments: the 2D band grids")
    launches, _, integ = run_main(path, MAIN_2D + ("sil_band_2d",),
                                  "wavy8192_u", card)
    read_solution(path)
    problem = integ.problem
    for key in ("neumann_sil_grid", "neumann_band_grid"):
        log(f"    build {key}: {problem.stats[key]}")
    steps = solve_steps(integ)
    if launches["sil_band_2d"] < steps:
        raise RuntimeError(f"K9-2D launched {launches['sil_band_2d']} times "
                           f"in {steps} depth steps")
    sg = problem.scene.n_sgrid
    pos = warm_state(problem, integ, WARM_STEPS).pos
    r_grid = Q.grid_closest_silhouette(sg, pos)
    dense = Q.closest_silhouette(problem.scene.neumann.gs, pos)
    lin, outside = Q.band_cell(sg, pos)
    tight = ~outside & (dense < sg.r_cap[lin])
    lower = bool((r_grid <= dense * (1 + TOL) + TOL).all())
    exact = bool(torch.isclose(r_grid[tight], dense[tight], rtol=TOL,
                               atol=TOL).all())
    log(f"    SilGrid R_N on {pos.shape[0]} warmed lanes: at most the dense "
        f"distance {lower}; equal (1e-5) on the {int(tight.sum())} lanes "
        f"below their cell's r_cap {exact}")
    if not (lower and exact and tight.any()):
        raise RuntimeError("the 2D SilGrid's R_N")
    return launches


def phase_kernels_3d(conf_path: str, device, kernels: Kernels) -> None:
    """K1, K4, K5 on the cube's need lanes and K6, K9 on every lane over
    the blob's grids, against their plain versions."""
    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.geometry.primitives import prim_project, prim_side
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.ops import resolve as R
    from elaina_tpu_torch.solver.wost import _sample_direction, _separate
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state
    from elaina_tpu_torch.utils.timing import cuda_ms, device_ms

    t0 = time.time()
    problem, integ = load_integrator(conf_path, device)
    eps = float(integ.settings.epsilonShell)
    torch.cuda.synchronize()
    log(f"[5] neumann3d scene loaded in {time.time() - t0:.1f} s")
    for key in ("dirichlet_grid", "neumann_sil_grid", "neumann_band_grid"):
        log(f"    build {key}: {problem.stats[key]}")
    scene = problem.scene
    g = scene.d_grid
    log(f"    fine res {g.fine.res}, tables {problem.table_bytes()} bytes")
    state = warm_state(problem, integ, WARM_STEPS)
    n = state.pos.shape[0]

    # K4 as _fast_dirichlet calls it: the N-wide need mask, K1 inside
    need, n_need, row = need_lanes(g, state, n)
    q = state.pos
    err = check_resolve_cases("sweep_resolve_3d", need, row, q, g,
                              "neumann3d_u")
    args = (need, row, q, g.coords, g.cand)
    d, pid, corners = R.sweep_resolve_3d(*args)
    Kp = g.coords.shape[2]
    rows = n_unique(row[need])
    split = resolve_split(3, need, row, q, g)
    kernels.add("sweep_resolve_3d", err, lambda: R.sweep_resolve_3d(*args),
                lambda: R.sweep_resolve_3d_plain(*args), None,
                n + n_need * (4 + 12 + 4 + 4 + 36) + rows * 9 * Kp * 4,
                120.0 * n_need * g.cand.shape[1],
                f"neumann3d_u's {n_need} need lanes of {n} after "
                f"{WARM_STEPS} steps (K1 inside)", rows=rows, **split)

    # K5 on the in-shell lanes
    pv = (corners[:, 0:3], corners[:, 3:6], corners[:, 6:9])
    uv = prim_project(3, q, pv)
    side = prim_side(3, q, pv)
    ins = need & (d < eps) & (uv[:, 0] > 0) & (uv[:, 1] > 0) & (uv.sum(1) < 1)
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
                n * 5 + n_unique(cfi[ins]) * 36 + n_ins * 36, 0.0,
                f"neumann3d_u: {n_ins} in-shell lanes of {n}")

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
                40.0 * n_in * sKp,
                f"neumann3d_u after {WARM_STEPS} steps: {n} lanes, {n_in} "
                f"in the grid, Kp = {sKp}")

    # K6 on every lane with this step's star radii and live lanes, fresh
    # uniforms and directions, as _neumann_walk_fused calls it (with its
    # skip, and without it); then on the same lanes with radii of 0.05 to
    # 1, which reach the blob: the star radii stay below the distance to
    # the blob (its band cells' r_cap clamps them), so at the main path's
    # radii few lanes' samples and rays find anything
    in_shell, R_B, _, _, _ = _separate(scene, state, eps, shrink=True)
    live = (state.active & ~in_shell & torch.isfinite(R_B)).contiguous()
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

    def band_args(radii, skip=True, coords=bg.coords):
        return (cell, q, radii.contiguous(), state.on_neumann.contiguous(),
                state.n_normal.contiguous(), u_sel, u_pt,
                direction.contiguous(), eps, coords,
                bg.skip_r if skip else None, live if skip else None)

    err = 0.0
    wide = 0.05 + 0.95 * torch.rand(n, generator=gen, device=device)
    # rows wider than 64 slots take K6's other instantiation: the same
    # table padded to 128 slots with PAD_COORD ones, which never weigh or
    # hit
    from elaina_tpu_torch.geometry.grid import PAD_COORD

    coords128 = torch.cat([bg.coords, torch.full_like(bg.coords, PAD_COORD)],
                          dim=2).contiguous()
    for label, radii, skip, coords in (
            ("star radii", R_B, True, bg.coords),
            ("star radii, no skip", R_B, False, bg.coords),
            ("radii 0.05-1", wide, True, bg.coords),
            ("radii 0.05-1, Kp = 128", wide, True, coords128)):
        kargs = band_args(radii, skip, coords)
        e, flips, out = compare_band_walk(kargs)
        err = max(err, e)
        work = (QK.band_work(cell, radii, state.on_neumann, eps, bg.skip_r,
                             live) if skip else inn)
        log(f"    band_neumann_walk, {label}: {n_in} lanes in the grid, "
            f"{int((inn & live).sum())} of them live, band work on "
            f"{int(work.sum())} (the skip took "
            f"{1.0 - float(work.sum()) / n:.4f} of all {n} lanes), "
            f"{int(((out[:, 0] > 0) & inn).sum())} with a sample, "
            f"{int((out[:, 9] > 0).sum())} occluded, "
            f"{int((out[:, 10] > 0).sum())} walk hits, {flips} CDF slots "
            f"flipped against the plain cumsum")
    del coords128
    kargs = band_args(R_B)
    bKp = bg.coords.shape[2]
    cells = n_unique(cell[inn])
    work = QK.band_work(cell, R_B, state.on_neumann, eps, bg.skip_r, live)
    n_work = int(work.sum())
    tested = inn & live
    n_tested = int(tested.sum())
    # every lane reads cell and writes out (15 floats) and slot; with the
    # skip a lane in the grid reads live, a live one R, on and its cell's
    # skip_r, and only a lane with band work q, n_normal, u_sel, u_pt,
    # d_walk and its cell's corners
    io_bytes = n * (4 + 60 + 4)
    band_bytes = 12 + 12 + 4 + 8 + 12
    all_bound, _ = bound(io_bytes + n_in * (4 + 1 + band_bytes)
                         + cells * 9 * bKp * 4, 200.0 * n_in * bKp)
    noskip = band_args(R_B, skip=False)
    ns_ms = cuda_ms(lambda: QK.band_neumann_walk(*noskip))
    ns_dev = device_ms(lambda: QK.band_neumann_walk(*noskip))[0]
    log(f"    band_neumann_walk without the skip: {ns_ms:.4f} ms (device "
        f"{ns_dev:.4f} ms); the bound of every lane in the grid "
        f"{all_bound:.4f} ms ({kernels.card})")
    kernels.add("band_neumann_walk", err,
                lambda: QK.band_neumann_walk(*kargs),
                lambda: QK.band_neumann_walk_plain(*kargs), None,
                io_bytes + n_in + n_tested * (4 + 1) + n_work * band_bytes
                + n_unique(cell[tested]) * 4
                + n_unique(cell[work]) * 9 * bKp * 4,
                200.0 * n_work * bKp,
                f"neumann3d_u after {WARM_STEPS} steps, star radii: {n} "
                f"lanes, {n_in} in the grid, band work on {n_work}, Kp = "
                f"{bKp}", noskip_ms=ns_ms, noskip_device_ms=ns_dev,
                all_lanes_bound_ms=all_bound)

    # K7: the walk ray alone, from the eps-offset origin in pos's cell, as
    # the unfused step and the source term call it (the step's live lanes,
    # the skip with reach tmax + eps)
    current = (state.pos + torch.where(state.on_neumann[:, None],
                                       eps * state.n_normal, 0.0)).contiguous()
    err = check_band_ray(cell, current, direction.contiguous(), R_B, wide,
                         live, eps, bg)
    rargs = (cell, current, direction.contiguous(), R_B.contiguous(),
             bg.coords, bg.skip_r, live, eps)
    noskip = rargs[:5]
    work = QK.ray_work(cell, R_B, eps, bg.skip_r, live)
    n_work = int(work.sum())
    ns_ms = cuda_ms(lambda: QK.band_ray(*noskip))
    ns_dev = device_ms(lambda: QK.band_ray(*noskip))[0]
    # every lane reads cell, live, tmax and its cell's skip_r and writes t
    # and slot; only a lane with band work reads o, d and its cell's
    # corners (the every-lane bound: o, d and the corners of every lane)
    corner_bytes = 9 * bKp * 4
    ray_bound, _ = bound(n * (4 + 1 + 4 + 4 + 4) + cells * 4
                         + n_in * 24 + cells * corner_bytes,
                         45.0 * n_in * bKp)
    log(f"    band_ray without the skip: {ns_ms:.4f} ms (device "
        f"{ns_dev:.4f} ms); the skip took {1.0 - n_work / n:.4f} of the "
        f"{n} lanes (band work on {n_work}); the bound of every lane in "
        f"the grid {ray_bound:.4f} ms ({kernels.card})")
    kernels.add("band_ray", err, lambda: QK.band_ray(*rargs),
                lambda: QK.band_ray_plain(*rargs), None,
                n * (4 + 1 + 4 + 4 + 4) + n_unique(cell[inn & live]) * 4
                + n_work * 24 + n_unique(cell[work]) * corner_bytes,
                45.0 * n_work * bKp,
                f"neumann3d_u after {WARM_STEPS} steps, star radii, the "
                f"step's live lanes: {n} lanes, {n_in} in the grid, band "
                f"work on {n_work}, Kp = {bKp}", noskip_ms=ns_ms,
                noskip_device_ms=ns_dev, all_lanes_bound_ms=ray_bound)

    # K8: the in-ball CDF sample alone, as the unfused step calls it (the
    # step's live lanes, the skip with reach R)
    err = check_band_ball(cell, q, u_sel, R_B, wide, live, bg)
    bargs = (cell, q, R_B.contiguous(), u_sel, bg.coords, bg.skip_r, live,
             0.0)
    noskip = bargs[:5]
    work = QK.ball_work(cell, R_B, 0.0, bg.skip_r, live)
    n_work = int(work.sum())
    ns_ms = cuda_ms(lambda: QK.band_ball(*noskip))
    ns_dev = device_ms(lambda: QK.band_ball(*noskip))[0]
    wargs = (cell, q, wide.contiguous(), u_sel, bg.coords)
    wide_dev = device_ms(lambda: QK.band_ball(*wargs, bg.skip_r, live))[0]
    wide_ns = device_ms(lambda: QK.band_ball(*wargs))[0]
    # every lane reads cell, live and R and writes slot, w_sel and total,
    # a live one in the grid its cell's skip_r; only a lane with band work
    # reads q, u and its cell's corners (the every-lane bound: q, u and
    # the corners of every lane in the grid)
    ball_bound, _ = bound(n * (4 + 1 + 4 + 12) + cells * 4 + n_in * 16
                          + cells * corner_bytes, 80.0 * n_in * bKp)
    log(f"    band_ball without the skip: {ns_ms:.4f} ms (device "
        f"{ns_dev:.4f} ms); the skip took {1.0 - n_work / n:.4f} of the "
        f"{n} lanes (band work on {n_work}); the bound of every lane in "
        f"the grid {ball_bound:.4f} ms; at radii 0.05-1 device "
        f"{wide_dev:.4f} ms with the skip and the step's live lanes, "
        f"{wide_ns:.4f} without ({kernels.card})")
    kernels.add("band_ball", err, lambda: QK.band_ball(*bargs),
                lambda: QK.band_ball_plain(*bargs), None,
                n * (4 + 1 + 4 + 12) + n_unique(cell[inn & live]) * 4
                + n_work * 16 + n_unique(cell[work]) * corner_bytes,
                80.0 * n_work * bKp,
                f"neumann3d_u after {WARM_STEPS} steps, star radii, the "
                f"step's live lanes: {n} lanes, {n_in} in the grid, band "
                f"work on {n_work}, Kp = {bKp}", noskip_ms=ns_ms,
                noskip_device_ms=ns_dev, all_lanes_bound_ms=ball_bound,
                wide_device_ms=wide_dev, wide_noskip_device_ms=wide_ns)

    # K11: the frame's plane points through the chain path, as the
    # DIRICHLET_SDF channel hands them over
    from elaina_tpu_torch.geometry.grid import grid_row_index

    q_pix = integ.eval_points
    check_grid_band("grid_band_3d", grid_row_index(g, q_pix), q_pix, g,
                    kernels, "neumann3d's 256^2 plane points")
    check_grid_band_ties("grid_band_3d", g.coords.shape[2], device)
    phase_fused_vs_unfused(scene, integ, eps)
    phase_skip_step(scene, state, eps)


def compare_band_walk(kargs) -> tuple:
    """K6 against its plain version on the arguments ``kargs`` of
    ``ops.queries.band_neumann_walk``: the lanes in the grid may differ in
    their CDF slot on at most CDF_FLIPS of them (a prefix sum's rounding
    at a slot boundary), the rest's 15 outputs within TOL.  Returns (the
    largest difference, the flipped slots, the kernel's out)."""
    import torch

    from elaina_tpu_torch.ops import queries as QK

    out, slot = QK.band_neumann_walk(*kargs)
    out_p, slot_p = QK.band_neumann_walk_plain(*kargs)
    inn = kargs[0] >= 0
    same = inn & (slot == slot_p)
    flips = int((inn & ~same).sum())
    if flips > CDF_FLIPS * int(inn.sum()) or not torch.equal(
            slot[~inn], slot_p[~inn]):
        raise RuntimeError(f"band_neumann_walk: {flips} CDF slots differ")
    a, b = out[same], out_p[same]
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise RuntimeError("band_neumann_walk: inf / finite differ")
    both = torch.isfinite(a)
    e = float((a[both] - b[both]).abs().max())
    if not torch.allclose(a[both], b[both], rtol=TOL, atol=1e-6):
        raise RuntimeError(f"band_neumann_walk differs: {e}")
    return e, flips, out


def check_band_ray(cell, o, d, R_B, wide, live, eps: float, bg) -> float:
    """K7 against its plain version with the skip (reach tmax + eps) on
    every mask of ``lane_masks`` and without a mask, at the star radii
    and at radii 0.05-1: slots exact, t within TOL; and the skipped
    kernel against the unskipped one, bit for bit on the live lanes.
    Returns the largest t difference from the plain version."""
    import torch

    from elaina_tpu_torch.ops import queries as QK

    err = 0.0
    inn = cell >= 0
    for rlabel, radii in (("star radii", R_B), ("radii 0.05-1", wide)):
        radii = radii.contiguous()
        t0, s0 = QK.band_ray(cell, o, d, radii, bg.coords)
        for label, m in (("no mask", None), *lane_masks(live)):
            args = (cell, o, d, radii, bg.coords, bg.skip_r, m, eps)
            t, slot = QK.band_ray(*args)
            t_p, slot_p = QK.band_ray_plain(*args)
            hit = torch.isfinite(t_p)
            if not (torch.equal(torch.isfinite(t), hit)
                    and torch.equal(slot, slot_p)):
                raise RuntimeError(f"band_ray: hits or slots differ "
                                   f"({rlabel}, {label})")
            e = float((t[hit] - t_p[hit]).abs().max()) if hit.any() else 0.0
            if not torch.allclose(t[hit], t_p[hit], rtol=TOL, atol=0.0):
                raise RuntimeError(f"band_ray t differs: {e}")
            err = max(err, e)
            on = torch.ones_like(live) if m is None else m
            if not (torch.equal(t[on], t0[on])
                    and torch.equal(slot[on], s0[on])):
                raise RuntimeError(f"band_ray: the skip changed a live lane "
                                   f"({rlabel}, {label})")
            work = QK.ray_work(cell, radii, eps, bg.skip_r, m)
            log(f"    band_ray, {rlabel}, {label}: {int(hit.sum())} hits, "
                f"band work on {int(work.sum())} of {int((inn & on).sum())} "
                f"live lanes in the grid; equal to the plain version (slots "
                f"exact) and, on those lanes, to the unskipped kernel")
    return err


def check_band_ball(cell, q, u, R_B, wide, live, bg) -> float:
    """K8 against its plain version on every mask of ``lane_masks`` and
    without a mask, with the skip (reach R) and without it, at the star
    radii and at radii 0.05-1: the lanes it does not sweep bit-equal (slot
    = Kp, zeros), the others' slots equal but for CDF_FLIPS of the lanes
    in the grid and their w_sel and total within TOL; and the kernel
    against itself without skip or mask, bit for bit on the lanes the mask
    keeps.  Returns the largest w_sel or total difference."""
    import torch

    from elaina_tpu_torch.ops import queries as QK

    err = 0.0
    inn = cell >= 0
    n_in = int(inn.sum())
    Kp = bg.coords.shape[2]
    for rlabel, radii in (("star radii", R_B), ("radii 0.05-1", wide)):
        radii = radii.contiguous()
        base = QK.band_ball(cell, q, radii, u, bg.coords)
        for label, m in (("no mask", None), *lane_masks(live)):
            for skip in (bg.skip_r, None):
                args = (cell, q, radii, u, bg.coords, skip, m, 0.0)
                out = QK.band_ball(*args)
                out_p = QK.band_ball_plain(*args)
                work = QK.ball_work(cell, radii, 0.0, skip, m)
                idle = (torch.full_like(out[0], Kp), torch.zeros_like(
                    out[1]), torch.zeros_like(out[2]))
                if not all(torch.equal(a[~work], b[~work])
                           and torch.equal(p[~work], b[~work])
                           for a, p, b in zip(out, out_p, idle)):
                    raise RuntimeError(f"band_ball: a lane without band "
                                       f"work differs ({rlabel}, {label})")
                (slot, w_sel, total), (slot_p, w_sel_p, total_p) = out, out_p
                same = work & (slot == slot_p)
                flips = int((work & ~same).sum())
                if flips > CDF_FLIPS * n_in:
                    raise RuntimeError(f"band_ball: {flips} CDF slots differ")
                e = (max(float((w_sel[same] - w_sel_p[same]).abs().max()),
                         float((total[work] - total_p[work]).abs().max()))
                     if same.any() else 0.0)
                if not (torch.allclose(w_sel[same], w_sel_p[same], rtol=TOL,
                                       atol=0)
                        and torch.allclose(total, total_p, rtol=TOL,
                                           atol=0)):
                    raise RuntimeError(f"band_ball w_sel or total differs: "
                                       f"{e}")
                err = max(err, e)
                on = torch.ones_like(live) if m is None else m
                if not all(torch.equal(a[on], b[on])
                           for a, b in zip(out, base)):
                    raise RuntimeError(f"band_ball: the skip changed a live "
                                       f"lane ({rlabel}, {label})")
                log(f"    band_ball, {rlabel}, {label}"
                    f"{'' if skip is not None else ', no skip'}: "
                    f"{int((same & (w_sel > 0)).sum())} lanes with a "
                    f"sample, band work on {int(work.sum())} of "
                    f"{int((inn & on).sum())} live lanes in the grid, "
                    f"{flips} CDF slots flipped against the plain cumsum; "
                    f"the rest bit-equal, and equal to the kernel without "
                    f"skip or mask on those lanes")
    return err


def phase_skip_step(scene, state, eps: float) -> None:
    """[5c] One depth step from the warmed lanes with the same generators,
    with K6's skip and without it: contributions and next walk states
    equal on every lane."""
    import dataclasses

    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.solver.wost import wost_depth_step
    from elaina_tpu_torch.utils.rng import sample_generators

    walk = Q.band_neumann_walk
    dev = state.pos.device

    def step():
        return wost_depth_step(scene, state, sample_generators(0, 1, dev),
                               eps)

    st1, c1, _ = step()
    Q.band_neumann_walk = (lambda bg, *args, live=None: walk(
        dataclasses.replace(bg, skip_r=None), *args))
    try:
        st0, c0, _ = step()
    finally:
        Q.band_neumann_walk = walk
    fields = ("pos", "thp", "active", "on_neumann", "n_normal")
    same = {f: torch.equal(getattr(st1, f), getattr(st0, f)) for f in fields}
    log(f"[5c] one step with and without K6's skip on "
        f"{state.pos.shape[0]} lanes: contributions equal "
        f"{torch.equal(c1, c0)}, next state equal {same}")
    if not (torch.equal(c1, c0) and all(same.values())):
        raise RuntimeError("K6's skip changed the depth step")


def phase_fused_vs_unfused(scene, integ, eps: float) -> None:
    """[5b] Three depth steps from every pixel with the same generators,
    fused (K6) and unfused (K8 + K7), lane for lane
    (tests/test_fused_band.py:180-190)."""
    import torch

    from elaina_tpu_torch.solver.wost import init_walk_state, wost_depth_step
    from elaina_tpu_torch.utils.rng import sample_generators

    runs = {}
    for on in (True, False):
        with fused_band(on):
            reset_counts()
            st = init_walk_state(integ.eval_points, integ.mask)
            gens = sample_generators(0, 0, integ.device)
            acc = torch.zeros_like(st.pos)
            for _ in range(WARM_STEPS):
                st, c, _ = wost_depth_step(scene, st, gens, eps)
                acc += c
            counts = read_counts()
        k = "band_neumann_walk" if on else "band_ball"
        if not counts[k]:
            raise RuntimeError(f"the {'fused' if on else 'unfused'} step "
                               f"did not launch {k}: {counts}")
        runs[on] = (st, acc)
    (st_f, acc_f), (st_u, acc_u) = runs[True], runs[False]
    pos = torch.isclose(st_f.pos, st_u.pos, rtol=1e-4, atol=1e-5).all(-1)
    acc = torch.isclose(acc_f, acc_u, rtol=1e-3, atol=1e-6).all(-1)
    on = st_f.on_neumann == st_u.on_neumann
    log(f"[5b] fused vs unfused step, {WARM_STEPS} steps on "
        f"{pos.shape[0]} lanes: positions {float(pos.float().mean()):.5f}, "
        f"contributions {float(acc.float().mean()):.5f}, on_neumann "
        f"{float(on.float().mean()):.5f} equal (>= 0.99 each), active "
        f"equal {bool(torch.equal(st_f.active, st_u.active))}; "
        f"{int(st_u.on_neumann.sum())} lanes on the blob")
    if not (pos.float().mean() >= 0.99 and acc.float().mean() >= 0.99
            and on.float().mean() >= 0.99
            and torch.equal(st_f.active, st_u.active)):
        raise RuntimeError("the fused and unfused steps disagree")


def phase_analytic_3d(root: str, device, card: str) -> None:
    """The mixed cube through the 3D loader and UniformIntegrator."""
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.utils import scenes as S

    problem = Problem(3, device, verbose=False).load_config(
        S.write_mixed_cube(root), cache_dir=os.environ["ELAINA_CACHE_DIR"])
    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [-0.6, 0.3, 0.4]],
                   np.float32)
    want = (pts[:, 0] + 1) / 2
    for route, chunk in (("balanced", None), ("per-sample", 1)):
        u, ms, capped = solve_points(problem, pts, 1024, CUBE_U_SPP, 256,
                                     0.02, chunk)
        log(f"[6] mixed-BC cube, {route} route: u "
            f"{np.round(u, 4).tolist()} vs {want.tolist()} (atol 0.07), "
            f"{ms} ms, depth-capped share {capped:.4f} ({card})")
        if not np.all(np.abs(u - want) <= 0.07):
            raise RuntimeError(f"analytic cube out of bound ({route})")

    # 6b: the same cube with a unit source, fused and unfused
    problem = Problem(3, device, verbose=False).load_config(
        S.write_mixed_cube_source(root),
        cache_dir=os.environ["ELAINA_CACHE_DIR"])
    want = (pts[:, 0] + 1) / 2 + (1 - pts[:, 0] ** 2) / 2
    for on in (True, False):
        for route, chunk in (("balanced", None), ("per-sample", 1)):
            with fused_band(on):
                reset_counts()
                u, ms, capped = solve_points(problem, pts, 1024, CUBE_SPP,
                                             SOURCE_CUBE_DEPTH, 0.02, chunk)
                counts = read_counts()
            step = "band_neumann_walk" if on else "band_ball"
            log(f"[6b] mixed-BC cube with a unit source, "
                f"{'fused' if on else 'unfused'}, {route} route: u "
                f"{np.round(u, 4).tolist()} vs {np.round(want, 4).tolist()}"
                f" (atol 0.07), {ms} ms, depth-capped share {capped:.4f}; "
                f"launches band_ray {counts['band_ray']}, {step} "
                f"{counts[step]} ({card})")
            if not (counts["band_ray"] and counts[step]):
                raise RuntimeError("the source cube did not launch its "
                                   "kernels")
            if not np.all(np.abs(u - want) <= 0.07):
                raise RuntimeError(f"analytic source cube out of bound "
                                   f"({route})")


def bumpy_errors(conf_path: str) -> tuple[float, float]:
    """(RMSE, mean error) of the exported bumpy3d solution against h."""
    sol = read_solution(conf_path)
    n = sol.shape[0]
    xs = 2 * np.arange(n) / n - 1.0
    X, Y = np.meshgrid(xs * 0.6, xs * 0.6, indexing="xy")
    err = sol[..., 0] - (0.5 + 0.4 * (X ** 2 - Y ** 2))
    return float(np.sqrt((err ** 2).mean())), float(err.mean())


def phase_bumpy(conf_path: str, card: str, keep: dict) -> None:
    """bumpy3d_u at the config's depth (a reading; its film and errors
    kept for [7g]) and at BUMPY_DEPTH (bounded)."""
    import torch

    from elaina_tpu_torch.geometry.grid import grid_row_index

    log("[7] bumpy3d_u")
    with open(conf_path) as f:
        conf = json.load(f)
    for depth in (conf["integrator"]["setting"]["maxWalkingDepth"],
                  BUMPY_DEPTH):
        conf["integrator"]["setting"]["maxWalkingDepth"] = depth
        with open(conf_path, "w") as f:
            json.dump(conf, f)
        _, result, integ = run_main(conf_path, ("sweep_resolve_3d",
                                                "grid_band_3d"), "bumpy3d_u",
                                    card)
        rmse, bias = bumpy_errors(conf_path)
        log(f"    depth {depth} against h: RMSE {rmse:.5f}, mean error "
            f"{bias:.5f} ({card})")
        if depth == BUMPY_DEPTH:
            break
        keep["bumpy3d_u"] = dict(route_keep(result, integ),
                                 errors=(rmse, bias))
        # the DIRICHLET_SDF film: finite, the row's lower bound on pixels
        # in truncated rows; K11 on the 2-level grid against its plain
        g = integ.problem.scene.d_grid
        q_pix = integ.eval_points
        row = grid_row_index(g, q_pix)
        sdf = torch.as_tensor(integ.films["DIRICHLET_SDF"].pixels()[..., 0]
                              .reshape(-1), device=q_pix.device)
        tr = g.row_trunc[row.long()]
        log(f"    DIRICHLET_SDF in [{float(sdf.min()):.5f}, "
            f"{float(sdf.max()):.5f}]; {int(tr.sum())} of {tr.numel()} "
            f"pixels in truncated rows ({len(g.meta)} levels, "
            f"{int(g.row_trunc.sum())} truncated rows of "
            f"{g.row_trunc.numel()})")
        if not (torch.isfinite(sdf).all() and torch.equal(
                sdf[tr], g.row_lbound[row.long()][tr])):
            raise RuntimeError("bumpy3d_u's DIRICHLET_SDF film")
        check_grid_band("grid_band_3d", row, q_pix, g, None,
                        "bumpy3d's 256^2 pixels")
        del integ, g
    scale = (64 / SPP_3D) ** 0.5
    log(f"    bounds at depth {BUMPY_DEPTH}: RMSE {0.05 * scale}, mean "
        f"error {0.015 * scale}")
    if not (rmse < 0.05 * scale and abs(bias) < 0.015 * scale):
        raise RuntimeError("bumpy3d_u out of its analytic bounds")


def phase_bumpy_n(conf_path: str, card: str, keep: dict) -> dict:
    """[7g] bumpy3d_n as shipped through run_expr (``guided_run``, held to
    [7]'s bumpy3d_u film at depth 64): both films' errors against h."""
    log("[7g] 3D guided path (bumpy3d_n)")
    launches, _, _ = guided_run(conf_path, BUMPY_3D, "bumpy3d_n", card,
                                keep)
    rmse, bias = bumpy_errors(conf_path)
    rmse_u, bias_u = keep["bumpy3d_u"]["errors"]
    log(f"    against h: bumpy3d_n RMSE {rmse:.5f}, mean error {bias:.5f}; "
        f"bumpy3d_u RMSE {rmse_u:.5f}, mean error {bias_u:.5f} (depth 64, "
        f"a reading; {card})")
    return launches


def check_cube_sdf(conf_path: str, integ) -> None:
    """neumann3d's DIRICHLET_SDF film within 1e-5 of the distance to the
    cube, 1.3 - max(|x|, |y|), at every pixel."""
    pts = frame_points(conf_path)
    sdf = integ.films["DIRICHLET_SDF"].pixels()[..., 0].reshape(-1)
    want = 1.3 - np.maximum(np.abs(pts[:, 0]), np.abs(pts[:, 1]))
    err = float(np.abs(sdf - want).max())
    log(f"    DIRICHLET_SDF against 1.3 - max(|x|, |y|): max error {err:.3g} "
        f"over {sdf.size} pixels (bound 1e-5)")
    if not (np.abs(pts[:, 2]).max() == 0.0 and err <= 1e-5):
        raise RuntimeError("neumann3d's DIRICHLET_SDF film")


def phase_main_3d(conf_path: str, card: str, keep: dict) -> dict:
    log("[8] 3D main path")
    launches, result, integ = run_main(conf_path, MAIN_3D, "neumann3d_u",
                                       card)
    keep["neumann3d_u"] = route_keep(result, integ)
    log_rounds("balanced route", integ.balance_rounds)
    mean = float(read_solution(conf_path).mean())
    log(f"    mean u {mean:.5f} (within (0.2, 0.8))")
    if not 0.2 < mean < 0.8:
        raise RuntimeError("neumann3d_u mean out of the boundary data's hull")
    check_cube_sdf(conf_path, integ)
    return launches


def phase_neumann3d_n(conf_path: str, card: str, keep: dict) -> dict:
    """[8g] neumann3d_n through run_expr (``guided_run``, held to [8]'s
    neumann3d_u film), its DIRICHLET_SDF film as [8]'s, one guided
    iteration's K6 against its plain version, and the guide's costs at
    the frame's 65,536 lanes."""
    log("[8g] 3D guided path with a Neumann set (neumann3d_n)")
    launches, _, integ = guided_run(conf_path, MAIN_3D, "neumann3d_n", card,
                                    keep)
    check_cube_sdf(conf_path, integ)
    check_guided_band_walk(integ, card)
    guide_costs(integ, card)
    return launches


def check_guided_band_walk(integ, card: str) -> None:
    """One guiding-phase depth step of the trained guide on the frame's
    lanes, GUIDED_WARM_STEPS guided steps in: K6 launches once in it, on the
    guide's directions, and that launch's inputs (the step's live lanes,
    star radii, walk state, uniforms and directions) give K6 what they
    give its plain version (``compare_band_walk``)."""
    from elaina_tpu_torch.ops import queries as QK
    from elaina_tpu_torch.solver import guided as G
    from elaina_tpu_torch.solver.wost import init_walk_state
    from elaina_tpu_torch.utils.rng import sample_generators

    scene, s = integ.problem.scene, integ.settings
    eps = float(s.epsilonShell)
    uf = float(s.uniformFractionInGuidingPhase)
    mgd = int(s.maxGuidedDepthInGuidingPhase)
    params = integ.trainer.ema_params
    gens = sample_generators(0, 1, integ.device)
    state = init_walk_state(integ.eval_points, integ.mask)

    def step(depth: int):
        return G.guided_depth_step(scene, integ.spec, params, integ.box,
                                   state, None, gens, depth, True, False, uf,
                                   mgd, eps=eps)[0]

    for depth in range(GUIDED_WARM_STEPS):
        state = step(depth)
    calls = []
    launch = QK.band_neumann_walk

    def spy(*args):
        calls.append(args)
        return launch(*args)

    # the wrapper counts its launches on the module's name, the spy here
    spy.launches = 0
    QK.band_neumann_walk = spy
    try:
        step(GUIDED_WARM_STEPS)
    finally:
        QK.band_neumann_walk = launch
    if not (len(calls) == 1 == spy.launches):
        raise RuntimeError(f"a guided step launched K6 {spy.launches} "
                           f"times in {len(calls)} calls")
    kargs = calls[0]
    cell, _, R, on = kargs[:4]
    live = kargs[-1]
    work = QK.band_work(cell, R, on, eps, kargs[10], live)
    err, flips, out = compare_band_walk(kargs)
    log(f"    K6 in a guided step (depth {GUIDED_WARM_STEPS}, max guided "
        f"depth {mgd}): {int(live.sum())} live of {live.shape[0]} lanes, "
        f"band work on {int(work.sum())}, {int(on.sum())} on the Neumann "
        f"set, {int((out[:, 0] > 0).sum())} with a sample, "
        f"{int((out[:, 10] > 0).sum())} walk hits; against its plain "
        f"version: largest difference {err:.3g}, {flips} CDF slots flipped "
        f"({card})")


def phase_source_3d(root: str, card: str) -> dict:
    """[8b] neumann3d_u with a volumetric source."""
    from elaina_tpu_torch.utils import scenes as S

    log("[8b] neumann3d_u with a source")
    # its own directory: write_neumann3d_source writes a neumann3d_u.json
    # of its samples beside it, and [8]'s is in ``root``
    d = os.path.join(root, "source3d")
    os.makedirs(d)
    path = S.write_neumann3d_source(d, SOURCE_3D_SPP)
    launches, _, integ = run_main(
        path, ("band_ray", "band_neumann_walk", "sweep_resolve_3d"),
        "neumann3d_source", card)
    mean = float(read_solution(path).mean())
    src = integ.films["SOURCE"].pixels()[..., :3]
    log(f"    mean u {mean:.5f}; SOURCE film in [{src.min():.4f}, "
        f"{src.max():.4f}]")
    if not (np.isfinite(src).all() and src.min() > 0):
        raise RuntimeError("neumann3d_source's SOURCE film")
    return launches


def phase_unfused_3d(conf_path: str, card: str) -> dict:
    """[8c] neumann3d_u at 8 spp, unfused (K8 + K7) and fused (K6)."""
    log("[8c] neumann3d_u unfused and fused, 8 spp")
    with open(conf_path) as f:
        conf = json.load(f)
    conf["integrator"]["setting"]["samplesPerPixel"] = 8
    out = {}
    for on, expect in ((False, ("band_ball", "band_ray")),
                       (True, ("band_neumann_walk",))):
        conf["exp_name"] = "neumann3d_" + ("fused8" if on else "unfused8")
        path = conf_path[:-5] + ("_fused8" if on else "_unfused8") + ".json"
        with open(path, "w") as f:
            json.dump(conf, f)
        with fused_band(on):
            launches, result, integ = run_main(path, expect, conf["exp_name"],
                                               card)
        if not on and launches["band_neumann_walk"]:
            raise RuntimeError("the unfused run launched K6")
        out[on] = (launches, (integ.sum / integ.spp).cpu().numpy(),
                   integ.standard_error(), result)
        del integ
    (lu, mu, su, ru), (_, mf, sf, rf) = out[False], out[True]
    within = np.abs(mf - mu) <= 4.0 * np.sqrt(su ** 2 + sf ** 2) + 1e-6
    rate = {k: r["walk_steps"] / (r["duration"] / 1e3)
            for k, r in (("unfused", ru), ("fused", rf))}
    log(f"    walk-steps/s unfused {rate['unfused']:.6g}, fused "
        f"{rate['fused']:.6g} (fused / unfused "
        f"{rate['fused'] / rate['unfused']:.4f}; {card}); means within 4 "
        f"combined standard errors on {within.mean():.5f} of the pixel "
        f"channels (>= 0.99)")
    if within.mean() < 0.99:
        raise RuntimeError("the unfused image disagrees with the fused one")
    return lu


def phase_routes(confs: dict, keep: dict, card: str) -> None:
    """[8r] lobed_u, lobed_n, neumann3d_u and bumpy3d_n on the per-sample
    route (the metric-frames switch, no frame written) at 1 / ROUTES_SPP_CUT
    of the spp of [4], [4g], [8] and [7g] (the guided paths' training
    samples as configured), held to those balanced films: within 4 combined
    standard errors on >= 99% of pixel channels.  Prints both routes'
    walk-steps/s, depth-capped share and peak memory, and for a guided
    path each phase's walk-steps/s, the loss and the guided / uniform
    variance of the mean on each route (a reading; against the uniform
    path's film on the same route where this phase runs it, else its
    balanced one)."""
    from elaina_tpu_torch.utils import scenes as S

    log("[8r] the per-sample route beside the balanced one")
    expect = {"lobed_u": MAIN_2D, "lobed_n": MAIN_2D,
              "neumann3d_u": MAIN_3D, "bumpy3d_n": BUMPY_3D}
    for label, conf in confs.items():
        path = S.write_per_sample(conf, label + "_per_sample")
        with open(path) as f:
            c = json.load(f)
        st = c["integrator"]["setting"]
        st["samplesPerPixel"] //= ROUTES_SPP_CUT
        with open(path, "w") as f:
            json.dump(c, f)
        _, result, integ = run_main(path, expect[label],
                                    label + " per-sample", card)
        if getattr(integ, "balance_rounds", None) is not None:
            raise RuntimeError(f"{label} per-sample ran the balanced route")
        ps, bal = route_keep(result, integ), keep[label]
        keep[label + "_per_sample"] = ps
        del integ
        within = np.abs(ps["mean"] - bal["mean"]) <= 4.0 * np.hypot(
            ps["se"], bal["se"]) + 1e-6
        for route, r in (("balanced", bal), ("per-sample", ps)):
            log(f"    {label} {route}: {r['rate']:.6g} walk-steps/s, "
                f"depth-capped share {r['capped']:.4f}, peak device "
                f"memory {r['peak']} bytes ({card})")
        if label in UNIFORM_OF:
            for route, r in (("balanced", bal), ("per-sample", ps)):
                st = r["phase_stats"]
                uniform = UNIFORM_OF[label]
                uni = keep.get(uniform + ("" if route == "balanced"
                                          else "_per_sample"), keep[uniform])
                ratio = float(np.mean(r["se"] ** 2) / np.mean(
                    uni["se"] ** 2))
                log(f"    {label} {route}: training phase "
                    f"{st['train_steps'] / st['train_s']:.6g} walk-steps/s,"
                    f" guiding phase {st['guide_steps'] / st['guide_s']:.6g}"
                    f"; loss {len(r['loss'])} values, {r['loss'][0]:.6g} -> "
                    f"{r['loss'][-1]:.6g}; guided / uniform variance of the "
                    f"mean {ratio:.4f} (a reading)")
        log(f"    {label}: the routes' films within 4 combined standard "
            f"errors on {within.mean():.5f} of the pixel channels (>= 0.99)")
        if within.mean() < 0.99:
            raise RuntimeError(f"{label}: the per-sample film disagrees with "
                               f"the balanced one")
    for label in confs:     # the balanced films stay for [9]
        keep.pop(label + "_per_sample")


def phase_syncs_balanced(conf_2d: str, conf_n: str, device,
                         group=None) -> None:
    """[8d] A whole balanced chunk of lobed_u (2 samples a lane) and of
    lobed_n's training phase (2 samples a lane, an optimizer pass every 4
    iterations) under ``torch.cuda.set_sync_debug_mode("error")``, lifted
    only around the host's reads of the loop condition (``balanced.
    read_flag``, every CHECK_EVERY iterations), after a short chunk
    outside it: no iteration waits for the device between the host's
    checks.  With ``group`` ([12a]: a one-rank NCCL group) lobed_n's
    chunk alone, in lockstep over the group: its all-reduces (the loop
    condition's, each optimizer pass's flag and gradients) queue on the
    stream and make the host wait for nothing."""
    import traceback

    import torch

    from elaina_tpu_torch.solver import balanced as B
    from elaina_tpu_torch.solver import guided as G
    from elaina_tpu_torch.solver.wost import wost_depth_step
    from elaina_tpu_torch.utils.ab import load_integrator
    from elaina_tpu_torch.utils.rng import stage_generators

    read = B.read_flag
    reads = []

    def lifted(flag):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(read(flag))
        finally:
            torch.cuda.set_sync_debug_mode("error")
        return reads[-1]

    paths = (("lobed_u", conf_2d), ("lobed_n", conf_n))
    for label, conf in paths if group is None else paths[1:]:
        problem, integ = load_integrator(conf, device, 2)
        integ.prepare()
        rd0, _, _, resolved = integ._balanced_inputs()
        pix, quota = B.identity_pieces(integ.n_pixels,
                                       np.where(resolved, 0, 2))
        pieces = B.make_pieces(integ.eval_points, rd0, pix, quota)
        eps = float(integ.settings.epsilonShell)
        gens = stage_generators(device)

        def run(cap):
            if label == "lobed_u":
                return B.run_chunk(
                    lambda sc, ex, st, g, w, s0: wost_depth_step(
                        sc, st, g, eps, step0=s0),
                    problem.scene, None, pieces, max_depth=64, iter_cap=cap,
                    round_seed=1, gens=gens)
            loop = G.TrainLoop(integ, integ.trainer, integ.n_pixels, 4,
                               group=group)
            return B.run_chunk(loop.step, problem.scene, None, pieces,
                               max_depth=64, iter_cap=cap, round_seed=1,
                               gens=gens, hooks=loop, group=group)

        run(2)
        reads.clear()
        torch.cuda.synchronize()
        B.read_flag = lifted
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run(B.ITER_CAP_MAX)
        except RuntimeError as e:
            where = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.line}"
                     for f in traceback.extract_tb(e.__traceback__)
                     if "elaina_tpu_torch" in f.filename]
            raise RuntimeError(f"{label}: the balanced chunk waits for the "
                               f"device at {where}: {e}") from None
        finally:
            torch.cuda.set_sync_debug_mode(0)
            B.read_flag = read
        torch.cuda.synchronize()
        iters = int(out.iters)
        if not (out.checks == len(reads) > 1 and not reads[-1]
                and int(out.done.sum()) == int(quota.sum())):
            raise RuntimeError(f"{label}: the probed chunk did not drain: "
                               f"{out.checks} checks, reads {reads}")
        tag = "[8d]" if group is None else (
            f"[12a] {group.backend} group of {group.size}:")
        log(f"{tag} {label}: a balanced "
            f"{'uniform' if label == 'lobed_u' else 'training'} chunk of "
            f"{iters} iterations over {integ.n_pixels} lanes "
            f"({int(out.steps)} live lane-steps"
            f"{', an optimizer pass every 4 iterations' if label == 'lobed_n' else ''}"
            f") with no host sync but its {out.checks} reads of the loop "
            f"condition, one every {B.CHECK_EVERY} iterations")
        del problem, integ, pieces, out

def phase_syncs(paths: dict, device) -> None:
    """[8d] One depth step of each main path under
    ``torch.cuda.set_sync_debug_mode("error")``, after one step outside it
    (the kernel libraries loaded, the FinePack baked): a step that makes
    the host wait for the device raises there, and the phase fails with
    the port's frames of the stack."""
    import traceback

    import torch

    from elaina_tpu_torch.solver.wost import wost_depth_step
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state
    from elaina_tpu_torch.utils.rng import sample_generators

    for label, conf in paths.items():
        problem, integ = load_integrator(conf, device, 1)
        state = warm_state(problem, integ, 1)
        gens = sample_generators(0, 1, device)
        eps = float(integ.settings.epsilonShell)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            wost_depth_step(problem.scene, state, gens, eps)
        except RuntimeError as e:
            where = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.line}"
                     for f in traceback.extract_tb(e.__traceback__)
                     if "elaina_tpu_torch" in f.filename]
            raise RuntimeError(f"{label}: the depth step waits for the "
                               f"device at {where}: {e}") from None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[8d] {label}: one depth step of {state.pos.shape[0]} lanes "
            f"({int(state.active.sum())} live) without a host sync")
        del problem, integ, state


def phase_syncs_guided(conf_path: str, label: str, device) -> None:
    """[8d] A guided path (lobed_n; neumann3d_n, whose steps take the
    fused band step on the guide's directions): one guided depth step in
    the training phase (records on), one in the guiding phase and one
    ``train_on_records`` batch under
    ``torch.cuda.set_sync_debug_mode("error")``, after one training step
    and one batch outside it."""
    import traceback

    import torch

    from elaina_tpu_torch.solver import guided as G
    from elaina_tpu_torch.solver.wost import init_walk_state
    from elaina_tpu_torch.utils.ab import load_integrator
    from elaina_tpu_torch.utils.rng import sample_generators

    problem, integ = load_integrator(conf_path, device, 1)
    scene, s, spec, box = problem.scene, integ.settings, integ.spec, integ.box
    eps = float(s.epsilonShell)
    params = integ.trainer.ema_params
    gens = sample_generators(0, 1, device)
    batch, _ = G._train_batch_policy(integ.n_pixels)
    state = init_walk_state(integ.eval_points, integ.mask)
    records = G.init_records(integ.n_pixels, problem.dim, device)
    state, records, _, _ = G.guided_depth_step(
        scene, spec, params, box, state, records, gens, 0, True, True, 0.5,
        10, eps=eps)
    G.train_on_records(integ.trainer, spec, integ.adam_cfg, box, records,
                       batch_size=batch, n_batches=1)
    calls = (
        ("training-phase step", lambda: G.guided_depth_step(
            scene, spec, params, box, state, records, gens, 1, True, True,
            0.5, 10, eps=eps)),
        ("guiding-phase step", lambda: G.guided_depth_step(
            scene, spec, params, box, state, None, gens, 1, True, False,
            0.5, 10, eps=eps)),
        ("train_on_records batch", lambda: G.train_on_records(
            integ.trainer, spec, integ.adam_cfg, box, records,
            batch_size=batch, n_batches=1)))
    path = label
    for step, fn in calls:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            where = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.line}"
                     for f in traceback.extract_tb(e.__traceback__)
                     if "elaina_tpu_torch" in f.filename]
            raise RuntimeError(f"{path} {step} waits for the device at "
                               f"{where}: {e}") from None
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f"[8d] {path}: one {step} on {integ.n_pixels} lanes "
            f"({int(state.active.sum())} live) without a host sync")
    del problem, integ, state, records


# --------------------------------------------------------------------------- #
# [9] equal time: budgeted solves and a checkpoint's resume
# --------------------------------------------------------------------------- #


def round_lines(rounds: list, card: str) -> str:
    """Each round's lanes, cap, iterations run, wall, the host's part
    before its chunk, seconds an iteration (the rest of its wall over its
    iterations), and ``lanes / rate`` at the round's own walk-steps/s (the
    JAX package's model of an iteration's wall)."""
    return "; ".join(
        f"({r['lanes']}, cap {r['cap']}, {r['ran']} run, {r['wall']:.4f} s, "
        f"host {r['host_s']:.4f} s, "
        f"{(r['wall'] - r['host_s']) / max(r['ran'], 1) * 1e3:.3f} ms an "
        f"iteration, "
        f"lanes / rate {r['lanes'] * r['wall'] / max(r['steps'], 1) * 1e3:.3f}"
        f" ms{', probe' if r['probe'] else ''})"
        for r in rounds) + f" ({card})"


def flat_rounds_of(rounds) -> list:
    """A balanced solve's round records; a guided one's phases in order."""
    if isinstance(rounds, dict):
        rounds = rounds["train"] + rounds["guide"]
    return rounds


def flat_rounds(integ) -> list:
    return flat_rounds_of(integ.balance_rounds)


def budgeted(conf_path: str, label: str, budget: float, expect: tuple,
             device, card: str):
    """A problem and an integrator as ``run_expr`` makes them (the hints of
    the earlier runs of the scene loaded from the cache), ``prepare()``,
    the launch counts zeroed, then ``solve(time_budget_s=budget)``.
    Returns (integrator, the solve's seconds, launches)."""
    import torch

    from elaina_tpu_torch.utils.ab import load_integrator

    problem, integ = load_integrator(conf_path, device)
    integ.prepare()
    reset_counts()
    secs = integ.solve(time_budget_s=budget) / 1e3
    torch.cuda.synchronize()
    launches = read_counts()
    if integ.sum.device.type != "cuda":
        raise RuntimeError(f"{label} did not run on the card")
    if not all(launches[k] for k in expect):
        raise RuntimeError(f"a kernel of {label} never launched: {launches}")
    log(f"    {label}: budget {budget:.3f} s, solve {secs:.3f} s "
        f"(overshoot {secs - budget:+.3f} s), {integ.total_walk_steps} walk "
        f"steps, {integ.total_walk_steps / secs:.6g} walk-steps/s ({card}); "
        f"launches {launches}")
    log(f"    rounds: {round_lines(flat_rounds(integ), card)}")
    return integ, secs, launches


def completion(integ) -> tuple:
    """The completed samples of the pixels not baked: (fewest, harmonic /
    arithmetic mean)."""
    spp = integ.spp
    done = (np.full(integ.n_pixels, spp) if integ.done_per_pixel is None
            else np.asarray(integ.done_per_pixel, np.float64))
    d = done[~integ._balanced_inputs()[3]].astype(np.float64)
    if d.size == 0:
        return spp, 1.0
    if d.min() < 1:
        return 0, 0.0
    return int(d.min()), float(d.size / (1.0 / d).sum() / d.mean())


def against(integ, ref: dict, label: str, ref_label: str) -> float:
    """The share of pixel channels whose means lie within 4 combined
    standard errors of the kept film's."""
    mean = (integ.sum / integ.spp).cpu().numpy()
    se = integ.standard_error()
    within = np.abs(mean - ref["mean"]) <= 4.0 * np.hypot(se, ref["se"]) \
        + 1e-6
    log(f"    {label} against {ref_label}: {within.mean():.5f} of pixel "
        f"channels within 4 combined standard errors")
    return float(within.mean())


def budget_gates(integ, label: str, budget: float, secs: float, ref: dict,
                 ref_label: str, card: str) -> None:
    """[9a]'s gates: the solve within the budget and its longest round
    and under twice the budget, every pixel not baked with a completed
    sample, harmonic / arithmetic mean of the completed samples >= 0.9,
    the film within 4 combined standard errors of the kept full film on
    >= 99% of pixel channels."""
    longest = max(r["wall"] for r in flat_rounds(integ))
    fewest, ratio = completion(integ)
    log(f"    {label}: wall {secs:.3f} s against budget {budget:.3f} s + "
        f"longest round {longest:.3f} s ({card}); completed samples a "
        f"pixel: fewest {fewest}, harmonic / arithmetic mean {ratio:.4f}, "
        f"spp {integ.spp}")
    share = against(integ, ref, label, ref_label)
    if not (secs <= budget + longest and secs < 2 * budget):
        raise RuntimeError(f"{label} overran its budget: {secs} s")
    if fewest < 1 or ratio < 0.9:
        raise RuntimeError(f"{label}: uneven completion ({fewest}, {ratio})")
    if share < 0.99:
        raise RuntimeError(f"{label} disagrees with {ref_label}")


def budget_of(ref: dict, label: str, ref_label: str, card: str) -> float:
    """[9a] / [9b]'s budget from the unbudgeted solve ``ref`` of the same
    scene: its host partitions' seconds (the rounds' ``host_s``, paid
    whatever the samples) plus BUDGET_SPP times its seconds a sample (the
    rest of its wall over its samples).  A share of the wall bought ~4-5
    samples a pixel, since the partitions' fixed ~0.8 s ate into it."""
    host = sum(r["host_s"] for r in flat_rounds_of(ref["rounds"]))
    per_sample = (ref["solve_s"] - host) / ref["spp"]
    budget = host + BUDGET_SPP * per_sample
    log(f"{label} under a budget of {budget:.3f} s: {ref_label}'s host "
        f"partitions {host:.3f} s + {BUDGET_SPP} x its {per_sample:.4f} s "
        f"a sample ({ref_label}'s solve {ref['solve_s']:.3f} s, "
        f"{ref['spp']} spp; {card})")
    return budget


def log_bought(label: str, integ) -> None:
    """The samples a pixel that a budget bought: the mean and the fewest
    completed over the pixels not baked."""
    spp = integ.settings.samplesPerPixel
    done = (np.full(integ.n_pixels, spp) if integ.done_per_pixel is None
            else np.asarray(integ.done_per_pixel, np.float64))
    d = done[~integ._balanced_inputs()[3]]
    log(f"    {label}: samples bought {float(d.mean()):.2f} a pixel on "
        f"average, fewest {int(d.min())}, of {spp}")


def phase_budget_2d(conf_2d: str, device, card: str, keep: dict) -> None:
    """[9a] lobed_u under a budget from [4]'s solve (``budget_of``), held
    to [4]'s film; then a fresh problem under ten times [4]'s wall: it
    loads the saved hints, skips the probe round and completes every
    sample."""
    budget = budget_of(keep["lobed_u"], "[9a] lobed_u", "[4]", card)
    integ, secs, _ = budgeted(conf_2d, "lobed_u budgeted", budget, MAIN_2D,
                              device, card)
    log_bought("lobed_u budgeted", integ)
    budget_gates(integ, "lobed_u budgeted", budget, secs, keep["lobed_u"],
                 "[4]'s film", card)
    keep["lobed_u_budget"] = {"se": integ.standard_error(), "secs": secs,
                              "budget": budget}
    generous = GENEROUS * keep["lobed_u"]["solve_s"]
    integ, secs, _ = budgeted(conf_2d, "lobed_u generous", generous,
                              MAIN_2D, device, card)
    problem = integ.problem
    key = integ._cost_cache()[1]
    r0 = integ.balance_rounds[0]
    log(f"    fresh problem: hints loaded {problem._hints_loaded}, cost of "
        f"this frame {key in problem._cost_cache}, rate of its lanes "
        f"{problem._rate_cache.get(integ.n_pixels)}; round 0: {r0['lanes']} "
        f"lanes, cap {r0['cap']}, probe {r0['probe']}, {r0['iters']} "
        f"iterations; samples left {integ.done_per_pixel is not None}")
    if not (problem._hints_loaded and key in problem._cost_cache
            and not r0["probe"] and integ.done_per_pixel is None
            and integ.spp == SPP):
        raise RuntimeError("the hints were not used, or the generous "
                           "budget left samples")


def phase_budget_guided(conf_n: str, device, card: str, keep: dict) -> None:
    """[9b] lobed_n under [9a]'s budget: the policy, the phases, its film
    against [4g]'s; the equal-time variance of the mean, guided over
    [9a]'s uniform film (a reading)."""
    budget = keep["lobed_u_budget"]["budget"]
    log(f"[9b] lobed_n under [9a]'s budget ({budget:.3f} s)")
    integ, secs, _ = budgeted(conf_n, "lobed_n budgeted", budget, MAIN_2D,
                              device, card)
    log_bought("lobed_n budgeted", integ)
    ps = integ.phase_stats
    policy = integ.train_policy
    log(f"    policy (skip, t_target, share_cap): ({policy['skip']}, "
        f"{policy['t_target']}, {policy['share_cap']}), predicted training "
        f"wall {policy['predicted_wall']}; train_spp_achieved "
        f"{integ.train_spp_achieved:.4f}; trained {integ._net_trained}")
    for phase in ("train", "guide"):
        sec, steps = ps[f"{phase}_s"], ps[f"{phase}_steps"]
        log(f"    {phase} phase: {sec:.3f} s, {steps} walk steps, "
            f"{steps / sec if sec else 0.0:.6g} walk-steps/s ({card})")
    longest = max(r["wall"] for r in flat_rounds(integ))
    fewest, ratio = completion(integ)
    log(f"    wall {secs:.3f} s against budget {budget:.3f} s (longest round "
        f"{longest:.3f} s; {card}); completed samples a pixel: fewest "
        f"{fewest}, harmonic / arithmetic mean {ratio:.4f}")
    share = against(integ, keep["lobed_n"], "lobed_n budgeted",
                    "[4g]'s film")
    se_g, se_u = integ.standard_error(), keep["lobed_u_budget"]["se"]
    log(f"    equal-time variance of the mean, guided / uniform: "
        f"{float(np.mean(se_g ** 2) / np.mean(se_u ** 2)):.4f} (a reading; "
        f"{secs:.3f} s against {keep['lobed_u_budget']['secs']:.3f} s)")
    if fewest < 1 or share < 0.99:
        raise RuntimeError("lobed_n under a budget: a pixel without a "
                           "sample, or its film disagrees with [4g]'s")


def phase_budget_3d(conf_3d: str, device, card: str, keep: dict) -> None:
    """[9c] neumann3d_u under half of [8]'s solve wall, gated as [9a]
    against [8]'s film."""
    budget = BUDGET_SHARE * keep["neumann3d_u"]["solve_s"]
    log(f"[9c] neumann3d_u under a budget of {BUDGET_SHARE} x [8]'s solve "
        f"({keep['neumann3d_u']['solve_s']:.3f} s)")
    integ, secs, _ = budgeted(conf_3d, "neumann3d_u budgeted", budget,
                              BUDGET_3D, device, card)
    budget_gates(integ, "neumann3d_u budgeted", budget, secs,
                 keep["neumann3d_u"], "[8]'s film", card)


def phase_resume(root: str, device, card: str) -> None:
    """[9d] [3b]'s guided square on the per-sample route: RESUME_SPP
    samples with a checkpoint every RESUME_EVERY, then a new integrator
    resumed from it to SQUARE_SPP: the checkpoint's trainer bit-equal to
    the first run's, the resumed run's new samples RESUME_SPP, each point
    within 0.07 of u."""
    import torch

    from elaina_tpu_torch.core.checkpoint import load_trainer
    from elaina_tpu_torch.core.config import IntegratorSettings
    from elaina_tpu_torch.nn.network import trainer_to_numpy
    from elaina_tpu_torch.solver.guided import GuidedIntegrator

    log("[9d] checkpoint and resume of the guided square")
    problem = square_problem(device)
    pts = np.array([[0.0, 0.0], [0.5, 0.8], [-0.5, -0.8], [0.8, 0.0],
                    [-0.8, 0.3], [0.2, -0.5], [-0.3, 0.6]], np.float32)
    reps = 256
    lanes = torch.as_tensor(np.repeat(pts, reps, axis=0), device=device)
    want = (pts[:, 0] + 1) / 2
    ck = os.path.join(root, "square_checkpoint.npz")
    runs = []
    for spp in (RESUME_SPP, SQUARE_SPP):
        settings = IntegratorSettings(
            frameSize=(len(lanes), 1), samplesPerPixel=spp,
            maxWalkingDepth=48, epsilonShell=0.02,
            trainSppCount=SQUARE_TRAIN_SPP)
        integ = GuidedIntegrator(problem, settings, "unused", points=lanes)
        integ.reset_network(SQUARE_NET)
        reset_counts()
        ms = integ.solve(checkpoint_path=ck, checkpoint_every=RESUME_EVERY)
        launches = read_counts()
        u = integ.films["SOLUTION"].pixels()[0, :, 0].reshape(
            len(pts), reps).mean(1)
        log(f"    {spp} spp ({integ.spp_done} run here): u "
            f"{np.round(u, 4).tolist()} vs {want.tolist()} (atol 0.07), "
            f"{ms} ms, optimizer steps {int(integ.trainer.opt.count)} "
            f"({card}); launches {launches}")
        if integ.sum.device.type != "cuda" or getattr(
                integ, "balance_rounds", None) is not None:
            raise RuntimeError("the resume did not run per-sample on the "
                               "card")
        if not all(launches[k] for k in MAIN_2D):
            raise RuntimeError(f"a kernel of the square never launched: "
                               f"{launches}")
        if spp == RESUME_SPP:
            saved, meta = load_trainer(ck, device)
            a, b = trainer_to_numpy(saved), trainer_to_numpy(integ.trainer)
            same = a["count"] == b["count"] and all(
                np.array_equal(a[f][k], b[f][k])
                for f in ("params", "ema_params", "mu", "nu") for k in a[f])
            log(f"    checkpoint at {meta}: trainer bit-equal {same}")
            if not same or meta.get("spp") != RESUME_SPP:
                raise RuntimeError("the checkpoint's trainer differs")
        runs.append(integ)
        if not np.all(np.abs(u - want) <= 0.07):
            raise RuntimeError(f"the resumed guided square out of bound "
                               f"({spp} spp)")
    if runs[1].spp_done != SQUARE_SPP - RESUME_SPP:
        raise RuntimeError(f"the resume ran {runs[1].spp_done} samples")


# --------------------------------------------------------------------------- #
# [10] masks, the profiler trace, the walk tracer
# --------------------------------------------------------------------------- #


def write_mask(path: str, frame: int) -> np.ndarray:
    """[10a]'s mask image, written with the port's ``write_png``: the left
    half of the frame on, a disc of radius frame / 8 in it off.  Returns
    the (H, W) bool mask."""
    from elaina_tpu_torch.output.image_io import write_png

    y, x = np.mgrid[0:frame, 0:frame] + 0.5
    on = (x < frame / 2) & (
        (x - frame / 4) ** 2 + (y - frame / 2) ** 2 > (frame / 8) ** 2)
    write_png(path, np.repeat(on[..., None], 3, -1).astype(np.float32),
              srgb=False)
    return on


def with_mask(conf_path: str, mask_path: str, exp_name: str) -> str:
    """A copy of a config beside it, named ``exp_name``, whose scene has
    ``mask_path``.  Returns its path."""
    with open(conf_path) as f:
        conf = json.load(f)
    conf["exp_name"] = exp_name
    conf["scene"]["mask_path"] = mask_path
    path = os.path.join(os.path.dirname(conf_path), exp_name + ".json")
    with open(path, "w") as f:
        json.dump(conf, f, indent=2)
    return path


@contextlib.contextmanager
def solve_budget(seconds: float):
    """``run_expr``'s ``solve()`` under ``time_budget_s=seconds`` for the
    block (a budget is a ``solve()`` argument only, as in the JAX
    package)."""
    from elaina_tpu_torch.solver.guided import GuidedIntegrator
    from elaina_tpu_torch.solver.integrator import UniformIntegrator

    saved = {c: c.solve for c in (UniformIntegrator, GuidedIntegrator)}
    for cls, solve in saved.items():
        cls.solve = (lambda self, _solve=solve, **kw:
                     _solve(self, time_budget_s=seconds, **kw))
    try:
        yield
    finally:
        for cls, solve in saved.items():
            cls.solve = solve


def masked_run(conf_path: str, expect: tuple, label: str, ref: dict,
               on: np.ndarray, card: str) -> dict:
    """A masked run through ``run_main`` and [10a]'s gates against the
    unmasked run ``ref`` (its ``route_keep``); the walk-step ratio is of
    steps a sample.  Returns its ``route_keep``, launches, ratio and
    integrator."""
    launches, result, integ = run_main(conf_path, expect, label, card)
    flat = on.reshape(-1)
    sums = integ.sum.cpu().numpy()
    film = integ.films["SOLUTION"].pixels()[..., :3].reshape(-1, 3)
    sol = read_solution(conf_path).reshape(-1, 3)
    zero = all((a[~flat] == 0).all() for a in
               (sums, integ.sum_sq.cpu().numpy(), film, sol))
    done = integ.done_per_pixel
    keep = route_keep(result, integ)
    within = np.abs(keep["mean"] - ref["mean"]) <= 4.0 * np.hypot(
        keep["se"], ref["se"]) + 1e-6
    share = float(within[flat].mean())
    ratio = (result["walk_steps"] / integ.spp) / (ref["steps"] / ref["spp"])
    log(f"    {label}: masked pixels {int((~flat).sum())} of {flat.size}, "
        f"all exactly 0: {zero}; {share:.5f} of the unmasked pixel "
        f"channels within 4 combined standard errors of the unmasked run; "
        f"walk steps {result['walk_steps']} at {integ.spp} spp against "
        f"{ref['steps']} at {ref['spp']}: {ratio:.4f} of the unmasked run's "
        f"a sample (unmasked share of the frame "
        f"{flat.mean():.4f}); samples left: {done is not None}")
    if not zero:
        raise RuntimeError(f"{label}: a masked pixel is not 0")
    if done is not None and (done[~flat] != integ.spp).any():
        raise RuntimeError(f"{label}: a masked pixel is not counted done")
    if share < 0.99:
        raise RuntimeError(f"{label} disagrees with its unmasked run")
    return dict(keep, launches=launches, ratio=ratio, integ=integ)


def check_ratio(label: str, ratio: float, on: np.ndarray,
                budget: bool = False) -> None:
    """Walk steps fall with the masked share: between 0.5 and 1.5 times
    the unmasked share of the frame (at most 1.5 under a budget, which
    cuts samples too)."""
    s = float(on.mean())
    if ratio > 1.5 * s or (not budget and ratio < 0.5 * s):
        raise RuntimeError(f"{label}: walk-step ratio {ratio:.4f} against "
                           f"an unmasked share of {s:.4f}")


def phase_masks(root: str, card: str, keep: dict) -> None:
    """[10a] Scene masks through ``run_expr``: lobed_u on both routes and
    under a budget, lobed_n (against the unmasked lobed_u), neumann3d_u,
    each against an unmasked run of its scene.
    Keeps the unmasked lobed_u's config for [10b] and [10c]."""
    from elaina_tpu_torch.utils import scenes

    log("[10a] scene masks")
    d = os.path.join(root, "masks")
    os.makedirs(d)
    mask_path = os.path.join(d, "mask.png")
    on = write_mask(mask_path, MASK_FRAME)

    conf_u = scenes.write_scene(d, MASK_SPP, frame=MASK_FRAME)
    keep["mask_conf"] = conf_u
    _, result, integ = run_main(conf_u, MAIN_2D,
                                f"lobed_u {MASK_FRAME}^2 unmasked", card)
    ref = route_keep(result, integ)
    masked = with_mask(conf_u, mask_path, "lobed_u_masked")
    bal = masked_run(masked, MAIN_2D, "lobed_u masked, balanced", ref, on,
                     card)
    check_ratio("lobed_u masked", bal["ratio"], on)
    ps = masked_run(scenes.write_per_sample(masked, "lobed_u_masked_ps"),
                    MAIN_2D, "lobed_u masked, per-sample", ref, on, card)
    check_ratio("lobed_u masked per-sample", ps["ratio"], on)
    budget = MASK_BUDGET_SHARE * bal["solve_s"]
    with solve_budget(budget):
        cut = masked_run(masked, MAIN_2D,
                         f"lobed_u masked, budget {budget:.3f} s", ref, on,
                         card)
    fewest, ha = completion(cut["integ"])
    log(f"    budgeted: solve {cut['solve_s']:.3f} s against "
        f"{budget:.3f} s, {cut['steps']} walk steps; completed samples a "
        f"pixel not baked: fewest {fewest}, harmonic / arithmetic mean "
        f"{ha:.4f} ({card})")
    check_ratio("lobed_u masked under a budget", cut["ratio"], on, True)
    if fewest < 1:
        raise RuntimeError("lobed_u masked under a budget: a pixel without "
                           "a sample")

    dn = os.path.join(d, "guided")
    os.makedirs(dn)
    conf_n = scenes.write_lobed_n(dn, MASK_SPP, MASK_TRAIN_SPP,
                                  frame=MASK_FRAME)
    # against the unmasked lobed_u run, as [4g] holds lobed_n to lobed_u
    gn = masked_run(with_mask(conf_n, mask_path, "lobed_n_masked"),
                    MAIN_2D, "lobed_n masked", ref, on, card)
    check_ratio("lobed_n masked", gn["ratio"], on)
    if not gn["integ"]._net_trained:
        raise RuntimeError("lobed_n masked: the guide never trained")

    # an unmasked run at the same spp: against [8]'s 64-spp film the
    # gate rests on the 8-sample standard errors alone, which the walks
    # capped at 0 (0.32 of them) make unreliable
    conf_3d = scenes.write_config_copy(d, "neumann3d_u", MASK_SPP)
    _, result, integ = run_main(conf_3d, MAIN_3D, "neumann3d_u unmasked",
                                card)
    n3 = masked_run(with_mask(conf_3d, mask_path, "neumann3d_u_masked"),
                    MAIN_3D, "neumann3d_u masked",
                    route_keep(result, integ), on, card)
    check_ratio("neumann3d_u masked", n3["ratio"], on)
    log(f"    walk-step ratios (masked / unmasked; unmasked share "
        f"{on.mean():.4f}): lobed_u balanced {bal['ratio']:.4f}, "
        f"per-sample {ps['ratio']:.4f}, budget {cut['ratio']:.4f}; "
        f"lobed_n (over unmasked lobed_u's) {gn['ratio']:.4f}; neumann3d_u "
        f"{n3['ratio']:.4f}")


def phase_profile(keep: dict, root: str, device, card: str) -> None:
    """[10b] ``StageTimer`` over the load, ``prepare()`` and a 1-spp solve
    at depth PROFILE_DEPTH of [10a]'s unmasked lobed_u, the solve inside
    ``profile_trace``: the trace names the port's kernels."""
    import dataclasses
    import glob

    from elaina_tpu_torch.utils.ab import load_integrator
    from elaina_tpu_torch.utils.profiling import StageTimer, profile_trace

    log("[10b] stage timer and profiler trace")
    timer = StageTimer()
    with timer.stage("load"):
        problem, integ = load_integrator(keep["mask_conf"], device, spp=1)
    # a short solve keeps the trace small: every op is an event
    integ.settings = dataclasses.replace(integ.settings,
                                         maxWalkingDepth=PROFILE_DEPTH)
    with timer.stage("prepare", integ.eval_points):
        integ.prepare()
    trace_dir = os.path.join(root, "trace")
    t0 = time.time()
    with profile_trace(trace_dir):
        with timer.stage("solve", integ.eval_points):
            integ.solve()
    scope = time.time() - t0
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"profile_trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    ours = {k: sum(k in n for n in kernels) for k in
            ("sweep_resolve", "compact_lanes", "fetch_colors")}
    log(f"    trace {os.path.basename(files[0])}: "
        f"{os.path.getsize(files[0])} bytes, {len(events)} events, "
        f"{len(kernels)} distinct CUDA kernels; the port's among them "
        f"(distinct names containing): {ours}")
    log(f"    stage timer ({card}): {json.dumps(timer.report())}; the "
        f"profile_trace scope {scope:.3f} s (its start, the solve, the "
        f"trace written)")
    if not (ours["sweep_resolve"] and ours["compact_lanes"]):
        raise RuntimeError("the trace does not name the port's kernels")
    keep["mask_problem"] = (problem, integ)


def phase_trace_walk(keep: dict, card: str) -> None:
    """[10c] ``trace_walk`` from the pixel of [10b]'s lobed_u farthest
    from the Dirichlet set."""
    import torch

    from elaina_tpu_torch.solver.debug import trace_walk

    log("[10c] walk tracer")
    problem, integ = keep.pop("mask_problem")
    rd0 = integ._step0()[0]
    pix = int(torch.argmax(rd0))
    point = integ.eval_points[pix].tolist()
    eps = float(integ.settings.epsilonShell)
    reset_counts()
    t0 = time.time()
    trace = trace_walk(problem.scene, point, eps=eps, max_depth=TRACE_DEPTH)
    secs = time.time() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    total = np.sum([e["contribution"] for e in trace], 0)
    log(f"    pixel {pix} at {point} (R_D {float(rd0[pix]):.4f}): "
        f"{len(trace)} steps in {secs:.3f} s ({card}), last active "
        f"{trace[-1]['active']}, contribution {total.tolist()}; "
        f"launches {launches}")
    if not (trace[0]["pos"] == point and not trace[-1]["active"]
            and len(trace) <= TRACE_DEPTH and np.isfinite(total).all()
            and all(e["active"] for e in trace[:-1])):
        raise RuntimeError("trace_walk: the walk did not end inactive "
                           "with finite contributions")
    if not launches.get("compact_lanes"):
        raise RuntimeError("trace_walk did not run the port's kernels")



# --------------------------------------------------------------------------- #
# [11] the BVH route
# --------------------------------------------------------------------------- #


def conf_copy(conf_path: str, exp_name: str, spp: int) -> str:
    """A copy of a config beside it with its own exp_name and spp."""
    with open(conf_path) as f:
        conf = json.load(f)
    conf["exp_name"] = exp_name
    conf["integrator"]["setting"]["samplesPerPixel"] = spp
    path = os.path.join(os.path.dirname(conf_path), exp_name + ".json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def bvh_problem(conf_path: str, device):
    """The config's problem on the BVH route."""
    from elaina_tpu_torch.core.problem import Problem

    with open(conf_path) as f:
        conf = json.load(f)
    return Problem(conf["dimensionality"], device, verbose=False).load_config(
        conf["scene"], cache_dir=os.environ["ELAINA_CACHE_DIR"], accel="bvh")


def timed_once(fn):
    """(fn(), ms): one call between two CUDA events (the plain traversals
    read their stacks back each iteration, so one call is their time)."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def strided(n: int, m: int, device):
    """m lane ids spread over n lanes."""
    import torch

    return torch.arange(0, n, max(1, n // m), device=device)[:m]


def check_ids_tied(name: str, gs, q, d, d_p, ids, ids_p) -> tuple:
    """Distances within TOL of the plain version's (inf where it is inf);
    ids equal but where q's distances to both prims tie within TOL.
    Returns (largest difference, ids that differ)."""
    import torch

    from elaina_tpu_torch.ops import bvh as B

    fin = torch.isfinite(d_p)
    if not torch.equal(torch.isfinite(d), fin):
        raise RuntimeError(f"{name}: inf / finite differ")
    err = float((d[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
    if not torch.allclose(d[fin], d_p[fin], rtol=TOL, atol=TOL):
        raise RuntimeError(f"{name} distances differ: {err}")
    diff = ids != ids_p
    if diff.any():
        D = gs.dim

        def dist(i):
            c = gs.corners[i[diff].long()]
            return B._prim_dist(D, q[diff], tuple(c[:, k * D:(k + 1) * D]
                                                  for k in range(D)))

        da, db = dist(ids), dist(ids_p)
        if not torch.allclose(da, db, rtol=TOL, atol=TOL):
            raise RuntimeError(f"{name}: {int(diff.sum())} ids differ "
                               f"without a tie")
    return err, int(diff.sum())


def edge_masks(n: int, device):
    """(label, live) of [11a]'s edge cases: a seeded half, no lane, lane
    N - 1 alone."""
    import torch

    g = torch.Generator(device=device).manual_seed(11)
    last = torch.zeros((n,), dtype=torch.bool, device=device)
    last[-1] = True
    return (("half", torch.rand(n, generator=g, device=device) < 0.5),
            ("none", torch.zeros((n,), dtype=torch.bool, device=device)),
            ("lane N - 1", last))


PRIM_TREE = ("bb_min", "bb_max", "left", "right", "leaf_prims", "corners")
SIL_TREE = ("sil_bb_min", "sil_bb_max", "sil_left", "sil_right", "sil_leaf",
            "sil_cone_axis", "sil_cone_cos", "sil_p0", "sil_p1", "sil_n1",
            "sil_n2", "sil_always")


def tree_once_bytes(gs, fields=PRIM_TREE) -> int:
    """Bytes of the tables a traversal's function needs, each read once:
    the tree's own fields (the prim tree, its leaf rows and corners for
    B1-B3; SIL_TREE, the entities' tree and the entities, for B4), not
    the padded packs B1 and B4 read them from (a field the set lacks, as
    a 2D set's ``sil_p1``, counts nothing)."""
    return sum(t.numel() * t.element_size() for t in (
        getattr(gs, f) for f in fields) if t is not None)


def ptxas_of(kernel: str) -> dict:
    """``-Xptxas -v``'s notes on each entry of ``csrc/bvh.cu`` whose name
    holds ``kernel``, by dimension: registers, stack frame and spill
    bytes."""
    import re

    from elaina_tpu_torch.ops import bvh as B

    out, entry = {}, None
    for line in B.build_log().splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = None
            if kernel + "I" in m.group(1):
                dim = re.search(r"ILi(\d)E", m.group(1))[1]
                entry = f"{kernel}<{dim}D>"
                out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[entry].update(stack_frame=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m[1])
    return out


def pack_report(gs, label: str) -> dict:
    """The set's packs: their bytes, and the ms of building them anew
    (``pack_trees`` on the card), printed."""
    import torch

    from elaina_tpu_torch.ops import bvh as B

    packs, ms = timed_once(lambda: B.pack_trees(gs))
    sizes = {k: v.numel() * v.element_size() for k, v in packs.items()}
    if not all(torch.equal(v, getattr(gs, k)) for k, v in packs.items()):
        raise RuntimeError(f"{label}: the packs built again differ")
    log(f"    packs of {label}: {sizes} bytes ({sum(sizes.values())} in all, "
        f"the trees' own fields {gs.tree_bytes()}), built in {ms:.3f} ms "
        f"(one call, its index sync included)")
    return {"pack_bytes": sizes, "pack_build_ms": ms}


def ptxas_report(kernel: str) -> dict:
    """``ptxas_of(kernel)``, printed; raises on local memory (a stack
    frame or a spill) in any entry."""
    notes = ptxas_of(kernel)
    log(f"    ptxas {kernel}: {notes}")
    bad = [k for k, v in notes.items()
           if v.get("stack_frame") or v.get("spill_stores")
           or v.get("spill_loads")]
    if not notes or bad:
        raise RuntimeError(f"{kernel}: local memory in {bad or 'no entry'}")
    return notes


def bvh_record(kernels, name, err, fn, plain_ms, lanes: int, lane_bytes,
               tree_bytes: int, mean_visits: float, dim: int, shape: str,
               **extra):
    """A B-kernel's record: ``bound_ms`` from the lanes' inputs and outputs
    and the tree's fields read once, ``bound_visits_ms`` with each of the
    ``mean_visits`` nodes a lane visits reading a node's box, children
    and leaf row (8 D + 24 bytes), both with FLOPS_PER_VISIT operations a
    visit."""
    flops = lanes * mean_visits * FLOPS_PER_VISIT
    v_ms, v_by = bound(lanes * (lane_bytes + mean_visits * (8 * dim + 24)),
                       flops)
    kernels.add(name, err, fn, None, None, lanes * lane_bytes + tree_bytes,
                flops, shape, plain_ms=plain_ms, mean_visits=mean_visits,
                bound_visits_ms=v_ms, bound_visits_by=v_by, **extra)


def kernel_visits(fn, n: int, device) -> float:
    """The mean nodes a lane's descent reads, from the kernel's own count
    (``fn(visits)`` fills it)."""
    import torch

    visits = torch.zeros(n, dtype=torch.int32, device=device)
    fn(visits)
    return float(visits.double().mean())


def check_b1(kernels, name, gs, q, label: str, **extra) -> None:
    """B1 on every lane of q against its plain version on a strided subset
    (and on EDGE_LANES of it under each edge mask); ``extra`` goes into
    its record."""
    import torch

    from elaina_tpu_torch.ops import bvh as B

    n = q.shape[0]
    sub = strided(n, BVH_PLAIN_LANES, q.device)
    d, ids = B.closest_point_bvh(gs, q)
    k_visits = kernel_visits(
        lambda v: B.closest_point_bvh(gs, q, visits=v), n, q.device)
    visits = torch.zeros(sub.numel(), dtype=torch.int64, device=q.device)
    qs = q[sub].contiguous()
    (d_p, ids_p), plain_ms = timed_once(
        lambda: B.closest_point_bvh_plain(gs, qs, visits=visits))
    err, ties = check_ids_tied(name, gs, qs, d[sub], d_p, ids[sub], ids_p)
    qe = qs[:EDGE_LANES]
    for mlabel, live in edge_masks(qe.shape[0], q.device):
        dm, im = B.closest_point_bvh(gs, qe, live)
        dmp, imp = B.closest_point_bvh_plain(gs, qe, live)
        if not (torch.equal(dm[~live], dmp[~live])
                and torch.equal(im[~live], imp[~live])
                and bool(torch.isinf(dm[~live]).all())):
            raise RuntimeError(f"{name}: a lane off the mask differs "
                               f"({mlabel})")
        err = max(err, check_ids_tied(name, gs, qe[live], dm[live],
                                      dmp[live], im[live], imp[live])[0])
    p_visits = float(visits.double().mean())
    log(f"    {name} ({label}): {n} lanes, the plain version on "
        f"{sub.numel()}: max err {err:.3g}, {ties} ids differ on a tie; "
        f"mean nodes visited {k_visits:.2f} (the kernel's reads, the "
        f"bound's), {p_visits:.2f} (the plain version's pops); edge "
        f"masks (half, none, lane N - 1) on {qe.shape[0]} of them equal")
    bvh_record(kernels, name, err, lambda: B.closest_point_bvh(gs, q),
               plain_ms, n, 4 * gs.dim + 8, tree_once_bytes(gs), k_visits,
               gs.dim, f"{n} lanes x {gs.n_prims} prims ({label}); the "
               f"plain version on {sub.numel()} of them",
               plain_lanes=int(sub.numel()), plain_mean_visits=p_visits,
               **extra)


def bvh_lanes(conf_3d: str, device):
    """neumann3d_u on the BVH route after WARM_STEPS depth steps: (problem,
    state, R_B) of its 65,536 lanes."""
    from elaina_tpu_torch.solver.wost import _separate
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state

    problem, integ = load_integrator(conf_3d, device, 1, accel="bvh")
    state = warm_state(problem, integ, WARM_STEPS)
    eps = float(integ.settings.epsilonShell)
    R_B = _separate(problem.scene, state, eps, shrink=True)[1]
    return problem, state, R_B.contiguous()


def check_b2(kernels, gs, o, d, tmax, live) -> None:
    """B2, closest hit and any hit, against its plain version on every
    lane, with the live mask and the edge masks, and at tmax 1e-4."""
    import torch

    from elaina_tpu_torch.ops import bvh as B

    n = o.shape[0]
    err = 0.0
    rec = None
    for any_hit in (False, True):
        cases = (("live", live, tmax), ("tmax 1e-4", live,
                                         torch.full_like(tmax, 1e-4)),
                 *((m, x, tmax) for m, x in edge_masks(n, o.device)))
        for label, m, tm in cases:
            h, t, p = B.ray_bvh(gs, o, d, tm, any_hit, m)
            visits = torch.zeros(n, dtype=torch.int64, device=o.device)
            (h_p, t_p, p_p), plain_ms = timed_once(
                lambda: B.ray_bvh_plain(gs, o, d, tm, any_hit, m,
                                        visits=visits))
            if not torch.equal(h, h_p):
                raise RuntimeError(f"ray_bvh: {int((h != h_p).sum())} hit "
                                   f"flags differ ({label}, any {any_hit})")
            if not (torch.isinf(t[~h]).all() and (p[~h] == 0).all()):
                raise RuntimeError("ray_bvh: a miss is not inf / 0")
            e = float((t[h] - t_p[h]).abs().max()) if h.any() else 0.0
            if not torch.allclose(t[h], t_p[h], rtol=TOL, atol=TOL):
                raise RuntimeError(f"ray_bvh t differs: {e}")
            if not torch.equal(p[h], p_p[h]):
                raise RuntimeError(f"ray_bvh: {int((p != p_p).sum())} ids "
                                   f"differ ({label})")
            err = max(err, e)
            log(f"    ray_bvh ({'any' if any_hit else 'closest'} hit, "
                f"{label}): {int(h.sum())} hits of {n} lanes, flags and ids "
                f"exact, t within TOL; plain {plain_ms:.1f} ms")
            if label == "live" and not any_hit:
                rec = (plain_ms, visits)
    bvh_record(kernels, "ray_bvh", err,
               lambda: B.ray_bvh(gs, o, d, tmax, False, live), rec[0], n,
               8 * gs.dim + 14, tree_once_bytes(gs),
               float(rec[1].double().mean()), gs.dim,
               f"{n} walk rays (live {int(live.sum())}) x {gs.n_prims} "
               f"triangles, closest hit")


def check_b3(kernels, gs, q, R, u, live) -> None:
    """B3 against its plain version on every lane: ids on >= 1 -
    CDF_FLIPS of the lanes, pdf within TOL where they agree, -1 / 0
    exactly where the ball holds no prim (also at R = 1e-3)."""
    import torch

    from elaina_tpu_torch.ops import bvh as B

    n = q.shape[0]
    err = 0.0
    rec = None
    for label, m, radii in (("live", live, R),
                            ("R 1e-3", live, torch.full_like(R, 1e-3)),
                            *((lb, x, R) for lb, x in edge_masks(n,
                                                                 q.device))):
        i, pdf = B.sample_in_ball_bvh(gs, q, radii, u, m)
        visits = torch.zeros(n, dtype=torch.int64, device=q.device)
        (i_p, pdf_p), plain_ms = timed_once(
            lambda: B.sample_in_ball_bvh_plain(gs, q, radii, u, m,
                                               visits=visits))
        same = i == i_p
        flips = int((~same).sum())
        if flips > CDF_FLIPS * max(int(m.sum()), 1):
            raise RuntimeError(f"sample_in_ball_bvh: {flips} ids differ "
                               f"({label})")
        none = i_p < 0
        if not (torch.equal(i[none & same], i_p[none & same])
                and bool((pdf[none & same] == 0).all())):
            raise RuntimeError("sample_in_ball_bvh: an empty ball's sample")
        e = float((pdf[same] - pdf_p[same]).abs().max()) if same.any() \
            else 0.0
        if not torch.allclose(pdf[same], pdf_p[same], rtol=TOL, atol=0):
            raise RuntimeError(f"sample_in_ball_bvh pdf differs: {e}")
        err = max(err, e)
        log(f"    sample_in_ball_bvh ({label}): {int((i >= 0).sum())} "
            f"samples of {n} lanes, {flips} ids flipped, pdf within TOL "
            f"where equal; plain {plain_ms:.1f} ms")
        if label == "live":
            rec = (plain_ms, visits)
    bvh_record(kernels, "sample_in_ball_bvh", err,
               lambda: B.sample_in_ball_bvh(gs, q, R, u, live), rec[0], n,
               4 * gs.dim + 9 + 8,
               tree_once_bytes(gs) + 4 * (gs.n_prims + gs.left.numel()),
               float(rec[1].double().mean()), gs.dim,
               f"{n} lanes (live {int(live.sum())}) x {gs.n_prims} "
               f"triangles, star radii")


def check_b4(kernels, gs, q, live, on, **extra) -> None:
    """B4 against its plain version on the live lanes, against the port's
    dense sweep on the live lanes off the Neumann boundary (``on`` (N,)
    bool marks the lanes on it: there a view vector lies in the surface,
    s1 s2 is a rounding either side of 0, and the two forms' sums may
    call an entity a silhouette apart; their agreement is printed), and
    under the edge masks."""
    import dataclasses

    import torch

    from elaina_tpu_torch.geometry import queries as Q
    from elaina_tpu_torch.ops import bvh as B

    n = q.shape[0]
    d = B.closest_silhouette_bvh(gs, q, live)
    k_visits = kernel_visits(
        lambda v: B.closest_silhouette_bvh(gs, q, live, visits=v), n,
        q.device)
    visits = torch.zeros(n, dtype=torch.int64, device=q.device)
    d_p, plain_ms = timed_once(
        lambda: B.closest_silhouette_bvh_plain(gs, q, live, visits=visits))
    d_s = torch.full_like(d, float("inf"))
    d_s[live] = Q.closest_silhouette(dataclasses.replace(gs, sil_left=None),
                                     q[live])
    err = 0.0
    off = live & ~on
    for o, label, m in ((d_p, "plain", live), (d_s, "dense sweep", off)):
        a, b = d[m], o[m]
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            raise RuntimeError(f"closest_silhouette_bvh: inf differs from "
                               f"the {label}")
        e = float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0
        if not torch.allclose(a[fin], b[fin], rtol=TOL, atol=TOL):
            raise RuntimeError(f"closest_silhouette_bvh differs from the "
                               f"{label}: {e}")
        err = max(err, e)
    onl = live & on
    agree = (torch.isclose(d[onl], d_s[onl], rtol=TOL, atol=TOL)
             | (torch.isinf(d[onl]) & torch.isinf(d_s[onl])))
    for label, m in edge_masks(n, q.device):
        dm = B.closest_silhouette_bvh(gs, q, m)
        if not (torch.isinf(dm[~m]).all()
                and torch.equal(dm[m], B.closest_silhouette_bvh(gs, q)[m])):
            raise RuntimeError(f"closest_silhouette_bvh: mask {label}")
    log(f"    closest_silhouette_bvh: {int(live.sum())} live lanes of {n}, "
        f"within TOL of the plain version, and of the dense sweep on the "
        f"{int(off.sum())} off the boundary (max err {err:.3g}); on the "
        f"{int(onl.sum())} on it, {int(agree.sum())} agree with the dense "
        f"sweep; edge masks equal; plain {plain_ms:.1f} ms; the kernel "
        f"reads {k_visits:.2f} nodes a lane (the bound's), the plain "
        f"version expands {float(visits.double().mean()):.2f} (lane, node) "
        f"pairs a lane")
    bvh_record(kernels, "closest_silhouette_bvh", err,
               lambda: B.closest_silhouette_bvh(gs, q, live), plain_ms, n,
               4 * gs.dim + 1 + 4, tree_once_bytes(gs, SIL_TREE), k_visits,
               gs.dim, f"{n} lanes (live {int(live.sum())}) x "
               f"{gs.sil_p0.shape[0]} silhouette edges",
               plain_mean_visits=float(visits.double().mean()),
               plain_counts="(lane, node) pairs a level expands", **extra)


def phase_bvh_kernels(conf_2d: str, conf_bumpy: str, conf_3d: str, device,
                      kernels: Kernels) -> None:
    """[11a] B1-B4 against their plain versions at the BVH route's
    shapes."""
    import torch

    log("[11a] BVH traversal kernels against their plain versions")
    ptx_b1 = ptxas_report("closest_point_bvh_kernel")
    ptx_b4 = ptxas_report("closest_silhouette_bvh_kernel")
    problem = bvh_problem(conf_2d, device)
    gs = problem.scene.dirichlet.gs
    q = torch.as_tensor(frame_points(conf_2d), device=device)
    check_b1(kernels, "closest_point_bvh", gs, q, "lobed_u's frame points",
             ptxas=ptx_b1, **pack_report(gs, "lobed_u's Dirichlet set"))
    problem = bvh_problem(conf_bumpy, device)
    gs = problem.scene.dirichlet.gs
    q = torch.as_tensor(frame_points(conf_bumpy), device=device)
    check_b1(kernels, "closest_point_bvh_3d", gs, q,
             "bumpy3d_5's frame points", ptxas=ptx_b1,
             **pack_report(gs, "bumpy3d_5's Dirichlet set"))
    problem, state, R_B = bvh_lanes(conf_3d, device)
    gs = problem.scene.neumann.gs
    packs = pack_report(gs, "neumann3d's Neumann set")
    live = state.active.contiguous()
    g = torch.Generator(device=device).manual_seed(12)
    d = torch.nn.functional.normalize(
        torch.randn(state.pos.shape, generator=g, device=device), dim=1)
    u = torch.rand(R_B.shape, generator=g, device=device)
    check_b2(kernels, gs, state.pos, d.contiguous(), R_B, live)
    check_b3(kernels, gs, state.pos, R_B, u, live)
    check_b4(kernels, gs, state.pos, live, state.on_neumann, ptxas=ptx_b4,
             **packs)


def phase_bvh_main(conf_bvh: str, device, card: str, keep: dict) -> dict:
    """[11b] lobed_u on the BVH route at BVH_SPP samples against [4]'s
    film; one depth step under the sync probe."""
    import traceback

    import torch

    from elaina_tpu_torch.solver.wost import wost_depth_step
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state
    from elaina_tpu_torch.utils.rng import sample_generators

    log("[11b] lobed_u on the BVH route")
    launches, result, integ = run_main(conf_bvh, ("closest_point_bvh",),
                                       "lobed_u bvh", card, accel="bvh")
    grid_kernels = [k for k in MAIN_2D if launches[k]]
    if grid_kernels:
        raise RuntimeError(f"the BVH route launched {grid_kernels}")
    share = against(integ, keep["lobed_u"], "lobed_u bvh", "[4]'s film")
    rate = result["walk_steps"] / (result["duration"] / 1e3)
    log(f"    walk-steps/s {rate:.6g} against [4]'s grid route "
        f"{keep['lobed_u']['rate']:.6g} (bvh / grid "
        f"{rate / keep['lobed_u']['rate']:.4f}; {card})")
    if share < 0.99:
        raise RuntimeError("the BVH route's lobed_u disagrees with [4]'s")
    del integ
    problem, integ = load_integrator(conf_bvh, device, 1, accel="bvh")
    state = warm_state(problem, integ, 1)
    gens = sample_generators(0, 1, device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wost_depth_step(problem.scene, state, gens,
                        float(integ.settings.epsilonShell))
    except RuntimeError as e:
        where = [f"{os.path.relpath(f.filename)}:{f.lineno} {f.line}"
                 for f in traceback.extract_tb(e.__traceback__)
                 if "elaina_tpu_torch" in f.filename]
        raise RuntimeError(f"the BVH depth step waits for the device at "
                           f"{where}: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"    one BVH depth step of {state.pos.shape[0]} lanes "
        f"({int(state.active.sum())} live) without a host sync")
    return launches


def phase_bvh_cube(root: str, device, card: str) -> dict:
    """[11c] the mixed cube of CUBE_FINE squares a face on the BVH route,
    [6]'s points and gates; returns the balanced run's launches."""
    from elaina_tpu_torch.core.problem import Problem
    from elaina_tpu_torch.utils import scenes as S

    cube = os.path.join(root, "cube_fine")
    os.makedirs(cube, exist_ok=True)
    problem = Problem(3, device, verbose=False).load_config(
        S.write_mixed_cube(cube, CUBE_FINE),
        cache_dir=os.environ["ELAINA_CACHE_DIR"], accel="bvh")
    sc = problem.scene
    log(f"[11c] mixed cube, {sc.dirichlet.gs.n_prims} Dirichlet and "
        f"{sc.neumann.gs.n_prims} Neumann triangles, BVH route")
    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [-0.6, 0.3, 0.4]],
                   np.float32)
    want = (pts[:, 0] + 1) / 2
    out = None
    for route, chunk in (("balanced", None), ("per-sample", 1)):
        reset_counts()
        u, ms, capped = solve_points(problem, pts, 1024, CUBE_FINE_SPP,
                                     256, 0.02, chunk)
        counts = read_counts()
        log(f"    {route} route: u {np.round(u, 4).tolist()} vs "
            f"{want.tolist()} (atol 0.07), {ms} ms, depth-capped share "
            f"{capped:.4f}; launches "
            f"{ {k: counts[k] for k in BVH_KERNELS} } ({card})")
        if not all(counts[k] for k in BVH_KERNELS):
            raise RuntimeError("the fine cube did not launch B1-B4")
        if not np.all(np.abs(u - want) <= 0.07):
            raise RuntimeError(f"the fine cube out of bound ({route})")
        out = out or counts
    return out


def phase_bvh_3d(conf_bvh: str, card: str, keep: dict) -> dict:
    """[11d] neumann3d_u on the BVH route (the unfused step), against
    [8]'s band route: printed, not gated, but the film's finiteness and
    B2-B4's launches."""
    log("[11d] neumann3d_u on the BVH route")
    launches, result, integ = run_main(
        conf_bvh, ("ray_bvh", "sample_in_ball_bvh", "closest_silhouette_bvh"),
        "neumann3d_u bvh", card, accel="bvh")
    mean = (integ.sum / integ.spp).cpu().numpy()
    if not np.isfinite(mean).all():
        raise RuntimeError("the BVH route's neumann3d_u film is not finite")
    bvh = route_keep(result, integ)
    band = keep["neumann3d_u"]
    share = against(integ, band, "neumann3d_u bvh", "[8]'s band-route film")
    log(f"    mean u {float(mean.mean()):.5f} against [8]'s "
        f"{float(band['mean'].mean()):.5f}; depth-capped share "
        f"{bvh['capped']:.4f} against [8]'s "
        f"{band['capped']:.4f}; walk-steps/s {bvh['rate']:.6g} against "
        f"[8]'s {band['rate']:.6g}; {share:.5f} of pixel channels within 4 "
        f"combined standard errors (printed, not gated; {card})")
    del integ
    bvh_step_split(conf_bvh, card)
    return launches


def bvh_step_split(conf_bvh: str, card: str) -> None:
    """[11d]'s reading: the device ms by kernel of BVH_TRACE_STEPS depth
    steps of the BVH route's walks (after WARM_STEPS), through
    ``utils/profiling.profile_trace`` (its Chrome trace's kernel
    events)."""
    import glob

    import torch

    from elaina_tpu_torch.solver.wost import wost_depth_step
    from elaina_tpu_torch.utils.ab import load_integrator, warm_state
    from elaina_tpu_torch.utils.profiling import profile_trace
    from elaina_tpu_torch.utils.rng import sample_generators

    device = torch.device("cuda", 0)
    problem, integ = load_integrator(conf_bvh, device, 1, accel="bvh")
    state = warm_state(problem, integ, WARM_STEPS)
    gens = sample_generators(0, 1, device)
    eps = float(integ.settings.epsilonShell)
    live = int(state.active.sum())
    trace_dir = os.path.join(os.path.dirname(conf_bvh), "trace_bvh")
    torch.cuda.synchronize()
    t0 = time.time()
    with profile_trace(trace_dir):
        for _ in range(BVH_TRACE_STEPS):
            wost_depth_step(problem.scene, state, gens, eps)
        torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    by = {}
    for e in events:
        if e.get("cat") == "kernel":
            k = by.setdefault(e["name"], [0.0, 0])
            k[0] += e.get("dur", 0.0) / 1e3
            k[1] += 1
    total = sum(v[0] for v in by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:BVH_TRACE_TOP]
    log(f"    {BVH_TRACE_STEPS} BVH depth steps of {state.pos.shape[0]} lanes "
        f"({live} live after {WARM_STEPS}) under profile_trace: device "
        f"{total:.4f} ms over {sum(v[1] for v in by.values())} kernel "
        f"launches of {len(by)} kernels, {wall:.1f} ms wall with the "
        f"profiler on ({card}); by kernel:")
    for name, (ms, count) in top:
        log(f"      {ms:.4f} ms, {count} x {name[:100]}")


# --------------------------------------------------------------------------- #
# [12] the multi-rank path
# --------------------------------------------------------------------------- #


def phase_nccl_probe(conf_n: str, root: str, device) -> None:
    """[12a] A one-rank NCCL group, and lobed_n's lockstep training chunk
    over it under the sync probe ([8d]'s balanced phase)."""
    from elaina_tpu_torch.parallel import dp

    group = dp.make_group(1, "nccl", device=device, rank=0, local_rank=0,
                          init_method=f"file://{root}/nccl_store",
                          timeout_s=MULTI_TIMEOUT_S)
    try:
        phase_syncs_balanced(None, conf_n, device, group)
    finally:
        group.close()


def multi_rank(i: int, n: int, root: str, confs: dict) -> None:
    """[12]: rank ``i`` of ``n`` gloo ranks on cuda:0 (spawned): the dry
    run's five steps, then each config of ``confs`` through ``run_expr``
    with the launch counts zeroed just before it.  Writes its launches,
    walk steps, walls and guided trainer digest to ``rank<i>.json``; rank
    0 also each film's mean and standard error to ``<label>.npz``."""
    import torch

    from elaina_tpu_torch.exec import run_expr
    from elaina_tpu_torch.parallel import dp, dryrun

    device = torch.device("cuda", 0)
    group = dp.make_group(n, "gloo", device=device, rank=i, local_rank=i,
                          init_method=f"file://{root}/store",
                          timeout_s=MULTI_TIMEOUT_S)
    out = {}
    try:
        t0 = time.time()
        out["dryrun"] = dryrun.run_steps(group)
        out["dryrun_s"] = time.time() - t0
        for label, conf in confs.items():
            reset_counts()
            t0 = time.time()
            with capture_integrators() as made:
                result = run_expr(conf, devices=n, group=group)
            torch.cuda.synchronize()
            integ = made[-1]
            rec = {"launches": read_counts(), "wall": time.time() - t0,
                   "duration_ms": result["duration"],
                   "walk_steps": result["walk_steps"],
                   "by_rank": result["walk_steps_by_rank"],
                   "rank_steps": integ.rank_walk_steps,
                   "iters": solve_steps(integ)}
            if label == "lobed_n":
                rec["trainer_hash"] = dryrun.trainer_hash(integ.trainer)
                rec["opt_steps"] = int(integ.trainer.opt.count)
                rec["phase_stats"] = integ.phase_stats
            if i == 0:
                np.savez(os.path.join(root, f"{label}.npz"),
                         mean=(integ.sum / integ.spp).cpu().numpy(),
                         se=integ.standard_error())
            out[label] = rec
            del made, integ
            torch.cuda.empty_cache()
    finally:
        group.close()
    with open(os.path.join(root, f"rank{i}.json"), "w") as f:
        json.dump(out, f)


def guided_copy(conf_path: str, exp_name: str, spp: int,
                train_spp: int) -> str:
    """``conf_copy`` of a guided config with ``train_spp`` training
    samples."""
    path = conf_copy(conf_path, exp_name, spp)
    with open(path) as f:
        conf = json.load(f)
    conf["integrator"]["setting"]["trainSppCount"] = train_spp
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def phase_multi(conf_2d: str, conf_n: str, conf_3d: str, root: str, device,
                card: str, keep: dict) -> None:
    """[12] The multi-rank path: [12a] the one-rank NCCL probe, then
    MULTI_RANKS gloo ranks spawned on cuda:0 (the kernels already built)
    run the dry run ([12a]) and lobed_u, lobed_n and neumann3d_u
    ([12b]-[12d]), each film against its single-rank run's."""
    import torch.multiprocessing as mp

    # every rank of this run is on this host: rendezvous over loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    phase_nccl_probe(conf_n, root, device)
    d = os.path.join(root, "ranks")
    os.makedirs(d)
    confs = {"lobed_u": conf_copy(conf_2d, "lobed_u_ranks", MULTI_SPP),
             "lobed_n": guided_copy(conf_n, "lobed_n_ranks", MULTI_N_SPP,
                                    MULTI_TRAIN_SPP),
             "neumann3d_u": conf_copy(conf_3d, "neumann3d_u_ranks",
                                      MULTI_3D_SPP)}
    t0 = time.time()
    ctx = mp.start_processes(multi_rank, args=(MULTI_RANKS, d, confs),
                             nprocs=MULTI_RANKS, join=False,
                             start_method="spawn")
    deadline = t0 + MULTI_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"[12]: the ranks did not end within "
                               f"{MULTI_TIMEOUT_S} s")
    ranks = []
    for i in range(MULTI_RANKS):
        with open(os.path.join(d, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    log(f"[12a] parallel/dryrun.py over {MULTI_RANKS} gloo ranks on cuda:0 "
        f"in {ranks[0]['dryrun_s']:.1f} s: {ranks[0]['dryrun']}")
    if any(r["dryrun"] != ranks[0]["dryrun"] for r in ranks):
        raise RuntimeError("[12a]: the ranks' dry runs differ")
    for label, tag, ref in (("lobed_u", "[12b]", "[4]"),
                            ("lobed_n", "[12c]", "[4g]"),
                            ("neumann3d_u", "[12d]", "[8]")):
        rs = [r[label] for r in ranks]
        for i, r in enumerate(rs):
            need = [k for k in MULTI_PATHS[label]
                    if i == 0 or k not in RANK0_ONLY]
            log(f"{tag} {label} rank {i}: launches "
                f"{ {k: r['launches'][k] for k in MULTI_PATHS[label]} }, "
                f"{r['rank_steps']} of {r['walk_steps']} walk steps, "
                f"{r['iters']} iterations, {r['wall']:.1f} s wall")
            if not all(r["launches"][k] for k in need):
                raise RuntimeError(f"{tag}: rank {i} did not launch every "
                                   f"kernel of {label}")
        if not (rs[0]["by_rank"] == [r["rank_steps"] for r in rs]
                and rs[0]["walk_steps"] == sum(rs[0]["by_rank"])):
            raise RuntimeError(f"{tag}: the walk steps do not add up: "
                               f"{rs[0]['by_rank']}")
        with np.load(os.path.join(d, f"{label}.npz")) as z:
            mean, se = z["mean"], z["se"]
        within = np.abs(mean - keep[label]["mean"]) <= 4.0 * np.hypot(
            se, keep[label]["se"]) + 1e-6
        rate = rs[0]["walk_steps"] / (rs[0]["duration_ms"] / 1e3)
        log(f"{tag} {label} on {MULTI_RANKS} ranks: "
            f"{within.mean():.5f} of pixel channels within 4 combined "
            f"standard errors of {ref}'s film; {rate:.6g} walk-steps/s "
            f"(a reading: {MULTI_RANKS} ranks share one card; {card})")
        if within.mean() < 0.99:
            raise RuntimeError(f"{tag}: {label}'s film disagrees with "
                               f"{ref}'s")
        if label == "lobed_n":
            hashes = [r["trainer_hash"] for r in rs]
            log(f"[12c] trainer digests {hashes}, {rs[0]['opt_steps']} "
                f"optimizer steps; phases {rs[0]['phase_stats']}")
            if len(set(hashes)) != 1 or not rs[0]["opt_steps"]:
                raise RuntimeError("[12c]: the ranks' trainers differ, or "
                                   "none trained")
    log(f"[12] {MULTI_RANKS} ranks: {time.time() - t0:.1f} s from the spawn "
        f"to the join")


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
    timed_phase("[1]", phase_build)
    kernels = Kernels(card)
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        os.environ["ELAINA_CACHE_DIR"] = os.path.join(root, "cache")
        conf_2d = scenes.write_scene(root, SPP)
        wavy = os.path.join(root, "wavy8192")
        os.makedirs(wavy)
        conf_wavy = scenes.write_scene(wavy, WAVY_SPP, neumann_segments=8192)
        conf_3d = scenes.write_config_copy(root, "neumann3d_u", SPP_3D)
        conf_bumpy = scenes.write_config_copy(root, "bumpy3d_u", SPP_3D)
        conf_bumpy_n = scenes.write_config_copy(root, "bumpy3d_n", SPP_3D,
                                                GUIDED_3D_TRAIN_SPP)
        # its own directory: write_neumann3d_n writes a neumann3d_u.json
        # of its samples beside it
        n3d = os.path.join(root, "neumann3d_n")
        os.makedirs(n3d)
        conf_3d_n = scenes.write_neumann3d_n(n3d, NEUMANN3D_N_SPP,
                                             GUIDED_3D_TRAIN_SPP)
        syncs = os.path.join(root, "syncs")
        os.makedirs(syncs)
        source_conf = scenes.write_neumann3d_source(syncs, 1)
        guided = os.path.join(root, "lobed_n")
        os.makedirs(guided)
        conf_n = scenes.write_lobed_n(guided, SPP, GUIDED_TRAIN_SPP)
        conf_2d_bvh = conf_copy(conf_2d, "lobed_u_bvh", BVH_SPP)
        conf_3d_bvh = conf_copy(conf_3d, "neumann3d_u_bvh", BVH_SPP)
        keep = {}
        for label, key, fn, args in (
                ("[2]", None, phase_kernels, (conf_2d, device, kernels)),
                ("[2c]", "bare_grid", phase_kernels_2c,
                 (conf_2d, conf_wavy, device, kernels)),
                ("[3]", None, phase_analytic, (device, card)),
                ("[3b]", None, phase_analytic_guided, (device, card)),
                ("[4]", "lobed_u", phase_main, (conf_2d, card, keep)),
                ("[4g]", "lobed_n", phase_guided, (conf_n, card, keep)),
                ("[4b]", "channels_2d", phase_channels_2d, (root, card)),
                ("[4c]", "nogrid_u", phase_nogrid, (root, device, card)),
                ("[4d]", None, phase_bench_square, (device, card)),
                ("[4e]", None, phase_neumann2d_chunked, (root, device, card)),
                ("[4f]", "wavy8192_u", phase_neumann2d_band,
                 (conf_wavy, card)),
                ("[5]", None, phase_kernels_3d, (conf_3d, device, kernels)),
                ("[6]", None, phase_analytic_3d, (root, device, card)),
                ("[7]", None, phase_bumpy, (conf_bumpy, card, keep)),
                ("[7g]", "bumpy3d_n", phase_bumpy_n,
                 (conf_bumpy_n, card, keep)),
                ("[8]", "neumann3d_u", phase_main_3d, (conf_3d, card, keep)),
                ("[8b]", "neumann3d_source", phase_source_3d, (root, card)),
                ("[8c]", "neumann3d_unfused", phase_unfused_3d,
                 (conf_3d, card)),
                ("[8g]", "neumann3d_n", phase_neumann3d_n,
                 (conf_3d_n, card, keep)),
                ("[8r]", None, phase_routes,
                 ({"lobed_u": conf_2d, "lobed_n": conf_n,
                   "neumann3d_u": conf_3d, "bumpy3d_n": conf_bumpy_n},
                  keep, card)),
                ("[8d]", None, phase_syncs,
                 ({"lobed_u": conf_2d, "neumann3d_u": conf_3d,
                   "neumann3d_source": source_conf,
                   "wavy8192_u": conf_wavy}, device)),
                ("[8d] guided", None, phase_syncs_guided,
                 (conf_n, "lobed_n", device)),
                ("[8d] guided 3D", None, phase_syncs_guided,
                 (conf_3d_n, "neumann3d_n", device)),
                ("[8d] balanced", None, phase_syncs_balanced,
                 (conf_2d, conf_n, device)),
                ("[9a]", None, phase_budget_2d, (conf_2d, device, card, keep)),
                ("[9b]", None, phase_budget_guided,
                 (conf_n, device, card, keep)),
                ("[9c]", None, phase_budget_3d, (conf_3d, device, card, keep)),
                ("[9d]", None, phase_resume, (root, device, card)),
                ("[10a]", None, phase_masks, (root, card, keep)),
                ("[10b]", None, phase_profile, (keep, root, device, card)),
                ("[10c]", None, phase_trace_walk, (keep, card)),
                ("[11a]", None, phase_bvh_kernels,
                 (conf_2d, conf_bumpy, conf_3d, device, kernels)),
                ("[11b]", "lobed_u_bvh", phase_bvh_main,
                 (conf_2d_bvh, device, card, keep)),
                ("[11c]", "cube_bvh", phase_bvh_cube, (root, device, card)),
                ("[11d]", "neumann3d_u_bvh", phase_bvh_3d,
                 (conf_3d_bvh, card, keep)),
                ("[12]", None, phase_multi,
                 (conf_2d, conf_n, conf_3d, root, device, card, keep))):
            out = timed_phase(label, fn, *args)
            if key is not None:
                runs[key] = out
            torch.cuda.empty_cache()
    for name, rec in kernels.records.items():
        rec["launches"] = runs[PATH_OF[name]][COUNTER_OF.get(name, name)]
        if not rec["launches"]:
            raise RuntimeError(f"{name} never launched on its path")
    log(f"[total] chip_smoke.py: {time.time() - t_start:.1f} s in all "
        f"({card})")
    print(card)
    print(json.dumps({"kernels": [kernels.records[k] for k in KERNELS
                                  if k in kernels.records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
