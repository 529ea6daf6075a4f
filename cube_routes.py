#!/usr/bin/env python3
"""The mixed cube of ``chip_smoke.py`` [6] and [6b] (fused, with its unit
source) on the balanced and the per-sample route, at 1,024 lanes a point
and 1 and 8 samples a lane: each point's mean, standard error and
depth-capped share, to read a route's bias against the Monte Carlo
error.  Run from the root of a checkout on a machine with the card:

    python3 cube_routes.py

It exits non-zero when PyTorch sees no CUDA device."""
import os
import sys
import tempfile

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from elaina_tpu_torch.core.config import IntegratorSettings  # noqa: E402
from elaina_tpu_torch.core.problem import Problem  # noqa: E402
from elaina_tpu_torch.solver.integrator import UniformIntegrator  # noqa: E402
from elaina_tpu_torch.utils import scenes as S  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("cube_routes: PyTorch sees no CUDA device")
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
print(C.card_line(), flush=True)
C.phase_build()
P3 = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [-0.6, 0.3, 0.4]],
              np.float32)
with tempfile.TemporaryDirectory() as root:
    cache = os.path.join(root, "cache")
    for label, writer, depth, want in (
            ("cube", S.write_mixed_cube, 256, (P3[:, 0] + 1) / 2),
            ("source cube", S.write_mixed_cube_source, 128,
             (P3[:, 0] + 1) / 2 + (1 - P3[:, 0] ** 2) / 2)):
        problem = Problem(3, dev, verbose=False).load_config(writer(root),
                                                           cache_dir=cache)
        for reps, spp in ((1024, 1), (1024, 8)):
            lanes = torch.as_tensor(np.repeat(P3, reps, 0), device=dev)
            for route, chunk in (("balanced", None), ("per-sample", 1)):
                st = IntegratorSettings(frameSize=(len(lanes), 1),
                                        samplesPerPixel=spp,
                                        maxWalkingDepth=depth,
                                        epsilonShell=0.02)
                integ = UniformIntegrator(problem, st, "unused",
                                          points=lanes)
                integ.solve(chunk)
                s1 = integ.sum[:, 0].reshape(3, reps).cpu().numpy()
                s2 = integ.sum_sq[:, 0].reshape(3, reps).cpu().numpy()
                n = reps * spp
                mean = s1.sum(1) / n
                var = s2.sum(1) / n - mean ** 2
                se = np.sqrt(var / (n - 1))
                print(f"{label} depth {depth} {reps}x{spp} {route}: u "
                      f"{np.round(mean, 4).tolist()} want "
                      f"{np.round(want, 4).tolist()} se "
                      f"{np.round(se, 4).tolist()} capped "
                      f"{integ.total_capped / (len(lanes) * spp):.4f}",
                      flush=True)
