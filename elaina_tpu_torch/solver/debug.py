"""Debug introspection: the per-depth trace of one walk.

The port's counterpart of ``elaina_tpu/solver/debug.py``, in place of the
reference's ``debugPixel`` printf gating (integrator/common.h:40-49): one
walk's state history on a 1-lane batch, through the same depth step as
the solve (``wost_depth_step``, its kernels on a CUDA scene), returned
as a list of dicts.
"""

from __future__ import annotations

import torch

from ..core.problem import Scene
from ..geometry.grid import build_fine_pack
from ..utils.rng import sample_generators
from .wost import check_neumann, init_walk_state, wost_depth_step


def trace_walk(scene: Scene, point, seed: int = 0, *, eps: float = 1e-3,
               max_depth: int = 16):
    """One entry a depth step, until the first step after which the walk
    is inactive: ``depth``, ``pos`` (where the step started),
    ``next_pos``, ``contribution`` (3,), ``thp``, ``active``,
    ``on_neumann`` and ``neumann_normal``, as the JAX package's.  The
    walk draws from the streams of sample 0 of run seed ``seed`` (where
    the JAX package takes a key).  A Dirichlet grid without a FinePack
    for ``eps`` gets one, as the integrator bakes it.  The JAX function's
    ``d_stack`` and ``n_stack`` size its BVH traversal stacks; they come
    back with the port's BVH route."""
    dev = scene.device
    grid = scene.d_grid
    if grid is not None and (grid.fine is None or grid.fine.eps != eps):
        grid.fine = build_fine_pack(grid, float(eps))
    check_neumann(scene)
    pts = torch.as_tensor(point, dtype=torch.float32, device=dev)[None, :]
    state = init_walk_state(pts, torch.ones((1,), dtype=torch.bool,
                                            device=dev))
    gens = sample_generators(seed, 0, dev)
    out = []
    for depth in range(max_depth):
        prev_pos = state.pos[0].tolist()
        state, contrib, _ = wost_depth_step(scene, state, gens, float(eps))
        entry = {
            "depth": depth,
            "pos": prev_pos,
            "next_pos": state.pos[0].tolist(),
            "contribution": contrib[0].tolist(),
            "thp": state.thp[0].item(),
            "active": bool(state.active[0]),
            "on_neumann": bool(state.on_neumann[0]),
            "neumann_normal": state.n_normal[0].tolist(),
        }
        out.append(entry)
        if not entry["active"]:
            break
    return out
