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


def _check_stack(b, stack: int, name: str) -> None:
    """Raise where a set's tree needs a longer stack than ``stack``."""
    if b is not None and b.gs.has_tree and stack < b.gs.depth + 1:
        raise ValueError(f"{name} {stack}: the set's tree of depth "
                         f"{b.gs.depth} needs a stack of {b.gs.depth + 1}")


def trace_walk(scene: Scene, point, seed: int = 0, *, eps: float = 1e-3,
               max_depth: int = 16, d_stack: int = 48, n_stack: int = 48):
    """One entry a depth step, until the first step after which the walk
    is inactive: ``depth``, ``pos`` (where the step started),
    ``next_pos``, ``contribution`` (3,), ``thp``, ``active``,
    ``on_neumann`` and ``neumann_normal``, as the JAX package's.  The
    walk draws from the streams of sample 0 of run seed ``seed`` (where
    the JAX package takes a key).  A Dirichlet grid without a FinePack
    for ``eps`` gets one, as the integrator bakes it.  ``d_stack`` and
    ``n_stack`` are the JAX function's traversal stacks of the Dirichlet
    and the Neumann set: on the BVH route a stack shorter than a descent
    of the set's tree can hold (depth + 1 nodes) raises, where the JAX
    function drops the push; any longer stack traces the same walk (the
    traversals keep depth + 4 entries, the JAX Problem's d_stack and
    n_stack)."""
    _check_stack(scene.dirichlet, d_stack, "d_stack")
    _check_stack(scene.neumann, n_stack, "n_stack")
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
