"""Uniform Walk-on-Stars: the walk state and the fused depth step.

Port of the uniform path of ``elaina_tpu/solver/wost.py`` (reference:
integrator/uniform/integrator.cu:64-623).  Every lane of the wavefront
is one walk; a depth step updates all lanes with masked tensor ops, in
the stage order of the reference's solve loop:

  _separate       star radius + epsilon-shell test (Dirichlet resolve on
                  kernels K1-K3 in 2D, K1, K4, K5 in 3D; a set without a
                  grid: the exact closest point on every lane, K13 in 2D;
                  the Neumann silhouette distance, over the SilGrid (K9,
                  3D and 2D) where the set has one, and clamped to the
                  prim band's completeness cap where it has that)
  _boundary_term  Dirichlet shell contribution
  _source_term    volumetric source: one Green-sampled point in the star,
                  its radius clipped on the Neumann boundary (3D: K7)
  _neumann_term   Neumann boundary integral, subtracted (2D: the dense or
                  chunked sweep, or the prim band's gather form; the
                  unfused 3D step: K8 and K7 over the prim band)
  _walk           mean-value step, clipped on the Neumann boundary (2D as
                  _neumann_term; the unfused 3D step: K7)
  _neumann_walk_fused
                  3D: the Neumann term and the walk ray of one step over
                  the prim band of each lane's cell (K6); the default,
                  ``ELAINA_FUSED_BAND=0`` takes the unfused pair instead

Randomness comes from the per-(sample, stage) generators of
``utils/rng.py``.  Each step draws, in this order: from "neumann" the
prim-selection uniforms (N,) and the point uniforms (N, 2); from "walk"
the sphere uniforms ((N,) in 2D, two (N,) in 3D) and, when the scene has
a Neumann set, the hemisphere uniforms (the same counts); from "source",
with a source, the direction (as "walk" draws it) and then the radius
uniforms (N, 3).  The fused and the unfused 3D steps draw the same
numbers, so the two agree lane for lane.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import torch

from ..core.problem import Scene
from ..geometry import queries as Q
from ..geometry.grid import fine_decode, grid_closest_point
from ..geometry.primitives import (prim_project, prim_sample_point,
                                   prim_side)
from ..ops.resolve import (fetch_colors, fetch_colors3, sweep_resolve,
                           sweep_resolve_3d)
from ..utils.mathops import frame_from_normal, geometric_interpolate, to_world
from .green import green_eval, green_norm, green_sample_radius
from .sampling import (sphere_measure, uniform_sample_hemisphere,
                       uniform_sample_hemisphere_pdf, uniform_sample_sphere,
                       uniform_sample_sphere_pdf)


@dataclass
class WalkState:
    pos: torch.Tensor         # (N, D)
    thp: torch.Tensor         # (N,) scalar throughput
    active: torch.Tensor      # (N,) walk alive
    on_neumann: torch.Tensor  # (N,) on the Neumann boundary
    n_normal: torch.Tensor    # (N, D) boundary normal where on_neumann


def init_walk_state(eval_points: torch.Tensor,
                    active: torch.Tensor) -> WalkState:
    n, d = eval_points.shape
    dev = eval_points.device
    return WalkState(
        pos=eval_points,
        thp=torch.ones((n,), dtype=torch.float32, device=dev),
        active=active,
        on_neumann=torch.zeros((n,), dtype=torch.bool, device=dev),
        n_normal=torch.zeros((n, d), dtype=torch.float32, device=dev))


def _surface_color(dim, colors, gs, pid, side, uv):
    """Side-selected two-sided vertex color, interpolated along the prim
    (integrator/common.h:242-260).  Indices column by column, as in
    GeomSet.prim_verts."""
    p = torch.clamp(pid, min=0)
    pick = torch.where(side >= 0, 0, 1)
    vals = tuple(colors[gs.indices[p, k], pick] for k in range(dim))
    return geometric_interpolate(dim, vals, uv)


def dirichlet_distance(scene: Scene, q):
    """(distance, prim id) to the Dirichlet boundary: through the chain
    path of its candidate grid (K10 in 2D, K11 in 3D), or without a grid
    through ``closest_point`` (K13 in 2D)."""
    if scene.d_grid is None:
        return Q.closest_point(scene.dirichlet.gs, q)
    return grid_closest_point(scene.d_grid, q)


def _dense_dirichlet(scene: Scene, q, active, eps: float, step0=None):
    """Dirichlet resolve of a set without a grid (the reference's
    ``dirichlet_distance_masked`` without a grid, wost.py:129-138, and
    ``_separate``'s shell test, :340-352): the exact distance on every
    active lane, need = active; in 2D K13 sweeps only those (K1 compacts
    them), and the others get R_D = +inf, which nothing downstream reads
    (their walks are dead).  ``step0`` = (fresh (N,), rd0 (N,)): the
    lanes at their walk's first step leave need, are not swept and take
    R_D = rd0 (their pixel's distance, computed once).  Returns (R_D,
    in_shell, color (N, 3), need); the color is the winner's
    side-selected, interpolated color."""
    dim = scene.dim
    gs = scene.dirichlet.gs
    if step0 is not None:
        active = active & ~step0[0]
    d, pid, uv, side = Q.closest_point_detail(gs, q, active)
    if dim == 2:
        interior = (uv > 0.0) & (uv < 1.0)
    else:
        interior = (uv[:, 0] > 0.0) & (uv[:, 1] > 0.0) & (uv[:, 0] + uv[:, 1]
                                                          < 1.0)
    in_shell = active & (d < eps) & interior
    color = _surface_color(dim, scene.dirichlet.colors, gs, pid, side, uv)
    if step0 is not None:
        d = torch.where(step0[0], step0[1], d)
    return d, in_shell, color, active


def _resolve_2d(g, need, row, q, eps: float):
    """K2 + K3 on the need lanes: (d, color (N, 3), in-shell)."""
    d_e, t, side, pid = sweep_resolve(need, row, q, g.coords, g.cand)
    ins = need & (d_e < eps) & (t > 0.0) & (t < 1.0)
    cfi = 2 * torch.clamp(pid, min=0) + (side < 0).to(torch.int32)
    c0, c1 = fetch_colors(ins, torch.where(ins, cfi, 0), g.color_rows)
    return d_e, c0 * (1.0 - t[:, None]) + c1 * t[:, None], ins


def _resolve_3d(g, need, row, q, eps: float):
    """K4 + K5 on the need lanes: the winner's barycentrics, side and
    interior test from its corners, then the in-shell lanes' colors."""
    d_e, pid, corners = sweep_resolve_3d(need, row, q, g.coords, g.cand)
    pv = (corners[:, 0:3], corners[:, 3:6], corners[:, 6:9])
    uv = prim_project(3, q, pv)
    side = prim_side(3, q, pv)
    interior = (uv[:, 0] > 0.0) & (uv[:, 1] > 0.0) & (uv[:, 0] + uv[:, 1]
                                                      < 1.0)
    ins = need & (d_e < eps) & interior
    cfi = 2 * torch.clamp(pid, min=0) + (side < 0).to(torch.int32)
    ca, cb, cc = fetch_colors3(ins, torch.where(ins, cfi, 0), g.color_rows)
    return d_e, geometric_interpolate(3, (ca, cb, cc), uv), ins


def _fast_dirichlet(scene: Scene, q, active, eps: float, step0=None):
    """Dirichlet resolve on the FinePack and the resolve kernels.

    One FinePack load per lane gives the candidate row, the need bit and a
    distance lower bound.  The active lanes whose need bit (or out-of-grid
    force) fired are swept exactly over their row (K2 / K4: the wrapper
    lists them with K1 and the sweep writes by lane id, so nothing is
    gathered or scattered here), and the in-shell ones fetch their
    boundary colors (K3 / K5).  ``step0`` = (fresh (N,), rd0 (N,)): the
    lanes at their walk's first step leave need before K1 lists the
    lanes, so no sweep reads their row, and take R_D = rd0 (reference
    wost.py:213-215, :309-310).  Returns (R_D, in_shell, color (N, 3),
    need).
    """
    g = scene.d_grid
    fp = g.fine
    if fp is None or fp.eps != float(eps):
        raise ValueError(f"the FinePack was baked for eps "
                         f"{None if fp is None else fp.eps}, not {eps}")
    row, need_f, rl, outside = fine_decode(fp, q)
    need = active & (need_f | outside)
    if step0 is not None:
        need &= ~step0[0]
    resolve = _resolve_2d if scene.dim == 2 else _resolve_3d
    d_e, col, in_shell = resolve(g, need, row, q, eps)

    R_D = torch.where(need, d_e, rl)
    if g.trunc_min_rl < 2.0 * float(eps):
        # truncated nearest-K rows near the shell: the sweep's min over a
        # subset can overestimate the distance; the cell's lower bound is
        # the valid star radius there (reference wost.py:295-307)
        tr = need & ~outside & g.row_trunc[row.long()]
        R_D = torch.where(tr, g.row_lbound[row.long()], R_D)
    if step0 is not None:
        R_D = torch.where(step0[0], step0[1], R_D)
    in_shell &= R_D < eps
    color = torch.where(in_shell[:, None], col, 0.0)
    return R_D, in_shell, color, need


def _separate(scene: Scene, state: WalkState, eps: float, shrink: bool,
              step0=None):
    """Star radius and epsilon-shell classification: (in_shell, R_B,
    bcolor, R_D, need), bcolor the interpolated Dirichlet color (unscaled)
    and need the lanes whose Dirichlet distance was resolved exactly.
    ``step0`` = (fresh, rd0) reuses each pixel's first Dirichlet query on
    the lanes at their walk's first step (the balanced solve's restarts;
    None on the per-sample route)."""
    q = state.pos
    n = q.shape[0]
    dev = q.device
    inf = torch.full((n,), float("inf"), device=dev)
    if scene.dirichlet is None:
        R_D = inf
        in_shell = torch.zeros((n,), dtype=torch.bool, device=dev)
        bcolor = torch.zeros((n, 3), device=dev)
        need = in_shell
    elif scene.d_grid is None:
        R_D, in_shell, bcolor, need = _dense_dirichlet(
            scene, q, state.active, eps, step0)
    else:
        R_D, in_shell, bcolor, need = _fast_dirichlet(
            scene, q, state.active, eps, step0)
    if scene.neumann is None:
        R_N = inf
    else:
        if scene.n_sgrid is not None:
            # a dead walk's R_N is never read: K9-2D skips its row
            R_N = Q.grid_closest_silhouette(scene.n_sgrid, q, state.active)
        else:
            R_N = Q.closest_silhouette(scene.neumann.gs, q, state.active)
        if scene.n_bgrid is not None:
            # clamp to the prim band's completeness cap, less 2 eps for
            # the eps-offset ray origins: within it one band row holds
            # every prim the step's ball and rays can touch (reference
            # wost.py:354-373).  Cells with r_cap ~ 0 drop R_N to 0 and
            # R_B to the 1e-4 floor.
            rcap = Q.band_r_cap(scene.n_bgrid, q)
            R_N = torch.minimum(R_N, torch.clamp(rcap - 2.0 * eps, min=0.0))
    R_B = torch.clamp(torch.minimum(R_D, R_N), min=1e-4)
    if shrink:
        R_B = R_B * 0.99
    return in_shell, R_B, bcolor, R_D, need


def _boundary_term(scene: Scene, state: WalkState, in_shell, bcolor):
    contrib = bcolor * scene.dirichlet_intensity * state.thp[:, None]
    return torch.where((state.active & in_shell)[:, None], contrib, 0.0)


def _sample_direction(gen, state: WalkState, dim: int, has_neumann: bool):
    """Hemisphere around the Neumann normal on the boundary, the full
    sphere elsewhere: (dir, pdf, alpha)."""
    n = state.pos.shape[0]
    dev = state.pos.device
    d_sph = uniform_sample_sphere(gen, n, dim)
    if not has_neumann:
        return (d_sph,
                torch.full((n,), uniform_sample_sphere_pdf(dim), device=dev),
                torch.ones((n,), device=dev))
    d_hem = to_world(dim, frame_from_normal(dim, state.n_normal),
                     uniform_sample_hemisphere(gen, n, dim))
    on = state.on_neumann
    direction = torch.where(on[:, None], d_hem, d_sph)
    pdf = torch.where(on, uniform_sample_hemisphere_pdf(dim),
                      uniform_sample_sphere_pdf(dim))
    alpha = torch.where(on, 0.5, 1.0)
    return direction, pdf, alpha


def _source_term(scene: Scene, state: WalkState, live, R_B, gen,
                 eps: float):
    """Volumetric source contribution (integrator.cu:234-316): one point
    at a Green-sampled radius along a sampled direction, counted when the
    radius stays short of the first Neumann hit from ``pos + eps dir``
    (over the prim band of pos's cell where the set has one, K7 in 3D;
    else the sweep)."""
    dim = scene.dim
    n = state.pos.shape[0]
    direction, dir_pdf, alpha = _sample_direction(
        gen, state, dim, scene.neumann is not None)
    dist = R_B
    if scene.neumann is not None:
        origin = state.pos + eps * direction
        if scene.n_bgrid is not None:
            hit, t, _ = Q.band_ray_intersect(scene.n_bgrid, scene.neumann.gs,
                                             origin, direction, dist,
                                             ref=state.pos, live=live,
                                             offset=eps)
        else:
            hit, t, _ = Q.ray_intersect(scene.neumann.gs, origin, direction,
                                        dist, live=live)
        dist = torch.where(hit, torch.minimum(t, dist), dist)
    u = torch.rand((n, 3), generator=gen, device=gen.device)
    r, _ = green_sample_radius(u, R_B, dim)
    value = scene.source.sample(state.pos + r[:, None] * direction)
    value = value * scene.source_intensity
    # the conditional sphere pdf's ratio (integrator.cu:313): the r powers
    # cancel, leaving uniform-sphere pdf / direction pdf / alpha
    scale = green_norm(R_B, dim) * (uniform_sample_sphere_pdf(dim)
                                    / dir_pdf) / alpha
    contrib = state.thp[:, None] * value * scale[:, None]
    return torch.where((live & (r <= dist))[:, None], contrib, 0.0)


def _neumann_term(scene: Scene, state: WalkState, live, R_B, gen,
                  eps: float):
    """Neumann boundary-integral contribution, subtracted
    (integrator.cu:318-445)."""
    dim = scene.dim
    gs = scene.neumann.gs
    bg = scene.n_bgrid
    n = state.pos.shape[0]
    u_sel = torch.rand(n, generator=gen, device=gen.device)
    if bg is not None:
        pid, pdf = Q.band_sample_in_ball(bg, gs, state.pos, R_B, u_sel,
                                         live=live)
    else:
        pid, pdf = Q.sample_in_ball(gs, state.pos, R_B, u_sel, live)
    valid = (pid >= 0) & (pdf > 0)

    u_pt = torch.rand((n, 2), generator=gen, device=gen.device)
    pv = gs.prim_verts(pid)
    sample_pt = prim_sample_point(dim, pv, u_pt[:, 0], u_pt[:, 1])
    r = torch.linalg.norm(sample_pt - state.pos, dim=-1)
    valid &= (r < R_B) & (r > 0)

    # first-intersection visibility (integrator.cu:372-394)
    origin = state.pos + torch.where(state.on_neumann[:, None],
                                     eps * state.n_normal, 0.0)
    ray = sample_pt - origin
    clamp_dist = torch.linalg.norm(ray, dim=-1)
    ray_dir = ray / torch.clamp(clamp_dist, min=1e-20)[:, None]
    if bg is not None:
        # reach: the ray's points lie within tmax + eps of pos
        occluded, _, _ = Q.band_ray_intersect(bg, gs, origin, ray_dir,
                                              clamp_dist - eps, ref=state.pos,
                                              live=live, offset=eps)
    else:
        # an occlusion test: the traversal may stop at the first hit
        # (reference wost.py:475-481)
        occluded, _, _ = Q.ray_intersect(gs, origin, ray_dir,
                                         clamp_dist - eps, any_hit=True,
                                         live=live)
    valid &= ~occluded

    side = prim_side(dim, state.pos, pv)
    normal = gs.prim_normal[torch.clamp(pid, min=0)]
    side_on = torch.sign(torch.sum(normal * state.n_normal, dim=-1))
    side = torch.where(state.on_neumann, side_on, side)
    valid &= side != 0

    uv = prim_project(dim, sample_pt, pv)
    color = _surface_color(dim, scene.neumann.colors, gs, pid, side, uv)
    alpha = torch.where(state.on_neumann, 0.5, 1.0)
    weight = (green_eval(torch.clamp(r, min=1e-20), R_B, dim) / alpha
              / torch.clamp(pdf, min=1e-30))
    contrib = color * scene.neumann_intensity * (state.thp * weight)[:, None]
    return torch.where((live & valid)[:, None], -contrib, 0.0)


def _walk(scene: Scene, state: WalkState, live, R_B, gen, eps: float,
          guided=None):
    """One mean-value step: sample a direction, clip on the Neumann
    boundary, update throughput (integrator.cu:447-526).  A guided caller
    passes its own ``(direction, pdf, alpha)`` as ``guided``, and ``gen``
    draws nothing."""
    dim = scene.dim
    if guided is None:
        direction, pdf, alpha = _sample_direction(gen, state, dim,
                                                  scene.neumann is not None)
    else:
        direction, pdf, alpha = guided
    next_pos = state.pos + R_B[:, None] * direction
    hit = torch.zeros_like(state.active)
    normal = torch.zeros_like(state.pos)
    if scene.neumann is not None:
        current = state.pos + torch.where(state.on_neumann[:, None],
                                          eps * state.n_normal, 0.0)
        gs = scene.neumann.gs
        if scene.n_bgrid is not None:
            hit, t, pid = Q.band_ray_intersect(scene.n_bgrid, gs, current,
                                               direction, R_B, ref=state.pos,
                                               live=live, offset=eps)
        else:
            hit, t, pid = Q.ray_intersect(gs, current, direction, R_B,
                                          live=live)
        n_raw = gs.prim_normal[pid]
        # shading normal opposes the incoming direction (:509-512)
        n_flip = torch.where(
            torch.sum(n_raw * direction, dim=-1, keepdim=True) > 0,
            -n_raw, n_raw)
        normal = torch.where(hit[:, None], n_flip, normal)
        t = torch.where(hit, t, 0.0)
        next_pos = torch.where(hit[:, None], current + t[:, None] * direction,
                               next_pos)
    thp = state.thp / (pdf * alpha * sphere_measure(dim))
    return WalkState(
        pos=torch.where(live[:, None], next_pos, state.pos),
        thp=torch.where(live, thp, state.thp),
        active=state.active,
        on_neumann=torch.where(live, hit, state.on_neumann),
        n_normal=torch.where(live[:, None], normal, state.n_normal))


def _neumann_walk_fused(scene: Scene, state: WalkState, live, R_B, gens,
                        eps: float, guided=None):
    """3D: the Neumann term and the walk step of ``_neumann_term`` and
    ``_walk`` in one band query per lane (kernel K6): the in-ball sample,
    its visibility ray and the walk ray over the prim band of the lane's
    cell (reference wost.py:513-574).  A guided caller passes its own
    ``(direction, pdf, alpha)`` as ``guided``, and "walk" draws nothing.
    Returns (contrib, state')."""
    dim = scene.dim
    gs = scene.neumann.gs
    n = state.pos.shape[0]
    gen_n = gens["neumann"]
    u_sel = torch.rand(n, generator=gen_n, device=gen_n.device)
    u_pt = torch.rand((n, 2), generator=gen_n, device=gen_n.device)
    if guided is None:
        direction, pdf, alpha = _sample_direction(gens["walk"], state, dim,
                                                  True)
    else:
        direction, pdf, alpha = guided
    o = Q.band_neumann_walk(scene.n_bgrid, gs, state.pos, R_B,
                            state.on_neumann, state.n_normal, u_sel, u_pt,
                            direction, eps, live=live)

    # Neumann boundary-integral contribution, subtracted
    valid = (o.pid >= 0) & (o.pdf_area > 0)
    r = torch.linalg.norm(o.sample_pt - state.pos, dim=-1)
    valid &= (r < R_B) & (r > 0) & ~o.occluded
    side_on = torch.sign(torch.sum(o.plane_n * state.n_normal, dim=-1))
    side = torch.where(state.on_neumann, side_on, o.side)
    valid &= side != 0
    # barycentrics of the sample point (prim_sample_point in 3D)
    su = torch.sqrt(u_pt[:, 0])
    b1 = u_pt[:, 1] * su
    uv = torch.stack([b1, su - b1], dim=-1)
    color = _surface_color(dim, scene.neumann.colors, gs, o.pid, side, uv)
    alpha_n = torch.where(state.on_neumann, 0.5, 1.0)
    weight = (green_eval(torch.clamp(r, min=1e-20), R_B, dim) / alpha_n
              / torch.clamp(o.pdf_area, min=1e-30))
    contrib = color * scene.neumann_intensity * (state.thp * weight)[:, None]
    contrib = torch.where((live & valid)[:, None], -contrib, 0.0)

    # the walk step from the band's ray results
    current = state.pos + torch.where(state.on_neumann[:, None],
                                      eps * state.n_normal, 0.0)
    n_flip = torch.where(
        torch.sum(o.wnormal * direction, dim=-1, keepdim=True) > 0,
        -o.wnormal, o.wnormal)
    normal = torch.where(o.whit[:, None], n_flip, 0.0)
    next_pos = torch.where(o.whit[:, None],
                           current + o.wt[:, None] * direction,
                           state.pos + R_B[:, None] * direction)
    thp = state.thp / (pdf * alpha * sphere_measure(dim))
    return contrib, WalkState(
        pos=torch.where(live[:, None], next_pos, state.pos),
        thp=torch.where(live, thp, state.thp),
        active=state.active,
        on_neumann=torch.where(live, o.whit, state.on_neumann),
        n_normal=torch.where(live[:, None], normal, state.n_normal))


def fused_band_available(scene: Scene) -> bool:
    """A 3D Neumann set takes the fused band step (K6) unless
    ``ELAINA_FUSED_BAND=0`` asks for the unfused K8 + K7 pair, the JAX
    package's switch for the same A/B."""
    return (scene.neumann is not None and scene.n_bgrid is not None
            and scene.dim == 3
            and os.environ.get("ELAINA_FUSED_BAND", "1") != "0")


def wost_depth_step(scene: Scene, state: WalkState, gens: dict,
                    eps: float, step0=None):
    """One depth iteration for every lane: (state', contrib (N, 3), the
    number of lanes resolved exactly as a 0-dim device tensor).
    ``step0``: see ``_separate``."""
    in_shell, R_B, bcolor, _, need = _separate(scene, state, eps,
                                               shrink=True, step0=step0)
    in_shell &= state.active
    contrib = torch.zeros((state.pos.shape[0], 3), device=state.pos.device)
    if scene.dirichlet is not None:
        contrib += _boundary_term(scene, state, in_shell, bcolor)
    # lanes that terminated (in shell) or have an unbounded star die here
    live = state.active & ~in_shell & torch.isfinite(R_B)
    if scene.source is not None:
        contrib += _source_term(scene, state, live, R_B, gens["source"], eps)
    if fused_band_available(scene):
        cn, state = _neumann_walk_fused(scene, state, live, R_B, gens, eps)
        contrib += cn
    else:
        if scene.neumann is not None:
            contrib += _neumann_term(scene, state, live, R_B,
                                     gens["neumann"], eps)
        state = _walk(scene, state, live, R_B, gens["walk"], eps)
    return replace(state, active=live), contrib, need.sum()


def check_neumann(scene: Scene):
    """A Neumann set takes its band grids, its trees (the BVH route) or,
    up to CHUNKED_DENSE_MAX prims, the dense and chunked sweeps; without
    its prim-band grid, a set above that needs its tree (and the sweeps
    of its silhouettes, exact at any count, serve without theirs)."""
    if scene.neumann is None:
        return
    gs = scene.neumann.gs
    if (scene.n_bgrid is None and gs.n_prims > Q.CHUNKED_DENSE_MAX
            and not gs.has_tree):
        raise ValueError(f"a Neumann set above {Q.CHUNKED_DENSE_MAX} prims "
                         f"needs its prim-band grid or its tree "
                         f"(accel='bvh')")


def compute_step0(scene: Scene, eval_points, mask, eps: float):
    """Each pixel's first separation, computed once (reference
    wost.py:1426-1447): (rd0 (N,), in_shell0 (N,), contrib0 (N, 3)).
    Every sample of a pixel starts at its evaluation point, so its first
    Dirichlet query is the same each time: the balanced solve hands rd0
    to the restarting lanes, and bakes the pixels in the shell at their
    first step analytically (contrib0, throughput 1) so they never walk."""
    state = init_walk_state(eval_points, mask)
    in_shell, _, bcolor, R_D, _ = _separate(scene, state, eps, shrink=True)
    in_shell &= mask
    if scene.dirichlet is not None:
        contrib0 = _boundary_term(scene, state, in_shell, bcolor)
    else:
        contrib0 = torch.zeros((eval_points.shape[0], 3),
                               device=eval_points.device)
    return R_D, in_shell, contrib0


def run_one_sample(scene: Scene, eval_points, mask, gens: dict, *,
                   eps: float, max_depth: int):
    """One sample per pixel: every lane walks to ``max_depth``.  Returns
    (contribution (N, 3), live lane-steps, exactly resolved lane-steps,
    walks still alive at the depth cap), the counts as 0-dim device
    tensors."""
    check_neumann(scene)
    state = init_walk_state(eval_points, mask)
    dev = eval_points.device
    total = torch.zeros((eval_points.shape[0], 3), device=dev)
    lives = torch.zeros((), dtype=torch.int64, device=dev)
    resolved = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        lives += state.active.sum()
        state, contrib, n_need = wost_depth_step(scene, state, gens, eps)
        total += contrib
        resolved += n_need
    return total, lives, resolved, state.active.sum()
