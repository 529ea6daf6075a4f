"""Guided Walk-on-Stars: online-learned vMF-mixture importance sampling.

Port of ``elaina_tpu/solver/guided.py`` (reference: integrator/guided/
integrator.cu:110-1146; SIGGRAPH 2025 "Guiding-Based Importance Sampling
for Walk on Stars"), in 2D and 3D.  In the training phase the walks record
their first vertices (``WalkRecords``) and the network takes Adam + EMA
steps on those records (``train_on_records``); in the guiding phase the
walks sample the trained mixture and record nothing.  Both phases take
the JAX package's default route, the balanced persistent solve
(``solver/balanced.py``): lanes restart as their walks die, a walk's
records move to the ready buffer when it ends, and the optimizer runs
on them every ``TRAIN_EVERY`` iterations (``TrainLoop``).  With metric
frames the solve takes the per-sample route: each sample walks every
pixel's lane to the maximum depth, and a training sample is followed by
up to five optimizer steps.

The depth step (``guided_depth_step``) is the uniform one with three
changes: no 0.99 shrink of the star radius (guided/integrator.cu:238-239);
the contributions also fill the walk records; and below the guided depth
the direction comes from the network with one-sample MIS against the
uniform direction (``guided_direction``).  A 3D Neumann set takes the
fused band step (K6) with that direction, its contribution added to the
records before the step's vertex is written, as the JAX package does.

Whether the network runs is decided on the host from what it knows (the
phase and the step's depth), never from a device value: the JAX
package's ``lax.cond`` on "any live lane within guided depth" would be a
host sync each step here, and running the branch on every lane differs
only on lanes that are not live, which move no film and write no record.
On the balanced route the lanes' depths differ, so the network runs on
every iteration of a phase that guides (max guided depth above 0) and
the guided depth holds per lane.  The same holds for the optimizer: a
batch with too few valid records, or a nonfinite gradient, is dropped by
``torch.where``, and so is a pass after the balanced chunk's drain.

``GuidedIntegrator.solve`` takes the JAX package's time budget and
checkpoints (guided.py:847-1075).  Under a budget the training phase
runs once, to at most ``TRAIN_SPP_TARGET`` samples within its share of
the budget (``budget_train_policy``), or not at all where the hints
predict that it overruns its share; both phases slice their rounds with
``balanced.BudgetSlicer``.  A checkpoint (``core/checkpoint.py``, the
JAX package's file layout) holds the trainer and the sums; with
``checkpoint_every`` the solve takes the per-sample route and writes one
every so many samples, and a solve given an existing checkpoint resumes
from it, sample ``spp0 + k`` drawing what the unbroken run draws.

Under a group of ranks (``integrator.group``, the JAX package's mesh,
guided.py:335-524, 580-652, 1118-1162) both balanced phases shard their
lanes.  The guiding phase drains each rank's lanes on their own
(``balanced_solve``).  The training phase runs in lockstep: every rank
runs the same iterations (``run_chunk(group=)``), the ``apply`` flag of
each optimizer pass is any rank's loop condition, and each pass's
gradients are averaged over the ranks (``train_on_records(group=)``) on
every rank, with or without records, so the ranks' trainers stay equal
bit for bit.  Left out, as in ``balanced.py``: the watchdog bounds,
``lane_cap``, the deterministic mode and the ``ELAINA_*`` knobs.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ..core.checkpoint import (load_solve_state, load_trainer,
                               save_solve_state, save_trainer)
from ..core.logger import log_info, log_warning
from ..nn.network import (AdamConfig, GuidingNetwork, NetworkSpec,
                          TrainerState, adam_ema_step, apply_network,
                          init_trainer, make_network, require_ieee_matmul)
from ..utils.mathops import reflect
from ..utils.rng import (STAGES, run_seed, sample_generators,
                         stage_generators, stream_seed)
from .balanced import (CHECK_EVERY, ITER_CAP_MAX, TAIL_MIN_LANES,
                       BudgetSlicer, balanced_solve, build_balanced_pieces,
                       close_round, hint_digest, identity_pieces,
                       initial_image, make_pieces, pick, probe_cost,
                       round_seed, run_chunk, tail_lanes)
from .distributions import (M_EPSILON, n_dim_output, vmm_from_raw, vmm_pdf,
                            vmm_pdf_effective, vmm_sample,
                            vmm_selection_prob)
from .integrator import BaseIntegrator, _progress, metrics_on
from .sampling import uniform_sample_hemisphere_pdf, uniform_sample_sphere_pdf
from .wost import (WalkState, _boundary_term, _neumann_term,
                   _neumann_walk_fused, _sample_direction, _separate,
                   _source_term, _walk, check_neumann, fused_band_available,
                   init_walk_state)

MAX_TRAIN_DEPTH = 4       # record slots (parameters.h:6)
TRAIN_DEPTH_CAP = 3       # Guidance::maxTrainDepth (guided/integrator.h:237)
SELECTION_MIS_E = 0.2     # constant e (train.h:546)
TRAIN_BATCH_SIZE = 65_536 * 8    # parameters.h:10
MIN_TRAIN_BATCH_SIZE = 65_536    # parameters.h:11
TRAIN_BATCHES = 5         # batchPerFrame (guided/integrator.cu:643-662)
TRAIN_EVERY = 10          # balanced training: iterations between optimizer
#                           passes (~ one sample a lane; guided.py:344)
TRAIN_PROBE_SPP = 4       # samples a pixel of the training phase's probe
TRAIN_ITER_CAP = 512      # a training round's longest cap (guided.py:1293)
PHASE_GUIDE, PHASE_TRAIN = 1, 2   # the phases' random streams (uniform: 0)

# The budgeted training policy (reference guided.py:655-697), the JAX
# package's measured constants, not tuned for the port.  Training to t
# samples buys the guided estimator an equal-spp variance ratio v(t)
# (guided / uniform) on the budget B's other seconds, so it pays iff its
# share of B stays below 1 - v(t): there v(32) ~ 0.55 and v(16) ~ 0.77,
# and an undertrained guide did worse than none.
TRAIN_SPP_TARGET = 32        # a budgeted solve's training samples, at most
TRAIN_KNEE_SPP = 24          # below this target the shallow cap holds
TRAIN_SHARE_DEEP = 0.45      # = 1 - v(32)
TRAIN_SHARE_SHALLOW = 0.15   # ~ (1 - v(16)) x 2/3


def budget_train_policy(train_spp_count: int, time_budget_s: float,
                        predicted_wall: float | None):
    """The budgeted training decision (reference guided.py:677-697):
    ``(skip, t_target, share_cap)``, train to ``t_target`` samples within
    ``share_cap * time_budget_s`` seconds, or skip the training phase
    where ``predicted_wall`` (seconds for ``t_target`` samples, None
    without hints) already overruns that share."""
    t_target = min(TRAIN_SPP_TARGET, int(train_spp_count))
    share_cap = (TRAIN_SHARE_DEEP if t_target >= TRAIN_KNEE_SPP
                 else TRAIN_SHARE_SHALLOW)
    skip = (predicted_wall is not None
            and predicted_wall > share_cap * time_budget_s)
    return skip, t_target, share_cap


@dataclass
class WalkRecords:
    """GuidedPixelStateBuffer (guided.h:12-69): per-lane walk history."""

    pos: torch.Tensor         # (R, N, D)
    dir: torch.Tensor         # (R, N, D)
    dir_pdf: torch.Tensor     # (R, N)
    thp: torch.Tensor         # (R, N) scalar throughput
    sol: torch.Tensor         # (R, N, 3)
    on_neumann: torch.Tensor  # (R, N) bool
    normal: torch.Tensor      # (R, N, D)
    cur: torch.Tensor         # (N,) int32, the lane's next slot


def init_records(n: int, dim: int, device: torch.device) -> WalkRecords:
    R = MAX_TRAIN_DEPTH

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return WalkRecords(pos=z(R, n, dim), dir=z(R, n, dim), dir_pdf=z(R, n),
                       thp=z(R, n), sol=z(R, n, 3),
                       on_neumann=z(R, n, dtype=torch.bool),
                       normal=z(R, n, dim), cur=z(n, dtype=torch.int32))


def _backfill(records: WalkRecords, contrib, inclusive: bool) -> WalkRecords:
    """Add a contribution to every record up to the lane's current depth
    (recordSolution: exclusive; recordSourceContribution: inclusive,
    guided.h:48-68)."""
    R = records.sol.shape[0]
    limit = records.cur + (1 if inclusive else 0)
    r_idx = torch.arange(R, device=contrib.device)[:, None]
    mask = r_idx < torch.clamp(limit, max=R)[None, :]
    return replace(records, sol=records.sol
                   + torch.where(mask[..., None], contrib[None], 0.0))


def _increment(records: WalkRecords, state: WalkState, direction, pdf,
               write_mask) -> WalkRecords:
    """Write a walk vertex into the lane's current slot where
    ``write_mask`` holds and a slot is left (incrementDepth,
    guided.h:25-46)."""
    w = write_mask & (records.cur < MAX_TRAIN_DEPTH)
    r_idx = torch.arange(MAX_TRAIN_DEPTH, device=w.device)[:, None]
    sel = w[None, :] & (records.cur[None, :] == r_idx)        # (R, N)

    def put(arr, val):
        return torch.where(sel.reshape(sel.shape + (1,) * (arr.ndim - 2)),
                           val, arr)

    return WalkRecords(
        pos=put(records.pos, state.pos), dir=put(records.dir, direction),
        dir_pdf=put(records.dir_pdf, pdf), thp=put(records.thp, state.thp),
        sol=put(records.sol, 0.0),
        on_neumann=put(records.on_neumann, state.on_neumann),
        normal=put(records.normal, state.n_normal),
        cur=records.cur + w.to(torch.int32))


def _records_where(mask, a: WalkRecords, b: WalkRecords) -> WalkRecords:
    """Per-lane select between two record buffers, ``mask`` (N,) bool
    (reference guided.py:297-305)."""
    def pick(x, y):
        return torch.where(mask.reshape((1,) * (x.dim() > 1) + mask.shape
                                        + (1,) * max(x.dim() - 2, 0)), x, y)

    return WalkRecords(*(pick(getattr(a, f), getattr(b, f))
                         for f in WalkRecords.__dataclass_fields__))


class GuideBox(NamedTuple):
    """The scene's AABB on the device: the network's coordinate frame and
    the box outside which nothing is guided or trained."""

    lo: torch.Tensor   # (D,)
    hi: torch.Tensor   # (D,)


def guide_box(scene, device: torch.device) -> GuideBox:
    return GuideBox(torch.as_tensor(scene.aabb_lo, device=device),
                    torch.as_tensor(scene.aabb_hi, device=device))


def normalize_coord(p, lo, hi):
    """normalizeSpatialCoord (train.h:148-155): the AABB inflated by 0.5%
    of its diagonal, mapped to [0, 1]^D around its centre."""
    diag = hi - lo
    inflate = 0.005 * torch.sqrt(torch.sum(diag * diag))
    lo2 = lo - inflate
    hi2 = hi + inflate
    center = 0.5 * (lo2 + hi2)
    return 0.5 + (p - center) / (hi2 - lo2)


def _in_box(pos, box: GuideBox):
    return torch.all((pos >= box.lo) & (pos <= box.hi), dim=-1)


def guided_direction(spec: NetworkSpec, params: dict, box: GuideBox,
                     state: WalkState, d_uni, pdf_uni, gens: dict,
                     uniform_fraction: float, has_neumann: bool, ok=None):
    """The guided branch of the depth step (inferenceStepImpl and
    handleOutShellPointImpl, guided/integrator.cu:496-526, 820-840) on
    every lane: the network at the lane's position, the mixture, the
    learned selection probability (clipped to [0, 0.999]: the raw sigmoid
    saturates to 1.0 and the blended pdf would lose its uniform floor), a
    guided direction (folded into the hemisphere on a Neumann boundary)
    where the route draw picks it and the uniform one elsewhere, and the
    one-sample MIS pdf sp * guided + (1 - sp) * uniform inside the AABB.
    ``ok`` (N,) bool, where given, limits the guiding to those lanes (the
    balanced route's per-lane guided depth); the others keep the uniform
    direction and pdf.  Draws from "route" the choice (N,) and from
    "guide" the mixture sample.  Returns (direction (N, D), pdf (N,))."""
    n, dim = state.pos.shape
    raw = apply_network(spec, params, normalize_coord(state.pos, box.lo,
                                                      box.hi))
    vmm = vmm_from_raw(raw, dim)
    sp = torch.clamp(vmm_selection_prob(raw, dim), 0.0, 0.999)
    in_aabb = _in_box(state.pos, box)
    if ok is not None:
        in_aabb &= ok
    gen = gens["route"]
    u_route = torch.rand(n, generator=gen, device=gen.device)
    choose = in_aabb & ((u_route < sp) | (uniform_fraction == 0.0))
    d_gui = vmm_sample(gens["guide"], vmm, dim)
    if has_neumann:
        fold = state.on_neumann & (torch.sum(state.n_normal * d_gui, dim=-1)
                                   <= 0)
        d_gui = torch.where(fold[:, None], reflect(d_gui, state.n_normal),
                            d_gui)
    direction = torch.where(choose[:, None], d_gui, d_uni)
    # the folded guided density is pdf(d) + pdf(reflect(d)) either way:
    # reflection is an involution
    if has_neumann:
        p = vmm_pdf_effective(vmm, direction, state.on_neumann,
                              state.n_normal, dim)
    else:
        p = vmm_pdf(vmm, direction, dim)
    pdf = torch.where(in_aabb, sp * p + (1.0 - sp) * pdf_uni, pdf_uni)
    return direction, pdf


def guided_depth_step(scene, spec: NetworkSpec, infer_params: dict,
                      box: GuideBox, state: WalkState,
                      records: WalkRecords | None, gens: dict, depth: int,
                      guiding_on: bool, training_on: bool,
                      uniform_fraction: float, max_guided_depth: int, *,
                      eps: float, train_sel=None, step0=None):
    """One guided depth iteration (solveImpl's inner loop,
    guided/integrator.cu:1004-1042).  The phase flags and settings are
    host values.  ``depth`` is the step's depth, a host int on the
    per-sample route, or each lane's walk depth (N,) on the balanced
    route: there the network runs on every iteration of a phase that
    guides below a max guided depth above 0, and the guided depth and the
    records' ``TRAIN_DEPTH_CAP`` hold per lane (reference guided.py:
    222-249, 283-287).  ``records`` None leaves out the records (the
    guiding phase); ``train_sel`` (N,) bool is isTrainingPixel
    (guided.h:101-109), None for every lane; ``step0``: see
    ``wost._separate``.  Draws the uniform direction from "uniform"
    before the route is chosen.  A 3D Neumann set takes the fused band
    step (``fused_band_available``) on the chosen direction, whose
    contribution reaches the records before ``_increment`` writes the
    step's vertex (reference guided.py:272-290).  Returns (state',
    records', contrib (N, 3), the number of lanes resolved exactly as a
    0-dim device tensor)."""
    dim = scene.dim
    in_shell, R_B, bcolor, _, need = _separate(scene, state, eps,
                                               shrink=False, step0=step0)
    in_shell &= state.active
    contrib = torch.zeros((state.pos.shape[0], 3), device=state.pos.device)
    if scene.dirichlet is not None:
        cb = _boundary_term(scene, state, in_shell, bcolor)
        contrib += cb
        if records is not None:
            records = _backfill(records, cb, inclusive=False)
    live = state.active & ~in_shell & torch.isfinite(R_B)
    if scene.source is not None:
        cs = _source_term(scene, state, live, R_B, gens["source"], eps)
        contrib += cs
        if records is not None:
            records = _backfill(records, cs, inclusive=True)
    has_neumann = scene.neumann is not None
    fused = fused_band_available(scene)
    if has_neumann and not fused:
        cn = _neumann_term(scene, state, live, R_B, gens["neumann"], eps)
        contrib += cn
        if records is not None:
            records = _backfill(records, cn, inclusive=True)
    direction, pdf, alpha = _sample_direction(gens["uniform"], state, dim,
                                              has_neumann)
    per_lane = torch.is_tensor(depth)
    if per_lane and guiding_on and max_guided_depth > 0:
        direction, pdf = guided_direction(spec, infer_params, box, state,
                                          direction, pdf, gens,
                                          uniform_fraction, has_neumann,
                                          ok=depth < max_guided_depth)
    elif not per_lane and guiding_on and depth < max_guided_depth:
        direction, pdf = guided_direction(spec, infer_params, box, state,
                                          direction, pdf, gens,
                                          uniform_fraction, has_neumann)
    if fused:
        cn, walked = _neumann_walk_fused(scene, state, live, R_B, gens, eps,
                                         guided=(direction, pdf, alpha))
        contrib += cn
        if records is not None:
            records = _backfill(records, cn, inclusive=True)
    if records is not None and training_on and (
            per_lane or depth < TRAIN_DEPTH_CAP):
        mask = live if train_sel is None else live & train_sel
        if per_lane:
            mask = mask & (depth < TRAIN_DEPTH_CAP)
        records = _increment(records, state, direction, pdf, mask)
    if not fused:
        walked = _walk(scene, state, live, R_B, None, eps,
                       guided=(direction, pdf, alpha))
    return replace(walked, active=live), records, contrib, need.sum()


def run_one_guided_sample(scene, spec: NetworkSpec, infer_params: dict,
                          box: GuideBox, eval_points, mask, gens: dict,
                          guiding_on: bool, training_on: bool,
                          uniform_fraction: float, max_guided_depth: int, *,
                          eps: float, max_depth: int, train_sel=None):
    """One sample per pixel: every lane walks to ``max_depth``.  Returns
    (contribution (N, 3), the records (None unless ``training_on``), live
    lane-steps, exactly resolved lane-steps, walks alive at the depth
    cap), the counts as 0-dim device tensors."""
    check_neumann(scene)
    n, dim = eval_points.shape
    dev = eval_points.device
    state = init_walk_state(eval_points, mask)
    records = init_records(n, dim, dev) if training_on else None
    total = torch.zeros((n, 3), device=dev)
    lives = torch.zeros((), dtype=torch.int64, device=dev)
    resolved = torch.zeros_like(lives)
    for depth in range(max_depth):
        lives += state.active.sum()
        state, records, c, n_need = guided_depth_step(
            scene, spec, infer_params, box, state, records, gens, depth,
            guiding_on, training_on, uniform_fraction, max_guided_depth,
            eps=eps, train_sel=train_sel)
        total += c
        resolved += n_need
    return total, records, lives, resolved, state.active.sum()


# --------------------------------------------------------------------------- #
# training (trainStepImpl + generate_training_data + the KL objective)
# --------------------------------------------------------------------------- #


def _train_loss(params: dict, spec: NetworkSpec, dim: int, x, wi, Li,
                dir_pdf, on_neumann, normal, valid):
    """The guide's objective over one batch (compute_dL_doutput_divergence,
    train.h:491-553, as autodiff of the same loss):
        L = -Li / dirPdf * log(guidePdf)
            - e * Li * (sg(guidePdf) - uniformPdf) / dirPdf^2 * selProb
    masked-mean over the valid records.  Returns (loss, mean KL term)."""
    raw = apply_network(spec, params, x)
    vmm = vmm_from_raw(raw, dim)
    guide_pdf = vmm_pdf_effective(vmm, wi, on_neumann, normal,
                                  dim) + M_EPSILON
    sp = vmm_selection_prob(raw, dim)
    dir_pdf = dir_pdf + M_EPSILON
    kl = -Li / dir_pdf * torch.log(guide_pdf)
    uniform_pdf = torch.where(on_neumann, uniform_sample_hemisphere_pdf(dim),
                              uniform_sample_sphere_pdf(dim))
    sp_term = (-SELECTION_MIS_E) * Li * (
        guide_pdf.detach() - uniform_pdf) / (dir_pdf ** 2) * sp
    count = torch.clamp(torch.sum(valid), min=1.0)
    loss = torch.sum(torch.where(valid, kl + sp_term, 0.0)) / count
    metric = torch.sum(torch.where(valid, kl, 0.0)) / count
    return loss, metric


def train_on_records(trainer: TrainerState, spec: NetworkSpec,
                     adam_cfg: AdamConfig, box: GuideBox,
                     records: WalkRecords, *, batch_size: int,
                     n_batches: int, apply=None, group=None):
    """Up to ``n_batches`` optimizer steps over consecutive slices of the
    flattened records (trainStepImpl, guided/integrator.cu:617-668);
    slices past the buffer's end wrap to fresh offsets.  A batch with
    no valid record changes nothing, and neither does any batch where
    ``apply`` (a 0-dim bool) is False.  Returns
    (trainer', mean KL metric as a 0-dim device tensor).

    ``group`` (``records``: this rank's lanes'; reference guided.py:
    580-652, ``axis_name``): each batch's mean gradient and metric are
    averaged over the ranks and its valid records counted over them (one
    ``all_reduce``), so a batch steps on every rank or on none; every
    rank must call it alike, with the same ``apply``."""
    R, N = records.dir_pdf.shape
    dim = records.pos.shape[-1]
    total = R * N
    r_idx = torch.arange(R, device=records.cur.device)[:, None]
    base_valid = (r_idx < records.cur[None, :]).reshape(total)
    pos = records.pos.reshape(total, dim)
    x = normalize_coord(pos, box.lo, box.hi)
    wi = records.dir.reshape(total, dim)
    dir_pdf = records.dir_pdf.reshape(total)
    thp = records.thp.reshape(total)
    sol = records.sol.reshape(total, 3)
    on_neumann = records.on_neumann.reshape(total)
    normal = records.normal.reshape(total, dim)
    # per-channel solution normalization + NaN/AABB filter
    # (generate_training_data, train.h:422-471)
    sol_n = torch.where(torch.abs(thp)[:, None] > M_EPSILON,
                        sol / thp[:, None], 0.0)
    Li = torch.mean(torch.abs(sol_n), dim=-1)
    valid = (base_valid & _in_box(pos, box) & (dir_pdf > 0)
             & torch.isfinite(Li) & torch.isfinite(dir_pdf)
             & torch.all(torch.isfinite(wi), dim=-1)
             & torch.all(torch.isfinite(x), dim=-1))
    size = min(batch_size, total)
    metric_sum = torch.zeros((), device=x.device)
    for i in range(n_batches):
        start = (i * size) % max(total - size + 1, 1)
        s = slice(start, start + size)
        params = {k: v.detach().requires_grad_()
                  for k, v in trainer.params.items()}
        loss, metric = _train_loss(params, spec, dim, x[s], wi[s], Li[s],
                                   dir_pdf[s], on_neumann[s], normal[s],
                                   valid[s])
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        enough = valid[s].any()
        if group is not None:
            grads, metric, enough = _mean_over(group, grads, metric,
                                               valid[s].sum())
        if apply is not None:
            enough = enough & apply
        trainer = adam_ema_step(trainer, grads, adam_cfg, apply=enough)
        metric_sum = metric_sum + torch.where(enough, metric.detach(), 0.0)
    return trainer, metric_sum / n_batches


def _mean_over(group, grads: dict, metric, n_valid):
    """One batch's gradients and metric averaged over the ranks (their
    sum over the group's size), and whether any rank had a valid record:
    one ``all_reduce`` of the three packed together."""
    names = sorted(grads)
    buf = group.all_sum(torch.cat(
        [grads[k].reshape(-1) for k in names]
        + [metric.detach().reshape(1), n_valid.to(torch.float32).reshape(1)]))
    parts = torch.split(buf[:-2] / group.size,
                        [grads[k].numel() for k in names])
    return ({k: p.reshape(grads[k].shape) for k, p in zip(names, parts)},
            buf[-2] / group.size, buf[-1] > 0)


def _train_batch_policy(n_pixels: int) -> tuple:
    """trainStepImpl's batching (guided/integrator.cu:643-662,
    parameters.h:10-11): up to TRAIN_BATCHES batches of TRAIN_BATCH_SIZE
    records a training sample, never below MIN_TRAIN_BATCH_SIZE, from a
    buffer of MAX_TRAIN_DEPTH records a pixel.  Returns (batch size,
    batches)."""
    total = MAX_TRAIN_DEPTH * n_pixels
    batch = min(TRAIN_BATCH_SIZE, max(MIN_TRAIN_BATCH_SIZE, total // 5))
    batch = min(batch, max(total, 1024))
    return batch, min(TRAIN_BATCHES, max(1, -(-total // batch)))


# --------------------------------------------------------------------------- #
# the balanced training chunk (make_balanced_train_chunk)
# --------------------------------------------------------------------------- #


class TrainLoop:
    """The training phase's part of a balanced chunk (reference
    ``make_balanced_train_chunk``, guided.py:337-524): each lane records
    its walk's first vertices, a walk's records move to the ``ready``
    buffer when the walk ends, and every ``train_every`` iterations
    ``train_on_records`` runs on ``ready``, whose generation is then
    consumed; the walks read the freshest EMA weights.  An iteration
    after the drain (``more`` False on the device) trains nothing and
    consumes nothing.  At the end the last walks' records are flushed and
    one single-batch pass runs.  Pass as ``run_chunk``'s hooks, with
    ``step`` as its step.

    ``group``: ``n`` is this rank's lanes, and the chunk runs in lockstep
    (pass the group to ``run_chunk`` as well): each pass applies where
    any rank's loop condition holds, and averages its gradients over the
    ranks; the pass after the drain (and ``finish``'s) runs on every rank
    whether it has records or not."""

    def __init__(self, integ, trainer: TrainerState, n: int,
                 train_every: int, piece_train=None, group=None):
        s = integ.settings
        self.spec, self.adam_cfg, self.box = (integ.spec, integ.adam_cfg,
                                              integ.box)
        self.batch_size, self.n_batches = _train_batch_policy(
            integ.n_pixels)
        self.eps = float(s.epsilonShell)
        self.uf = float(s.uniformFractionInTrainingPhase)
        self.mgd = int(s.maxGuidedDepthInTrainingPhase)
        dev = integ.device
        self.rec = init_records(n, integ.problem.dim, dev)
        self.ready = init_records(n, integ.problem.dim, dev)
        self.trainer = trainer
        self.metric = torch.zeros((), device=dev)
        self.train_every = train_every
        self.piece_train = piece_train     # (S, M) bool, or None
        self.train_sel = None
        self.group = group

    def step(self, scene, extra, state, gens, wstep, step0):
        state, self.rec, contrib, need = guided_depth_step(
            scene, self.spec, self.trainer.ema_params, self.box, state,
            self.rec, gens, wstep, True, True, self.uf, self.mgd,
            eps=self.eps, train_sel=self.train_sel, step0=step0)
        return state, contrib, need

    def _flush(self, active):
        done = ~active & (self.rec.cur > 0)
        self.ready = _records_where(done, self.rec, self.ready)
        return done

    def walks_ended(self, active):
        done = self._flush(active)
        self.rec = replace(self.rec, cur=torch.where(done, 0, self.rec.cur))

    def restarted(self, restart, slot):
        self.rec = replace(self.rec,
                           cur=torch.where(restart, 0, self.rec.cur))
        if self.piece_train is not None:
            self.train_sel = pick(self.piece_train, slot)

    def iteration_done(self, j: int, more):
        if (j + 1) % self.train_every:
            return
        if self.group is not None:
            more = self.group.any(more)
        self.trainer, metric = train_on_records(
            self.trainer, self.spec, self.adam_cfg, self.box, self.ready,
            batch_size=self.batch_size, n_batches=self.n_batches,
            apply=more, group=self.group)
        self.metric = torch.where(more, metric, self.metric)
        self.ready = replace(self.ready,
                             cur=torch.where(more, 0, self.ready.cur))

    def finish(self, active):
        self._flush(active)
        self.trainer, _ = train_on_records(
            self.trainer, self.spec, self.adam_cfg, self.box, self.ready,
            batch_size=self.batch_size, n_batches=1, group=self.group)


# --------------------------------------------------------------------------- #
# the integrator
# --------------------------------------------------------------------------- #


class GuidedIntegrator(BaseIntegrator):
    """GuidedIntegrator<2> and <3> (guided/integrator.h:96-253).  Call
    ``reset_network`` before ``solve``."""

    # isTrainingPixel's stride (guided.h:109): only pixels with
    # (pixel - offset) % stride == 0 write records; the offset is drawn
    # again each solve (integrator.cu:126).  Runtime state, not a config
    # field; 1 = every pixel trains.
    train_pixel_stride = 1

    def __init__(self, problem, settings, base_path: str, points=None):
        super().__init__(problem, settings, base_path, points)
        self.box = guide_box(problem.scene, self.device)

    def reset_network(self, net_conf: dict | None):
        """resetNetworkImpl (guided/integrator.cu:1096-1137)."""
        if self.device.type == "cuda":
            require_ieee_matmul()
        conf = net_conf or {}
        dim = self.problem.dim
        self.spec = make_network(dim, n_dim_output(dim), conf)
        self.adam_cfg = AdamConfig.from_json(conf.get("optimizer"))
        self.reset_training()

    def reset_training(self):
        """resetTrainingImpl (guided/integrator.cu:1139-1146)."""
        self.trainer = init_trainer(self.spec, self.device)
        self.loss_history: list[float] = []
        self._net_trained = False

    def _phase(self, spp: int) -> tuple:
        """(uniform fraction, max guided depth, training) of sample
        ``spp``.  A guiding phase whose network never took an optimizer
        step samples uniformly (max guided depth 0): guiding from a
        freshly initialized mixture measured 1.6x worse RMSE than
        uniform in the JAX package."""
        s = self.settings
        if spp < s.trainSppCount:
            return (float(s.uniformFractionInTrainingPhase),
                    int(s.maxGuidedDepthInTrainingPhase), True)
        mgd = int(s.maxGuidedDepthInGuidingPhase) if self._net_trained else 0
        return float(s.uniformFractionInGuidingPhase), mgd, False

    def _train_selection(self, seed: int):
        """isTrainingPixel's lanes (N,) bool, or None at stride 1."""
        stride = int(self.train_pixel_stride)
        self._solve_count = getattr(self, "_solve_count", 0) + 1
        if stride <= 1:
            self.train_pixel_offset = 0
            return None
        rng = np.random.default_rng(stream_seed(seed, self._solve_count,
                                                len(STAGES)))
        self.train_pixel_offset = int(rng.integers(stride))
        pix = torch.arange(self.n_pixels, device=self.device)
        return (pix - self.train_pixel_offset) % stride == 0

    def _note_trained(self):
        """Whether an optimizer step ever ran: one read of the step
        count, at the end of a training phase."""
        self._net_trained = self._net_trained or int(
            self.trainer.opt.count) > 0

    def solve(self, checkpoint_path: str | None = None,
              checkpoint_every: int = 0,
              time_budget_s: float | None = None) -> int:
        """Every sample, or as many as ``time_budget_s`` seconds allow: the
        training phase (trainSppCount samples), then the guiding phase on
        the EMA weights.  Returns wall-clock milliseconds.  Leaves the
        mean in the SOLUTION film, the sums in ``sum`` / ``sum_sq`` over
        ``spp`` samples, the samples this call ran in ``spp_done``, the
        counts of ``UniformIntegrator.solve``, the training loss in
        ``loss_history`` and each phase's seconds and live lane-steps in
        ``phase_stats``.

        A ``checkpoint_path`` that exists is resumed: its trainer, its
        trained flag (True where the file has none, as the JAX package
        reads it) and, from ``<checkpoint_path>.solve.npz``, its sums and
        sample count.  The route is the JAX package's choice
        (guided.py:955-1030): the balanced persistent phases, unless the
        config asks for metric frames or ``checkpoint_every`` > 0 with a
        ``checkpoint_path``, which take the per-sample route; there a
        checkpoint is written every ``checkpoint_every`` samples.  Under a
        budget (seconds from this call, after ``prepare()``) the training
        phase follows ``budget_train_policy`` (``train_policy``,
        ``train_spp_achieved``) and the phases slice their rounds; the
        per-sample route stops between samples once the budget is spent.

        Under a group (``group``) the balanced phases shard their lanes
        over its ranks; the per-sample route runs on rank 0 while the
        others wait, then every rank takes rank 0's sums and trainer;
        only rank 0 writes checkpoints and hints."""
        self._check_group()
        seed = run_seed()
        tsel = self._train_selection(seed)
        start = self._clock()
        total = torch.zeros((self.n_pixels, 6), device=self.device)
        spp0 = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            spp0 = self._resume(checkpoint_path, total)
        if metrics_on(self.settings) or (checkpoint_path
                                         and checkpoint_every > 0):
            return self._on_lead(lambda: self._solve_per_sample(
                seed, tsel, start, total, spp0, checkpoint_path,
                checkpoint_every, time_budget_s))
        return self._solve_persistent(seed, tsel, start, total, spp0,
                                      time_budget_s)

    def _share_from_lead(self):
        super()._share_from_lead()
        self.trainer = self.group.replicate(self.trainer)
        self._net_trained = bool(self.group.host_max(
            [float(self._net_trained)])[0])

    def _resume(self, path: str, total) -> int:
        """Load a checkpoint into the trainer and ``total`` (N, 6); returns
        its sample count (0 without a solve-state file)."""
        self.trainer, meta = load_trainer(path, self.device)
        self._net_trained = bool(meta.get("net_trained", True))
        self._sq_from = 0
        sol = path + ".solve.npz"
        if not os.path.exists(sol):
            return 0
        sums, spp0, _, sq = load_solve_state(sol)
        total[:, :3] = torch.as_tensor(sums, device=self.device)
        if sq is None:
            log_warning("%s holds no sums of squares (a JAX package's "
                        "checkpoint): the mean resumes exactly, the "
                        "standard error takes its variance from the "
                        "resumed samples only", sol)
            self._sq_from = spp0
        else:
            total[:, 3:] = torch.as_tensor(sq, device=self.device)
        return spp0

    def _finish(self, total, spp: int, spp0: int, start: float,
                done_per_pixel=None) -> int:
        """Keep the sums of ``spp`` samples (``spp0`` of them resumed),
        fill the SOLUTION film, save the hints; returns the solve's
        milliseconds."""
        sq_from = getattr(self, "_sq_from", 0)
        if sq_from and spp > sq_from:
            # the file had no squares: the samples run since stand for all
            total[:, 3:] *= spp / (spp - sq_from)
        self._sq_from = 0
        sol = total[:, :3].cpu().numpy()           # waits for the device
        duration_ms = int((time.time() - start) * 1000)
        self.sum, self.sum_sq, self.spp = total[:, :3], total[:, 3:], spp
        self.spp_done = spp - spp0
        self.done_per_pixel = done_per_pixel
        self._save_hints()
        self._put("SOLUTION", sol / max(spp, 1))
        return duration_ms

    def _guide_step(self, params: dict, uniform_fraction: float,
                    max_guided_depth: int):
        """The balanced chunk's step without records: guided below each
        lane's guided depth on ``params``."""
        spec, box = self.spec, self.box
        eps = float(self.settings.epsilonShell)

        def step(scene, extra, state, gens, wstep, step0):
            state, _, contrib, need = guided_depth_step(
                scene, spec, params, box, state, None, gens, wstep, True,
                False, uniform_fraction, max_guided_depth, eps=eps,
                step0=step0)
            return state, contrib, need

        return step

    def _solve_persistent(self, seed: int, tsel, start: float, total,
                          spp0: int, time_budget_s: float | None) -> int:
        """The balanced route (reference guided.py:955-1030):
        ``_training_persistent`` then ``_guiding_persistent``.
        ``loss_history`` gets one KL metric a training round (the last
        in-loop pass's), as the JAX package's does; ``balance_rounds``
        keeps each phase's round records.  Under a budget the training
        runs once, to ``t_target`` samples within min(share cap x budget,
        the budget left), or is skipped where ``_train_spp_wall``
        predicts that it overruns its share (the guide then stays
        untrained and the guiding phase samples uniformly); a training
        phase that the budget cut after the budget's end leaves no
        guiding phase."""
        s = self.settings
        check_neumann(self.problem.scene)
        spp = int(s.samplesPerPixel)
        n_train = min(int(s.trainSppCount), spp)
        self.phase_stats = {"train_steps": 0, "guide_steps": 0,
                            "train_s": 0.0, "guide_s": 0.0}
        self.balance_rounds = {"train": [], "guide": []}
        self.train_policy = None
        self.train_spp_achieved = float(min(spp0, n_train))
        counts = np.full(self.n_pixels, spp0, np.int64)
        done_spp, stop = spp0, False
        if spp0 < n_train:
            budget = spp_cap = None
            skip = False
            if time_budget_s:
                t_target = min(TRAIN_SPP_TARGET, int(s.trainSppCount))
                tw = self._train_spp_wall(t_target)
                skip, t_target, share_cap = budget_train_policy(
                    s.trainSppCount, time_budget_s, tw)
                self.train_policy = {"skip": skip, "t_target": t_target,
                                     "share_cap": share_cap,
                                     "predicted_wall": tw}
                if skip:
                    log_warning("training to %d spp predicted at %.2f s "
                                "against a %.2f s budget (share cap "
                                "%.0f%%): skipping the training phase",
                                t_target, tw, time_budget_s,
                                100 * share_cap)
                else:
                    budget = min(share_cap * time_budget_s, max(
                        0.0, time_budget_s - (self._clock() - start)))
                    spp_cap = t_target
            if not skip:
                t = time.time()
                image, rounds, done, interrupted, done_spp = \
                    self._training_persistent(seed, tsel, spp0, n_train,
                                              budget, spp_cap)
                total += image
                counts += done
                self.balance_rounds["train"] = rounds
                self.phase_stats["train_steps"] = sum(r["steps"]
                                                      for r in rounds)
                self.phase_stats["train_s"] = time.time() - t
                stop = bool(interrupted and time_budget_s
                            and self._clock() - start > time_budget_s)
        if not stop and spp > done_spp:
            t = time.time()
            out = self._guiding_persistent(seed, done_spp, start,
                                           time_budget_s)
            total += torch.cat([out.image, out.image_sq], 1)
            counts += out.done
            done_spp = spp
            self.balance_rounds["guide"] = out.rounds
            self.phase_stats["guide_steps"] = out.steps
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.phase_stats["guide_s"] = time.time() - t
        rounds = self.balance_rounds["train"] + self.balance_rounds["guide"]
        self.total_walk_steps = sum(r["steps"] for r in rounds)
        self.rank_walk_steps = sum(r["rank_steps"] for r in rounds)
        self.total_resolved = sum(r["resolved"] for r in rounds)
        self.total_capped = sum(r["capped"] for r in rounds)
        return self._finish(total, done_spp, spp0, start,
                            counts if (counts < done_spp).any() else None)

    def _training_persistent(self, seed: int, tsel, spp0: int, n_train: int,
                             time_budget_s: float | None = None,
                             spp_cap: int | None = None):
        """The training phase on the balanced route (reference guided.py:
        1177-1481) from sample ``spp0`` to ``n_train``, or ``spp_cap``
        samples where fewer: a probe round of min(TRAIN_PROBE_SPP, the
        samples) samples (2 under a budget) on the identity partition at
        cap 8 x that, unless the problem's cost cache has this frame; then
        cost-balanced rounds at cap min(1.35 x ideal + 24,
        TRAIN_ITER_CAP), each a ``TrainLoop``; the tail rounds (ideal <=
        max depth) run the record-free guide step at a quarter of the
        width from TAIL_MIN_LANES up (a multiple of a group's size).  Under
        ``time_budget_s`` (seconds from the phase's start) the rounds are
        ``BudgetSlicer``'s, seeded with ``_train_rate_prior``, over
        worklists shuffled each round, with the drain-skip.  Sets
        ``_pixel_cost`` (the guiding phase's partition), the trainer,
        ``_net_trained`` (an optimizer step ran), ``_walk_rate`` (the
        guiding phase's rate prior), ``train_spp_achieved`` and the
        problem's training rate.  Returns
        (sums (N, 6) rescaled to the phase's samples, round records, the
        completed samples a pixel, whether the budget cut it, the sample
        count it ends at).  Under a group each rank runs its slice of every
        round's lanes: a ``TrainLoop`` round in lockstep, a record-free
        tail round on its own."""
        s = self.settings
        scene = self.problem.scene
        n = self.n_pixels
        dev = self.device
        group = self.group
        mult = 1 if group is None else group.size
        max_depth = int(s.maxWalkingDepth)
        uf = float(s.uniformFractionInTrainingPhase)
        mgd = int(s.maxGuidedDepthInTrainingPhase)
        remaining = n_train - spp0
        if spp_cap is not None:
            remaining = min(remaining, int(spp_cap))
        rd0, in_shell0, contrib0, resolved = self._balanced_inputs()
        image = initial_image(in_shell0, contrib0, remaining)
        rem = np.where(resolved, 0, remaining).astype(np.int64)
        cache, key = self._cost_cache()
        have_cost0 = key in cache
        if group is not None:
            group.check_same("the training phase's hints", hint_digest(
                cache.get(key), self._train_rate_prior(),
                self._iter_walls(PHASE_TRAIN)))
        cost = np.ones(n)
        if have_cost0:
            cost = self._pixel_cost = np.maximum(
                np.asarray(cache[key], np.float64), 1.0)
        spp_w = min(2 if time_budget_s else TRAIN_PROBE_SPP, remaining)
        piece_pix, piece_quota = identity_pieces(
            n, np.where(resolved, 0, spp_w))
        tbit = None if tsel is None else tsel.cpu().numpy()
        gens = stage_generators(dev)
        trainer = self.trainer
        opt0 = int(trainer.opt.count)
        rounds = []
        slicer = BudgetSlicer(time_budget_s, self._clock(),
                              self._train_rate_prior(),
                              self._iter_walls(PHASE_TRAIN),
                              None if group is None else group.clock)
        interrupted = False
        n_walk = int(np.sum(~resolved))
        for round_i in range(16 + 4 * (1 + remaining * max_depth // 48)):
            if rem.sum() == 0:
                break
            if time_budget_s and round_i > 0 and rem.sum() < max(
                    1, n_walk * remaining // 2000):
                interrupted = True          # the drain-skip
                break
            rem_round, stop = slicer.plan(rem, cost, round_i, spp_w,
                                          have_cost0 or round_i > 0)
            if stop or slicer.min_round_stop(round_i, n,
                                             2 * CHECK_EVERY + max_depth):
                interrupted = True
                break
            tail, n_round = False, n
            probe = round_i == 0 and not have_cost0
            if probe:
                cap = 8 * spp_w
            else:
                ideal = int(np.ceil(float((rem_round * cost).sum()) / n))
                cap = min(int(1.35 * ideal) + 24, TRAIN_ITER_CAP)
                # the tail decision looks at all the remaining work
                ideal_full = int(np.ceil(float((rem * cost).sum()) / n))
                if ideal_full <= max_depth:
                    # the tail trains almost nothing: the record-free step
                    # at a quarter of the width, room for every walk
                    tail = True
                    if n >= TAIL_MIN_LANES and tail_lanes(n, mult):
                        n_round = tail_lanes(n, mult)
                        ideal = int(np.ceil(ideal * n / n_round))
                    cap = min(max_depth + 2 * ideal + 64,
                              TRAIN_ITER_CAP if n_round == n
                              else ITER_CAP_MAX)
            cap = slicer.bound_cap(cap, n_round, CHECK_EVERY)
            t_r = time.time()
            if not probe:
                piece_pix, piece_quota = build_balanced_pieces(
                    slicer.fit_quota(rem, rem_round, cost, cap, n_round),
                    cost, n_round,
                    shuffle=(np.random.default_rng(0xE1A + round_i)
                             if time_budget_s else None))
            sl = slice(None) if group is None else group.lanes(n_round)
            pieces = make_pieces(self.eval_points, rd0, piece_pix[:, sl],
                                 piece_quota[:, sl])
            t_c = time.time()
            kw = dict(max_depth=max_depth, iter_cap=cap, gens=gens,
                      round_seed=round_seed(seed, PHASE_TRAIN, round_i,
                                            group))
            loop = None
            if tail and n_round < n:
                out = run_chunk(self._guide_step(trainer.ema_params, uf,
                                                 mgd), scene, None, pieces,
                                **kw)
            else:
                # a full-width tail round passes no in-loop optimizer pass
                # (its records still reach the end-of-chunk pass)
                loop = TrainLoop(
                    self, trainer, pieces.quota.shape[1],
                    cap + 1 if tail else TRAIN_EVERY,
                    None if tbit is None else torch.from_numpy(
                        tbit[piece_pix[:, sl]]).to(dev), group)
                out = run_chunk(loop.step, scene, None, pieces, hooks=loop,
                                group=group, **kw)
                trainer = loop.trainer
            image, done, rec, lsteps = close_round(
                image, out, pieces, n, n_round, cap, t_r, t_c, probe, group)
            rem = np.maximum(rem - done, 0)
            rounds.append(rec)
            slicer.update(rec["steps"], rec["wall"], rec["ran"],
                          rec["lanes"], rec["host_s"])
            if loop is not None:
                self.loss_history.append(float(loop.metric))
            if probe:
                cost = self._pixel_cost = probe_cost(lsteps, done, max_depth)
                cache[key] = cost
            if self._lead():
                _progress(int(100 * (1 - rem.sum() / max(
                    float(n_walk) * remaining, 1.0))), 100, "Training")
            if slicer.expired() and rem.sum() > 0:
                interrupted = True
                break
        self.trainer = trainer
        if int(trainer.opt.count) > opt0:
            self._net_trained = True
        if slicer.rate is not None:
            # the guiding phase's rate prior (training's, optimizer passes
            # included: an underestimate)
            self._walk_rate = slicer.rate
        if slicer.solve_rate():
            self._rate_cache()[("train", n)] = slicer.solve_rate()
        self._keep_iter_walls(PHASE_TRAIN, slicer.iter_s)
        self.train_spp_achieved = float(
            spp0 + remaining - rem.sum() / max(n_walk, 1))
        done_total = np.where(resolved, remaining, remaining - rem)
        if rem.sum() > 0:
            log_warning("training phase: %d samples left%s; rescaling each "
                        "pixel's sums by its completed samples",
                        int(rem.sum()),
                        " (time budget)" if interrupted else "")
            image = image * torch.as_tensor(
                remaining / np.maximum(done_total, 1), dtype=torch.float32,
                device=dev)[:, None]
        return image, rounds, done_total, interrupted, spp0 + remaining

    def _guiding_persistent(self, seed: int, spp0: int, start: float,
                            time_budget_s: float | None = None):
        """The guiding phase on the balanced route (reference guided.py:
        1483-1539): ``balanced_solve`` of the samples from ``spp0`` with
        the record-free guided step on the EMA weights, partitioned by the
        training phase's cost, under the solve's budget from ``start``,
        its rate prior the training phase's or the problem's.  A network
        that never took an optimizer step samples uniformly (max guided
        depth 0)."""
        s = self.settings
        mgd = int(s.maxGuidedDepthInGuidingPhase)
        if not self._net_trained:
            log_warning("guiding phase with an untrained network: sampling "
                        "uniformly (max guided depth 0)")
            mgd = 0
        rd0, in_shell0, contrib0, resolved = self._balanced_inputs()
        cost0 = getattr(self, "_pixel_cost", None)
        if cost0 is None:
            cache, key = self._cost_cache()
            cost0 = cache.get(key)
        rates = self._rate_cache()
        return balanced_solve(
            self._guide_step(self.trainer.ema_params,
                             float(s.uniformFractionInGuidingPhase), mgd),
            self.problem.scene, None, self.eval_points, rd0, resolved,
            contrib0, in_shell0, spp=int(s.samplesPerPixel) - spp0,
            max_depth=int(s.maxWalkingDepth), seed=seed, phase=PHASE_GUIDE,
            cost0=cost0, progress=_progress, time_budget_s=time_budget_s,
            start_time=start,
            rate0=getattr(self, "_walk_rate", None) or rates.get(
                self.n_pixels),
            rate_sink=lambda r: rates.__setitem__(self.n_pixels, r),
            iter0=self._iter_walls(PHASE_GUIDE),
            iter_sink=lambda w: self._keep_iter_walls(PHASE_GUIDE, w),
            group=self.group)

    def _train_rate_prior(self):
        """The training phase's walk-steps/s prior (reference guided.py:
        1082-1097): the problem's training rate, at least 0.4 x its walk
        rate (the optimizer's share), or that floor alone; None without
        either."""
        rates = self._rate_cache()
        tr = rates.get(("train", self.n_pixels))
        rp = rates.get(self.n_pixels)
        floor = 0.4 * rp if rp else None
        if tr:
            return max(tr, floor) if floor else tr
        return floor

    def _train_spp_wall(self, spp: int) -> float | None:
        """Predicted seconds of ``spp`` training samples over the pixels
        not baked, from the cost and rate hints (reference guided.py:
        1099-1110); None without them."""
        rp = self._train_rate_prior()
        cache, key = self._cost_cache()
        cp = cache.get(key)
        if not rp or cp is None:
            return None
        resolved = self._balanced_inputs()[3]
        cpp = float(np.sum(np.maximum(np.asarray(cp), 1.0) * ~resolved))
        return spp * cpp / rp

    def _solve_per_sample(self, seed: int, tsel, start: float, total,
                          spp0: int, checkpoint_path: str | None,
                          checkpoint_every: int,
                          time_budget_s: float | None) -> int:
        """The per-sample route (reference guided.py:1000-1080): samples
        ``spp0`` on, each walking every lane to the depth cap, sample
        ``i`` from the streams of (run seed, ``i``); a training sample is
        followed by ``train_on_records``, and ``loss_history`` gets one KL
        metric a training sample.  With ``checkpoint_every`` > 0 the
        trainer and the sums go to ``checkpoint_path`` every
        ``checkpoint_every`` samples; under a budget the loop stops after
        the sample that passes it."""
        s = self.settings
        scene = self.problem.scene
        spp = int(s.samplesPerPixel)
        eps, max_depth = float(s.epsilonShell), int(s.maxWalkingDepth)
        batch_size, n_batches = _train_batch_policy(self.n_pixels)
        sums, sums_sq = total[:, :3], total[:, 3:]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        steps = {"train": zero.clone(), "guide": zero.clone()}
        resolved, capped = zero.clone(), zero.clone()
        secs = {"train": 0.0, "guide": 0.0}
        metrics = []
        t_phase = start
        done = spp0
        for i in range(spp0, spp):
            uniform_fraction, mgd, training = self._phase(i)
            contrib, records, st, res, cap = run_one_guided_sample(
                scene, self.spec, self.trainer.ema_params, self.box,
                self.eval_points, self.mask,
                sample_generators(seed, i, self.device), True, training,
                uniform_fraction, mgd, eps=eps, max_depth=max_depth,
                train_sel=tsel)
            if training:
                self.trainer, metric = train_on_records(
                    self.trainer, self.spec, self.adam_cfg, self.box,
                    records, batch_size=batch_size, n_batches=n_batches)
                metrics.append(metric)
            sums += contrib
            sums_sq += contrib * contrib
            steps["train" if training else "guide"] += st
            resolved += res
            capped += cap
            done = i + 1
            if training and (done == s.trainSppCount or done == spp):
                self._note_trained()             # waits for the device
                secs["train"] += time.time() - t_phase
                t_phase = time.time()
            if (s.saveSppMetricsDuration > 0
                    and i % s.saveSppMetricsDuration == 0
                    and i < s.saveSppMetricsUntil):
                self._dump_frames(sums, done, "frames", str(i))
            if s.saveTimeMetricsDuration > 0 and \
                    i % s.saveTimeMetricsDuration == 0:
                self._dump_frames(sums, done, "frames_time",
                                  str(int((time.time() - start) * 1000)))
            if (checkpoint_path and checkpoint_every > 0
                    and done % checkpoint_every == 0):
                self._note_trained()
                save_trainer(checkpoint_path, self.trainer,
                             {"spp": done, "net_trained": self._net_trained})
                save_solve_state(checkpoint_path + ".solve.npz", sums, done,
                                 solution_sq_sum=sums_sq)
            _progress(done, spp)
            if time_budget_s and time.time() - start > time_budget_s:
                log_info("guided solve interrupted at %d/%d spp (time "
                         "budget %.1f s)", done, spp, time_budget_s)
                break
        self.phase_stats = {"train_steps": int(steps["train"]),
                            "guide_steps": int(steps["guide"])}
        secs["guide"] += time.time() - t_phase
        self.phase_stats.update(train_s=secs["train"], guide_s=secs["guide"])
        self.total_walk_steps = (self.phase_stats["train_steps"]
                                 + self.phase_stats["guide_steps"])
        self.rank_walk_steps = self.total_walk_steps
        self.total_resolved = int(resolved)
        self.total_capped = int(capped)
        if metrics:
            self.loss_history.extend(torch.stack(metrics).tolist())
        return self._finish(total, done, spp0, start)

    def query_network(self, p):
        """queryNetworkImpl (guided/integrator.cu:565-615): log the mixture
        of the EMA weights at a world point; returns it."""
        q = torch.as_tensor(np.asarray(p, np.float32),
                            device=self.device)[None, :]
        net = GuidingNetwork(self.spec, self.trainer.ema_params)
        with torch.no_grad():
            raw = net(normalize_coord(q, self.box.lo, self.box.hi))
        dim = self.problem.dim
        vmm = vmm_from_raw(raw, dim)
        sp = float(vmm_selection_prob(raw, dim)[0])
        log_info("VMM @ %s (selection prob %.4f):", np.asarray(p).tolist(),
                 sp)
        for i in range(vmm.lam.shape[-1]):
            log_info("Component %d: lambda = %f, kappa = %f, mu = %s", i,
                     float(vmm.lam[0, i]), float(vmm.kappa[0, i]),
                     np.round(vmm.mu[0, i].cpu().numpy(), 4).tolist())
        return vmm
