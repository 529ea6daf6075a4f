"""Guided Walk-on-Stars: online-learned vMF-mixture importance sampling.

Port of the per-sample route of ``elaina_tpu/solver/guided.py``
(reference: integrator/guided/integrator.cu:110-1146; SIGGRAPH 2025
"Guiding-Based Importance Sampling for Walk on Stars"), in 2D.  Each
sample walks every pixel's lane to the maximum depth; in the training
phase the lanes record their first vertices (``WalkRecords``), and after
the sample the network takes up to five Adam + EMA steps on those records
(``train_on_records``).  In the guiding phase the walks sample the
trained mixture and record nothing.

The depth step (``guided_depth_step``) is the uniform one with three
changes: no 0.99 shrink of the star radius (guided/integrator.cu:238-239);
the contributions also fill the walk records; and below the guided depth
the direction comes from the network with one-sample MIS against the
uniform direction (``guided_direction``).  Whether the network runs is
decided on the host from what it knows (the phase and the step's depth),
never from a device value: the JAX package's ``lax.cond`` on "any live
lane within guided depth" would be a host sync each step here, and running
the branch on every lane differs only on lanes that are not live, which
move no film and write no record.  The same holds for the optimizer: a
batch with too few valid records, or a nonfinite gradient, is dropped by
``torch.where``.

Not ported: the balanced persistent routes (``_training_persistent``,
``_guiding_persistent``), the time budget and checkpointing, and 3D (the
tri-plane encoding): ROADMAP Queue 1.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ..core.logger import log_info
from ..nn.network import (AdamConfig, GuidingNetwork, NetworkSpec,
                          TrainerState, adam_ema_step, apply_network,
                          init_trainer, make_network, require_ieee_matmul)
from ..utils.mathops import reflect
from ..utils.rng import STAGES, run_seed, sample_generators, stream_seed
from .distributions import (M_EPSILON, n_dim_output, vmm_from_raw, vmm_pdf,
                            vmm_pdf_effective, vmm_sample,
                            vmm_selection_prob)
from .integrator import BaseIntegrator, _progress
from .sampling import uniform_sample_hemisphere_pdf, uniform_sample_sphere_pdf
from .wost import (WalkState, _boundary_term, _neumann_term,
                   _sample_direction, _separate, _source_term, _walk,
                   check_neumann, init_walk_state)

MAX_TRAIN_DEPTH = 4       # record slots (parameters.h:6)
TRAIN_DEPTH_CAP = 3       # Guidance::maxTrainDepth (guided/integrator.h:237)
SELECTION_MIS_E = 0.2     # constant e (train.h:546)
TRAIN_BATCH_SIZE = 65_536 * 8    # parameters.h:10
MIN_TRAIN_BATCH_SIZE = 65_536    # parameters.h:11
TRAIN_BATCHES = 5         # batchPerFrame (guided/integrator.cu:643-662)


def no_guided_3d():
    return NotImplementedError(
        "guided WoSt in 3D (the tri-plane encoding, the 3D mixture's step) "
        "arrives with the ROADMAP item 'guided 3D'")


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
                     uniform_fraction: float, has_neumann: bool):
    """The guided branch of the depth step (inferenceStepImpl and
    handleOutShellPointImpl, guided/integrator.cu:496-526, 820-840) on
    every lane: the network at the lane's position, the mixture, the
    learned selection probability (clipped to [0, 0.999]: the raw sigmoid
    saturates to 1.0 and the blended pdf would lose its uniform floor), a
    guided direction (folded into the hemisphere on a Neumann boundary)
    where the route draw picks it and the uniform one elsewhere, and the
    one-sample MIS pdf sp * guided + (1 - sp) * uniform inside the AABB.
    Draws from "route" the choice (N,) and from "guide" the mixture
    sample.  Returns (direction (N, D), pdf (N,))."""
    n, dim = state.pos.shape
    raw = apply_network(spec, params, normalize_coord(state.pos, box.lo,
                                                      box.hi))
    vmm = vmm_from_raw(raw, dim)
    sp = torch.clamp(vmm_selection_prob(raw, dim), 0.0, 0.999)
    in_aabb = _in_box(state.pos, box)
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
                      eps: float, train_sel=None):
    """One guided depth iteration (solveImpl's inner loop,
    guided/integrator.cu:1004-1042).  ``depth``, the phase flags and
    settings are host values.  ``records`` None leaves out the records
    (the guiding phase); ``train_sel`` (N,) bool is isTrainingPixel
    (guided.h:101-109), None for every lane.  Draws the uniform direction
    from "uniform" before the route is chosen.  Returns (state', records',
    contrib (N, 3), the number of lanes resolved exactly as a 0-dim
    device tensor)."""
    dim = scene.dim
    if dim != 2:
        raise no_guided_3d()
    in_shell, R_B, bcolor, _, need = _separate(scene, state, eps,
                                               shrink=False)
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
    if has_neumann:
        cn = _neumann_term(scene, state, live, R_B, gens["neumann"], eps)
        contrib += cn
        if records is not None:
            records = _backfill(records, cn, inclusive=True)
    direction, pdf, alpha = _sample_direction(gens["uniform"], state, dim,
                                              has_neumann)
    if guiding_on and depth < max_guided_depth:
        direction, pdf = guided_direction(spec, infer_params, box, state,
                                          direction, pdf, gens,
                                          uniform_fraction, has_neumann)
    if records is not None and training_on and depth < TRAIN_DEPTH_CAP:
        mask = live if train_sel is None else live & train_sel
        records = _increment(records, state, direction, pdf, mask)
    state = _walk(scene, state, live, R_B, None, eps,
                  guided=(direction, pdf, alpha))
    return replace(state, active=live), records, contrib, need.sum()


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
                     n_batches: int):
    """Up to ``n_batches`` optimizer steps over consecutive slices of the
    flattened records (trainStepImpl, guided/integrator.cu:617-668);
    slices past the buffer's end wrap to fresh offsets.  A batch with
    no valid record changes nothing.  Returns
    (trainer', mean KL metric as a 0-dim device tensor)."""
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
        trainer = adam_ema_step(trainer, grads, adam_cfg, apply=enough)
        metric_sum = metric_sum + torch.where(enough, metric.detach(), 0.0)
    return trainer, metric_sum / n_batches


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
# the integrator
# --------------------------------------------------------------------------- #


class GuidedIntegrator(BaseIntegrator):
    """GuidedIntegrator<2> (guided/integrator.h:96-253) on the per-sample
    route.  Call ``reset_network`` before ``solve``."""

    # isTrainingPixel's stride (guided.h:109): only pixels with
    # (pixel - offset) % stride == 0 write records; the offset is drawn
    # again each solve (integrator.cu:126).  Runtime state, not a config
    # field; 1 = every pixel trains.
    train_pixel_stride = 1

    def __init__(self, problem, settings, base_path: str, points=None):
        if problem.dim != 2:
            raise no_guided_3d()
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

    def solve(self) -> int:
        """Every sample: the training phase (trainSppCount samples, each
        followed by ``train_on_records``), then the guiding phase on the
        EMA weights.  Returns wall-clock milliseconds.  Leaves the mean in
        the SOLUTION film, the sums in ``sum`` / ``sum_sq``, the counts of
        ``UniformIntegrator.solve``, the KL metric of each training sample
        in ``loss_history`` and each phase's seconds and live lane-steps
        in ``phase_stats``."""
        s = self.settings
        scene = self.problem.scene
        spp = int(s.samplesPerPixel)
        seed = run_seed()
        eps, max_depth = float(s.epsilonShell), int(s.maxWalkingDepth)
        batch_size, n_batches = _train_batch_policy(self.n_pixels)
        tsel = self._train_selection(seed)
        start = time.time()
        total = torch.zeros((self.n_pixels, 3), device=self.device)
        total_sq = torch.zeros_like(total)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        steps = {"train": zero.clone(), "guide": zero.clone()}
        resolved, capped = zero.clone(), zero.clone()
        secs = {"train": 0.0, "guide": 0.0}
        metrics = []
        t_phase = start
        for i in range(spp):
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
            total += contrib
            total_sq += contrib * contrib
            steps["train" if training else "guide"] += st
            resolved += res
            capped += cap
            if training and (i + 1 == s.trainSppCount or i + 1 == spp):
                self._note_trained()             # waits for the device
                secs["train"] += time.time() - t_phase
                t_phase = time.time()
            if (s.saveSppMetricsDuration > 0
                    and i % s.saveSppMetricsDuration == 0
                    and i < s.saveSppMetricsUntil):
                self._dump_frames(total, i + 1, "frames", str(i))
            if s.saveTimeMetricsDuration > 0 and \
                    i % s.saveTimeMetricsDuration == 0:
                self._dump_frames(total, i + 1, "frames_time",
                                  str(int((time.time() - start) * 1000)))
            _progress(i + 1, spp)
        self.phase_stats = {"train_steps": int(steps["train"]),
                            "guide_steps": int(steps["guide"])}
        secs["guide"] += time.time() - t_phase
        self.phase_stats.update(train_s=secs["train"], guide_s=secs["guide"])
        self.total_walk_steps = (self.phase_stats["train_steps"]
                                 + self.phase_stats["guide_steps"])
        self.total_resolved = int(resolved)
        self.total_capped = int(capped)
        if metrics:
            self.loss_history.extend(torch.stack(metrics).tolist())
        duration_ms = int((time.time() - start) * 1000)
        self.sum, self.sum_sq, self.spp = total, total_sq, spp
        self._put("SOLUTION", total.cpu().numpy() / max(spp, 1))
        return duration_ms

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
