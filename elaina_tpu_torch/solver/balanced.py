"""The balanced persistent solve: per-lane worklists of (pixel, quota)
pieces, lanes restarting with their next sample as soon as a walk dies.

Port of the JAX package's default solve (``elaina_tpu/solver/wost.py``:
``build_balanced_pieces`` :732, ``make_balanced_chunk`` :792-940,
``flush_balanced`` :942, ``oversub_lanes`` :1097, ``balanced_solve``
:1137-1423).  The per-sample loop (``wost.run_one_sample``) runs every op
over all N lanes up to the depth cap, dead lanes included; here each lane
holds up to ``N_PIECES`` pieces, each a pixel and a number of samples,
and starts the next sample of its piece (or its next piece) the moment
its walk dies, so the lanes stay busy.

A round is one chunk: a host loop of depth steps over the lanes'
worklists (``run_chunk``).  A walk's contributions build up in ``pend``
and reach its slot's sums, and the completed count, only when the walk
dies.  The round's iteration cap bounds when samples may start: a walk
in flight at the cap runs to its end (at most ``max_depth`` more
iterations), and the samples not started stay for a later round.  The
JAX package drops the walks in flight at its cap and runs their samples
again, which favours short walks (a walk's chance to be cut grows with
its length) and biases a pixel whose walks' values depend on their
length, as a source's do.  The loop's condition
(any walk alive, or before the cap any lane with samples left in its
piece) is computed on the device every iteration, and the host reads it
every ``CHECK_EVERY`` iterations only: the iterations after the drain
are gated on the device by it, so they change nothing, and the outputs
equal those of a loop that stops at the drain.  ``balanced_solve`` runs the rounds: a probe round on the
identity partition (lane = pixel) measures each pixel's cost in steps a
sample, then the remaining samples are split into cost-balanced
worklists (``build_balanced_pieces``), the last ones at a quarter of the
width.  The host reads the round's counts once a round.

Left out, against the JAX package: the time budget (``BudgetSlicer``,
the drain-skip, the shuffled partition), the runtime-watchdog bounds on a
round's iteration cap (a guard against the TPU runtime's kill of long
dispatches), ``lane_cap`` (the TPU's SMEM gate on the lane-list width,
which the port's K1 does not have), the deterministic mode (no cap here
depends on a measured wall), the device mesh and the ``ELAINA_*`` knobs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.logger import log_warning
from ..utils.rng import balanced_seed, reseed, stage_generators
from .wost import WalkState, init_walk_state

N_PIECES = 4            # worklist slots a lane (wost.py:723)
LANE_TARGET = 64 * 1024  # lanes a small frame is widened to (wost.py:1108)
CHECK_EVERY = 8         # iterations between the host's reads of the loop
#                         condition
ITER_CAP_MAX = 1024     # the longest round, in iterations (wost.py:724)
PROBE_SPP = 8           # samples a pixel of the cost probe (round 0)
PROBE_CAP = 64          # the probe round's iteration cap
TAIL_MIN_LANES = 4 * 32768   # tail rounds shrink to a quarter of the lanes
#                              from this width up


def build_balanced_pieces(rem: np.ndarray, cost: np.ndarray, n_lanes: int,
                          s: int = N_PIECES):
    """Cost-balanced contiguous partition of the remaining samples into
    per-lane worklists (host numpy, reference wost.py:732-789).

    ``rem`` (P,) samples left a pixel, ``cost`` (P,) its estimated steps
    a sample.  Lane j gets up to ``s`` contiguous (pixel, quota) pieces
    whose cost adds up to ~W / M; a heavy pixel is split across
    consecutive lanes, and pieces past ``s`` stay in ``rem`` for the next
    round.  Returns (piece_pix (s, M) int32, piece_quota (s, M) int32),
    quota 0 padding."""
    rem = rem.astype(np.int64)
    active = np.flatnonzero(rem > 0)
    piece_pix = np.zeros((s, n_lanes), np.int32)
    piece_quota = np.zeros((s, n_lanes), np.int32)
    if active.size == 0:
        return piece_pix, piece_quota
    ra = rem[active]
    c = np.maximum(cost[active].astype(np.float64), 1.0)
    w = c * ra
    cum = np.concatenate([[0.0], np.cumsum(w)])
    bounds = np.arange(n_lanes + 1) * (cum[-1] / n_lanes)
    bi = np.clip(np.searchsorted(cum, bounds, side="right") - 1, 0,
                 ra.size - 1)
    frac = np.clip((bounds - cum[bi]) / np.maximum(w[bi], 1e-30), 0.0, 1.0)
    off = np.minimum((frac * ra[bi]).astype(np.int64), ra[bi])
    bi[-1], off[-1] = ra.size - 1, ra[-1]
    # lane j's piece k is active pixel bi[j] + k, clipped to lane j + 1's
    # start
    p0, p1, o0, o1 = bi[:-1], bi[1:], off[:-1], off[1:]
    for k in range(s):
        p = p0 + k
        ps = np.minimum(p, ra.size - 1)
        b = np.where(p == p1, o1, ra[ps])
        a = np.where(k == 0, o0, 0)
        piece_pix[k] = active[ps]
        piece_quota[k] = np.where(p <= p1, np.maximum(b - a, 0), 0)
    return piece_pix, piece_quota


def oversub_lanes(n: int, spp: int, lane_target: int = LANE_TARGET) -> int:
    """The balanced solve's lane width (reference wost.py:1097-1112): a
    frame below ``lane_target`` pixels is widened towards it, at most to
    its total sample count, its pixels split across co-lanes (each lane
    draws its own numbers, so the split is unbiased); a larger frame
    keeps one lane a pixel."""
    if n >= lane_target:
        return n
    return max(min(lane_target, n * max(int(spp), 1)), n)


@dataclass
class Pieces:
    """One round's worklists on the device, slot-major."""

    pix: torch.Tensor     # (S, M) int64, the piece's pixel
    pos: torch.Tensor     # (S, M, D) its evaluation point
    rd0: torch.Tensor     # (S, M) its step-0 Dirichlet distance
    quota: torch.Tensor   # (S, M) int32, its samples


def make_pieces(pts, rd0, piece_pix: np.ndarray,
                piece_quota: np.ndarray) -> Pieces:
    """The device tables of host worklists over the pixels' points
    ``pts`` (N, D) and step-0 distances ``rd0`` (N,)."""
    pix = torch.from_numpy(piece_pix.astype(np.int64)).to(pts.device)
    return Pieces(pix=pix, pos=pts[pix], rd0=rd0[pix],
                  quota=torch.from_numpy(piece_quota).to(pts.device))


def identity_pieces(n: int, quota0: np.ndarray):
    """The probe partition: lane i holds pixel i with ``quota0[i]``."""
    pix = np.zeros((N_PIECES, n), np.int32)
    pix[0] = np.arange(n)
    quota = np.zeros((N_PIECES, n), np.int32)
    quota[0] = quota0
    return pix, quota


@dataclass
class ChunkOut:
    """A chunk's results: per slot, the sums of the committed samples and
    of their squares (S, M, 6), the committed counts ``done`` (S, M) in
    the JAX package's form, each lane's live steps ``lsteps`` (M,), and
    0-dim device counts: live lane-steps ``steps``, iterations before
    the drain ``iters``, lanes resolved exactly ``resolved``, walks the
    depth cap killed alive ``capped``; ``checks`` is the host's reads of
    the loop condition."""

    acc: torch.Tensor
    done: torch.Tensor
    lsteps: torch.Tensor
    steps: torch.Tensor
    iters: torch.Tensor
    resolved: torch.Tensor
    capped: torch.Tensor
    checks: int


def read_flag(flag: torch.Tensor) -> bool:
    """The host's read of the loop condition, every ``check_every``
    iterations: the one place a chunk waits for the device (``chip_smoke.
    py`` [8d] lifts its sync probe around it)."""
    return bool(flag)


def pick(table, slot):
    """``table`` (S, M) or (S, M, F) at each lane's slot.  A lane past its
    last slot (slot S) reads slot S - 1, a value no caller uses there."""
    idx = torch.clamp(slot, max=table.shape[0] - 1).long()[None]
    if table.dim() == 3:
        idx = idx[..., None].expand(1, -1, table.shape[2])
    return torch.gather(table, 0, idx)[0]


def _commit(acc, pend, died, slot):
    """Add the walks that died to their slot's sums, and the squares of
    their totals to the slot's sums of squares: one scatter."""
    val = torch.where(died[:, None], torch.cat([pend, pend * pend], 1), 0.0)
    idx = torch.clamp(slot, max=acc.shape[0] - 1).long()
    acc.scatter_add_(0, idx[None, :, None].expand(1, -1, 6), val[None])


def run_chunk(step_fn, scene, extra, pieces: Pieces, *, max_depth: int,
              iter_cap: int, round_seed: int, gens: dict,
              check_every: int = CHECK_EVERY, hooks=None) -> ChunkOut:
    """One round of the balanced solve (reference ``make_balanced_chunk``'s
    loop, wost.py:843-925): iterations of ``step_fn(scene, extra, state,
    gens, wstep, step0) -> (state', contrib (M, 3), lanes resolved)``
    over the worklists until every lane drained its pieces and every walk
    died; samples start only in the first ``iter_cap`` iterations, and
    the walks then in flight run to their end.  The stage generators
    ``gens`` are seeded for iteration j from (``round_seed``, j).

    ``hooks`` (the guided training phase) is told, each iteration, which
    walks have ended (``walks_ended(active)``, after the commit), which
    lanes restart (``restarted(restart, slot)``) and that the iteration
    is over (``iteration_done(j, more)``, ``more`` the device's loop
    condition at its start), and at the end ``finish(active)``."""
    S, n = pieces.quota.shape
    dev = pieces.quota.device
    quota = pieces.quota
    st = init_walk_state(pieces.pos[0], torch.zeros(n, dtype=torch.bool,
                                                    device=dev))
    acc = torch.zeros((S, n, 6), device=dev)
    pend = torch.zeros((n, 3), device=dev)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    scnt, slot, sidx, wstep, lsteps = zi, zi, zi, zi, zi.clone()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    resolved, capped = steps.clone(), steps.clone()

    def more_of(st, slot, sidx, start: bool):
        if not start:
            return st.active.any()
        left = (slot < S) & (sidx < pick(quota, slot))
        return st.active.any() | left.any()

    checks = 0
    n_iter = iter_cap + max_depth       # every walk dies by then
    for j in range(n_iter):
        start = j < iter_cap
        more = more_of(st, slot, sidx, start)
        died = ~st.active & (scnt < sidx)
        _commit(acc, pend, died, slot)
        scnt = scnt + died.to(torch.int32)
        pend = torch.where(died[:, None], 0.0, pend)
        if hooks is not None:
            hooks.walks_ended(st.active)
        if start:
            # advance exhausted pieces (quota 0 pads a worklist's tail);
            # after the drain nothing advances: the iteration changes
            # nothing
            adv = (~st.active & (sidx >= pick(quota, slot)) & (slot < S)
                   & more)
            slot = slot + adv.to(torch.int32)
            sidx = torch.where(adv, 0, sidx)
            scnt = torch.where(adv, 0, scnt)
            restart = ~st.active & (sidx < pick(quota, slot)) & (slot < S)
            rd0 = pick(pieces.rd0, slot)
        else:
            restart, rd0 = torch.zeros_like(st.active), pieces.rd0[0]
        if hooks is not None:
            hooks.restarted(restart, slot)
        st = WalkState(
            pos=torch.where(restart[:, None], pick(pieces.pos, slot),
                            st.pos),
            thp=torch.where(restart, 1.0, st.thp),
            active=st.active | restart,
            on_neumann=st.on_neumann & ~restart,
            n_normal=torch.where(restart[:, None], 0.0, st.n_normal))
        sidx = sidx + restart.to(torch.int32)
        live = st.active.to(torch.int32)
        steps += live.sum()
        lsteps += live
        wstep = torch.where(restart, 0, wstep)
        st, contrib, n_need = step_fn(scene, extra, st,
                                      reseed(gens, round_seed, j), wstep,
                                      (restart, rd0))
        resolved += n_need
        pend = pend + contrib
        wstep = wstep + st.active.to(torch.int32)
        # the depth cap kills walks that used up their steps
        over = st.active & (wstep >= max_depth)
        capped += over.sum()
        st = replace(st, active=st.active & ~over)
        it += more.to(torch.int32)
        if hooks is not None:
            hooks.iteration_done(j, more)
        if (j + 1) % check_every == 0 and j + 1 < n_iter:
            checks += 1
            if not read_flag(more_of(st, slot, sidx, j + 1 < iter_cap)):
                break
    # the walks that died on the last iteration commit here
    died = ~st.active & (scnt < sidx)
    _commit(acc, pend, died, slot)
    scnt = scnt + died.to(torch.int32)
    if hooks is not None:
        hooks.finish(st.active)
    done = torch.stack([torch.where(slot > k, quota[k],
                                    torch.where(slot == k, scnt, 0))
                        for k in range(S)])
    return ChunkOut(acc=acc, done=done, lsteps=lsteps, steps=steps,
                    iters=it, resolved=resolved, capped=capped,
                    checks=checks)


def flush_balanced(image, acc, done, pix, n_pixels: int):
    """A chunk's slot sums into the pixel sums ``image`` (N, 6) by each
    piece's pixel (reference wost.py:942-951): (image', the committed
    samples a pixel (N,) int32)."""
    flat = pix.reshape(-1)
    image = image.index_add(0, flat, acc.reshape(-1, acc.shape[-1]))
    done_pix = torch.zeros(n_pixels, dtype=torch.int32, device=pix.device)
    return image, done_pix.index_add_(0, flat, done.reshape(-1))


@dataclass
class BalancedResult:
    """A balanced solve's pixel sums of the samples and of their squares
    (N, 3) each, unnormalised (rescaled to ``spp`` samples where a pixel
    completed fewer), each pixel's completed samples, its counts (live
    lane-steps, exactly resolved lane-steps, walks capped alive) and one
    record a round."""

    image: torch.Tensor
    image_sq: torch.Tensor
    done: np.ndarray      # (N,) completed samples a pixel (spp if baked)
    steps: int
    resolved: int
    capped: int
    rounds: list


def round_record(out: ChunkOut, lanes: int, cap: int) -> dict:
    """The host's reads of one round (a sync, once a round)."""
    steps, iters = int(out.steps), int(out.iters)
    return {"lanes": lanes, "cap": cap, "iters": iters, "steps": steps,
            "resolved": int(out.resolved), "capped": int(out.capped),
            "checks": out.checks,
            "occupancy": steps / max(iters * lanes, 1)}


def probe_cost(lsteps: np.ndarray, done: np.ndarray,
               max_depth: int) -> np.ndarray:
    """Each pixel's steps a sample from the identity-partition probe:
    lane steps over completed samples, the mean where a pixel completed
    none, at least 1 and at most ``max_depth`` (reference
    wost.py:1343-1357)."""
    c = lsteps.astype(np.float64) / np.maximum(done, 1)
    have = done > 0
    fallback = float(c[have].mean()) if have.any() else 8.0
    cost = np.where(have, np.maximum(c, 1.0), max(fallback, 1.0))
    return np.minimum(cost, float(max_depth))


def initial_image(in_shell0, contrib0, spp: int):
    """(N, 6): the pixels in the shell at their first step, baked with
    ``spp`` samples of contrib0 (reference wost.py:970-972), and the sum
    of their squares."""
    c = torch.where(in_shell0[:, None], contrib0, 0.0)
    return torch.cat([spp * c, spp * (c * c)], 1)


def balanced_solve(step_fn, scene, extra, pts, rd0, resolved: np.ndarray,
                   contrib0, in_shell0, *, spp: int, max_depth: int,
                   seed: int, phase: int, cost0=None, cost_sink=None,
                   progress=None,
                   lane_target: int = LANE_TARGET) -> BalancedResult:
    """Round-based balanced solve of ``spp`` samples a pixel (reference
    wost.py:1137-1423, without its time budget).  ``pts`` (N, D) and
    ``rd0`` (N,) on the device; ``resolved`` (N,) host bool marks the
    pixels baked analytically (in the shell at step 0, or masked).

    Round 0 runs the identity partition for min(PROBE_SPP, spp) samples
    at cap PROBE_CAP and measures each pixel's cost (shared through
    ``cost_sink``), unless ``cost0`` gives it; later rounds split the
    remaining samples into cost-balanced worklists at cap 1.35 x the
    ideal + 24, the last ones (ideal <= max_depth) at a quarter of the
    width from TAIL_MIN_LANES up with room for every walk to finish.  A
    pixel left without a sample after the last round (8 + 4 (1 + spp x
    max_depth / ITER_CAP_MAX) rounds) gets one more round of one sample,
    and the sums are rescaled by the completed counts."""
    n = pts.shape[0]
    S = N_PIECES
    m = oversub_lanes(n, spp, lane_target)
    image = initial_image(in_shell0, contrib0, spp)
    rem = np.where(resolved, 0, spp).astype(np.int64)
    cost = np.ones(n)
    max_rounds = 8 + 4 * (1 + spp * max_depth // ITER_CAP_MAX)
    have_cost0 = cost0 is not None
    if have_cost0:
        cost = np.maximum(np.asarray(cost0, np.float64), 1.0)
        piece_pix, piece_quota = build_balanced_pieces(rem, cost, m, S)
    else:
        piece_pix, piece_quota = identity_pieces(
            n, np.where(resolved, 0, min(PROBE_SPP, spp)))
    gens = stage_generators(pts.device)
    rounds, total = [], dict(steps=0, resolved=0, capped=0)
    n_walked = max(float(np.sum(~resolved)) * spp, 1.0)

    def run(round_i, cap, piece_pix, piece_quota):
        nonlocal image, rem
        pieces = make_pieces(pts, rd0, piece_pix, piece_quota)
        out = run_chunk(step_fn, scene, extra, pieces, max_depth=max_depth,
                        iter_cap=cap,
                        round_seed=balanced_seed(seed, phase, round_i),
                        gens=gens)
        image, done_pix = flush_balanced(image, out.acc, out.done,
                                         pieces.pix, n)
        done = done_pix.cpu().numpy().astype(np.int64)
        rem = np.maximum(rem - done, 0)
        rec = round_record(out, piece_pix.shape[1], cap)
        rounds.append(rec)
        for k in total:
            total[k] += rec[k]
        return out, done

    for round_i in range(max_rounds):
        if rem.sum() == 0:
            break
        n_round = m
        if round_i == 0 and not have_cost0:
            n_round, cap = n, PROBE_CAP
        else:
            ideal = ideal_full = int(np.ceil(float((rem * cost).sum()) / m))
            if ideal_full <= max_depth and m >= TAIL_MIN_LANES:
                # tail: a depth step costs its full width whether lanes
                # live or not, so pack the leftovers into a quarter
                n_round = m // 4
                ideal = int(np.ceil(ideal * m / n_round))
            cap = min(int(1.35 * ideal) + 24, ITER_CAP_MAX)
            if ideal_full <= max_depth:
                # the last round: room for every walk to finish
                cap = min(max_depth + 2 * ideal + 64, ITER_CAP_MAX)
        if round_i > 0 or piece_pix.shape[1] != n_round:
            piece_pix, piece_quota = build_balanced_pieces(rem, cost,
                                                           n_round, S)
        out, done = run(round_i, cap, piece_pix, piece_quota)
        if round_i == 0 and not have_cost0:
            cost = probe_cost(out.lsteps.cpu().numpy(), done, max_depth)
            if cost_sink is not None:
                cost_sink(cost)
        if progress is not None:
            progress(int((1.0 - rem.sum() / n_walked) * 100), 100)

    done_total = np.where(resolved, spp, spp - rem)
    if rem.sum() > 0:
        zero = ~resolved & (rem >= spp)
        if zero.any():
            # the unbiasedness floor: a pixel with no completed sample
            # would rescale to 0, so give each one walk room to finish
            piece_pix, piece_quota = build_balanced_pieces(
                zero.astype(np.int64), cost, n, S)
            run(max_rounds + 1, max_depth + 8, piece_pix, piece_quota)
            done_total = np.where(resolved, spp, spp - rem)
        log_warning("balanced_solve: %d of %d samples left after %d rounds;"
                    " rescaling each pixel's sums by its completed samples",
                    int(rem.sum()), int(n_walked), max_rounds)
        scale = torch.as_tensor(spp / np.maximum(done_total, 1),
                                dtype=torch.float32, device=pts.device)
        image = image * scale[:, None]
    return BalancedResult(image=image[:, :3], image_sq=image[:, 3:],
                          done=done_total, rounds=rounds, **total)
