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

With ``time_budget_s`` the rounds are time-sliced (``BudgetSlicer``, the
JAX package's policy): a probe of at most 2 samples a pixel, then
proportional round quotas over shuffled worklists, each round's cap
bounded so that its predicted wall fits half of the budget left, and the
partial sums rescaled by each pixel's completed samples.  The port's
round differs from the JAX package's in what a budget must count: its
walks in flight drain after the cap (up to ``max_depth`` iterations),
the host partitions the worklists before it (numpy passes over every
pixel), and on the card an iteration is host-bound, about as long at
a quarter of the lanes as at all of them.  So the slicer predicts a
round's wall from the seconds an iteration measured at its width and
the host's part (the hints of earlier solves seed them), subtracts the
drain from the slice's iterations, stops where even the shortest round
no longer fits, and shrinks the quotas to what the cap can start.

Under a group of ranks (``parallel/dp.Group``, the JAX package's device
mesh, wost.py:792-940) the lanes are sharded: every rank computes the
same partition of the whole frame (the same probe costs, the same seeded
shuffle) and runs ``run_chunk`` on its own contiguous slice of the
round's worklists, on streams of its own (``round_seed``), with no
collective inside a round; at the round's end the ranks add their sums
and completed counts into full-frame tensors and sum them, with the
steps (``close_round``), and take the largest iteration count, wall and
host time.  So every host decision after a round is the same on every
rank.  The lane width is a multiple of the group's size
(``oversub_lanes``' ``lane_multiple``), and so is a tail round's
(``tail_lanes``, or the tail keeps the full width).  A budget's slicer
reads one clock, rank 0's (``Group.clock``).

Left out, against the JAX package: the runtime-watchdog bounds on a
round's iteration cap (a guard against the TPU runtime's kill of long
dispatches), ``lane_cap`` (the TPU's SMEM gate on the lane-list width,
which the port's K1 does not have), the deterministic mode (no cap here
depends on a measured wall unless a budget is given) and the
``ELAINA_*`` knobs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.logger import log_warning
from ..utils.rng import balanced_seed, fold_rank, reseed, stage_generators
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
                          s: int = N_PIECES, shuffle=None):
    """Cost-balanced contiguous partition of the remaining samples into
    per-lane worklists (host numpy, reference wost.py:732-789).

    ``rem`` (P,) samples left a pixel, ``cost`` (P,) its estimated steps
    a sample.  Lane j gets up to ``s`` contiguous (pixel, quota) pieces
    whose cost adds up to ~W / M; a heavy pixel is split across
    consecutive lanes, and pieces past ``s`` stay in ``rem`` for the next
    round.  ``shuffle`` (a numpy Generator, budgeted rounds) permutes the
    pixels first, so that the samples a capped round leaves are a random
    subset of the pixels each round, not the same lists' tails.  Returns
    (piece_pix (s, M) int32, piece_quota (s, M) int32), quota 0 padding."""
    rem = rem.astype(np.int64)
    active = np.flatnonzero(rem > 0)
    piece_pix = np.zeros((s, n_lanes), np.int32)
    piece_quota = np.zeros((s, n_lanes), np.int32)
    if active.size == 0:
        return piece_pix, piece_quota
    if shuffle is not None:
        active = shuffle.permutation(active)
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


class BudgetSlicer:
    """The time-budget slicing of round-based solves (reference
    wost.py:984-1095), shared by ``balanced_solve`` and the guided
    training phase.  ``plan`` gives each round proportional quotas sized
    to fill half of the budget left at the measured walk-steps/s
    (``rate``, an EMA over the rounds seeded by ``rate0``), so that the
    slices shrink towards the deadline; ``bound_cap`` bounds the round's
    iteration cap to the slice.  ``plan``, ``update``'s rate, ``expired``
    and ``solve_rate`` are the JAX package's; ``iteration_wall``,
    ``bound_cap``, ``min_round_stop`` and ``fit_quota`` model the port's
    round (see there).  ``plan``, ``min_round_stop`` and ``expired`` read
    ``time.time()``, as the JAX package's slicer does, or ``clock`` where
    given (a group's: rank 0's time on every rank)."""

    def __init__(self, time_budget_s, start_time, rate0=None, iter0=None,
                 clock=None):
        self.budget = time_budget_s
        self.start = start_time
        self.clock = clock
        self.rate = float(rate0) if rate0 else None
        # a caller's rate0 is a prior from another solve or phase, trusted
        # for round 1's minimum-dispatch stop; a rate measured on this
        # solve's own round 0 is not
        self.trusted_prior = rate0 is not None
        self.slice_s = None
        # seconds an iteration by lane width, seeded by ``iter0`` (the
        # port's: the hints of earlier solves of this phase)
        self.iter_s = dict(iter0 or {})
        self.host_s = None      # a round's host seconds before its chunk
        self.r0_rate = None     # round 0's own walk-steps/s
        self.later = [0, 0.0]   # the later rounds' steps and wall

    def plan(self, rem, cost, round_i: int, probe_spp: int,
             have_cost: bool, n_lanes: int | None = None,
             floor: int | None = None):
        """The round's quotas: (rem_round, stop).  Without a budget, every
        remaining sample; without a rate (or on a probe round without a
        cost), a probe of at most 2 samples a pixel; else each pixel's
        remaining samples times one fraction (ceil: every pixel moves),
        1.3x the step capacity of half the budget left.  Stops once the
        budget is spent (after round 0), or from round 2 (round 1 with a
        trusted prior) once even the minimum dispatch, ``floor``
        iterations of ``n_lanes`` lanes, would overrun the budget left by
        half its own wall."""
        if self.budget is None:
            return rem, False
        remaining_s = self.budget - (self._now() - self.start)
        if remaining_s <= 0 and round_i > 0:
            return rem, True
        if self.rate is None or (round_i == 0 and not have_cost):
            return np.minimum(rem, min(probe_spp, 2)), False
        if n_lanes and floor and (round_i > 1
                                  or (round_i == 1 and self.trusted_prior)):
            min_wall = floor * n_lanes / self.rate
            if remaining_s < 0.5 * min_wall:
                return rem, True
        self.slice_s = 0.5 * remaining_s
        cap_steps = self.slice_s * self.rate
        total_cost = float((rem * np.maximum(cost, 1.0)).sum())
        if total_cost > cap_steps:
            frac = 1.3 * cap_steps / total_cost
            rem_round = np.minimum(rem, np.ceil(rem * frac)).astype(
                rem.dtype)
            return rem_round, False
        return rem, False

    def iteration_wall(self, n_lanes: int) -> float:
        """Predicted seconds of one iteration over ``n_lanes`` lanes: what
        this solve's rounds of that width measured (an EMA, as the rate);
        at a width not measured yet, the JAX package's ``n_lanes / rate``,
        but not below any width's measured iteration.  On the card an
        iteration is host-bound and costs about the same at any width:
        ``n_lanes / rate`` predicts a full-width round at its wall over its
        occupancy, and a quarter-width tail round at about a quarter of
        its wall."""
        if n_lanes in self.iter_s:
            return self.iter_s[n_lanes]
        return max([n_lanes / self.rate, *self.iter_s.values()])

    def min_round_stop(self, round_i: int, n_lanes: int,
                       iters: int) -> bool:
        """The port's form of ``plan``'s minimum-dispatch stop (which the
        port's callers leave out, passing it no ``n_lanes``): from round 2,
        or round 1 with a trusted prior, stop once the budget left is under
        half of the shortest round's predicted wall, ``iters`` iterations
        (the least cap and the drain) at ``iteration_wall(n_lanes)`` and
        the host's part before its chunk.  The JAX package counts max
        depth + 32 iterations at ``n_lanes / rate``, which on the card
        overestimates a full-width iteration by its occupancy."""
        if self.budget is None or self.rate is None:
            return False
        if not (round_i > 1 or (round_i == 1 and self.trusted_prior)):
            return False
        remaining_s = self.budget - (self._now() - self.start)
        return remaining_s < 0.5 * ((self.host_s or 0.0)
                                    + iters * self.iteration_wall(n_lanes))

    def bound_cap(self, cap: int, n_lanes: int, floor: int) -> int:
        """Bound an iteration cap to the slice, at least ``floor``.  Where
        no iteration was measured, the JAX package's bound, ``slice_s *
        rate / n_lanes`` iterations.  Else the port's: its cap bounds when
        samples start, and the walks in flight then run to their end (the
        drain, up to the depth, completes samples the cap let start), so
        the slice is the round's start window, the host's part and the
        cap: ``host_s + cap x iteration_wall(n_lanes) <= slice_s``.  The
        round's predicted wall overshoots its slice by its drain at most,
        and the halving slices keep the solve's overshoot under one round
        (``min_round_stop``).  On an H100 (80GB HBM3, 700 W) a slice less
        the drain (64 iterations, ~0.36 s there) and the host's part
        (~0.35 s) left half of lobed_u's full-solve wall ~5 of its 32
        samples a pixel (PERF.md)."""
        if self.budget is None or self.rate is None or self.slice_s is None:
            return cap
        if self.iter_s:
            iters = (self.slice_s - (self.host_s or 0.0)) / (
                self.iteration_wall(n_lanes))
        else:
            iters = self.slice_s * self.rate / max(n_lanes, 1)
        return min(cap, max(int(iters), floor))

    def fit_quota(self, rem, rem_round, cost, cap: int, n_lanes: int):
        """The port's quotas for a round capped at ``cap``: ``plan``'s,
        but at most 1.3x what the cap can start, ``cap x n_lanes`` steps (a
        busy lane walks a step an iteration), each pixel's remaining
        samples times one fraction, at least one.  ``plan`` sizes them to
        fill the whole slice, but the port's drain takes up to ``max_depth``
        of a round's iterations: quotas that the cap cannot start complete
        in each lane's order, so pixels at the lists' ends would get none
        (the JAX package's reason for proportional quotas)."""
        if self.budget is None or self.slice_s is None:
            return rem_round
        total_cost = float((rem * np.maximum(cost, 1.0)).sum())
        cap_steps = float(cap) * n_lanes
        if total_cost <= 1.3 * cap_steps:
            return rem_round
        frac = 1.3 * cap_steps / total_cost
        return np.minimum(rem_round, np.ceil(rem * frac).astype(rem.dtype))

    def update(self, steps: int, wall_s: float, iters: int | None = None,
               n_lanes: int | None = None, host_s: float = 0.0):
        """A round's live lane-steps and wall; the port's ``iters`` (the
        iterations it ran) over ``n_lanes`` lanes give its seconds an
        iteration at that width (for ``iteration_wall``), its wall less
        ``host_s``, the host's partition and upload before its chunk
        (kept as an EMA too, for ``bound_cap`` and ``min_round_stop``)."""
        r = steps / max(wall_s, 1e-9)
        self.rate = r if self.rate is None else 0.4 * self.rate + 0.6 * r
        if self.r0_rate is None:
            self.r0_rate = r
        else:
            self.later[0] += steps
            self.later[1] += wall_s
        if iters:
            t = max(wall_s - host_s, 0.0) / iters
            old = self.iter_s.get(n_lanes)
            self.iter_s[n_lanes] = t if old is None else 0.4 * old + 0.6 * t
            self.host_s = host_s if self.host_s is None else (
                0.4 * self.host_s + 0.6 * host_s)

    def solve_rate(self) -> float | None:
        """The walk-steps/s that a later solve starts from (reference
        wost.py:1396-1400): the larger of round 0's own and the later
        rounds' together (round 0 may carry a first call's overhead, and a
        short solve does nearly all its work in round 0)."""
        steps, wall = self.later
        rates = [r for r in (steps / wall if wall > 0 else None,
                             self.r0_rate) if r]
        return max(rates) if rates else None

    def expired(self) -> bool:
        return (self.budget is not None
                and self._now() - self.start > self.budget)

    def _now(self) -> float:
        return self.clock() if self.clock is not None else time.time()


def oversub_lanes(n: int, spp: int, lane_target: int = LANE_TARGET,
                  lane_multiple: int = 1) -> int:
    """The balanced solve's lane width (reference wost.py:1097-1112): a
    frame below ``lane_target`` pixels is widened towards it, at most to
    its total sample count, rounded down to a multiple of
    ``lane_multiple`` (a group's size), its pixels split across co-lanes
    (each lane draws its own numbers, so the split is unbiased); a larger
    frame keeps one lane a pixel."""
    if n >= lane_target:
        return n
    k = max(lane_multiple, 1)
    m = min(lane_target, n * max(int(spp), 1))
    return max((m // k) * k, n)


def tail_lanes(m: int, lane_multiple: int = 1) -> int:
    """A tail round's width (reference wost.py:1252-1255): a quarter of
    ``m`` lanes rounded down to a multiple of ``lane_multiple``; 0 where
    none is left (the tail then keeps its ``m`` lanes)."""
    k = max(lane_multiple, 1)
    return (m // 4) // k * k


def round_seed(seed: int, phase: int, round_i: int, group=None) -> int:
    """The seed of one round of a balanced solve on this rank: the
    round's (``balanced_seed``), with the rank folded in."""
    s = balanced_seed(seed, phase, round_i)
    return s if group is None else fold_rank(s, group.rank)


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
    the loop condition and ``ran`` the iterations the host ran (the
    drain's and up to ``CHECK_EVERY`` - 1 after it)."""

    acc: torch.Tensor
    done: torch.Tensor
    lsteps: torch.Tensor
    steps: torch.Tensor
    iters: torch.Tensor
    resolved: torch.Tensor
    capped: torch.Tensor
    checks: int
    ran: int


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
              check_every: int = CHECK_EVERY, hooks=None,
              group=None) -> ChunkOut:
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
    condition at its start), and at the end ``finish(active)``.

    ``group`` (a group's training phase, whose hooks issue collectives)
    runs the ranks in lockstep: the host reads the loop condition of every
    rank together (any rank's), so every rank runs the same iterations
    and calls its hooks alike; a rank that drained runs on, its
    iterations gated on the device as after the drain.  Without it each
    rank drains on its own."""
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

    checks = ran = 0
    n_iter = iter_cap + max_depth       # every walk dies by then
    for j in range(n_iter):
        ran = j + 1
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
            flag = more_of(st, slot, sidx, j + 1 < iter_cap)
            if group is not None:
                flag = group.any(flag)
            if not read_flag(flag):
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
                    checks=checks, ran=ran)


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


def round_record(out: ChunkOut, lanes: int, cap: int, wall: float,
                 host_s: float, probe: bool) -> dict:
    """The host's reads of one round (a sync, once a round), its wall
    seconds from its partition to its count read, the host's seconds
    before its chunk (the partition and upload), and whether it was a
    cost probe on the identity partition."""
    steps, iters = int(out.steps), int(out.iters)
    return {"lanes": lanes, "cap": cap, "iters": iters, "steps": steps,
            "resolved": int(out.resolved), "capped": int(out.capped),
            "checks": out.checks, "ran": out.ran, "wall": wall,
            "host_s": host_s, "probe": probe,
            "occupancy": steps / max(iters * lanes, 1),
            "rank_steps": steps}


def close_round(image, out: ChunkOut, pieces: Pieces, n_pixels: int,
                lanes: int, cap: int, t_r: float, t_c: float, probe: bool,
                group=None):
    """A round's end: its sums added to the pixel sums ``image`` (N, 6),
    each pixel's completed samples (host int64), the round's record
    (``round_record``; its wall from ``t_r``, the partition's time, to the
    count read) and, for a probe round on the identity partition, each
    pixel's lane steps (host), else None.  Under a group the ranks add
    their sums, counts and probe steps into full-frame tensors and sum
    them, and the record holds the steps of every rank (its own in
    ``rank_steps``) and the largest iterations, wall and host time of any:
    the same record on every rank."""
    if group is None:
        image, done_pix = flush_balanced(image, out.acc, out.done,
                                         pieces.pix, n_pixels)
        done = done_pix.cpu().numpy().astype(np.int64)   # waits: the wall
        rec = round_record(out, lanes, cap, time.time() - t_r, t_c - t_r,
                           probe)
        return image, done, rec, (out.lsteps.cpu().numpy() if probe
                                  else None)
    delta, done_pix = flush_balanced(torch.zeros_like(image), out.acc,
                                     out.done, pieces.pix, n_pixels)
    ints = [done_pix.long()]
    if probe:
        lsteps = torch.zeros(n_pixels, dtype=torch.int64,
                             device=image.device)
        lsteps[group.lanes(n_pixels)] = out.lsteps.long()
        ints.append(lsteps)
    ints.append(torch.stack([out.steps, out.resolved, out.capped]).long())
    ints = group.all_sum(torch.cat(ints))
    image = image + group.all_sum(delta)
    host = ints.cpu().numpy()                          # waits: the wall
    wall, host_s, iters, ran, checks = group.host_max(
        [time.time() - t_r, t_c - t_r, int(out.iters), out.ran, out.checks])
    steps, resolved, capped = (int(v) for v in host[-3:])
    iters, ran, checks = int(iters), int(ran), int(checks)
    rec = {"lanes": lanes, "cap": cap, "iters": iters, "steps": steps,
           "resolved": resolved, "capped": capped, "checks": checks,
           "ran": ran, "wall": wall, "host_s": host_s, "probe": probe,
           "occupancy": steps / max(iters * lanes, 1),
           "rank_steps": int(out.steps)}
    return (image, host[:n_pixels], rec,
            host[n_pixels:2 * n_pixels] if probe else None)


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


def hint_digest(cost=None, rate=None, iters=None) -> list:
    """Eight numbers that differ where two sets of a solve's hints (the
    pixels' costs, the walk rate, the seconds an iteration by width) do,
    for ``Group.check_same``."""
    c = np.zeros(0) if cost is None else np.asarray(cost, np.float64)
    it = sorted((iters or {}).items())
    return [float(cost is None), float(c.sum()),
            float((c * np.arange(c.size)).sum()), float(rate or 0.0),
            float(len(it)), float(sum(k for k, _ in it)),
            float(sum(v for _, v in it)), float(sum(k * v for k, v in it))]


def initial_image(in_shell0, contrib0, spp: int):
    """(N, 6): the pixels in the shell at their first step, baked with
    ``spp`` samples of contrib0 (reference wost.py:970-972), and the sum
    of their squares."""
    c = torch.where(in_shell0[:, None], contrib0, 0.0)
    return torch.cat([spp * c, spp * (c * c)], 1)


def balanced_solve(step_fn, scene, extra, pts, rd0, resolved: np.ndarray,
                   contrib0, in_shell0, *, spp: int, max_depth: int,
                   seed: int, phase: int, cost0=None, cost_sink=None,
                   progress=None, lane_target: int = LANE_TARGET,
                   time_budget_s=None, start_time=None, rate0=None,
                   rate_sink=None, iter0=None, iter_sink=None,
                   group=None) -> BalancedResult:
    """Round-based balanced solve of ``spp`` samples a pixel (reference
    wost.py:1137-1423).  ``pts`` (N, D) and ``rd0`` (N,) on the device;
    ``resolved`` (N,) host bool marks the pixels baked analytically (in
    the shell at step 0, or masked).

    Round 0 runs the identity partition for min(PROBE_SPP, spp) samples
    at cap PROBE_CAP and measures each pixel's cost (shared through
    ``cost_sink``), unless ``cost0`` gives it; later rounds split the
    remaining samples into cost-balanced worklists at cap 1.35 x the
    ideal + 24, the last ones (ideal <= max_depth) at a quarter of the
    width from TAIL_MIN_LANES up with room for every walk to finish.

    With ``time_budget_s`` (seconds from ``start_time``) the rounds are
    ``BudgetSlicer``'s: the probe takes at most 2 samples a pixel, later
    rounds proportional quotas over worklists shuffled each round, caps
    bounded to the slice; a round whose samples left are below 1/2000 of
    the solve's is not run (the drain-skip), and the solve stops at a
    round boundary once the budget is spent.  ``rate0`` seeds the
    walk-steps/s estimate, and ``rate_sink`` is given the solve's rate
    (the larger of round 0's and the later rounds' together), with or
    without a budget; ``iter0`` and ``iter_sink`` do the same for the
    seconds an iteration by lane width (``BudgetSlicer.iter_s``).  A
    pixel left without a sample after the last round gets one more round
    of one sample on a lane of its own, and the sums are rescaled by the
    completed counts.

    ``group``: the lanes sharded over its ranks (see the module's
    docstring); ``pts``, ``rd0``, ``resolved``, ``contrib0`` and
    ``in_shell0`` are the whole frame's on every rank, the frame's pixel
    count a multiple of the group's size, and the result is the whole
    frame's, the same on every rank (its step-0 sums counted once)."""
    n = pts.shape[0]
    S = N_PIECES
    mult = 1 if group is None else group.size
    m = oversub_lanes(n, spp, lane_target, mult)
    image = initial_image(in_shell0, contrib0, spp)
    rem = np.where(resolved, 0, spp).astype(np.int64)
    cost = np.ones(n)
    max_rounds = 8 + 4 * (1 + spp * max_depth // ITER_CAP_MAX)
    spp_w = min(PROBE_SPP, spp)
    have_cost0 = cost0 is not None
    if have_cost0:
        cost = np.maximum(np.asarray(cost0, np.float64), 1.0)
    budget_mode = time_budget_s is not None
    clock = None if group is None else group.clock
    if group is not None:
        group.check_same("the balanced solve's hints",
                         hint_digest(cost0, rate0, iter0))
    slicer = BudgetSlicer(time_budget_s, start_time or (clock or time.time)(),
                          rate0, iter0, clock)
    shuffle = np.random.default_rng(0xE1A) if budget_mode else None
    gens = stage_generators(pts.device)
    rounds, total = [], dict(steps=0, resolved=0, capped=0)
    n_walked = max(float(np.sum(~resolved)) * spp, 1.0)
    # the shortest round: the least cap and the drain
    min_round = 2 * CHECK_EVERY + max_depth

    def run(round_i, cap, piece_pix, piece_quota, t_r, probe=False):
        """One round from its partition, made at ``t_r``, on this rank's
        lanes of it."""
        nonlocal image, rem
        lanes = piece_pix.shape[1]
        sl = slice(None) if group is None else group.lanes(lanes)
        pieces = make_pieces(pts, rd0, piece_pix[:, sl], piece_quota[:, sl])
        t_c = time.time()
        out = run_chunk(step_fn, scene, extra, pieces, max_depth=max_depth,
                        iter_cap=cap,
                        round_seed=round_seed(seed, phase, round_i, group),
                        gens=gens)
        image, done, rec, lsteps = close_round(image, out, pieces, n, lanes,
                                               cap, t_r, t_c, probe, group)
        rem = np.maximum(rem - done, 0)
        rounds.append(rec)
        for k in total:
            total[k] += rec[k]
        return lsteps, done, rec

    interrupted = False
    for round_i in range(max_rounds):
        if rem.sum() == 0:
            break
        if budget_mode and round_i > 0 and rem.sum() < max(
                1, int(n_walked) // 2000):
            # the drain-skip: a round for < 1/2000 of the samples commits
            # almost nothing; the rescale below stays unbiased
            interrupted = True
            break
        rem_round, stop = slicer.plan(rem, cost, round_i, spp_w, have_cost0)
        if stop or slicer.min_round_stop(round_i, m, min_round):
            interrupted = True
            break
        n_round = m
        probe = round_i == 0 and not have_cost0
        if probe:
            n_round, cap = n, PROBE_CAP
        else:
            ideal = int(np.ceil(float((rem_round * cost).sum()) / m))
            # the tail decision looks at all the remaining work, not at the
            # budget's round quotas
            ideal_full = int(np.ceil(float((rem * cost).sum()) / m))
            if (ideal_full <= max_depth and m >= TAIL_MIN_LANES
                    and tail_lanes(m, mult)):
                # tail: a depth step costs its full width whether lanes
                # live or not, so pack the leftovers into a quarter (of a
                # group's size's multiple)
                n_round = tail_lanes(m, mult)
                ideal = int(np.ceil(ideal * m / n_round))
            cap = min(int(1.35 * ideal) + 24, ITER_CAP_MAX)
            if ideal_full <= max_depth:
                # the last round: room for every walk to finish
                cap = min(max_depth + 2 * ideal + 64, ITER_CAP_MAX)
        cap = slicer.bound_cap(cap, n_round, CHECK_EVERY)
        t_r = time.time()
        if probe:
            # the identity partition, with the slice's quota under a budget
            piece_pix, piece_quota = identity_pieces(
                n, np.minimum(rem_round, spp_w))
        else:
            piece_pix, piece_quota = build_balanced_pieces(
                slicer.fit_quota(rem, rem_round, cost, cap, n_round), cost,
                n_round, S, shuffle=shuffle)
        lsteps, done, rec = run(round_i, cap, piece_pix, piece_quota, t_r,
                                probe)
        slicer.update(rec["steps"], rec["wall"], rec["ran"], rec["lanes"],
                      rec["host_s"])
        if probe:
            cost = probe_cost(lsteps, done, max_depth)
            if cost_sink is not None:
                cost_sink(cost)
        if progress is not None and (group is None or group.rank == 0):
            progress(int((1.0 - rem.sum() / n_walked) * 100), 100)
        if slicer.expired() and rem.sum() > 0:
            interrupted = True
            break

    if rate_sink is not None and slicer.solve_rate():
        rate_sink(slicer.solve_rate())
    if iter_sink is not None:
        iter_sink(slicer.iter_s)
    done_total = np.where(resolved, spp, spp - rem)
    if rem.sum() > 0:
        zero = ~resolved & (rem >= spp)
        if zero.any():
            # the unbiasedness floor: a pixel with no completed sample
            # would rescale to 0, so give each one a lane and room for its
            # walk to finish
            piece_pix, piece_quota = identity_pieces(n, zero)
            run(max_rounds + 1, max_depth + 8, piece_pix, piece_quota,
                time.time())
            done_total = np.where(resolved, spp, spp - rem)
        log_warning("balanced_solve: %d of %d samples left after %d rounds"
                    "%s; rescaling each pixel's sums by its completed "
                    "samples", int(rem.sum()), int(n_walked), len(rounds),
                    " (time budget)" if interrupted else "")
        scale = torch.as_tensor(spp / np.maximum(done_total, 1),
                                dtype=torch.float32, device=pts.device)
        image = image * scale[:, None]
    return BalancedResult(image=image[:, :3], image_sq=image[:, 3:],
                          done=done_total, rounds=rounds, **total)
