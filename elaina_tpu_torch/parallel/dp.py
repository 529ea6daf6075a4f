"""Data parallelism over walks: the lanes sharded over the ranks of a
``torch.distributed`` process group.

Port of ``elaina_tpu/parallel/dp.py``.  The reference is single-GPU; the
JAX package shards the lane (pixel, walk) axis over a 1-D device mesh.
Here one process runs a rank on one device (``cuda:<local rank>``, or
the CPU), and a ``Group`` (``make_group``) stands where the JAX package
has a mesh.  The walks are sharded over the lanes: each rank holds a
contiguous slice of them (``Group.lanes``, ``shard_lanes``); the scene,
the frame's points and the guide are replicated (every rank builds the
same ones, or ``replicate`` broadcasts them from rank 0).  Every rank runs
the port's depth step, and with it its CUDA kernels, on its own lanes.

The collectives are ``all_reduce`` and ``broadcast`` only, the two that
gloo runs on CUDA tensors as well, so the same code runs on N cards under
NCCL and on one card under gloo (``make_group(..., backend="gloo",
device="cuda:0")``, two ranks on one card: correct, but it measures no
scaling, since gloo's CUDA all-reduce waits for the device).  A film is
summed as a full-frame ``all_reduce`` (each rank adds its lanes' sums
into a zero frame), never gathered.  Each rank's random streams fold its
rank into the seeds (``utils/rng.fold_rank``), the counterpart of
``fold_in(key, axis_index)``.

Every process group has a timeout (``CPU_TIMEOUT_S`` on the CPU): ranks
whose collectives fall out of step fail at a collective, they do not hang.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, fields, is_dataclass, replace

import torch
import torch.distributed as dist

from ..nn.network import (AdamConfig, NetworkSpec, TrainerState,
                          adam_ema_step, apply_network)
from ..solver import guided as G
from ..solver.distributions import (M_EPSILON, vmm_from_raw, vmm_pdf,
                                    vmm_selection_prob)
from ..solver.sampling import (uniform_sample_hemisphere_pdf,
                               uniform_sample_sphere_pdf)
from ..solver.wost import run_one_sample
from ..utils.mathops import reflect
from ..utils.rng import fold_rank, sample_generators

CPU_TIMEOUT_S = 60     # a CPU group's timeout: collectives out of step fail
CUDA_TIMEOUT_S = 900   # a card's: rank 0 alone builds the scene's grids
#                        (the slowest, neumann3d's SilGrid, ~90 s on an
#                        H100's host) while the others wait for it


@dataclass
class Group:
    """One rank's view of its process group: its rank, the group's size,
    its local rank (its card on a host), its device and the process group
    (``pg``).  The collectives act on tensors on ``device``."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    pg: object

    def lanes(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` lanes."""
        if n % self.size:
            raise ValueError(f"{n} lanes do not divide over {self.size} "
                             f"ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.pg)
        return t

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s largest value over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.pg)
        return t

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool on the device: whether ``flag`` holds on any rank
        (no read to the host)."""
        x = self.all_sum(flag.to(torch.int32).reshape(1))
        return x[0] > 0

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` as rank ``src`` holds it, in place."""
        dist.broadcast(t, src, group=self.pg)
        return t

    def host_max(self, values) -> list:
        """Host numbers, each the largest over the ranks."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        return self.all_max(t).tolist()

    def host_sum(self, values) -> list:
        """Host integers, each summed over the ranks."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        return self.all_sum(t).tolist()

    def check_same(self, label: str, values) -> None:
        """Raise on every rank unless each of ``values`` (host numbers) is
        the same on every rank: what the ranks must decide alike from
        (a partition's costs, a budget's priors) was not."""
        hi = self.host_max(values)
        lo = self.host_max([-float(v) for v in values])
        if any(h != -l for h, l in zip(hi, lo)):
            raise RuntimeError(f"{label} differ across the ranks: "
                               f"{list(zip([-v for v in lo], hi))}")

    def clock(self) -> float:
        """Rank 0's ``time.time()``: one clock for every decision that the
        ranks must take alike (a time budget's)."""
        t = torch.tensor([time.time()], dtype=torch.float64,
                         device=self.device)
        return float(self.broadcast(t)[0])

    def barrier(self) -> None:
        """Wait until every rank reaches this point."""
        float(self.all_sum(torch.zeros(1, device=self.device))[0])

    def by_rank(self, value: int) -> list:
        """Each rank's ``value``, in rank order, on every rank."""
        out = [0] * self.size
        out[self.rank] = int(value)
        return self.host_sum(out)

    def replicate(self, tree):
        """``tree`` with every tensor broadcast from rank 0 (dicts, lists,
        tuples, named tuples and dataclasses are walked; other leaves
        stay).  A tensor off the group's device goes through it and
        back."""
        if torch.is_tensor(tree):
            t = tree.detach().to(self.device).contiguous().clone()
            return self.broadcast(t).to(tree.device)
        if isinstance(tree, dict):
            return {k: self.replicate(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(self.replicate(v) for v in tree))
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.replicate(v) for v in tree)
        if is_dataclass(tree) and not isinstance(tree, type):
            return replace(tree, **{f.name: self.replicate(getattr(tree,
                                                                   f.name))
                                    for f in fields(tree) if f.init})
        return tree

    def close(self) -> None:
        """Destroy the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_group(n_devices: int | None = None, backend: str | None = None, *,
               device=None, rank: int | None = None,
               local_rank: int | None = None, init_method: str | None = None,
               timeout_s: float | None = None) -> Group:
    """This process's rank of a group of ``n_devices`` ranks (the
    counterpart of ``make_mesh``).  The rank, the local rank and the
    rendezvous are the arguments', else ``torchrun``'s environment
    (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``; ``init_method`` "env://",
    ``MASTER_ADDR`` and ``MASTER_PORT``).  It initializes the process's
    default process group.

    ``device`` "cuda" (the default) takes ``cuda:<local rank>`` and the
    NCCL backend, one card a rank: fewer visible cards than the ranks on a
    host (``LOCAL_WORLD_SIZE``, else ``n_devices``), or a rank on another
    rank's card, raises before any rendezvous.  "cpu" takes gloo.  gloo
    with CUDA tensors is taken only where the caller names it
    (``backend="gloo"`` and a CUDA ``device``, which may name one card for
    every rank).  ``timeout_s`` bounds every collective (default
    ``CPU_TIMEOUT_S`` on the CPU, ``CUDA_TIMEOUT_S`` on the card)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only: use gloo on the "
                         "CPU")
    env = os.environ
    from_env = rank is None
    if from_env:
        if "RANK" not in env:
            raise RuntimeError(
                "a group of ranks needs each process's rank: run the ranks "
                "under torchrun (RANK, WORLD_SIZE, LOCAL_RANK), or `python "
                "-m elaina_tpu_torch run --devices N`, which spawns them")
        rank = int(env["RANK"])
    size = int(n_devices if n_devices is not None
               else env.get("WORLD_SIZE", 1))
    if from_env and int(env.get("WORLD_SIZE", size)) != size:
        raise ValueError(f"{size} ranks asked for, WORLD_SIZE="
                         f"{env['WORLD_SIZE']}")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("PyTorch sees no CUDA device: run the ranks "
                               "on the CPU with device='cpu' (gloo)")
        count = torch.cuda.device_count()
        if backend == "nccl":
            on_host = int(env.get("LOCAL_WORLD_SIZE", size))
            if on_host > count:
                raise RuntimeError(
                    f"{on_host} NCCL ranks on a host with {count} visible "
                    f"CUDA device(s): NCCL takes one card a rank (two "
                    f"ranks on one card: backend='gloo')")
            if dev.index is not None and dev.index != local_rank:
                raise RuntimeError(f"NCCL rank {rank} (local rank "
                                   f"{local_rank}) on {dev}: each rank takes "
                                   f"cuda:<local rank>")
        if dev.index is None:
            if local_rank >= count:
                raise RuntimeError(f"local rank {local_rank} but {count} "
                                   f"visible CUDA device(s)")
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if timeout_s is None:
        timeout_s = CPU_TIMEOUT_S if dev.type == "cpu" else CUDA_TIMEOUT_S
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return Group(rank=rank, size=size, local_rank=local_rank, device=dev,
                 backend=backend, pg=dist.group.WORLD)


def shard_lanes(group: Group, *tensors):
    """Each lane-major tensor's slice of this rank (the lane axis, dim 0,
    split in contiguous equal parts over the ranks)."""
    out = [t[group.lanes(t.shape[0])] for t in tensors]
    return tuple(out) if len(out) > 1 else out[0]


def replicate(group: Group, tree):
    """``tree`` as rank 0 holds it, on every rank (``Group.replicate``)."""
    return group.replicate(tree)


def sharded_uniform_sample(group: Group, scene, eval_points, mask,
                           seed: int, sample: int, *, eps: float,
                           max_depth: int):
    """One sample of the uniform solver on this rank's lanes
    (``eval_points``, ``mask``: its shard, ``shard_lanes``), each rank on
    its own streams (``fold_rank``): (contribution (n_local, 3), the live
    lane-steps summed over the ranks, a 0-dim tensor).  A pure map: the
    step count is the only collective."""
    gens = sample_generators(fold_rank(seed, group.rank), sample,
                             eval_points.device)
    contrib, steps, _, _ = run_one_sample(scene, eval_points, mask, gens,
                                          eps=eps, max_depth=max_depth)
    return contrib, group.all_sum(steps.reshape(1))[0]


def sharded_guided_spp(group: Group, scene, spec: NetworkSpec,
                       infer_params: dict, box, eval_points, mask,
                       seed: int, sample: int, training_on: bool,
                       uniform_fraction: float, max_guided_depth: int, *,
                       eps: float, max_depth: int):
    """One guided sample on this rank's lanes: (contribution (n_local,
    3), the records of its lanes (None unless ``training_on``), the live
    lane-steps summed over the ranks).  The records stay on their rank."""
    gens = sample_generators(fold_rank(seed, group.rank), sample,
                             eval_points.device)
    contrib, records, steps, _, _ = G.run_one_guided_sample(
        scene, spec, infer_params, box, eval_points, mask, gens, True,
        training_on, uniform_fraction, max_guided_depth, eps=eps,
        max_depth=max_depth)
    return contrib, records, group.all_sum(steps.reshape(1))[0]


def _loss_sums(params: dict, spec: NetworkSpec, dim: int, x, wi, Li,
               dir_pdf, on_neumann, normal, valid):
    """The guided objective's sums over the valid records (the mean form
    is ``guided._train_loss``), for a mean over every rank's records:
    (sum of the loss terms, sum of the KL terms)."""
    raw = apply_network(spec, params, x)
    vmm = vmm_from_raw(raw, dim)
    p = vmm_pdf(vmm, wi, dim)
    p_r = vmm_pdf(vmm, reflect(wi, normal), dim)
    guide_pdf = torch.where(on_neumann, p + p_r, p) + M_EPSILON
    sp = vmm_selection_prob(raw, dim)
    dir_pdf = dir_pdf + M_EPSILON
    kl = -Li / dir_pdf * torch.log(guide_pdf)
    uniform_pdf = torch.where(on_neumann, uniform_sample_hemisphere_pdf(dim),
                              uniform_sample_sphere_pdf(dim))
    sp_term = (-G.SELECTION_MIS_E) * Li * (
        guide_pdf.detach() - uniform_pdf) / (dir_pdf ** 2) * sp
    return (torch.sum(torch.where(valid, kl + sp_term, 0.0)),
            torch.sum(torch.where(valid, kl, 0.0)))


def sharded_train_on_records(group: Group, trainer: TrainerState,
                             spec: NetworkSpec, adam_cfg: AdamConfig, box,
                             records, *, batch_size: int, n_batches: int):
    """Data-parallel training on the records of every rank's lanes
    (``records``: this rank's): each batch, each rank's gradient of its
    loss sum over ``batch_size // size`` records, summed over the ranks
    and divided by the ranks' valid records counted together (at least
    1); then the replicated Adam + EMA step, so that the ranks' trainers
    stay equal.  No gate on the valid count (the JAX function has none;
    ``adam_ema_step`` still drops a nonfinite gradient).  A batch's start
    is clamped to the buffer (``dynamic_slice_in_dim``), where
    ``train_on_records`` wraps it.  Returns (trainer', the mean KL metric
    as a 0-dim tensor, the same on every rank)."""
    R, n_local = records.dir_pdf.shape
    dim = records.pos.shape[-1]
    total = R * n_local
    dev = records.cur.device
    r_idx = torch.arange(R, device=dev)[:, None]
    base_valid = (r_idx < records.cur[None, :]).reshape(total)
    pos = records.pos.reshape(total, dim)
    x = G.normalize_coord(pos, box.lo, box.hi)
    wi = records.dir.reshape(total, dim)
    dir_pdf = records.dir_pdf.reshape(total)
    thp = records.thp.reshape(total)
    sol = records.sol.reshape(total, 3)
    on_b = records.on_neumann.reshape(total)
    normal = records.normal.reshape(total, dim)
    sol_n = torch.where(torch.abs(thp)[:, None] > 1e-5, sol / thp[:, None],
                        0.0)
    Li = torch.mean(torch.abs(sol_n), dim=-1)
    valid = (base_valid & G._in_box(pos, box) & (dir_pdf > 0)
             & torch.isfinite(Li))
    local_batch = max(1, batch_size // group.size)
    width = min(local_batch, total)
    names = sorted(trainer.params)
    metric = torch.zeros((), device=dev)
    for i in range(n_batches):
        start = max(min(i * local_batch, total - width), 0)
        s = slice(start, start + width)
        params = {k: v.detach().requires_grad_()
                  for k, v in trainer.params.items()}
        loss_sum, kl_sum = _loss_sums(params, spec, dim, x[s], wi[s], Li[s],
                                      dir_pdf[s], on_b[s], normal[s],
                                      valid[s])
        grads = torch.autograd.grad(loss_sum, [params[k] for k in names])
        buf = group.all_sum(torch.cat(
            [g.reshape(-1) for g in grads]
            + [valid[s].sum().to(torch.float32).reshape(1),
               kl_sum.detach().reshape(1)]))
        count = torch.clamp(buf[-2], min=1.0)
        parts = torch.split(buf[:-2], [g.numel() for g in grads])
        trainer = adam_ema_step(
            trainer, {k: p.reshape(g.shape) / count
                      for k, p, g in zip(names, parts, grads)}, adam_cfg)
        metric = metric + buf[-1] / count
    return trainer, metric / n_batches
