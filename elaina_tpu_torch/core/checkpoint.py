"""Checkpoint and resume of the guided solve: the trainer and the sums.

Port of ``elaina_tpu/core/checkpoint.py`` in its ``.npz`` layout, so that
a file written by either package loads in the other.  The trainer file
holds ``params/<name>``, ``ema/<name>``, ``mu/<name>`` and ``nu/<name>``
(the network's parameters, their EMA and the Adam moments, named as the
JAX package names them), ``opt_count`` and, with ``extra``, ``extra_json``
(a JSON object as uint8 bytes: the guided solve writes its ``spp`` and
``net_trained``).  The solve-state file holds ``solution_sum`` (N, 3),
``spp_done`` and ``extra_json``; the port also writes the per-pixel sums
of squares, ``solution_sq_sum``, which the JAX package's file lacks.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..nn.network import TrainerState, trainer_from_numpy, trainer_to_numpy

# the file's groups and the fields of ``trainer_to_numpy`` they hold
_GROUPS = (("params", "params"), ("ema", "ema_params"), ("mu", "mu"),
           ("nu", "nu"))


def _extra_bytes(extra: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(extra).encode(), dtype=np.uint8)


def _extra_of(z) -> dict:
    if "extra_json" not in z.files:
        return {}
    return json.loads(bytes(z["extra_json"]).decode())


def save_trainer(path: str, trainer: TrainerState,
                 extra: dict | None = None) -> None:
    """Write the trainer to ``path`` (``np.savez``: ``.npz`` is added to a
    path without it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = trainer_to_numpy(trainer)
    payload = {f"{group}/{k}": v for group, field in _GROUPS
               for k, v in host[field].items()}
    payload["opt_count"] = np.asarray(host["count"], np.int32)
    if extra:
        payload["extra_json"] = _extra_bytes(extra)
    np.savez(path, **payload)


def load_trainer(path: str, device: torch.device = torch.device("cpu")
                 ) -> tuple[TrainerState, dict]:
    """The trainer of a file that either package wrote, on ``device``, and
    its ``extra`` (empty where the file has none)."""
    with np.load(path) as z:
        groups = {field: {k[len(group) + 1:]: z[k] for k in z.files
                          if k.startswith(group + "/")}
                  for group, field in _GROUPS}
        count = int(z["opt_count"])
        extra = _extra_of(z)
    return trainer_from_numpy(groups["params"], groups["ema_params"],
                              groups["mu"], groups["nu"], count,
                              device), extra


def save_solve_state(path: str, solution_sum, spp_done: int,
                     extra: dict | None = None,
                     solution_sq_sum=None) -> None:
    """Write the per-pixel sums (N, 3) of ``spp_done`` samples and, where
    given, their squares' sums."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"solution_sum": _host(solution_sum),
               "spp_done": np.int64(spp_done),
               "extra_json": _extra_bytes(extra or {})}
    if solution_sq_sum is not None:
        payload["solution_sq_sum"] = _host(solution_sq_sum)
    np.savez(path, **payload)


def load_solve_state(path: str):
    """(solution_sum (N, 3) numpy, spp_done, extra, solution_sq_sum (N, 3)
    numpy or None where the file has none, as the JAX package's)."""
    with np.load(path) as z:
        sq = z["solution_sq_sum"] if "solution_sq_sum" in z.files else None
        return z["solution_sum"], int(z["spp_done"]), _extra_of(z), sq


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
