"""Dirichlet-resolve kernels K1-K3: wrappers, plain versions, build.

Port of ``elaina_tpu/ops/pallas_resolve.py`` (``compact_lanes``,
``sweep_resolve``, ``fetch_colors``).  The CUDA sources are in
``csrc/resolve.cu``, compiled with nvcc for sm_90a into ``_build/`` at the
first launch and bound through ctypes (pointers and the current stream as
``c_void_p``).  Each wrapper checks its inputs, allocates its outputs with
``torch.empty``, launches on the current stream and counts its launches in
``<wrapper>.launches``.  A CPU tensor takes the plain PyTorch version
beside the kernel; a CUDA tensor launches the kernel or raises.

Contracts (from the TPU kernels, minus the bitmask words):

* ``compact_lanes(mask, cap) -> (lanes (cap,) i32, cnt (1,) i32)``: ids of
  the set lanes in ascending order; ``cnt`` counts every set lane, even
  past ``cap``; entries past ``min(cnt, cap)`` are unspecified.
* ``sweep_resolve(mask, row, q, coords, cand) -> (d, t, side, pid)``: on
  masked lanes, the exact closest of the K candidates of row ``row``:
  distance, segment parameter t in [0, 1], the winner's cross product
  ``e x (q - a)`` (prim_side's sign) and its prim id; the smallest slot
  wins ties.  Unmasked lanes give 0, 0, 0, -1.
* ``fetch_colors(mask, cfi, color_rows) -> (c0, c1)``: on masked lanes,
  the two endpoint colors of row ``cfi`` of the (2P, 6) table; 0 on
  unmasked lanes and rows out of range.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from ..utils.build import PKG_DIR, build_shared

SOURCE = os.path.join(PKG_DIR, "csrc", "resolve.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
COMPACT_TILE = 1024     # lanes per tile of the compaction passes
_PLAIN_CHUNK = 16384    # lanes per chunk of the plain sweep (bounds memory)

_LIB = None
_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the resolve kernels are built "
                           "on the machine with the GPU")
    return path


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/resolve.cu`` on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build_shared("elaina_resolve", [nvcc()], [SOURCE],
                                   NVCC_FLAGS))
    lib.compact_lanes_launch.restype = ctypes.c_int
    lib.compact_lanes_launch.argtypes = [_VP, _I64, _I32, _VP, _VP, _VP, _VP]
    lib.sweep_resolve_launch.restype = ctypes.c_int
    lib.sweep_resolve_launch.argtypes = [_VP, _VP, _VP, _VP, _VP, _I64, _I32,
                                         _I32, _VP, _VP, _VP, _VP, _VP]
    lib.fetch_colors_launch.restype = ctypes.c_int
    lib.fetch_colors_launch.argtypes = [_VP, _VP, _VP, _I64, _I64, _VP, _VP,
                                        _VP]
    _LIB = lib
    return lib


def build_log() -> str:
    """The compiler's notes from the kernel build (``-Xptxas -v``)."""
    with open(library()._name + ".log") as f:
        return f.read()


def _check(name: str, x: torch.Tensor, dtype, shape, device):
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _launch(fn, *args, device: torch.device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


# --------------------------------------------------------------------------- #
# K1 compact_lanes
# --------------------------------------------------------------------------- #


def compact_lanes_plain(mask: torch.Tensor, cap: int):
    ids = torch.nonzero(mask).flatten().to(torch.int32)
    lanes = torch.zeros((cap,), dtype=torch.int32, device=mask.device)
    k = min(cap, ids.numel())
    lanes[:k] = ids[:k]
    cnt = torch.tensor([ids.numel()], dtype=torch.int32, device=mask.device)
    return lanes, cnt


def compact_lanes(mask: torch.Tensor, cap: int):
    n = mask.shape[0]
    _check("mask", mask, torch.bool, (n,), mask.device)
    if mask.device.type == "cpu":
        return compact_lanes_plain(mask, cap)
    lanes = torch.empty((cap,), dtype=torch.int32, device=mask.device)
    cnt = torch.empty((1,), dtype=torch.int32, device=mask.device)
    scratch = torch.empty((2 * (-(-n // COMPACT_TILE)) + 1,),
                          dtype=torch.int32, device=mask.device)
    _launch(library().compact_lanes_launch, _ptr(mask), n, cap, _ptr(lanes),
            _ptr(cnt), _ptr(scratch), device=mask.device)
    compact_lanes.launches += 1
    return lanes, cnt


compact_lanes.launches = 0


# --------------------------------------------------------------------------- #
# K2 sweep_resolve
# --------------------------------------------------------------------------- #


def sweep_resolve_plain(mask, row, q, coords, cand):
    n = row.shape[0]
    K = cand.shape[1]
    dev = q.device
    d = torch.zeros((n,), dtype=torch.float32, device=dev)
    t = torch.zeros((n,), dtype=torch.float32, device=dev)
    side = torch.zeros((n,), dtype=torch.float32, device=dev)
    pid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sel = torch.nonzero(mask).flatten()
    for c0 in range(0, sel.numel(), _PLAIN_CHUNK):
        ids = sel[c0:c0 + _PLAIN_CHUNK]
        r = row[ids].long()
        ax, ay, bx, by = coords[r].unbind(1)                # (c, Kp) each
        qx = q[ids, 0:1]
        qy = q[ids, 1:2]
        ex = bx - ax
        ey = by - ay
        wx = qx - ax
        wy = qy - ay
        den = torch.clamp(ex * ex + ey * ey, min=1e-30)
        tt = torch.clamp((wx * ex + wy * ey) / den, 0.0, 1.0)
        dx = wx - tt * ex
        dy = wy - tt * ey
        d2 = dx * dx + dy * dy
        slot = torch.argmin(d2, dim=1, keepdim=True)       # first minimum
        d[ids] = torch.sqrt(d2.gather(1, slot)[:, 0])
        t[ids] = tt.gather(1, slot)[:, 0]
        side[ids] = (ex * wy - ey * wx).gather(1, slot)[:, 0]
        s = slot[:, 0]
        pid[ids] = torch.where(s < K, cand[r, s.clamp(max=K - 1)],
                               torch.full_like(s, -1, dtype=torch.int32))
    return d, t, side, pid


def sweep_resolve(mask, row, q, coords, cand):
    n = row.shape[0]
    dev = q.device
    R, K = cand.shape
    Kp = coords.shape[2]
    _check("mask", mask, torch.bool, (n,), dev)
    _check("row", row, torch.int32, (n,), dev)
    _check("q", q, torch.float32, (n, 2), dev)
    _check("coords", coords, torch.float32, (R, 4, Kp), dev)
    _check("cand", cand, torch.int32, (R, K), dev)
    if Kp < K or Kp % 32:
        raise ValueError(f"coords has {Kp} slots per row for K={K}")
    if dev.type == "cpu":
        return sweep_resolve_plain(mask, row, q, coords, cand)
    d = torch.empty((n,), dtype=torch.float32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    side = torch.empty((n,), dtype=torch.float32, device=dev)
    pid = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(library().sweep_resolve_launch, _ptr(mask), _ptr(row), _ptr(q),
            _ptr(coords), _ptr(cand), n, K, Kp, _ptr(d), _ptr(t), _ptr(side),
            _ptr(pid), device=dev)
    sweep_resolve.launches += 1
    return d, t, side, pid


sweep_resolve.launches = 0


# --------------------------------------------------------------------------- #
# K3 fetch_colors
# --------------------------------------------------------------------------- #


def fetch_colors_plain(mask, cfi, color_rows):
    r = cfi.long()
    on = mask & (r >= 0) & (r < color_rows.shape[0])
    c = torch.where(on[:, None], color_rows[r.clamp(0, color_rows.shape[0]
                                                    - 1)],
                    torch.zeros((), dtype=torch.float32, device=cfi.device))
    return c[:, :3].contiguous(), c[:, 3:].contiguous()


def fetch_colors(mask, cfi, color_rows):
    n = cfi.shape[0]
    dev = cfi.device
    _check("mask", mask, torch.bool, (n,), dev)
    _check("cfi", cfi, torch.int32, (n,), dev)
    _check("color_rows", color_rows, torch.float32,
           (color_rows.shape[0], 6), dev)
    if dev.type == "cpu":
        return fetch_colors_plain(mask, cfi, color_rows)
    c0 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    c1 = torch.empty((n, 3), dtype=torch.float32, device=dev)
    _launch(library().fetch_colors_launch, _ptr(mask), _ptr(cfi),
            _ptr(color_rows), n, color_rows.shape[0], _ptr(c0), _ptr(c1),
            device=dev)
    fetch_colors.launches += 1
    return c0, c1


fetch_colors.launches = 0

KERNELS = (compact_lanes, sweep_resolve, fetch_colors)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
