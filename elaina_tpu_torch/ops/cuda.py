"""Building, binding and launching the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled with
nvcc for sm_90a into ``_build/`` at its first use (``utils/build.py``),
then loaded with ctypes: pointers (``Tensor.data_ptr()``) and the current
stream go over as Python ints into ``c_void_p`` arguments.  A launch
function returns ``cudaGetLastError()``, and ``launch`` raises when it is
not 0.  Nothing here falls back: a missing
nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil

import torch

from ..utils.build import PKG_DIR, build_shared

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
CPU = torch.device("cpu")
VP = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int32
F32 = ctypes.c_float

_LIBS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def load_library(name: str, source: str, signatures: dict) -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` (once per process), with
    each function's argtypes set from ``signatures`` and restype int."""
    lib = _LIBS.get(name)
    if lib is None:
        csrc = os.path.join(PKG_DIR, "csrc")
        lib = ctypes.CDLL(build_shared(
            name, [nvcc()], [os.path.join(csrc, source)], NVCC_FLAGS,
            headers=sorted(glob.glob(os.path.join(csrc, "*.cuh")))))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib


def build_log(lib: ctypes.CDLL) -> str:
    """The compiler's notes from a library's build (``-Xptxas -v``)."""
    with open(lib._name + ".log") as f:
        return f.read()


def check(name: str, x: torch.Tensor, dtype, shape, device):
    """Raise unless ``x`` has this dtype, shape and device and is
    contiguous: one test on the way through, the reason only on failure."""
    if (x.dtype is not dtype or x.shape != shape or x.device != device
            or not x.is_contiguous()):
        if x.dtype != dtype:
            raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if x.device != device:
            raise ValueError(f"{name}: on {x.device}, expected {device}")
        raise ValueError(f"{name}: not contiguous")


def launch(fn, *args, device: torch.device):
    """Call a launch function with the current stream of ``device`` as its
    last argument; raise if it returns a CUDA error.  On the current
    device (every launch of a run on one card) no device context is
    entered; a tensor on another card enters its device first, so the
    kernel never runs on a card that does not hold its tensors."""
    if device.index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")
