"""Building, binding and launching the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface and is compiled with
nvcc for sm_90a into ``_build/`` at its first use (``utils/build.py``),
then loaded with ctypes: pointers and the current stream go over as
``c_void_p``.  A launch function returns ``cudaGetLastError()``, and
``launch`` raises when it is not 0.  Nothing here falls back: a missing
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
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def launch(fn, *args, device: torch.device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")
