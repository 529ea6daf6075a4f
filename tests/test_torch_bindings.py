"""The ctypes bindings of the port's CUDA libraries against their sources.

Each ``*_launch`` function of ``csrc/resolve.cu``, ``csrc/queries.cu``
and ``csrc/bvh.cu`` is bound in ``ops/{resolve,queries,bvh}.py`` with one
ctypes type per argument, the stream last.  An argument left out of the
list is passed by ctypes' default rule, a 32-bit int, so a pointer past
the list is cut and the launch faults only on the card.  Here, without a
card or nvcc: every exported launch function is bound, with as many types
as its C prototype has parameters, pointers as ``c_void_p``.
"""

import ctypes
import os
import re

import pytest

torch = pytest.importorskip("torch")

from elaina_tpu_torch.ops import bvh, queries, resolve  # noqa: E402

CSRC = os.path.join(os.path.dirname(resolve.__file__), os.pardir, "csrc")
C_TYPES = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32,
           "float": ctypes.c_float}


def _prototypes(source: str) -> dict:
    """name -> parameter types of each function in the extern "C" block."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    text = text[text.index('extern "C" {'):]
    out = {}
    for name, params in re.findall(r"\bint (\w+_launch)\((.*?)\)\s*\{", text,
                                   re.S):
        out[name] = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
    return out


@pytest.mark.parametrize("module, source", [(resolve, "resolve.cu"),
                                            (queries, "queries.cu"),
                                            (bvh, "bvh.cu")],
                         ids=["resolve", "queries", "bvh"])
def test_launch_signatures_match_sources(module, source):
    protos = _prototypes(source)
    assert set(module._SIGNATURES) == set(protos)
    for name, params in protos.items():
        sig = module._SIGNATURES[name]
        assert len(sig) == len(params), name
        for ctype, param in zip(sig, params):
            want = ctypes.c_void_p if "*" in param else C_TYPES[param]
            assert ctype is want, (name, param)
