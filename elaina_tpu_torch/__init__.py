"""elaina_tpu_torch: the Walk-on-Stars solver in PyTorch, for CUDA GPUs.

A port of ``elaina_tpu`` (the JAX reference beside it).  The slice carried
so far is 2D uniform WoSt end to end: scene load, the Dirichlet candidate
grid and its FinePack, the depth step with the three Dirichlet-resolve
kernels (``ops/resolve.py``, CUDA sources in ``csrc/``), the per-sample
solve loop, film export and the CLI (``python -m elaina_tpu_torch run``).

The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"


def run(conf_path: str):
    """Run an experiment config (``python -m elaina_tpu_torch run``)."""
    from .exec import run_expr

    return run_expr(conf_path)
