"""elaina_tpu_torch: the Walk-on-Stars solver in PyTorch, for CUDA GPUs.

A port of ``elaina_tpu`` (the JAX reference beside it): uniform and
guided WoSt in 2D and 3D end to end, from scene load and the grids
through the depth step (its TPU kernels as CUDA sources in ``csrc/``,
bound in ``ops/``) and the solve's routes to film export and the CLI
(``python -m elaina_tpu_torch run``).

The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"


def run(conf_path: str):
    """Run an experiment config (``python -m elaina_tpu_torch run``)."""
    from .exec import run_expr

    return run_expr(conf_path)
