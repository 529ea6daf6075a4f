"""Model families: the two WoSt integrators and the guiding network.

The reference ships exactly two solver variants (exec.cu:77:
``std::variant<UniformIntegrator<2|3>, GuidedIntegrator<2|3>>``); both are
dimension-generic here.  This package is the stable import point for
them, with the names of ``elaina_tpu.models``.
"""

from ..nn.network import (  # noqa: F401
    AdamConfig,
    NetworkSpec,
    TrainerState,
    apply_network,
    init_trainer,
    make_network,
)
from ..solver.guided import GuidedIntegrator, run_one_guided_sample  # noqa: F401
from ..solver.integrator import CHANNELS, UniformIntegrator  # noqa: F401
from ..solver.wost import run_one_sample  # noqa: F401

__all__ = [
    "CHANNELS",
    "UniformIntegrator",
    "GuidedIntegrator",
    "run_one_sample",
    "run_one_guided_sample",
    "make_network",
    "apply_network",
    "init_trainer",
    "NetworkSpec",
    "TrainerState",
    "AdamConfig",
]
