"""Exponential moving average of a scalar (reference: util/ema.h:9-59).

The port's own copy of ``elaina_tpu/utils/ema.py``: the reference's two
decay modes, per step and by wall time (the guided trainer smooths its
loss with Ema(Type::Time, 50ms), guided/integrator.cu:42).
"""

from __future__ import annotations

import time


class Ema:
    STEP = "step"
    TIME = "time"

    def __init__(self, mode: str = "time", half_life: float = 50.0):
        """half_life: steps (STEP mode) or milliseconds (TIME mode)."""
        self.mode = mode
        self.half_life = half_life
        self.value = 0.0
        self._last_t = time.time() * 1000.0
        self._initialized = False

    def update(self, x: float) -> float:
        if not self._initialized:
            self.value = x
            self._initialized = True
            self._last_t = time.time() * 1000.0
            return self.value
        if self.mode == self.TIME:
            now = time.time() * 1000.0
            dt = max(now - self._last_t, 0.0)
            self._last_t = now
            alpha = 0.5 ** (dt / max(self.half_life, 1e-9))
        else:
            alpha = 0.5 ** (1.0 / max(self.half_life, 1e-9))
        self.value = alpha * self.value + (1.0 - alpha) * x
        return self.value

    def ema_val(self) -> float:
        return self.value
