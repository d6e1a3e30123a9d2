"""Learning-rate schedules of the port (the JAX package's
`optim/schedules.py`); only the constant schedule the DDPM pretraining uses
is ported so far."""
from __future__ import annotations

import numpy as np


def constant_schedule(lr: float):
    """step -> lr as a float32 value, as the JAX package's schedule returns."""
    def f(step):
        return np.float32(lr)
    return f
