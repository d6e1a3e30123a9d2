from repro_torch.optim.optimizers import Optimizer, adamw
from repro_torch.optim.schedules import constant_schedule

__all__ = ["Optimizer", "adamw", "constant_schedule"]
