from repro_torch.optim.optimizers import (Optimizer, adamw, clip_by_global_norm,
                                          global_norm, make_optimizer, momentum, sgd)
from repro_torch.optim.schedules import (constant_schedule, cosine_schedule,
                                         get_schedule, wsd_schedule)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "get_schedule", "global_norm", "make_optimizer",
           "momentum", "sgd", "wsd_schedule"]
