"""repro_torch.gen — the AIGC dataplane of the port (the JAX package's
`repro.gen`).

Serves SUBP4 generation schedules with the class-conditional DDPM
(diffusion/ddpm.py) instead of the procedural oracle:

* `sampler`  — bucketed, per-image-keyed, strided ancestral sampling: every
  selected vehicle's per-label schedule rides one pass, padded to the
  power-of-two bucket family;
* `service`  — `BatchedDDPMGenerator`, the round-keyed generator the round
  loop plugs in for `RunConfig(generator="ddpm")`;
* `calib`    — measured per-image sampling latency, cached per device in a
  ``repro_torch.gen/calib/v1`` file, feeding the eq. 12-13 delay terms;
* `pretrain` — the reference-pool DDPM training loop + checkpoint.
"""
from repro_torch.gen.calib import (CALIB_SCHEMA, MeasuredService,
                                   calibrated_service, load_calibration,
                                   measure_t_per_image, save_calibration)
from repro_torch.gen.pretrain import (DDPM_CKPT_SCHEMA, load_pretrained,
                                      pretrain_ddpm)
from repro_torch.gen.sampler import (image_noise, sample_schedule,
                                     strided_timesteps)
from repro_torch.gen.service import (GEN_KEY, BatchedDDPMGenerator,
                                     gen_round_key, make_ddpm_generator,
                                     runner_ddpm)

__all__ = [
    "BatchedDDPMGenerator", "CALIB_SCHEMA", "DDPM_CKPT_SCHEMA", "GEN_KEY",
    "MeasuredService", "calibrated_service", "gen_round_key", "image_noise",
    "load_calibration", "load_pretrained", "make_ddpm_generator",
    "measure_t_per_image", "pretrain_ddpm", "runner_ddpm", "sample_schedule",
    "save_calibration", "strided_timesteps",
]
