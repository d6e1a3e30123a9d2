from repro_torch.diffusion.ddpm import (DDPM, ddpm_loss, ddpm_sample,
                                        draw_loss_noise, make_ddpm, q_sample)
