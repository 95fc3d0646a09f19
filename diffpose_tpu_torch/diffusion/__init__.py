from diffpose_tpu_torch.diffusion.ddim import (
    antithetic_timesteps,
    ddim_sample,
    make_skip_sequence,
    q_sample,
)
from diffpose_tpu_torch.diffusion.schedule import (
    alphas_cumprod,
    compute_alpha,
    get_beta_schedule,
    padded_alphas_cumprod,
)

__all__ = [
    "antithetic_timesteps",
    "alphas_cumprod",
    "compute_alpha",
    "ddim_sample",
    "get_beta_schedule",
    "make_skip_sequence",
    "padded_alphas_cumprod",
    "q_sample",
]
