"""DDPM scheduler (SD 1.5 configuration).

Counterpart of ``fresco_tpu/diffusion/scheduler.py`` (reference
src/pipe_FRESCO.py:14-77): scaled-linear betas 0.00085..0.012 over 1000
train steps, epsilon prediction.  The sampler loops over steps in
Python, so timesteps are plain ints and the per-step coefficients are
host floats (the schedule is computed in float32, as in the JAX
package).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_inference_steps: int = 20

    @functools.cached_property
    def alphas_cumprod(self) -> np.ndarray:
        betas = np.linspace(
            self.beta_start**0.5, self.beta_end**0.5, self.num_train_timesteps,
            dtype=np.float32,
        ) ** 2
        return np.cumprod(1.0 - betas, dtype=np.float32)

    @property
    def timesteps_np(self) -> np.ndarray:
        """Descending inference timesteps (diffusers set_timesteps)."""
        step = self.num_train_timesteps // self.num_inference_steps
        return (np.arange(self.num_inference_steps) * step)[::-1].astype("int32")

    def previous_timestep(self, t: int) -> int:
        return int(t) - self.num_train_timesteps // self.num_inference_steps

    def _ac(self, t: int, dtype, device) -> torch.Tensor:
        return torch.tensor(float(self.alphas_cumprod[int(t)]), dtype=dtype, device=device)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: int) -> torch.Tensor:
        """q(x_t | x_0) (SDEdit init, pipe_FRESCO.py:159-161)."""
        ac = self._ac(t, x0.dtype, x0.device)
        return torch.sqrt(ac) * x0 + torch.sqrt(1.0 - ac) * noise

    def predict_x0(self, sample: torch.Tensor, eps: torch.Tensor, t: int) -> torch.Tensor:
        wd = torch.promote_types(sample.dtype, torch.float32)
        ac = self._ac(t, wd, sample.device)
        return (sample.to(wd) - torch.sqrt(1.0 - ac) * eps.to(wd)) / torch.sqrt(ac)

    def step_from_x0(self, sample, pred_x0, t: int, noise) -> torch.Tensor:
        """DDPM posterior mean plus variance noise, given (possibly edited)
        x0.  The reference adds noise at every step, the last included,
        with the variance clamped at 1e-20."""
        wd = torch.promote_types(sample.dtype, torch.float32)
        dev = sample.device
        prev_t = self.previous_timestep(t)
        ac_t = self._ac(t, wd, dev)
        ac_prev = self._ac(max(prev_t, 0), wd, dev) if prev_t >= 0 else torch.tensor(1.0, dtype=wd, device=dev)
        beta_t = 1.0 - ac_t
        beta_prev = 1.0 - ac_prev
        cur_alpha = ac_t / ac_prev
        cur_beta = 1.0 - cur_alpha
        x0_coeff = torch.sqrt(ac_prev) * cur_beta / beta_t
        xt_coeff = torch.sqrt(cur_alpha) * beta_prev / beta_t
        mean = x0_coeff * pred_x0.to(wd) + xt_coeff * sample.to(wd)
        var = torch.clamp(beta_prev / beta_t * cur_beta, min=1e-20)
        return (mean + torch.sqrt(var) * noise.to(wd)).to(sample.dtype)
