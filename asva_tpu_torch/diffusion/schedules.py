"""Noise schedule tables (port of asva_tpu/diffusion/schedules.py:18).

SD1.5 config: scaled_linear betas 0.00085 -> 0.012, 1000 train steps,
epsilon prediction, steps_offset=1, "leading" timestep spacing.  The tables
are host-side numpy, shared by the samplers; `add_noise` and `velocity`
(training) work on tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"  # or "v_prediction"
    steps_offset: int = 1

    @property
    def alphas_cumprod(self) -> np.ndarray:
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start ** 0.5, self.beta_end ** 0.5,
                                self.num_train_timesteps,
                                dtype=np.float64) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end,
                                self.num_train_timesteps, dtype=np.float64)
        else:
            raise ValueError(self.beta_schedule)
        return np.cumprod(1.0 - betas).astype(np.float32)

    def _sqrt_ac(self, x0: torch.Tensor, t: torch.Tensor):
        """sqrt(ac_t) and sqrt(1 - ac_t), shaped to broadcast over x0."""
        ac = torch.from_numpy(self.alphas_cumprod).to(x0.device)[t]
        shape = (-1,) + (1,) * (x0.dim() - 1)
        return (torch.sqrt(ac).reshape(shape).to(x0.dtype),
                torch.sqrt(1.0 - ac).reshape(shape).to(x0.dtype))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """x_t = sqrt(ac_t) x0 + sqrt(1-ac_t) noise; t: (b,) int."""
        sa, sb = self._sqrt_ac(x0, t)
        return sa * x0 + sb * noise

    def velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
        """v = sqrt(ac_t) noise - sqrt(1-ac_t) x0."""
        sa, sb = self._sqrt_ac(x0, t)
        return sa * noise - sb * x0

    def leading_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Ascending sampled train timesteps, diffusers 'leading' spacing."""
        if not 1 <= num_inference_steps <= self.num_train_timesteps:
            raise ValueError(
                f"num_inference_steps={num_inference_steps} must be in "
                f"[1, {self.num_train_timesteps}]")
        ratio = self.num_train_timesteps // num_inference_steps
        ts = ((np.arange(num_inference_steps) * ratio).round()
              .astype(np.int64) + self.steps_offset)
        if ts[-1] >= self.num_train_timesteps:
            raise ValueError(
                f"last timestep {ts[-1]} >= num_train_timesteps "
                f"{self.num_train_timesteps}; lower num_inference_steps")
        return ts
