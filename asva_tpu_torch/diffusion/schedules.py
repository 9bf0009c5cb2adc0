"""Noise schedule tables (port of asva_tpu/diffusion/schedules.py:18).

SD1.5 config: scaled_linear betas 0.00085 -> 0.012, 1000 train steps,
epsilon prediction, steps_offset=1, "leading" timestep spacing.  Host-side
numpy, shared by the samplers.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
