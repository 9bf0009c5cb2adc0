"""DDIM and PLMS (PNDM skip-prk) samplers.

Port of asva_tpu/diffusion/samplers.py.  Each sampler is compiled into a
*plan* of host-side per-iteration coefficients; `sampler_step` consumes one
plan row (`plan_row_arrays(plan)[i]`-style dict of numpy scalars) and a
`SamplerState`.  The JAX `lax.scan` over plan rows becomes a Python loop
over `range(plan.num_iterations)`; the row's boolean flags become plain
`if`s.  The step arithmetic runs in fp32 and the result is cast to the
latents' dtype, as in the JAX version.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .schedules import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """Per-iteration constants; every array has leading dim = num iterations."""
    t_model: np.ndarray        # timestep fed to the UNet (int32)
    sqrt_ac_t: np.ndarray
    sqrt_ac_prev: np.ndarray
    ac_t: np.ndarray
    ac_prev: np.ndarray
    ets_weights: np.ndarray    # (n_iter, 4): [w_current, w_buf0, w_buf1, w_buf2]
    append_flag: np.ndarray    # bool: push current eps into the buffer
    use_cur_sample: np.ndarray  # bool: step from the stashed sample instead
    store_cur_sample: np.ndarray  # bool: stash the pre-step sample
    kind: str                  # "ddim" | "plms"

    @property
    def num_iterations(self) -> int:
        return len(self.t_model)


class SamplerState(NamedTuple):
    latents: torch.Tensor      # (b, f, h, w, c)
    ets: torch.Tensor          # (3,) + stepped-frames shape: eps history
    cur_sample: torch.Tensor   # stashed sample for the PLMS trapezoid step


def ddim_plan(schedule: DiffusionSchedule, num_steps: int) -> SamplerPlan:
    ac = schedule.alphas_cumprod.astype(np.float64)
    ts = schedule.leading_timesteps(num_steps)[::-1].copy()  # descending
    ratio = schedule.num_train_timesteps // num_steps
    prev = ts - ratio
    ac_t = ac[ts]
    ac_prev = np.where(prev >= 0, ac[np.clip(prev, 0, None)], ac[0])
    n = len(ts)
    w = np.zeros((n, 4), np.float32)
    w[:, 0] = 1.0
    return SamplerPlan(
        t_model=ts.astype(np.int32),
        sqrt_ac_t=np.sqrt(ac_t).astype(np.float32),
        sqrt_ac_prev=np.sqrt(ac_prev).astype(np.float32),
        ac_t=ac_t.astype(np.float32), ac_prev=ac_prev.astype(np.float32),
        ets_weights=w, append_flag=np.zeros(n, bool),
        use_cur_sample=np.zeros(n, bool), store_cur_sample=np.zeros(n, bool),
        kind="ddim")


def plms_plan(schedule: DiffusionSchedule, num_steps: int) -> SamplerPlan:
    ac = schedule.alphas_cumprod.astype(np.float64)
    base = schedule.leading_timesteps(num_steps)  # ascending
    ratio = schedule.num_train_timesteps // num_steps
    # duplicated second-to-last timestep, then reversed (diffusers
    # PNDMScheduler.set_timesteps with skip_prk_steps=True)
    seq = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
    n = len(seq)

    t_coeff = seq.copy()
    t_prev = seq - ratio
    weights = np.zeros((n, 4), np.float32)
    append = np.zeros(n, bool)
    use_cur = np.zeros(n, bool)
    store_cur = np.zeros(n, bool)
    adams = {2: [1.5, -0.5, 0.0], 3: [23 / 12, -16 / 12, 5 / 12]}
    ets_len = 0
    for counter in range(n):
        if counter == 1:
            # re-do the first transition with the trapezoid average,
            # stepping from the stashed original sample
            t_prev[counter] = t_coeff[counter]
            t_coeff[counter] = t_coeff[counter] + ratio
            weights[counter] = [0.5, 0.5, 0.0, 0.0]
            use_cur[counter] = True
        else:
            append[counter] = True
            ets_len = min(ets_len + 1, 4)
            if ets_len == 1:
                weights[counter] = [1.0, 0.0, 0.0, 0.0]
                store_cur[counter] = True
            elif ets_len in adams:
                weights[counter] = [*adams[ets_len], 0.0]
            else:
                weights[counter] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]
    ac_t = ac[t_coeff]
    ac_prev = np.where(t_prev >= 0, ac[np.clip(t_prev, 0, None)], ac[0])
    return SamplerPlan(
        t_model=seq.astype(np.int32),
        sqrt_ac_t=np.sqrt(ac_t).astype(np.float32),
        sqrt_ac_prev=np.sqrt(ac_prev).astype(np.float32),
        ac_t=ac_t.astype(np.float32), ac_prev=ac_prev.astype(np.float32),
        ets_weights=weights, append_flag=append, use_cur_sample=use_cur,
        store_cur_sample=store_cur, kind="plms")


def plan_row_arrays(plan: SamplerPlan) -> list:
    """The plan as a list of per-iteration row dicts (numpy scalars)."""
    fields = ("t_model", "sqrt_ac_t", "sqrt_ac_prev", "ac_t", "ac_prev",
              "ets_weights", "append_flag", "use_cur_sample",
              "store_cur_sample")
    return [{k: getattr(plan, k)[i] for k in fields}
            for i in range(plan.num_iterations)]


def init_state(plan: SamplerPlan, latents: torch.Tensor,
               step_slice=slice(None)) -> SamplerState:
    """step_slice selects which frames the sampler steps (frame-0 pinning)."""
    stepped = latents[:, step_slice]
    zeros = torch.zeros((3,) + stepped.shape, dtype=latents.dtype,
                        device=latents.device)
    return SamplerState(latents=latents, ets=zeros, cur_sample=stepped)


def sampler_step(kind: str, row: dict, state: SamplerState,
                 eps: torch.Tensor, step_slice=slice(None),
                 prediction_type: str = "epsilon") -> SamplerState:
    """Advance one sampler iteration.  eps: the model's prediction for the
    *stepped* frames only.  Returns a new state (inputs are not mutated)."""
    latents = state.latents
    sample = latents[:, step_slice]
    # plan scalars in fp32, as the JAX step computes them
    one = np.float32(1.0)
    ac_t, ac_prev = np.float32(row["ac_t"]), np.float32(row["ac_prev"])
    sqrt_ac_t = np.float32(row["sqrt_ac_t"])
    sqrt_ac_prev = np.float32(row["sqrt_ac_prev"])

    if prediction_type == "v_prediction":
        if kind != "ddim":
            raise NotImplementedError(
                "v_prediction is only supported with DDIM (as in diffusers)")
        eps = (float(np.sqrt(one - ac_t)) * sample.float()
               + float(sqrt_ac_t) * eps.float()).to(eps.dtype)
    elif prediction_type != "epsilon":
        raise ValueError(prediction_type)

    w = [float(v) for v in row["ets_weights"]]
    combined = (w[0] * eps.float() + w[1] * state.ets[0].float()
                + w[2] * state.ets[1].float()
                + w[3] * state.ets[2].float()).to(eps.dtype)
    new_ets = (torch.stack([eps.to(state.ets.dtype), state.ets[0],
                            state.ets[1]])
               if row["append_flag"] else state.ets)
    base = state.cur_sample if row["use_cur_sample"] else sample
    new_cur = sample if row["store_cur_sample"] else state.cur_sample

    c = combined.float()
    if kind == "ddim":
        x0 = (base.float() - float(np.sqrt(one - ac_t)) * c) / float(sqrt_ac_t)
        stepped = float(sqrt_ac_prev) * x0 + float(np.sqrt(one - ac_prev)) * c
    else:  # plms transition
        denom = (ac_t * np.sqrt(one - ac_prev)
                 + np.sqrt(ac_t * (one - ac_t) * ac_prev))
        stepped = (float(sqrt_ac_prev / sqrt_ac_t) * base.float()
                   - float(ac_prev - ac_t) * c / float(denom))

    new_latents = latents.clone()
    new_latents[:, step_slice] = stepped.to(latents.dtype)
    return SamplerState(latents=new_latents, ets=new_ets, cur_sample=new_cur)
