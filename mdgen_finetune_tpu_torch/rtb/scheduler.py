"""DDPM scheduler with GFlowNet extensions, as tensor functions.

Counterpart of the JAX package's ``rtb/scheduler.py`` (:30-236; reference
src/rtb_utils/diffusers/schedulers/scheduling_ddpm_gfn.py): a DDPM ancestral
sampler whose ``step`` also returns the posterior mean and std and the
realized noise, so that the exact Normal log-prob of each realized transition
can be summed (scheduling_ddpm_gfn.py:410-553), plus

- ``target``-forced noise (target - mu) / sigma (:522-525);
- the uniform-noise option of ``xT_type="uniform"`` (:528-532);
- ``step_noise``: the forward-noising move the backward policy takes, with
  its effective std (:599-681);
- the stride-aware previous / next timestep, with the reference's T-1
  clamps (:704-740).

The tables are f32 tensors on the caller's device. A timestep is a Python
int, a 0-d or a (B,) integer tensor; tables are indexed exactly as the JAX
package indexes them (``_alpha_prod``: 1 below t = 0).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 schedule (scheduling_ddpm_gfn.py:51-92)."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_steps):
        t1, t2 = i / num_steps, (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


class DDPMGFNScheduler:
    def __init__(self, num_train_timesteps: int = 1000, beta_schedule: str = "squaredcos_cap_v2",
                 prediction_type: str = "v_prediction", clip_sample: bool = True,
                 clip_sample_range: float = 3.0, variance_type: str = "fixed_large",
                 timestep_spacing: str = "leading", num_inference_steps: Optional[int] = None,
                 device=None):
        self.num_train_timesteps = num_train_timesteps
        self.beta_schedule = beta_schedule
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.clip_sample_range = clip_sample_range
        self.variance_type = variance_type
        self.timestep_spacing = timestep_spacing
        self.num_inference_steps = num_inference_steps
        if beta_schedule == "linear":
            betas = np.linspace(1e-4, 0.02, num_train_timesteps)
        elif beta_schedule == "squaredcos_cap_v2":
            betas = betas_for_alpha_bar(num_train_timesteps)
        else:
            raise NotImplementedError(beta_schedule)
        self.device = torch.device(device or "cpu")
        self._init_tables(betas)

    def _init_tables(self, betas: np.ndarray):
        """The f32 beta and alpha-bar tables on ``self.device`` and the
        default timestep list."""
        self.betas = torch.tensor(betas, dtype=torch.float32, device=self.device)
        self.alphas_cumprod = torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32,
                                           device=self.device)
        self.timesteps = self.set_timesteps(self.num_inference_steps or self.num_train_timesteps)

    # ------------------------------------------------------------------
    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """The descending host-side timestep list (int64 numpy)."""
        self.num_inference_steps = num_inference_steps
        if self.timestep_spacing == "leading":
            ratio = self.num_train_timesteps // num_inference_steps
            ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1].astype(np.int64)
        elif self.timestep_spacing == "linspace":
            ts = np.linspace(0, self.num_train_timesteps - 1,
                             num_inference_steps).round()[::-1].astype(np.int64)
        else:
            raise NotImplementedError(self.timestep_spacing)
        self.timesteps = ts
        return ts

    @property
    def stride(self) -> int:
        return self.num_train_timesteps // (self.num_inference_steps or self.num_train_timesteps)

    def previous_timestep(self, t):
        """t - stride, + 1 at t == T-1 (scheduling_ddpm_gfn.py:704-719)."""
        if isinstance(t, (int, np.integer)):
            return int(t) - self.stride + (1 if t == self.num_train_timesteps - 1 else 0)
        prev = t - self.stride
        return torch.where(t == self.num_train_timesteps - 1, prev + 1, prev)

    def next_timestep(self, t):
        """t + stride, clamped to T-1 (scheduling_ddpm_gfn.py:721-740)."""
        if isinstance(t, (int, np.integer)):
            return min(int(t) + self.stride, self.num_train_timesteps - 1)
        return torch.clamp(t + self.stride, max=self.num_train_timesteps - 1)

    # ------------------------------------------------------------------
    def _alpha_prod(self, t):
        """alphas_cumprod[t], 1 where t < 0; f32 on the tables' device."""
        t = torch.as_tensor(t, device=self.device)
        a = self.alphas_cumprod[t.clamp(min=0).long()]
        return torch.where(t >= 0, a, torch.ones_like(a))

    @staticmethod
    def _bc(val, x):
        """Broadcast per-batch scalars (B,) against samples (B, ...)."""
        if torch.is_tensor(val) and val.ndim == 1:
            return val.reshape((-1,) + (1,) * (x.ndim - 1))
        return val

    def get_variance(self, t):
        """The step's variance per ``variance_type`` (scheduling_ddpm_gfn.py:
        314-360); the std for ``fixed_small_log``."""
        a_t = self._alpha_prod(t)
        a_prev = self._alpha_prod(self.previous_timestep(torch.as_tensor(t, device=self.device)))
        beta_t = 1 - a_t / a_prev
        variance = ((1 - a_prev) / (1 - a_t) * beta_t).clamp(min=1e-20)
        if self.variance_type == "fixed_small":
            return variance
        if self.variance_type == "fixed_small_log":
            return torch.exp(0.5 * torch.log(variance))
        if self.variance_type == "fixed_large":
            return beta_t
        raise NotImplementedError(self.variance_type)

    def _std(self, t):
        v = self.get_variance(t)
        return v if self.variance_type == "fixed_small_log" else v ** 0.5

    def pred_x0(self, model_output, t, sample):
        a_t = self._bc(self._alpha_prod(t), sample)
        b_t = 1 - a_t
        if self.prediction_type == "epsilon":
            x0 = (sample - b_t ** 0.5 * model_output) / a_t ** 0.5
        elif self.prediction_type == "sample":
            x0 = model_output
        elif self.prediction_type == "v_prediction":
            x0 = a_t ** 0.5 * sample - b_t ** 0.5 * model_output
        else:
            raise NotImplementedError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0

    def step(self, model_output, t, sample, generator: Optional[torch.Generator] = None,
             noise=None, target=None, xT_type: str = "gaussian") -> dict:
        """One ancestral step t -> previous_timestep(t) (JAX :137-191).
        The noise: ``target``-forced, else ``noise`` (a tensor, or a scalar
        broadcast), else drawn from ``generator`` (U[-3, 3] under
        ``xT_type="uniform"``, else standard normal). Returns
        {prev_sample, pred_original_sample, posterior_mean, posterior_std,
        noise}."""
        t = torch.as_tensor(t, device=self.device)
        a_t = self._bc(self._alpha_prod(t), sample)
        a_prev = self._bc(self._alpha_prod(self.previous_timestep(t)), sample)
        b_t, b_prev = 1 - a_t, 1 - a_prev
        cur_alpha = a_t / a_prev
        cur_beta = 1 - cur_alpha
        x0 = self.pred_x0(model_output, t, sample)
        x0_coeff = (a_prev ** 0.5 * cur_beta) / b_t
        xt_coeff = cur_alpha ** 0.5 * b_prev / b_t
        mean = x0_coeff * x0 + xt_coeff * sample
        std = self._bc(self._std(t), sample)

        if target is not None:
            variance_noise = (target - mean) / std
        elif noise is None:
            if generator is None:
                raise ValueError("need a generator to draw the step noise")
            shape, dev = model_output.shape, generator.device
            if xT_type == "uniform":
                variance_noise = torch.rand(shape, generator=generator, device=dev) * 6.0 - 3.0
            else:
                variance_noise = torch.randn(shape, generator=generator, device=dev)
            variance_noise = variance_noise.to(model_output.device)
        elif not torch.is_tensor(noise) or noise.ndim == 0:
            variance_noise = noise * torch.ones_like(model_output)
        else:
            variance_noise = noise

        add = self._bc((t > 0).to(torch.float32), sample)
        return {"prev_sample": mean + add * std * variance_noise, "pred_original_sample": x0,
                "posterior_mean": mean, "posterior_std": std, "noise": variance_noise}

    # ------------------------------------------------------------------
    def add_noise(self, original_samples, noise, timesteps, return_std: bool = False):
        a = self._alpha_prod(timesteps)
        shape = (-1,) + (1,) * (original_samples.ndim - 1)
        x_mean = (a ** 0.5).reshape(shape) * original_samples
        noisy = x_mean + ((1 - a) ** 0.5).reshape(shape) * noise
        if return_std:
            return noisy, x_mean, self._std(timesteps)
        return noisy

    def step_noise(self, x, noise, t, scheduled_std: bool = True):
        """The forward-noising move prev(t) -> t, the backward policy's
        transition (scheduling_ddpm_gfn.py:599-681): (x_noised, mean, std)."""
        t = torch.as_tensor(t, device=self.device)
        a_source = self._alpha_prod(self.previous_timestep(t))
        a_end = self._alpha_prod(t)
        x_scale = (a_end / a_source) ** 0.5
        std = (1 - a_end) ** 0.5 - x_scale * (1 - a_source) ** 0.5
        mean = x_scale * x
        x_noised = mean + std * noise
        if scheduled_std:
            std = self._std(t)
        return x_noised, mean, std

    def get_velocity(self, sample, noise, timesteps):
        a = self._alpha_prod(timesteps)
        shape = (-1,) + (1,) * (sample.ndim - 1)
        return (a ** 0.5).reshape(shape) * noise - ((1 - a) ** 0.5).reshape(shape) * sample


def normal_logprob(x, mean, std):
    """Sum of elementwise Normal log-probs over the non-batch dims."""
    var = std ** 2
    lp = -0.5 * ((x - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return lp.sum(dim=tuple(range(1, x.ndim)))
