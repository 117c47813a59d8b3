"""More GFN-instrumented schedulers: DDIM, DDPM-DP, SDE-VE, EDM-Euler.

Counterpart of the JAX package's ``rtb/schedulers_extra.py`` (reference
src/rtb_utils/diffusers/schedulers/: scheduling_ddim_gfn.py,
scheduling_ddpm_dp.py, scheduling_sde_ve_gfn.py,
scheduling_edm_euler_gfn.py). Only DDPM-GFN drives the MDGen fine-tune path;
these complete the family. Every ``step`` returns {prev_sample,
pred_original_sample, posterior_mean, posterior_std, noise}, so each is a
drop-in policy step for ``PosteriorPriorDGFN``, and takes its noise as
``noise=`` (a tensor or a scalar), ``target=`` or drawn from ``generator=``.
Tables are f32 tensors on the caller's device; a timestep is a Python int, a
0-d or a (B,) integer tensor (a (B,) timestep broadcasts over the sample's
batch, where the JAX package's SDE-VE and EDM steps take a scalar only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scheduler import DDPMGFNScheduler, betas_for_alpha_bar


def _step_noise(generator, shape, device, xT_type="gaussian"):
    """A standard normal draw, or U[-3, 3] under ``xT_type="uniform"``."""
    if generator is None:
        raise ValueError("need a generator to draw the step noise")
    if xT_type == "uniform":
        z = torch.rand(shape, generator=generator, device=generator.device) * 6.0 - 3.0
    else:
        z = torch.randn(shape, generator=generator, device=generator.device)
    return z.to(device)


def _given_noise(noise, like):
    return noise * torch.ones_like(like) if not torch.is_tensor(noise) or noise.ndim == 0 \
        else noise


class DDIMGFNScheduler(DDPMGFNScheduler):
    """DDIM ancestral step with eta-controlled stochasticity
    (scheduling_ddim_gfn.py; JAX :24-67). eta = 1 gives a DDPM-like
    variance; eta = 0 is deterministic (posterior_std floored at 1e-12)."""

    def __init__(self, eta: float = 1.0, **kw):
        self.eta = eta
        super().__init__(**kw)

    def step(self, model_output, t, sample, generator: Optional[torch.Generator] = None,
             noise=None, target=None, xT_type: str = "gaussian") -> dict:
        t = torch.as_tensor(t, device=self.device)
        a_t = self._bc(self._alpha_prod(t), sample)
        a_prev = self._bc(self._alpha_prod(self.previous_timestep(t)), sample)
        x0 = self.pred_x0(model_output, t, sample)
        eps = (sample - a_t ** 0.5 * x0) / (1 - a_t).clamp(min=1e-12) ** 0.5
        sigma = self.eta * ((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)) ** 0.5
        dir_coeff = (1 - a_prev - sigma ** 2).clamp(min=0.0) ** 0.5
        mean = a_prev ** 0.5 * x0 + dir_coeff * eps
        if target is not None:
            variance_noise = (target - mean) / sigma.clamp(min=1e-12)
        elif noise is None:
            variance_noise = _step_noise(generator, sample.shape, sample.device, xT_type)
        else:
            variance_noise = _given_noise(noise, sample)
        add = self._bc((t > 0).to(torch.float32), sample)
        return {"prev_sample": mean + add * sigma * variance_noise, "pred_original_sample": x0,
                "posterior_mean": mean, "posterior_std": sigma.clamp(min=1e-12),
                "noise": variance_noise}


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR beta rescale (scheduling_ddpm_dp.py:96-129;
    arXiv:2305.08891 Alg. 1)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, aT = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


class DDPMDPScheduler(DDPMGFNScheduler):
    """DDPM with a differentiable-posterior step (scheduling_ddpm_dp.py:
    132-587; JAX :82-170). Unlike the GFN scheduler: t - stride previous
    timesteps without the T-1 quirk (:574-587), linear / scaled_linear /
    squaredcos_cap_v2 / sigmoid betas with the linear schedule rescaled by
    1000 / T (:204-218), the optional zero-terminal-SNR rescale (:222-224),
    "trailing" timestep spacing (:319-324) and dynamic thresholding of the
    x0 prediction (:372-403)."""

    def __init__(self, num_train_timesteps: int = 1000, beta_schedule: str = "linear",
                 beta_start: float = 1e-4, beta_end: float = 0.02,
                 prediction_type: str = "epsilon", clip_sample: bool = True,
                 clip_sample_range: float = 1.0, variance_type: str = "fixed_small",
                 timestep_spacing: str = "leading", num_inference_steps: Optional[int] = None,
                 thresholding: bool = False, dynamic_thresholding_ratio: float = 0.995,
                 sample_max_value: float = 1.0, rescale_betas_zero_snr: bool = False,
                 device=None):
        self.num_train_timesteps = T = num_train_timesteps
        self.beta_schedule, self.beta_start, self.beta_end = beta_schedule, beta_start, beta_end
        self.prediction_type = prediction_type
        self.clip_sample, self.clip_sample_range = clip_sample, clip_sample_range
        self.variance_type = variance_type
        self.timestep_spacing = timestep_spacing
        self.num_inference_steps = num_inference_steps
        self.thresholding = thresholding
        self.dynamic_thresholding_ratio = dynamic_thresholding_ratio
        self.sample_max_value = sample_max_value
        self.rescale_betas_zero_snr = rescale_betas_zero_snr
        if beta_schedule == "linear":
            scale = 1000.0 / T  # scheduling_ddpm_dp.py:205-208
            betas = np.linspace(scale * beta_start, scale * beta_end, T)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T) ** 2
        elif beta_schedule == "squaredcos_cap_v2":
            betas = betas_for_alpha_bar(T)
        elif beta_schedule == "sigmoid":
            betas = 1 / (1 + np.exp(-np.linspace(-6, 6, T))) * (beta_end - beta_start) + beta_start
        else:
            raise NotImplementedError(beta_schedule)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        self.device = torch.device(device or "cpu")
        self._init_tables(betas)

    def set_timesteps(self, num_inference_steps: int) -> np.ndarray:
        if self.timestep_spacing == "trailing":
            self.num_inference_steps = num_inference_steps
            ratio = self.num_train_timesteps / num_inference_steps
            ts = np.round(np.arange(self.num_train_timesteps, 0, -ratio)).astype(np.int64) - 1
            self.timesteps = ts
            return ts
        return super().set_timesteps(num_inference_steps)

    def previous_timestep(self, t):
        """t - T // num_inference_steps, no boundary quirk."""
        return t - self.stride

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
        if self.thresholding:
            return self._threshold_sample(x0)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
        return x0

    def _threshold_sample(self, sample):
        """Dynamic thresholding: clamp x0 to [-s, s] / s, s the per-sample
        ``dynamic_thresholding_ratio`` quantile of |x0| clipped to [1,
        ``sample_max_value``]."""
        B = sample.shape[0]
        flat = sample.reshape(B, -1).abs().float()
        s = torch.quantile(flat, self.dynamic_thresholding_ratio, dim=1)
        s = s.clamp(1.0, self.sample_max_value).reshape((B,) + (1,) * (sample.ndim - 1))
        return torch.maximum(torch.minimum(sample, s), -s) / s


class SDEVEGFNScheduler:
    """Variance-exploding SDE sampler with GFN outputs
    (scheduling_sde_ve_gfn.py; JAX :172-220): reverse-diffusion predictor
    steps down a geometric sigma ladder; the model predicts the score."""

    def __init__(self, num_train_timesteps: int = 1000, sigma_min: float = 0.01,
                 sigma_max: float = 50.0, num_inference_steps: Optional[int] = None,
                 device=None):
        self.num_train_timesteps = num_train_timesteps
        self.sigma_min, self.sigma_max = sigma_min, sigma_max
        self.device = torch.device(device or "cpu")
        self.set_timesteps(num_inference_steps or num_train_timesteps)

    def set_timesteps(self, n: int) -> np.ndarray:
        self.num_inference_steps = n
        self.timesteps = np.arange(n)[::-1].copy()
        ladder = self.sigma_min * (self.sigma_max / self.sigma_min) ** np.linspace(0, 1, n)
        self.sigmas = torch.tensor(ladder, dtype=torch.float32, device=self.device)
        return self.timesteps

    def step(self, score, t, sample, generator: Optional[torch.Generator] = None, noise=None,
             target=None, xT_type: str = "gaussian") -> dict:
        t = torch.as_tensor(t, device=self.device)
        sigma_t = self.sigmas[t.long()]
        sigma_prev = torch.where(t > 0, self.sigmas[(t - 1).clamp(min=0).long()],
                                 torch.zeros_like(sigma_t))
        diff2 = DDPMGFNScheduler._bc((sigma_t ** 2 - sigma_prev ** 2).clamp(min=1e-12), sample)
        mean = sample + diff2 * score
        std = diff2 ** 0.5
        if target is not None:
            variance_noise = (target - mean) / std
        elif noise is None:
            variance_noise = _step_noise(generator, sample.shape, sample.device)
        else:
            variance_noise = _given_noise(noise, sample)
        add = DDPMGFNScheduler._bc((t > 0).to(torch.float32), sample)
        return {"prev_sample": mean + add * std * variance_noise, "pred_original_sample": mean,
                "posterior_mean": mean, "posterior_std": std, "noise": variance_noise}

    def add_noise(self, original_samples, noise, timesteps):
        s = self.sigmas[torch.as_tensor(timesteps, device=self.device).long()]
        return original_samples + s.reshape((-1,) + (1,) * (original_samples.ndim - 1)) * noise


class EDMEulerGFNScheduler:
    """Karras-EDM Euler sampler with GFN-compatible outputs
    (scheduling_edm_euler_gfn.py; JAX :223-270): an x0-parametrized
    denoiser over a Karras sigma schedule, a deterministic first-order Euler
    step; ``posterior_std`` is the floor 1e-6 and ``noise`` is reported but
    not added."""

    def __init__(self, num_train_timesteps: int = 1000, sigma_min: float = 0.002,
                 sigma_max: float = 80.0, rho: float = 7.0,
                 num_inference_steps: Optional[int] = None, device=None):
        self.num_train_timesteps = num_train_timesteps
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho
        self.device = torch.device(device or "cpu")
        self.set_timesteps(num_inference_steps or 50)

    def set_timesteps(self, n: int) -> np.ndarray:
        self.num_inference_steps = n
        ramp = np.linspace(0, 1, n)
        inv_rho = 1.0 / self.rho
        sigmas = (self.sigma_max ** inv_rho
                  + ramp * (self.sigma_min ** inv_rho - self.sigma_max ** inv_rho)) ** self.rho
        self.sigmas = torch.tensor(np.append(sigmas, 0.0), dtype=torch.float32,
                                   device=self.device)
        self.timesteps = np.arange(n)[::-1].copy()
        return self.timesteps

    def precondition(self, sample, t):
        sigma = self.sigmas[torch.as_tensor(t, device=self.device).long()]
        return sample / DDPMGFNScheduler._bc((sigma ** 2 + 1) ** 0.5, sample)

    def step(self, denoised_x0, t, sample, generator: Optional[torch.Generator] = None,
             noise=None, target=None, xT_type: str = "gaussian") -> dict:
        i = self.num_inference_steps - 1 - torch.as_tensor(t, device=self.device).long()
        sigma = DDPMGFNScheduler._bc(self.sigmas[i], sample)  # t counts down, sigmas up
        sigma_next = DDPMGFNScheduler._bc(self.sigmas[i + 1], sample)
        d = (sample - denoised_x0) / sigma.clamp(min=1e-12)
        mean = sample + (sigma_next - sigma) * d
        std = torch.full((), 1e-6, device=sample.device)  # the Euler step is deterministic
        if noise is None:
            variance_noise = (torch.zeros_like(sample) if generator is None
                              else _step_noise(generator, sample.shape, sample.device))
        else:
            variance_noise = _given_noise(noise, sample)
        return {"prev_sample": mean, "pred_original_sample": denoised_x0,
                "posterior_mean": mean, "posterior_std": std, "noise": variance_noise}
