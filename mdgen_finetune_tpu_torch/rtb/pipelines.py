"""Diffusion sampling pipelines over the GFN scheduler family.

Counterpart of the JAX package's ``rtb/pipelines.py`` (reference
src/rtb_utils/diffusers/pipelines/: ddpm_gfn/pipeline_ddpm.py:26-150,
ddim_gfn/pipeline_ddim_gfn.py, ddpm_dp/pipeline_ddpm_dp.py,
ldm_gfn/pipeline_ldm_gfn.py). A pipeline binds a denoiser to a scheduler and
runs the ancestral chain as a Python loop over ``scheduler.step``, as the
reference's pipelines do (pipeline_ddpm.py:131-147); the JAX package runs
the same chain as one ``lax.scan``. The per-step math lives in the
schedulers (``rtb/scheduler.py``, ``rtb/schedulers_extra.py``).

The RTB fine-tuning path does not use these (``PosteriorPriorDGFN`` runs its
own chain that records log-probs): they are the plain-generation surface
for a trained denoiser, on the scheduler's device. The named pipelines
build their scheduler on ``device``, the card unless the CPU is asked for.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..inference.sampling import resolve_device
from .scheduler import DDPMGFNScheduler
from .schedulers_extra import DDIMGFNScheduler, DDPMDPScheduler


class DiffusionPipeline:
    """Generic ancestral-sampling pipeline.

    ``denoise_fn(x, t, **condition) -> model_output``, ``t`` a (B,) int64
    tensor of train-timestep indices; ``scheduler`` any GFN scheduler with
    ``set_timesteps`` / ``step``; ``decode_fn`` (optional) maps the final
    latents to the output space (the LDM pipeline's decoder)."""

    def __init__(self, denoise_fn: Callable, scheduler, decode_fn: Optional[Callable] = None):
        self.denoise_fn = denoise_fn
        self.scheduler = scheduler
        self.decode_fn = decode_fn

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator] = None, batch_size: int = 1,
                 num_inference_steps: Optional[int] = None, x_shape: Optional[tuple] = None,
                 condition: Optional[dict] = None, noise_type: str = "gaussian",
                 x_init: Optional[torch.Tensor] = None,
                 noises: Optional[Sequence[torch.Tensor]] = None):
        """Sample ``(batch_size, *x_shape)`` (pipeline_ddpm.py:50-147): the
        initial state standard normal or U[-3, 3] under
        ``noise_type="uniform"``, ``condition`` forwarded to the denoiser at
        every step. The draws come from ``generator``, or are given:
        ``x_init`` the initial state, ``noises[i]`` the i-th step's noise."""
        if x_shape is None:
            raise ValueError("x_shape is required")
        if num_inference_steps is not None:
            self.scheduler.set_timesteps(num_inference_steps)
        dev = self.scheduler.device
        shape = (batch_size,) + tuple(x_shape)
        if x_init is None:
            if generator is None:
                raise ValueError("need a generator or x_init")
            x = (6.0 * torch.rand(shape, generator=generator, device=generator.device) - 3.0
                 if noise_type == "uniform"
                 else torch.randn(shape, generator=generator, device=generator.device))
        else:
            x = x_init
        x = x.to(dev, torch.float32)
        for i, tk in enumerate(self.scheduler.timesteps):
            tvec = torch.full((batch_size,), int(tk), dtype=torch.int64, device=dev)
            out = self.denoise_fn(x, tvec, **(condition or {}))
            noise = None if noises is None else noises[i].to(dev)
            x = self.scheduler.step(out, tvec, x, generator=generator, noise=noise)["prev_sample"]
        if self.decode_fn is not None:
            x = self.decode_fn(x)
        return x

    def sample(self, *args, **kwargs):
        return self(*args, **kwargs)


class DDPMGFNPipeline(DiffusionPipeline):
    """DDPM ancestral sampling (pipeline_ddpm.py:26-150). Takes only a
    DDPM-GFN-family scheduler, as the reference's
    ``DDPMGFNScheduler.from_config`` guard does."""

    def __init__(self, denoise_fn, scheduler=None, device="cuda", **sched_kw):
        if scheduler is None:
            scheduler = DDPMGFNScheduler(device=resolve_device(device), **sched_kw)
        elif not isinstance(scheduler, DDPMGFNScheduler):
            raise TypeError("DDPMGFNPipeline needs a DDPMGFNScheduler(-family) scheduler")
        super().__init__(denoise_fn, scheduler)


class DDIMGFNPipeline(DiffusionPipeline):
    """DDIM sampling with eta-controlled stochasticity
    (pipeline_ddim_gfn.py; eta lives on the scheduler)."""

    def __init__(self, denoise_fn, scheduler=None, eta: float = 0.0, device="cuda",
                 **sched_kw):
        super().__init__(denoise_fn, scheduler or DDIMGFNScheduler(
            eta=eta, device=resolve_device(device), **sched_kw))


class DDPMDPPipeline(DiffusionPipeline):
    """DDPM-DP sampling (pipeline_ddpm_dp.py over scheduling_ddpm_dp)."""

    def __init__(self, denoise_fn, scheduler=None, device="cuda", **sched_kw):
        super().__init__(denoise_fn, scheduler or DDPMDPScheduler(
            device=resolve_device(device), **sched_kw))


class LDMGFNPipeline(DiffusionPipeline):
    """Latent sampling, then ``decode_fn`` (pipeline_ldm_gfn.py:60-137: the
    scheduler loop over latents, then the autoencoder's decode)."""

    def __init__(self, denoise_fn, decode_fn, scheduler=None, eta: float = 1.0, device="cuda",
                 **sched_kw):
        super().__init__(denoise_fn, scheduler or DDIMGFNScheduler(
            eta=eta, device=resolve_device(device), **sched_kw), decode_fn=decode_fn)
