"""RTB posterior fine-tuning (the JAX package's ``rtb/``): the DDPM-GFN
scheduler and its DDIM / DDPM-DP / SDE-VE / EDM-Euler siblings, LoRA
adapters, the twin-policy sampler, the rewards, the replay buffer, the
frozen-prior wrapper, the trainers, the outsourced UNet policies and the
plain-generation pipelines."""
from .denoisers import UNet2D, UNet3DSeq, UNetSeqDenoiser
from .lora import lora_init, lora_kernels, lora_merge, lora_targets_default
from .pipelines import (DDIMGFNPipeline, DDPMDPPipeline, DDPMGFNPipeline, DiffusionPipeline,
                        LDMGFNPipeline)
from .replay_buffer import ReplayBuffer
from .samplers import PosteriorPriorBaselineSampler, PosteriorPriorDGFN
from .scheduler import DDPMGFNScheduler
from .schedulers_extra import (DDIMGFNScheduler, DDPMDPScheduler, EDMEulerGFNScheduler,
                               SDEVEGFNScheduler)

__all__ = [
    "DDPMGFNScheduler",
    "DDIMGFNScheduler",
    "DDPMDPScheduler",
    "EDMEulerGFNScheduler",
    "SDEVEGFNScheduler",
    "lora_init",
    "lora_kernels",
    "lora_merge",
    "lora_targets_default",
    "PosteriorPriorDGFN",
    "PosteriorPriorBaselineSampler",
    "ReplayBuffer",
    "UNet2D",
    "UNet3DSeq",
    "UNetSeqDenoiser",
    "DiffusionPipeline",
    "DDPMGFNPipeline",
    "DDIMGFNPipeline",
    "DDPMDPPipeline",
    "LDMGFNPipeline",
]
