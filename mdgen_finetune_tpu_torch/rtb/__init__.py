"""RTB posterior fine-tuning of LatentMDGen (the JAX package's ``rtb/``):
the DDPM-GFN scheduler, LoRA adapters, the twin-policy sampler, the rewards,
the replay buffer, the frozen-prior wrapper and the trainers. The
outsourced UNet policies (``denoisers``, ``pipelines``, ``schedulers_extra``)
are not ported yet (ROADMAP.md queue 1)."""
from .lora import lora_init, lora_kernels, lora_merge, lora_targets_default
from .replay_buffer import ReplayBuffer
from .samplers import PosteriorPriorBaselineSampler, PosteriorPriorDGFN
from .scheduler import DDPMGFNScheduler

__all__ = [
    "DDPMGFNScheduler",
    "lora_init",
    "lora_kernels",
    "lora_merge",
    "lora_targets_default",
    "PosteriorPriorDGFN",
    "PosteriorPriorBaselineSampler",
    "ReplayBuffer",
]
