"""Sampling and rollout."""
from .sampling import InferenceEngine, sample_prior_latent

__all__ = ["InferenceEngine", "sample_prior_latent"]
