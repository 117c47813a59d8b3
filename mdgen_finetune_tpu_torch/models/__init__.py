"""The denoiser (``denoiser.LatentMDGen``) and its building blocks."""
