"""Flow-matching training losses and the probability-flow drift.

Counterpart of the JAX package's ``transport/transport.py::Transport``
(:35-180; reference src/mdgen/transport/transport.py:137-257) for the
continuous objectives: velocity matching, and the noise / score objectives
with their loss weightings; ``drift_fn`` for the ODE samplers
(``samplers.py``); ``t_to_alpha``, the Dirichlet concentration schedule that
design sampling reads (``models/denoiser.py::forward_inference``). The
Dirichlet flow-matching terms of the design task's loss are not ported yet
(ROADMAP.md queue 1 item 14), nor is the SDE sampler (item 8).

Randomness: ``training_losses`` draws t and x0 from a ``torch.Generator``,
or takes them as given (the tests hand both packages the same draws).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import MDGenConfig
from .paths import expand_t, get_path


def t_to_alpha(t, alpha_max: float):
    """Linear schedule 1 -> alpha_max for the Dirichlet concentration and
    its derivative in t (src/mdgen/transport/transport.py:52-57)."""
    return 1 * (1 - t) + t * alpha_max, (alpha_max - 1)


def mean_flat(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over all non-batch dims (src/mdgen/transport/transport.py:12-16)."""
    dims = tuple(range(1, x.ndim))
    return (x * mask).sum(dims) / mask.sum(dims)


def check_interval(cfg: MDGenConfig, *, sde: bool = False, eval: bool = False,
                   last_step_size: float = 0.0):
    """Integration interval endpoints (src/mdgen/transport/transport.py:94-123)."""
    t0, t1 = 0.0, 1.0
    train_eps, sample_eps = default_eps(cfg)
    eps = sample_eps if eval else train_eps
    if cfg.transport.path_type == "VP":
        t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
    elif cfg.transport.prediction != "velocity" or sde:
        t0 = eps
        t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
    return t0, t1


def default_eps(cfg: MDGenConfig):
    """(train_eps, sample_eps) of the path and objective."""
    t = cfg.transport
    if t.path_type == "VP":
        return t.train_eps or 1e-5, t.sample_eps or 1e-3
    if t.prediction != "velocity":
        return t.train_eps or 1e-3, t.sample_eps or 1e-3
    return 0.0, 0.0


class Transport:
    """The path and the prediction type of a config."""

    def __init__(self, cfg: MDGenConfig):
        self.cfg = cfg
        self.path = get_path(cfg.transport.path_type)
        self.prediction = cfg.transport.prediction

    def check_interval(self, **kw):
        return check_interval(self.cfg, **kw)

    def training_losses(self, model_fn: Callable, x1: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        model_kwargs: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        x0: Optional[torch.Tensor] = None) -> dict:
        """The per-element loss (B,) of ``model_fn(x_t, t, **model_kwargs)``
        against the path's target. t (B,) and x0 (like x1) are drawn from
        ``generator`` unless given. Returns {"t", "pred", "loss"}."""
        if self.cfg.task.design:
            raise NotImplementedError(
                "the design task's Dirichlet flow-matching loss is not ported yet "
                "(ROADMAP.md queue 1 item 14, training the design tasks)")
        B = x1.shape[0]
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=generator.device,
                             dtype=x1.dtype).to(x1.device)
        if t is None:
            t0, t1 = self.check_interval()
            u = torch.rand(B, generator=generator, device=generator.device, dtype=x1.dtype)
            t = u.to(x1.device) * (t1 - t0) + t0
        te = expand_t(t, x1)
        xt, ut = self.path.interpolate(te, x0, x1)
        out = model_fn(xt, t, **(model_kwargs or {}))
        mask = torch.ones_like(x1) if mask is None else mask
        terms = {"t": t, "pred": out}
        if self.prediction == "velocity":
            terms["loss"] = mean_flat((out - ut) ** 2, mask)
            return terms
        sigma_t, _ = self.path.sigma(te)
        # loss weighting of the noise / score objectives
        # (src/mdgen/transport/transport.py:190-201)
        lw = self.cfg.transport.loss_weight
        if lw == "velocity":
            weight = (self.path.drift(xt, te)[1] / sigma_t) ** 2
        elif lw == "likelihood":
            weight = self.path.drift(xt, te)[1] / sigma_t ** 2
        elif lw == "none":
            weight = 1.0
        else:
            raise NotImplementedError(f"loss_weight={lw}")
        if self.prediction == "noise":
            terms["loss"] = mean_flat(weight * (out - x0) ** 2, mask)
        else:  # score
            terms["loss"] = mean_flat(weight * (out * sigma_t + x0) ** 2, mask)
        return terms

    def drift_fn(self, model_fn: Callable) -> Callable:
        """The probability-flow ODE drift ``drift(x, t)`` of ``model_fn(x, t)``
        for the config's prediction type (src/mdgen/transport/transport.py:
        224-257; the JAX package's ``Transport.drift_fn``, :159-180)."""
        if self.prediction == "velocity":
            return model_fn

        if self.prediction == "score":
            def score_ode(x, t):
                te = expand_t(t, x)
                drift_mean, drift_var = self.path.drift(x, te)
                return -drift_mean + drift_var * model_fn(x, t)

            return score_ode

        def noise_ode(x, t):
            te = expand_t(t, x)
            drift_mean, drift_var = self.path.drift(x, te)
            sigma_t, _ = self.path.sigma(te)
            score = model_fn(x, t) / -sigma_t
            return -drift_mean + drift_var * score

        return noise_ode


def create_transport(cfg: MDGenConfig) -> Transport:
    return Transport(cfg)
