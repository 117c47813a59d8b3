"""Flow-matching training losses, the probability-flow drift, the score and
the reverse-SDE sampler.

Counterpart of the JAX package's ``transport/transport.py::Transport``
(:35-234; reference src/mdgen/transport/transport.py:84-405) for the
continuous objectives: velocity matching, and the noise / score objectives
with their loss weightings; ``drift_fn`` for the ODE samplers and the
likelihood (``samplers.py``); ``score_fn`` and ``make_sde_sampler`` (the
SDE sampler with its Mean / Euler / Tweedie last steps); ``prior_logp``;
``t_to_alpha``, the Dirichlet concentration schedule that design sampling
reads (``models/denoiser.py::forward_inference``) and the design tasks'
Dirichlet flow-matching loss draws from (JAX :93-152; reference
src/mdgen/transport/transport.py:160-171, 208-219).

Randomness: ``training_losses`` draws t, x0 and the design task's simplex
point from a ``torch.Generator``, or takes them as given (the tests hand
both packages the same draws).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..config import MDGenConfig
from .paths import expand_t, get_path
from .samplers import sample_sde


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

    def draws(self, generator: Optional[torch.Generator], shape, dtype, device,
              aatype1: Optional[torch.Tensor] = None, x0=None, t=None, x_d=None):
        """``training_losses``' random draws for a latent batch of ``shape``
        (B, T, L, K), in its order: x0 (a standard normal of ``shape``), t
        (B,) uniform on the training interval, and with ``design`` (not
        ``mpnn`` / ``dynamic_mpnn``) the simplex point x_d (B, L, 20), a
        Dirichlet draw at the concentrations of ``aatype1`` and t. Those given
        are kept. Returns (x0, t, x_d) on ``device`` (x_d on the generator's
        device, or None)."""
        if x0 is None:
            x0 = torch.randn(shape, generator=generator, device=generator.device,
                             dtype=dtype).to(device)
        if t is None:
            t0, t1 = self.check_interval()
            u = torch.rand(shape[0], generator=generator, device=generator.device, dtype=dtype)
            t = u.to(device) * (t1 - t0) + t0
        task = self.cfg.task
        if task.design and not (task.mpnn or task.dynamic_mpnn) and x_d is None:
            alphas = 1 + _one_hot20(aatype1, dtype) * (
                t_to_alpha(t, self.cfg.transport.alpha_max)[0][:, None, None] - 1)
            x_d = torch._sample_dirichlet(alphas.to(generator.device), generator)
        return x0, t, x_d

    def training_losses(self, model_fn: Callable, x1: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        model_kwargs: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None,
                        t: Optional[torch.Tensor] = None,
                        x0: Optional[torch.Tensor] = None,
                        aatype1: Optional[torch.Tensor] = None,
                        x_d: Optional[torch.Tensor] = None) -> dict:
        """The per-element loss (B,) of ``model_fn(x_t, t, **model_kwargs)``
        against the path's target. t (B,) and x0 (like x1) are drawn from
        ``generator`` unless given. Returns {"t", "pred", "loss"}.

        With ``design`` (JAX :93-152) x_t gains 20 simplex channels: under
        ``mpnn`` / ``dynamic_mpnn`` zeros, and the model, called at t = 1,
        returns the sequence logits, whose cross-entropy against ``aatype1``
        (B, L) is the loss (``loss_continuous`` a (B,) NaN); otherwise a
        point of Dir(1 + onehot(aatype1) (alpha(t) - 1)) per residue (``x_d``
        (B, L, 20) when given, else drawn from ``generator``), the same for
        every frame, and the loss is ``w * CE(out[..., -20:]) + (1 - w) *
        loss_continuous`` of ``out[..., :-20]`` (``discrete_loss_weight``).
        x_t is interpolated at the drawn t before t is set to 1 (JAX
        :96-99). The result then also holds ``loss_discrete``,
        ``loss_continuous`` and ``logits``."""
        task = self.cfg.task
        design = task.design
        mpnn = task.mpnn or task.dynamic_mpnn
        if design and self.prediction != "velocity":
            raise ValueError("the design tasks train the velocity objective only")
        B = x1.shape[0]
        x0, t, x_d = self.draws(generator, x1.shape, x1.dtype, x1.device, aatype1, x0=x0, t=t,
                                x_d=x_d)
        te = expand_t(t, x1)
        xt, ut = self.path.interpolate(te, x0, x1)
        if design:
            _, T, L, _ = x1.shape
            if mpnn:
                t = torch.ones_like(t)
                x_d = x1.new_zeros(B, L, 20)
            x_d = x_d.to(xt.device, xt.dtype)[:, None].expand(B, T, L, 20)
            xt = torch.cat([xt, x_d], dim=-1)
        out = model_fn(xt, t, **(model_kwargs or {}))
        terms = {"t": t}
        if design:
            logits = out if mpnn else out[..., -20:]
            loss_d = _cross_entropy(logits, aatype1)
            terms.update(loss_discrete=loss_d, logits=logits)
            if mpnn:
                terms.update(pred=out, loss=loss_d,
                             loss_continuous=x1.new_full((B,), float("nan")))
                return terms
            out = out[..., :-20]
        mask = torch.ones_like(x1) if mask is None else mask
        terms["pred"] = out
        if self.prediction == "velocity":
            terms["loss"] = mean_flat((out - ut) ** 2, mask)
        else:
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
        if design:
            w = self.cfg.transport.discrete_loss_weight
            terms["loss_continuous"] = terms["loss"]
            terms["loss"] = terms["loss_discrete"] * w + (1 - w) * terms["loss"]
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

    def score_fn(self, model_fn: Callable) -> Callable:
        """The score ``score(x, t)`` of ``model_fn(x, t)`` for the config's
        prediction type (reference transport.py:259-275; JAX :182-188)."""
        if self.prediction == "noise":
            return lambda x, t: model_fn(x, t) / -self.path.sigma(expand_t(t, x))[0]
        if self.prediction == "score":
            return model_fn
        return lambda x, t: self.path.score_from_velocity(model_fn(x, t), x, expand_t(t, x))

    def make_sde_sampler(self, model_fn: Callable, *, num_steps: int = 250,
                         method: str = "Euler", diffusion_form: str = "SBDM",
                         diffusion_norm: float = 1.0, last_step: str = "Mean",
                         last_step_size: float = 0.04) -> Callable:
        """The reverse-SDE sampler of ``model_fn`` (JAX :190-228; reference
        transport.py:294-405): ``sample(x, generator=None, noise=None, rows=None)``
        -> (x, counts) through ``samplers.sample_sde`` on [max(t0, 1e-3), t1]
        of ``check_interval(sde=True, eval=True, last_step_size=...)``
        (the score and the diffusion are singular at t = 0). The drift and
        the score of one (x, t) share one call of ``model_fn``. ``Tweedie``
        ends with x / alpha + sigma^2 / alpha * score(x, t1) at t1 (one
        more call)."""
        if last_step not in ("Mean", "Euler", "Tweedie"):
            raise NotImplementedError(last_step)
        model_fn = _last_call(model_fn)
        drift, score = self.drift_fn(model_fn), self.score_fn(model_fn)

        def diffusion(x, te):
            return self.path.diffusion(x, te, form=diffusion_form, norm=diffusion_norm)

        t0, t1 = self.check_interval(sde=True, eval=True, last_step_size=last_step_size)
        t0 = max(t0, 1e-3)

        def sample(x, generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None, rows: Optional[tuple] = None):
            out, counts = sample_sde(drift, diffusion, score, x, t0=t0, t1=t1,
                                     num_steps=num_steps, method=method,
                                     last_step=None if last_step == "Tweedie" else last_step,
                                     last_step_size=last_step_size, generator=generator,
                                     noise=noise, rows=rows)
            if last_step == "Tweedie":
                tv = torch.full((x.shape[0],), t1, dtype=x.dtype, device=x.device)
                te = expand_t(tv, out)
                alpha, _ = self.path.alpha(te)
                sigma, _ = self.path.sigma(te)
                out = out / alpha + (sigma ** 2 / alpha) * score(out, tv)
                counts["evals"] += 1
            return out, counts

        return sample

    @staticmethod
    def prior_logp(z: torch.Tensor) -> torch.Tensor:
        """Standard-normal log density of each element of the batch (B,)
        (reference transport.py:84-92; JAX :230-234)."""
        n = z[0].numel()
        return -n / 2.0 * math.log(2 * math.pi) - (z.reshape(z.shape[0], -1) ** 2).sum(-1) / 2.0


def _one_hot20(aatype, dtype) -> torch.Tensor:
    """(..., 20) one-hot of residue types; type 20 (unknown) is all zeros,
    as ``jax.nn.one_hot`` gives it."""
    return (aatype.long()[..., None] == torch.arange(20, device=aatype.device)).to(dtype)


def _cross_entropy(logits: torch.Tensor, aatype1: torch.Tensor) -> torch.Tensor:
    """Mean over every (element, frame, residue) of -log softmax(logits) at
    the residue's type: logits (B, T', L, 20), aatype1 (B, L). A type out of
    range (20) reads NaN, as ``jnp.take_along_axis`` fills it."""
    log_p = torch.log_softmax(logits, dim=-1)
    tgt = aatype1.long()[:, None].expand(logits.shape[:-1])
    picked = log_p.gather(-1, tgt.clamp(max=19)[..., None])[..., 0]
    return -torch.where(tgt < 20, picked, float("nan")).mean()


def _last_call(model_fn: Callable) -> Callable:
    """``model_fn`` that returns its last result again when called with the
    same x and t objects (the SDE drift asks for the drift and the score of
    one (x, t): one model evaluation)."""
    last = [None, None, None]

    def call(x, t):
        if last[0] is not x or last[1] is not t:
            last[:] = [x, t, model_fn(x, t)]
        return last[2]

    return call


def create_transport(cfg: MDGenConfig) -> Transport:
    return Transport(cfg)
