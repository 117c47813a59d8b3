"""Posterior / prior GFlowNet diffusion sampler.

Counterpart of the JAX package's ``rtb/samplers.py`` (reference
PosteriorPriorDGFN.sample_fwd, src/models/samplers.py:380-486): twin DDPM
policies, a frozen prior and a LoRA posterior, step the same chain; the
posterior reuses the prior's realized noise, and the loop sums exact Normal
log-probs of the realized transitions under the prior forward policy, the
posterior forward policy and the fixed backward (noising) policy. JAX's
``lax.scan`` is a Python loop here. The carried state is detached (the
reference's ``.detach()``), the prior branch runs under ``torch.no_grad``,
a step whose detach flag is set detaches the posterior's output, and the
Langevin shift is detached: gradients flow only through the posterior's
mean and std at each step, in exactly JAX's places.

Every draw can be passed in, so that a caller can replay a trajectory or
feed another implementation's draws: ``x_start``, the per-step ``noise``
(S, B, *dim), the ``detach_flags`` (S,) and the back-and-forth noise.
Otherwise each is drawn from an explicit ``torch.Generator``, in the order
x_start, detach flags, then each step's noise.

Policies: ``prior_fn(x, t, condition)`` and ``posterior_fn(lora, x, t,
condition)``, with t a Python int (one timestep for the batch) or a (B,)
integer tensor (``replay_logpf``); ``condition`` is the policy's keyword
arguments, tensors and ``Rigid`` frames with a leading batch axis.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from ..geometry.rigid import Rigid
from .scheduler import DDPMGFNScheduler, normal_logprob


def map_condition(fn, condition: dict) -> dict:
    """``fn`` on every tensor of a condition dict (a ``Rigid``'s rot and
    trans; None stays None)."""
    def one(v):
        if isinstance(v, Rigid):
            return Rigid(fn(v.rot), fn(v.trans))
        return fn(v) if torch.is_tensor(v) else v
    return {k: one(v) for k, v in condition.items()}


def _randn(generator, shape):
    return torch.randn(shape, generator=generator, device=generator.device)


def draw_xT(generator: torch.Generator, shape: tuple, xT_type: str = "gaussian") -> torch.Tensor:
    """A draw of the terminal prior: N(0, 1), or U[-3, 3] under
    ``xT_type="uniform"``."""
    if xT_type == "uniform":
        return torch.rand(shape, generator=generator, device=generator.device) * 6.0 - 3.0
    return _randn(generator, shape)


def xT_logprob(x, xT_type: str = "gaussian"):
    """(B,) log-density of x under the terminal prior of ``draw_xT``."""
    if xT_type == "uniform":
        return torch.full((x.shape[0],), -math.log(6.0) * x[0].numel(), device=x.device)
    return normal_logprob(x, torch.zeros_like(x), torch.ones_like(x))


def _detach_flags(generator, n_steps: int, detach_freq: float) -> np.ndarray:
    """``int(n_steps * detach_freq)`` distinct steps, drawn without
    replacement (JAX draws them with ``jax.random.choice``)."""
    flags = np.zeros(n_steps, bool)
    n = int(n_steps * detach_freq)
    if n:
        idx = torch.randperm(n_steps, generator=generator, device=generator.device)[:n]
        flags[idx.cpu().numpy()] = True
    return flags


class PosteriorPriorDGFN:
    def __init__(self, scheduler: DDPMGFNScheduler, prior_fn: Callable, posterior_fn: Callable,
                 dim: tuple, sampling_length: int = 100, xT_type: str = "gaussian",
                 langevin_fn: Optional[Callable] = None):
        """``langevin_fn(x, t)``: an optional reward-gradient correction
        (detached by the caller) added to both policies' step mean (src/
        models/samplers.py:120-171; JAX applies the equivalent mean-space
        shift of the reference's output correction)."""
        self.scheduler = scheduler
        self.prior_fn = prior_fn
        self.posterior_fn = posterior_fn
        self.dim = tuple(dim)
        self.sampling_length = sampling_length
        self.xT_type = xT_type
        self.langevin_fn = langevin_fn
        scheduler.set_timesteps(sampling_length)

    def draws(self, generator: torch.Generator, batch_size: int,
              detach_freq: float = 0.0) -> dict:
        """One forward trajectory's randomness drawn ahead, for ``sample_fwd``:
        {x_start, detach_flags, noise (S, B, *dim)} (U[-3, 3] noise under
        ``xT_type="uniform"``)."""
        S = len(self.scheduler.timesteps)
        x_start = draw_xT(generator, (batch_size, *self.dim), self.xT_type)
        flags = _detach_flags(generator, S, detach_freq)
        noise = draw_xT(generator, (S, batch_size, *self.dim), self.xT_type)
        return {"x_start": x_start, "detach_flags": flags, "noise": noise}

    # ------------------------------------------------------------------
    def sample_fwd(self, generator: Optional[torch.Generator], lora, condition: dict,
                   batch_size: int, x_start=None, noise=None, detach_flags=None,
                   detach_freq: float = 0.0, detach_cut_off: float = 1.0,
                   sample_from_prior: bool = False, save_traj: bool = False,
                   timesteps=None, include_x_start_logp: bool = True) -> dict:
        """{x, logpf_posterior, logpf_prior, logpb} (+ ``traj`` (S+1, B,
        *dim), xT first, with ``save_traj``); JAX :62-156.

        ``detach_cut_off``: also detach every step with t > detach_cut_off *
        num_train_timesteps (src/models/samplers.py:426-427). ``timesteps``:
        another descending timestep list (partial chains of the
        back-and-forth step). ``include_x_start_logp``: count x_start's
        density under the terminal prior in the forward log-probs."""
        sched = self.scheduler
        ts = sched.timesteps if timesteps is None else np.asarray(timesteps)
        n_steps = len(ts)
        if x_start is None:
            x_start = draw_xT(generator, (batch_size, *self.dim), self.xT_type)
        x = x_start
        logp0 = (xT_logprob(x, self.xT_type) if include_x_start_logp
                 else torch.zeros(x.shape[0], device=x.device))
        flags = (_detach_flags(generator, n_steps, detach_freq) if detach_flags is None
                 else np.asarray(detach_flags, bool))
        if detach_cut_off < 1.0:
            flags = flags | (ts > detach_cut_off * sched.num_train_timesteps)

        xT = x
        lpf_prior, lpf_post, lpb = logp0, logp0, torch.zeros_like(logp0)
        traj = [xT]
        for i, t in enumerate(ts):
            # the reference steps from next_timestep(t) (samplers.py:435)
            t_next = sched.next_timestep(int(t))
            lgv = self.langevin_fn(x, t_next) if self.langevin_fn is not None else 0.0
            with torch.no_grad():
                prior_out = self.prior_fn(x, t_next, condition)
                pr = sched.step(prior_out, t_next, x, generator=generator,
                                noise=None if noise is None else noise[i], xT_type=self.xT_type)
            pr_mean = pr["posterior_mean"] + lgv

            post_out = self.posterior_fn(lora, x, t_next, condition)
            if flags[i]:
                post_out = post_out.detach()
            po = sched.step(post_out, t_next, x, noise=pr["noise"])
            po_mean = po["posterior_mean"] + lgv

            new_x = (pr["prev_sample"] + lgv if sample_from_prior
                     else po["prev_sample"] + lgv).detach()
            lpf_prior = lpf_prior + normal_logprob(new_x, pr_mean, pr["posterior_std"])
            lpf_post = lpf_post + normal_logprob(new_x, po_mean, po["posterior_std"])
            _, pb_mean, pb_std = sched.step_noise(new_x, xT, t=t_next)
            lpb = lpb + normal_logprob(x, pb_mean.detach(), pb_std)
            x = new_x
            if save_traj:
                traj.append(x)
        out = {"x": x, "logpf_prior": lpf_prior, "logpf_posterior": lpf_post, "logpb": lpb}
        if save_traj:
            out["traj"] = torch.stack(traj)
        return out

    # ------------------------------------------------------------------
    def sample_bkw(self, generator: Optional[torch.Generator], lora, condition: dict, x,
                   noise=None, detach_flags=None, detach_freq: float = 0.0, timesteps=None,
                   include_xT_logp: bool = True) -> dict:
        """Backward (noising) trajectory from the terminal x, scoring the
        posterior and the prior forward log-probs along it (JAX :158-233;
        src/models/samplers.py:488-578). Each backward state is a fresh
        marginal noising of the clean sample (``add_noise(x, noise,
        t_next)``), as in the reference; ``noise`` (S, B, *dim) in ascending
        t order, else drawn after the detach flags."""
        sched = self.scheduler
        ts_host = sched.timesteps if timesteps is None else np.asarray(timesteps)
        ts = ts_host[::-1]  # ascending: clean -> noise
        n_steps = len(ts)
        flags = (_detach_flags(generator, n_steps, detach_freq) if detach_flags is None
                 else np.asarray(detach_flags, bool))
        B = x.shape[0]
        x_start, x_cur = x, x
        zero = torch.zeros(B, device=x.device)
        lpb, lpf_post, lpf_prior = zero, zero, zero
        for i, t in enumerate(ts):
            t_next = sched.next_timestep(int(t))
            eps = _randn(generator, x.shape) if noise is None else noise[i]
            t_vec = torch.full((B,), t_next, dtype=torch.long, device=x.device)
            x_noised, pb_mean, pb_std = sched.add_noise(x_start, eps, t_vec, return_std=True)
            x_noised = x_noised.detach()
            lpb = lpb + normal_logprob(x_noised, pb_mean, sched._bc(pb_std, x_noised))

            post_out = self.posterior_fn(lora, x_noised, t_next, condition)
            if flags[i]:
                post_out = post_out.detach()
            po = sched.step(post_out, t_next, x_noised, noise=torch.zeros_like(x_cur))
            lpf_post = lpf_post + normal_logprob(x_cur.detach(), po["posterior_mean"],
                                                 po["posterior_std"])
            with torch.no_grad():
                prior_out = self.prior_fn(x_noised, t_next, condition)
                pr = sched.step(prior_out, t_next, x_noised, noise=torch.zeros_like(x_cur))
                lpf_prior = lpf_prior + normal_logprob(x_cur, pr["posterior_mean"],
                                                       pr["posterior_std"])
            x_cur = x_noised
        if include_xT_logp:
            lpf_post = lpf_post + xT_logprob(x_cur, self.xT_type)
            lpf_prior = lpf_prior + xT_logprob(x_cur, self.xT_type)
        return {"x": x_start, "xT": x_cur, "logpb": lpb, "logpf_posterior": lpf_post,
                "logpf_prior": lpf_prior}

    # ------------------------------------------------------------------
    def replay_logpf(self, lora, condition: dict, xs, ts, targets):
        """Posterior log-probs of stored transitions with target-forced noise
        (JAX :242-259; src/models/samplers.py:686-742): xs, targets (m, B,
        *dim) states and their successors, ts (m,) integer timesteps; one
        policy call over the m * B flattened states, t per element.
        Returns (m * B,)."""
        m, B = xs.shape[:2]
        flat = xs.reshape(m * B, *xs.shape[2:])
        tgt = targets.reshape(m * B, *targets.shape[2:])
        t_vec = torch.as_tensor(ts, device=xs.device).long().repeat_interleave(B)
        cond = map_condition(lambda v: torch.cat([v] * m, dim=0), condition)
        out = self.posterior_fn(lora, flat, t_vec, cond)
        po = self.scheduler.step(out, t_vec, flat, target=tgt)
        return normal_logprob(po["prev_sample"].detach(), po["posterior_mean"],
                              po["posterior_std"])

    # ------------------------------------------------------------------
    def sample_back_and_forth(self, generator: Optional[torch.Generator], lora, condition: dict,
                              x, noise_level: float = 0.5, bkw_noise=None,
                              fwd_noise=None) -> dict:
        """Back-and-forth local exploration (JAX :261-298; src/models/
        samplers.py:580-660): noise good terminal samples backward over the
        last ``noise_level`` fraction of the chain, scoring both policies,
        then resample forward over the same partial chain (the forward
        reuses no draw of the backward: ``bkw_noise`` then ``fwd_noise``)."""
        ts = np.asarray(self.scheduler.timesteps)
        n_back = min(max(int(len(ts) * noise_level), 1), len(ts))
        partial = ts[len(ts) - n_back:]
        bkw = self.sample_bkw(generator, lora, condition, x, noise=bkw_noise, timesteps=partial,
                              include_xT_logp=False)
        fwd = self.sample_fwd(generator, lora, condition, x.shape[0], x_start=bkw["xT"],
                              noise=fwd_noise, timesteps=partial, include_x_start_logp=False)
        return {"x": x, "x_prime": fwd["x"], "t_mid": int(partial[0]),
                "logpf_posterior_b": bkw["logpf_posterior"], "logpf_prior_b": bkw["logpf_prior"],
                "logpb_b": bkw["logpb"], "logpf_posterior_f": fwd["logpf_posterior"],
                "logpf_prior_f": fwd["logpf_prior"], "logpb_f": fwd["logpb"]}


class PosteriorPriorBaselineSampler:
    """Training-free guidance baseline (DPS / FPS-style; JAX :300-389,
    src/models/samplers.py:1016-1175): each ancestral step runs the frozen
    prior, differentiates a reward objective of its x0 estimate in the state
    and shifts the step by ``scale * grad``. With ``mc`` the objective is a
    logsumexp over ``particles`` noise-perturbed x0 estimates. ``prior_fn``
    must be differentiable in x. Draws: ``x_start``, ``noise`` (S, B, *dim),
    ``particle_noise`` (S, P, B, *dim), else from the generator in that
    order per step (the step noise, then the particles)."""

    def __init__(self, scheduler: DDPMGFNScheduler, prior_fn: Callable, dim: tuple,
                 sampling_length: int = 100, xT_type: str = "gaussian", scale: float = 1.0,
                 mc: bool = False, particles: int = 10):
        self.scheduler = scheduler
        self.prior_fn = prior_fn
        self.dim = tuple(dim)
        self.sampling_length = sampling_length
        self.xT_type = xT_type
        self.scale = scale
        self.mc = mc
        self.particles = particles
        scheduler.set_timesteps(sampling_length)

    def sample(self, generator: Optional[torch.Generator], condition: dict, batch_size: int,
               log_reward_fn: Optional[Callable] = None, sample_from_prior: bool = False,
               x_start=None, noise=None, particle_noise=None) -> dict:
        sched = self.scheduler
        if x_start is None:
            x_start = draw_xT(generator, (batch_size, *self.dim), self.xT_type)
        x = x_start
        logp0 = xT_logprob(x, self.xT_type)
        guided = (not sample_from_prior) and log_reward_fn is not None
        lpf_post, lpf_prior = logp0, logp0

        def objective(xc, t, i):
            out = self.prior_fn(xc, t, condition)
            x0_hat = sched.pred_x0(out, t, xc)
            if not self.mc:
                return log_reward_fn(x0_hat).sum()
            r_t = sched._std(t)
            r_t = r_t / torch.sqrt(1 + r_t ** 2)
            vals = torch.stack([
                log_reward_fn(x0_hat + (_randn(generator, x0_hat.shape) if particle_noise is None
                                        else particle_noise[i, p]) * r_t)
                for p in range(self.particles)])
            return (torch.logsumexp(vals, dim=0) - math.log(self.particles)).sum()

        for i, t in enumerate(sched.timesteps):
            t = int(t)
            with torch.no_grad():
                out = self.prior_fn(x, t, condition)
                res = sched.step(out, t, x, generator=generator,
                                 noise=None if noise is None else noise[i], xT_type=self.xT_type)
            if guided:
                with torch.enable_grad():
                    xg = x.detach().requires_grad_()
                    g, = torch.autograd.grad(objective(xg, t, i), xg)
                g = torch.nan_to_num(g)
                new_x = res["prev_sample"] + g * self.scale
                lpf_post = lpf_post + normal_logprob(new_x, res["posterior_mean"] + g * self.scale,
                                                     res["posterior_std"])
                lpf_prior = lpf_prior + normal_logprob(new_x, res["posterior_mean"],
                                                       res["posterior_std"])
            else:
                new_x = res["prev_sample"]
                lp = normal_logprob(new_x, res["posterior_mean"], res["posterior_std"])
                lpf_post, lpf_prior = lpf_post + lp, lpf_prior + lp
            x = new_x.detach()
        return {"x": x, "logpf_posterior": lpf_post, "logpf_prior": lpf_prior}


def back_and_forth_loss(res: dict, logr_x, logr_x_prime, learning_cutoff: float = 0.0):
    """Local, logZ-free RTB loss of a back-and-forth pair (JAX :391-402):
    the two trajectories share their prefix up to the renoised midpoint, so
    their RTB constraints' difference cancels logZ and the prefix."""
    delta_f = res["logpf_posterior_f"] - res["logpf_prior_f"] - logr_x_prime
    delta_b = res["logpf_posterior_b"] - res["logpf_prior_b"] - logr_x
    return 0.5 * torch.relu((delta_f - delta_b) ** 2 - learning_cutoff)


def rtb_loss(logpf_posterior, logZ, log_pf_prior_or_pb, logr, learning_cutoff: float = 0.0):
    """Relative trajectory balance (src/rtb_utils/gfn_diffusion.py:459-460)."""
    return 0.5 * torch.relu(
        (logpf_posterior + logZ - log_pf_prior_or_pb - logr) ** 2 - learning_cutoff)


def vargrad_logz(logpf_posterior, log_pf_prior_or_pb, logr):
    """Per-sample logZ estimate of the VarGrad objective, detached
    (src/rtb_utils/gfn_diffusion.py:438-456)."""
    return (-logpf_posterior + log_pf_prior_or_pb + logr).detach()
