"""RTB posterior fine-tuning and prior distillation on one GPU.

Counterpart of the JAX package's ``rtb/trainer.py`` (reference
src/rtb_utils/gfn_diffusion.py):

- ``RTBTrainer`` (JAX :38-470; reference :154-543): each iteration draws the
  conditioning from the dataset, runs the twin-policy sampler (the frozen
  prior and the LoRA posterior, both the ``LatentMDGen`` denoiser as a DDPM
  v-predictor), decodes the terminal latents through the frozen flow, scores
  them with the reward, and takes an RTB / TB / VarGrad step on the adapters
  and logZ;
- ``RTBBatchedTrainer`` (JAX :472-550): one trajectory without gradients,
  then the gradient accumulated over chunks of timesteps by replaying the
  stored transitions with target-forced noise;
- ``DiffuserTrainer`` (JAX :553-617): distils the prior-latent distribution
  into a DDPM v-predictor (a ``LatentMDGen`` or an outsourced UNet) with
  the min-SNR-gamma loss.

The policy is one ``LatentMDGen`` (the prior's engine model unless other
weights are given), called through ``torch.func.functional_call``: once per
iteration the adapters are merged (``lora_merge``) and the trunk pack is
built from the merged weights under grad (``make_trunk_pack``), and every
posterior call of the iteration reuses both (JAX merges inside every scan
step; the values are the same). The prior is the same ``forward`` under
``torch.no_grad`` with the base weights and a pack made once, so that at
b = 0 the posterior's log-probs equal the prior's bit for bit. On the card
the calls run the trunk's and the encoder's hand-written kernels; the
posterior's backward runs the trunk's backward kernels (``FusedTrunkFn``).
An outsourced policy (``policy=``, say ``rtb.denoisers.UNet3DSeq``) has no
trunk pack: its prior is the module at its frozen weights and its posterior
one ``functional_call`` over the merged adapters (on its Linear kernels, by
``lora_targets``); the decode and the reward stay the prior flow's.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
multi_transform(adam(lr) for the adapters, adam(logz_lr) for logZ))``: the
clip's global norm spans the adapters and logZ, then each gets Adam at its
own rate (``training.trainer.Optimizer`` with ``lrs``). Randomness comes from
explicit ``torch.Generator`` objects, or the draws are passed in.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from ..config import MDGenConfig
from ..geometry.rigid import full_f32
from ..models.denoiser import LatentMDGen, refuse_rtb_unported
from ..training.trainer import Optimizer
from .lora import lora_init, lora_kernels, lora_merge, lora_targets_default
from .priors import MDGenSimulator
from .replay_buffer import ReplayBuffer
from .samplers import (PosteriorPriorDGFN, back_and_forth_loss, map_condition, rtb_loss,
                       vargrad_logz)
from .scheduler import DDPMGFNScheduler


@dataclasses.dataclass(frozen=True)
class RTBConfig:
    """(src/rtb_utils/args.py:25-126 essentials)"""

    method: str = "rtb"  # rtb | tb
    lr: float = 5e-5
    logz_lr: float = 5e-2
    batch_size: int = 4
    n_iterations: int = 1000
    sampling_length: int = 10
    num_train_timesteps: int = 1000
    xT_type: str = "gaussian"
    vargrad: bool = False
    learning_cutoff: float = 0.1
    detach_freq: float = 0.0
    detach_cut_off: float = 1.0
    lora_rank: int = 32
    replay_buffer: bool = False
    rb_size: int = 1000
    rb_ratio: float = 0.25
    rb_strategy: str = "uniform"  # uniform | reward (1/4 high-reward mix)
    rb_beta: float = 1.0
    prior_sampling: bool = False  # src/rtb_utils/args.py:83-84
    prior_sampling_ratio: float = 0.1
    back_and_forth: bool = False  # src/rtb_utils/args.py:76
    bf_freq: int = 4  # a back-and-forth exploration step every bf_freq iterations
    bf_noise_level: float = 0.5
    langevin: bool = False  # reward-gradient policy correction (samplers.py:120-171)
    lgv_scale: float = 0.01
    lgv_clip: float = 1e2
    grad_clip: float = 1.0
    seed: int = 0


def _latent_manifold_log_reward(x):
    """The default differentiable Langevin proxy over MDGen latents
    (B, T, L, 21[+20]): highest when the quaternion block and each torsion
    (cos, sin) pair are unit-norm, i.e. when the latents decode to valid
    geometry (JAX :72-82)."""
    quat = x[..., :4]
    q_pen = ((quat * quat).sum(-1) - 1.0) ** 2  # (B, T, L)
    tor = x[..., 7:21].reshape(*x.shape[:-1], 7, 2)
    t_pen = (((tor * tor).sum(-1) - 1.0) ** 2).sum(-1)
    return -(q_pen + t_pen).sum(dim=tuple(range(1, q_pen.ndim)))


class _Policy(nn.Module):
    """The denoiser behind ``functional_call``: its forward, or with
    ``pack_only`` its trunk pack, under the swapped-in weights."""

    def __init__(self, model: LatentMDGen):
        super().__init__()
        self.model = model

    def forward(self, x=None, t=None, pack_only: bool = False, **kw):
        if pack_only:
            return self.model.make_trunk_pack()
        return self.model(x, t, **kw)


class RTBTrainer:
    def __init__(self, cfg: MDGenConfig, rtb: RTBConfig, prior_sim: MDGenSimulator,
                 reward_fn: Callable, workdir: str = "workdir/rtb", reward_on_device: bool = True,
                 lgv_log_reward_fn: Optional[Callable] = None, policy: Optional[nn.Module] = None,
                 policy_params: Optional[dict] = None,
                 lora_targets: Optional[Callable[[str], bool]] = None):
        """``reward_fn(atom14, aatype (B, L)) -> (B,)`` log-rewards;
        ``reward_on_device``: the reward is a function of the decoded sample
        on the device (one sampler pass with gradients), else a host oracle
        (sample, decode, score, then the same trajectory re-run with
        gradients). ``lgv_log_reward_fn``: the differentiable latents -> (B,)
        proxy of the Langevin correction (``_latent_manifold_log_reward`` by
        default).

        ``policy``: another policy module (an outsourced ``UNet3DSeq``,
        src/rtb_utils/denoisers.py:504-561, JAX :91-169) called as ``(x,
        t / num_train_timesteps, **condition)``, by default the prior's
        ``LatentMDGen``; ``policy_params``: its base weights by parameter
        name (a state_dict; the module's own when absent), frozen: the prior
        is the policy at these weights and the posterior adds the adapters.
        ``lora_targets(flax path) -> bool`` picks the adapted Linear kernels
        (``lora_targets_default`` by default: LatentMDGen's names)."""
        refuse_rtb_unported(cfg)
        self.cfg, self.rtb = cfg, rtb
        self.prior_sim = prior_sim
        self.reward_fn = reward_fn
        self.workdir = workdir
        self.device = prior_sim.device
        self.outsourced = policy is not None
        if self.outsourced or policy_params is not None:  # a frozen copy of the policy
            self.model = copy.deepcopy(policy if self.outsourced else prior_sim.engine.model)
            self.model.to(self.device).requires_grad_(False)
            if policy_params is not None:
                extra = self.model.load_state_dict(policy_params, strict=False).unexpected_keys
                if extra:
                    raise KeyError(f"policy_params: not parameters of the policy: {extra}")
        else:
            self.model = prior_sim.engine.model
        if not self.outsourced:
            self._policy = _Policy(self.model)
            with torch.no_grad():
                self.prior_pack = self.model.make_trunk_pack()
        self.scheduler = DDPMGFNScheduler(
            num_train_timesteps=rtb.num_train_timesteps, prediction_type="v_prediction",
            clip_sample=True, clip_sample_range=3.0, variance_type="fixed_large",
            device=self.device)

        langevin_fn = None
        if rtb.langevin:
            lgv_fn = lgv_log_reward_fn or _latent_manifold_log_reward

            def langevin_fn(x, t):
                with torch.enable_grad():
                    y = x.detach().requires_grad_()
                    g, = torch.autograd.grad(lgv_fn(y).sum(), y)
                g = torch.nan_to_num(g).clamp(-rtb.lgv_clip, rtb.lgv_clip)
                return rtb.lgv_scale * g.detach()

        self.sampler = PosteriorPriorDGFN(
            self.scheduler, self.prior_fn, self.posterior_fn, dim=prior_sim.latent_shape,
            sampling_length=rtb.sampling_length, xT_type=rtb.xT_type, langevin_fn=langevin_fn)

        targets = lora_targets or lora_targets_default
        self.kernels = lora_kernels(self.model, targets)
        self.lora = lora_init(torch.Generator().manual_seed(rtb.seed), self.model,
                              rank=rtb.lora_rank, targets=targets, device=self.device)
        self.logZ = torch.zeros((), device=self.device)
        for t in self._trainables().values():
            t.requires_grad_(True)
        self.opt = Optimizer(rtb.lr, rtb.grad_clip, lrs={"logZ": rtb.logz_lr})
        self.opt_state = self.opt.init(self._trainables())
        self.replay = (ReplayBuffer(rtb.rb_size, mode=rtb.rb_strategy, beta=rtb.rb_beta,
                                    seed=rtb.seed) if rtb.replay_buffer else None)
        self.reward_on_device = reward_on_device
        self._host_rng = np.random.default_rng(rtb.seed + 7)
        self._last_x = None  # terminal samples stash for back-and-forth exploration
        self.generator = torch.Generator(device=self.device).manual_seed(rtb.seed + 1)

    # ------------------------------------------------------------------
    def _trainables(self) -> dict:
        """The adapters and logZ as one flat dict of leaf tensors (the
        optimizer's parameters): ``lora/<path>/a``, ``lora/<path>/b``,
        ``logZ``."""
        out = {f"lora/{p}/{k}": ab[k] for p, ab in self.lora.items() for k in ("a", "b")}
        out["logZ"] = self.logZ
        return out

    def _time(self, x, t):
        """(zeros(B) + t) / num_train_timesteps in f32 (JAX :129-132)."""
        z = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        return (z + torch.as_tensor(t, device=x.device)) / self.rtb.num_train_timesteps

    def prior_fn(self, x, t, condition):
        """The frozen prior: ``forward`` with the base weights, no gradients."""
        with torch.no_grad():
            if self.outsourced:
                return self.model(x, self._time(x, t), **condition)
            return self.model(x, self._time(x, t), trunk_pack=self.prior_pack, **condition)

    def posterior_context(self):
        """This iteration's merged adapter weights (and, for LatentMDGen, the
        trunk pack built from them), in the caller's grad mode (one merge a
        backward)."""
        merged = lora_merge(self.model, self.lora, kernels=self.kernels)
        if self.outsourced:
            return merged, None
        merged = {f"model.{k}": v for k, v in merged.items()}
        pack = torch.func.functional_call(self._policy, merged, (), {"pack_only": True})
        return merged, pack

    def posterior_fn(self, ctx, x, t, condition):
        """The LoRA posterior: ``forward`` under the merged weights of
        ``ctx`` (``posterior_context``)."""
        merged, pack = ctx
        if self.outsourced:
            return torch.func.functional_call(self.model, merged, (x, self._time(x, t)),
                                              condition)
        return torch.func.functional_call(self._policy, merged, (x, self._time(x, t)),
                                          {**condition, "trunk_pack": pack})

    # ------------------------------------------------------------------
    def _logz_estimate(self, logpf_posterior, log_pf_ref, logr, peptide_ids=None,
                       n_peptides: int = 1):
        """logZ of the RTB loss: the learned scalar, a VarGrad batch estimate,
        or (the conditional multi-peptide variant) one VarGrad estimate per
        peptide gathered back per element, a segment mean by ``index_add_``
        (src/rtb_utils/gfn_diffusion.py:438-456)."""
        if not self.rtb.vargrad:
            return self.logZ
        vg = vargrad_logz(logpf_posterior, log_pf_ref, logr)
        if peptide_ids is None or n_peptides <= 1:
            return vg.mean()
        sums = vg.new_zeros(n_peptides).index_add_(0, peptide_ids, vg)
        counts = vg.new_zeros(n_peptides).index_add_(0, peptide_ids, torch.ones_like(vg))
        return (sums / counts.clamp(min=1))[peptide_ids]

    def objective(self, res: dict, logr, peptide_ids=None, n_peptides: int = 1):
        """(mean RTB loss, aux) of a sampled trajectory ``res`` against the
        log-rewards ``logr`` (JAX ``_loss`` / ``_fused_loss``, :202-291)."""
        ref = res["logpb"] if self.rtb.method == "tb" else res["logpf_prior"]
        logZ = self._logz_estimate(res["logpf_posterior"], ref, logr, peptide_ids, n_peptides)
        loss = rtb_loss(res["logpf_posterior"], logZ, ref, logr, self.rtb.learning_cutoff)
        aux = {"loss_vec": loss.detach(), "logZ": logZ.detach().mean(),
               "logZ_vec": (logZ * torch.ones_like(loss)).detach(),
               "pf_divergence": (res["logpf_posterior"] - res["logpf_prior"]).detach().mean()}
        return loss.mean(), aux

    def _replicate(self, tree: dict, B: int) -> dict:
        """Tile the conditioning to the sampler's batch (each element
        repeated B // n times, ``Rigid`` frames too; src/rtb_utils/priors.py:
        95-147)."""
        return map_condition(
            lambda v: v.repeat_interleave(B // v.shape[0], dim=0) if v.shape[0] != B else v,
            tree)

    def _peptide_ids(self, batch: dict, B: int):
        """(ids (B,), n_peptides) in ``_replicate``'s layout: a batch of n
        distinct peptides tiled to B gives B // n consecutive elements per
        peptide (src/rtb_utils/gfn_diffusion.py:438-456)."""
        names = batch.get("name")
        n = len(names) if names is not None else 1
        if n <= 1:
            return None, 1
        uniq = {}
        base = np.asarray([uniq.setdefault(nm, len(uniq)) for nm in names])
        return torch.as_tensor(np.repeat(base, B // n), device=self.device), len(uniq)

    def _decode_reward(self, batch_rep: dict, x):
        atom14, _ = self.prior_sim.sample(batch_rep, x)
        return torch.as_tensor(self.reward_fn(atom14, batch_rep["seqres"]),
                               dtype=torch.float32, device=self.device).detach()

    # ------------------------------------------------------------------
    def step(self, it: int, generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None) -> dict:
        """One RTB iteration (src/rtb_utils/gfn_diffusion.py:391-491): a
        replay-buffer draw after the ``it > batch_size`` gate, a
        back-and-forth step every ``bf_freq``-th iteration, else a forward
        trajectory (from the prior with probability ``prior_sampling_ratio``
        under ``prior_sampling``) scored on the device or by the host
        oracle. ``draws``: the forward trajectory's randomness
        (``PosteriorPriorDGFN.draws``), else from ``generator`` (the
        trainer's own by default)."""
        gen = generator or self.generator
        condition, batch = self.prior_sim.get_cond_args()
        B = self.rtb.batch_size
        condition = self._replicate(condition, B)
        batch_rep = self._replicate({k: v for k, v in batch.items() if k != "name"}, B)
        peptide_ids, n_peptides = self._peptide_ids(batch, B)

        use_replay = (self.replay is not None and it > self.rtb.batch_size
                      and len(self.replay) >= B and self._host_rng.random() < self.rtb.rb_ratio)
        if use_replay:  # backward trajectories from stored terminal samples
            x0, logr = self.replay.sample(B)
            x0 = torch.as_tensor(x0, device=self.device)
            logr = torch.as_tensor(logr, device=self.device)
            res = self.sampler.sample_bkw(gen, self.posterior_context(), condition, x0,
                                          detach_freq=self.rtb.detach_freq)
            loss, aux = self.objective(res, logr)
            return self._apply_update(loss, aux, logr, None)

        if (self.rtb.back_and_forth and self._last_x is not None
                and it % self.rtb.bf_freq == self.rtb.bf_freq - 1):
            res = self.sampler.sample_back_and_forth(gen, self.posterior_context(), condition,
                                                     self._last_x,
                                                     noise_level=self.rtb.bf_noise_level)
            logr_x = self._decode_reward(batch_rep, res["x"])
            logr_xp = self._decode_reward(batch_rep, res["x_prime"])
            loss = back_and_forth_loss(res, logr_x, logr_xp, self.rtb.learning_cutoff)
            aux = {"loss_vec": loss.detach(), "logZ": self.logZ.detach(),
                   "pf_divergence": (res["logpf_posterior_f"]
                                     - res["logpf_prior_f"]).detach().mean()}
            self._last_x = res["x_prime"].detach()
            return self._apply_update(loss.mean(), aux, logr_xp, None)

        sample_from_prior = bool(self.rtb.prior_sampling
                                 and self._host_rng.random() < self.rtb.prior_sampling_ratio)
        kw = dict(detach_freq=self.rtb.detach_freq, detach_cut_off=self.rtb.detach_cut_off,
                  sample_from_prior=sample_from_prior)
        if not self.reward_on_device:
            # host reward: sample -> decode -> score, then the same draws with gradients
            draws = draws or self.sampler.draws(gen, B, self.rtb.detach_freq)
            with torch.no_grad():
                res = self.sampler.sample_fwd(gen, self.posterior_context(), condition, B,
                                              **draws, **kw)
            logr = self._decode_reward(batch_rep, res["x"])
        res = self.sampler.sample_fwd(gen, self.posterior_context(), condition, B,
                                      **(draws or {}), **kw)
        if self.reward_on_device:
            logr = self._decode_reward(batch_rep, res["x"])
        loss, aux = self.objective(res, logr, peptide_ids, n_peptides)
        return self._apply_update(loss, aux, logr, res["x"].detach())

    @torch.no_grad()
    def _apply_gradients(self):
        """One optimizer update from the adapters' and logZ's ``.grad``
        (zero where the loss did not reach them), the grads then cleared."""
        params = self._trainables()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        self.opt.step(params, grads, self.opt_state)
        for p in params.values():
            p.grad = None

    def _apply_update(self, loss, aux, logr, zs0) -> dict:
        loss.backward()
        self._apply_gradients()
        if self.rtb.vargrad:
            with torch.no_grad():
                self.logZ.copy_(aux["logZ"])
        if zs0 is not None:
            self._last_x = zs0
            if self.replay is not None:
                # only fresh samples enter the buffer (x_0 is None in the
                # reference, gfn_diffusion.py:463-465)
                self.replay.add(zs0.cpu().numpy(), logr.cpu().numpy(),
                                aux["loss_vec"].cpu().numpy())
        return {"loss": float(loss.detach()), "logr": float(logr.mean()),
                "logZ": float(aux["logZ"]), "pf_divergence": float(aux["pf_divergence"])}

    def run(self, n_iterations: Optional[int] = None, log_every: int = 10, log_fn=None) -> list:
        os.makedirs(self.workdir, exist_ok=True)
        history = []
        for it in range(n_iterations or self.rtb.n_iterations):
            t0 = time.time()
            metrics = self.step(it)
            metrics.update(it=it, dur=round(time.time() - t0, 2))
            history.append(metrics)
            if it % log_every == 0:
                (log_fn or (lambda m: print(json.dumps(m), flush=True)))(metrics)
        return history

    # ------------------------------------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """The adapters, logZ and the optimizer state (``torch.save``)."""
        path = path or os.path.join(self.workdir, "checkpoint.pt")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().cpu() if torch.is_tensor(tree) else tree

        torch.save({"lora": host(self.lora), "logZ": float(self.logZ.detach()),
                    "opt_state": host(self.opt_state)}, path)
        return path

    def load(self, path: str):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for p, ab in ckpt["lora"].items():
                for k in ("a", "b"):
                    self.lora[p][k].copy_(ab[k])
            self.logZ.fill_(ckpt["logZ"])

        def dev(tree):
            if isinstance(tree, dict):
                return {k: dev(v) for k, v in tree.items()}
            return tree.to(self.device) if torch.is_tensor(tree) else tree

        self.opt_state = dev(ckpt["opt_state"])


class RTBBatchedTrainer(RTBTrainer):
    """Memory-bounded RTB (JAX :472-550; src/rtb_utils/gfn_diffusion.py:
    494-543, src/models/samplers.py:686-742): one trajectory without
    gradients, then the gradient accumulated over chunks of ``replay_chunk``
    timesteps, each chunk's stored transitions replayed through one
    posterior call over the (m * B) flattened states with target-forced
    noise. For long chains, whose full-trajectory graph does not fit.

    The adapters' gradient is the full-trajectory RTB gradient divided by
    m; logZ's is S / m times its own, as every replayed transition carries
    logZ. The last chunk is filled out to m by repeating its last
    transition, as JAX does, so every chunk is one call of the same shape;
    the repeats carry zero weight here, where JAX counts that transition
    once per repeat."""

    def __init__(self, *args, replay_chunk: int = 4, **kw):
        super().__init__(*args, **kw)
        self.replay_chunk = replay_chunk

    def step(self, it: int, generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None) -> dict:
        gen = generator or self.generator
        condition, batch = self.prior_sim.get_cond_args()
        B = self.rtb.batch_size
        condition = self._replicate(condition, B)
        batch_rep = self._replicate({k: v for k, v in batch.items() if k != "name"}, B)
        with torch.no_grad():
            res = self.sampler.sample_fwd(gen, self.posterior_context(), condition, B,
                                          detach_freq=self.rtb.detach_freq, save_traj=True,
                                          **(draws or {}))
        logr = self._decode_reward(batch_rep, res["x"])
        ref = res["logpb"] if self.rtb.method == "tb" else res["logpf_prior"]
        # dLoss/dlogpf per sample, zero where the relu cutoff is inactive
        correction = (res["logpf_posterior"] + self.logZ - ref - logr).detach()
        correction = correction * (correction ** 2 > self.rtb.learning_cutoff).to(correction.dtype)

        sched = self.sampler.scheduler
        # transition i: traj[i] -> traj[i + 1], stepped at next_timestep(timesteps[i])
        step_ts = np.asarray([sched.next_timestep(int(t)) for t in sched.timesteps])
        traj, n_steps, m = res["traj"], len(step_ts), self.replay_chunk
        for s in range(0, n_steps, m):
            idx = list(range(s, min(s + m, n_steps)))
            weight = torch.zeros(m, device=self.device)
            weight[:len(idx)] = 1.0
            idx += [idx[-1]] * (m - len(idx))  # fill out the last chunk, the fill weighted 0
            xs, targets = traj[idx], traj[[i + 1 for i in idx]]
            lp = self.sampler.replay_logpf(self.posterior_context(), condition, xs,
                                           step_ts[idx], targets)
            corr = correction.repeat(m) * weight.repeat_interleave(B)
            ((lp + self.logZ) * corr).mean().backward()
        self._apply_gradients()
        loss = 0.5 * torch.relu(correction ** 2 - self.rtb.learning_cutoff).mean()
        return {"loss": float(loss), "logr": float(logr.mean()),
                "logZ": float(self.logZ.detach()),
                "pf_divergence": float((res["logpf_posterior"] - res["logpf_prior"]).mean())}


# ---------------------------------------------------------------------------
class DiffuserTrainer:
    """Outsourced-prior distillation (JAX :553-617; src/rtb_utils/
    gfn_diffusion.py:605-805): train a DDPM v-predictor (a ``LatentMDGen``,
    or the ``model`` given, such as an outsourced ``UNet3DSeq``) to reproduce
    the prior-latent distribution, with the min-SNR-gamma weighted
    v-prediction MSE and AdamW (optax's ``adamw(lr)``: no clipping, weight
    decay 1e-4)."""

    def __init__(self, cfg: MDGenConfig, source_sampler: Callable, condition: dict,
                 lr: float = 1e-4, num_train_timesteps: int = 1000, min_snr_gamma: float = 5.0,
                 seed: int = 0, model: Optional[nn.Module] = None, device="cuda"):
        """``source_sampler(generator) -> clean latents (B, T, L, D)``;
        ``condition`` the denoiser's keyword arguments for that batch;
        ``model`` called as ``(x, t / num_train_timesteps, **condition)``."""
        from ..inference.sampling import resolve_device

        if model is None:
            refuse_rtb_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        full_f32()  # as every entry point: an outsourced UNet's convolutions in f32
        dtype = torch.bfloat16 if cfg.model.use_bf16 else torch.float32
        self.outsourced = model is not None
        self.model = model if self.outsourced else LatentMDGen(cfg, cfg.latent_dim, dtype=dtype)
        self.scheduler = DDPMGFNScheduler(num_train_timesteps=num_train_timesteps,
                                          device=self.device)
        self.source_sampler = source_sampler
        self.condition = condition
        self.min_snr_gamma = min_snr_gamma
        self.num_train_timesteps = num_train_timesteps
        self.opt = Optimizer(lr, float("inf"), adamw=True)
        self.seed = seed

    def init_params(self, state_dict: Optional[dict] = None) -> dict:
        """The model's parameters, which ``train`` updates in place: a
        ``LatentMDGen``'s init (``reset_parameters``) seeded by ``seed``; a
        given ``model``'s own weights, or ``state_dict`` loaded into it (say
        ``utils.weights.unet_from_flax`` of the JAX package's)."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        elif not self.outsourced:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                self.model.reset_parameters()
        self.model.to(self.device).train().requires_grad_(True)
        return dict(self.model.named_parameters())

    def loss(self, generator: torch.Generator, clean):
        B = clean.shape[0]
        t = torch.randint(0, self.num_train_timesteps, (B,), generator=generator,
                          device=generator.device).to(self.device)
        noise = torch.randn(clean.shape, generator=generator, device=generator.device)
        noise = noise.to(self.device)
        noisy = self.scheduler.add_noise(clean, noise, t)
        target = self.scheduler.get_velocity(clean, noise, t)
        pred = self.model(noisy, t.float() / self.num_train_timesteps, **self.condition)
        # min-SNR-gamma weighting (gfn_diffusion.py:732-744)
        a = self.scheduler._alpha_prod(t)
        snr = a / (1 - a)
        w = torch.clamp(snr, max=self.min_snr_gamma) / snr.clamp(min=1e-8)
        mse = ((pred - target) ** 2).mean(dim=tuple(range(1, clean.ndim)))
        return (w * mse).mean()

    def train(self, params: dict, opt_state: dict, n_steps: int,
              generator: torch.Generator) -> tuple:
        """``n_steps`` AdamW steps, each on a fresh source batch; returns
        (params, opt_state, losses)."""
        losses = []
        for _ in range(n_steps):
            clean = self.source_sampler(generator).to(self.device)
            loss = self.loss(generator, clean)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            self.opt.step(params, {k: g if g is not None else torch.zeros_like(p)
                                   for (k, p), g in zip(params.items(), grads)}, opt_state)
            losses.append(float(loss.detach()))
        return params, opt_state, losses
