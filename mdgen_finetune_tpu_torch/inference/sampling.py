"""Generative sampling and autoregressive rollout on the GPU.

Counterpart of the JAX package's ``inference/sampling.py`` (reference
NewMDGenWrapper.inference, src/mdgen/wrapper.py:416-514, and the
sim_inference rollout loop, src/sim_inference.py:62-112). Euler on the
velocity field runs the flagship path: the weights folded once, and the
whole t grid's t-embeddings, AdaLN rows and encoder outputs computed before
the chain; each step is then one ``flat_call``. Heun and dopri5 (the
forward-simulation presets' default) integrate the probability-flow drift
of ``LatentMDGen.forward_inference`` with ``transport.sample_ode``, and so
does every sampler of the modular configurations (``interleave_ipa``,
``hyena``, ``no_rope``), Euler included, as the JAX package's
``LatentMDGen.flat_scan_ok`` sends them to its generic route, and so do the
design tasks. The tasks are forward simulation, upsampling
(``cond_interval``), transition paths (``tps_condition``: the doubled
offsets, the encoder's token pair over the start and end frames),
inpainting (the flat chain, residues 0 and 3 conditioned), inpainting with
sequence design (``design``: 20 simplex channels drawn from Dirichlet(1),
moved by the Dirichlet conditional flow; the designed sequence is their
argmax) and ``mpnn`` / ``dynamic_mpnn`` (one evaluation at t = 1: the
sequence of the given structures), with the ablations ``no_offsets`` (the
offsets are the frames themselves) and ``no_torsion``. With
``sampler="sde"`` every task but ``mpnn`` / ``dynamic_mpnn`` integrates the
reverse SDE instead (``transport.make_sde_sampler`` over
``forward_inference``, never the flat chain). ``log_likelihood`` is the
exact log-likelihood of a batch's latents under the probability-flow ODE,
its divergence a VJP in x through ``LatentMDGen.forward`` (the trunk's
backward kernels). ``no_frames`` samples in neither package: the JAX
package's ``_sample`` has no atom37 batch and no rigids to decode.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise. Randomness comes from an explicit
``torch.Generator``, or the draws are passed in (the prior ``zs0``, the
SDE's ``noise``, the likelihood's ``probes``).

With ``mesh`` (``parallel/``; JAX :63-77) every rank is handed the same
batch and generator, and a sample's B elements split as a training step's
do (``kernel_sharding.split_axes``): under the batch fold each rank samples
its rows, on the flat Euler chain or the generic one; under the sequence
split (B = 1) its rows of the batch axes, the trunk split over the rest.
The prior and the SDE's noise are drawn for the whole batch and sliced;
dopri5 takes the mean of its error norm over every rank's rows, so that all
take the same steps. The result is all-gathered: every rank returns what
the one-process engine returns. ``log_likelihood`` runs unsplit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MDGenConfig
from ..data.featurize import featurize_atom14_batch
from ..geometry import frames as G
from ..geometry.rigid import Rigid, full_f32
from ..models.denoiser import LatentMDGen, refuse_input_grad
from ..parallel import comm
from ..parallel.kernel_sharding import gather, kernel_mesh, split_axes
from ..parallel.mesh import local_slice
from ..tasks import prep_batch
from ..transport import check_interval, create_transport, ode_likelihood, sample_ode
from ..utils.weights import from_flax

ODE_METHODS = ("euler", "heun", "dopri5")
SAMPLERS = ("ode", "sde")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must exist unless the CPU
    was asked for (no quiet fall-back)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def sample_prior_latent(generator: torch.Generator, B: int, T: int, L: int,
                        latent_dim: int, device=None, design: bool = False,
                        uniform: bool = False) -> torch.Tensor:
    """Prior draw (src/mdgen/wrapper.py:416-434), f32: Gaussian, or with
    ``uniform`` U[-3, 3] (the outsourced prior's draw, src/train_prior.py:
    52-59); with ``design`` the last 20 channels are a Dirichlet(1) draw per
    (B, L), the same in every frame (normalized standard exponentials,
    drawn after the continuous part from the same generator)."""
    cont = latent_dim - (20 if design else 0)
    if uniform:
        z = torch.rand(B, T, L, cont, generator=generator, device=generator.device) * 6.0 - 3.0
    else:
        z = torch.randn(B, T, L, cont, generator=generator, device=generator.device)
    if design:
        e = torch.empty(B, L, 20, device=generator.device).exponential_(generator=generator)
        zd = e / e.sum(-1, keepdim=True)
        z = torch.cat([z, zd[:, None].expand(B, T, L, 20)], dim=-1)
    return z.to(device) if device is not None else z


class InferenceEngine:
    """``params``: the port's state_dict, or the JAX package's flax tree as
    nested dicts of numpy arrays (converted by ``from_flax``).
    ``sampler``: "ode" (the config's ODE method) or "sde" (the reverse SDE,
    reference Sampler.sample_sde, src/mdgen/transport/transport.py:346-450);
    ``sde_opts`` go to ``Transport.make_sde_sampler`` (num_steps, method,
    diffusion_form, diffusion_norm, last_step, last_step_size).
    ``last_counts``: the counts of the last sample (``transport.samplers``:
    accepted and rejected steps, drift evaluations); ``mesh``: the ranks'
    (dp, sp) mesh to split samples over (module docstring), registered for
    the trunk's sharded regions only inside ``_sample``."""

    def __init__(self, cfg: MDGenConfig, params, *, device="cuda", dtype=None,
                 sampler: str = "ode", sde_opts: dict | None = None, mesh=None):
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}: one of {SAMPLERS}")
        if cfg.transport.sampling_method not in ODE_METHODS:
            raise NotImplementedError(cfg.transport.sampling_method)
        self.sampler = sampler
        self.sde_opts = dict(sde_opts or {})
        self.mesh = mesh
        self.cfg = cfg
        self.transport = create_transport(cfg)
        self.last_counts = None
        self.device = resolve_device(device)
        full_f32()
        dtype = dtype or (torch.bfloat16 if cfg.model.use_bf16 else torch.float32)
        self.model = LatentMDGen(cfg, cfg.latent_dim, dtype=dtype)
        if any(isinstance(v, dict) for v in params.values()):
            params = from_flax(params, cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval().requires_grad_(False)

    def _tensor(self, v, dtype=None):
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    def _decode(self, samples, rigids: Rigid, seqres):
        """Latents -> (atom14, aa_out) (src/mdgen/wrapper.py:487-514): the
        forward offsets from frame 0 (under ``no_offsets`` the frames
        themselves, JAX :102-103), then the torsions, which follow the
        reverse offsets under the doubled offsets (JAX :95-98); ``aa_out``
        the given sequence, or under ``design`` the argmax of the simplex
        channels (B, T, L)."""
        B, T, L, _ = samples.shape
        rel = Rigid.from_tensor_7(samples[..., :7], normalize_quats=True)
        frames = rel if self.cfg.task.no_offsets else rigids[:, 0:1].compose(rel)
        k = 14 if self.cfg.doubled_offsets else 7
        torsions = samples[..., k:k + 14].reshape(B, T, L, 7, 2)
        torsions = torsions / torch.linalg.vector_norm(torsions, dim=-1, keepdim=True)
        aat = seqres[:, None].expand(B, T, L)
        aa_out = samples[..., -20:].argmax(-1) if self.cfg.task.design else aat
        return G.frames_torsions_to_atom14(frames, torsions, aat), aa_out

    def _sequence_only(self, batch, prep):
        """``mpnn`` / ``dynamic_mpnn`` (src/mdgen/wrapper.py:456-465; JAX
        :112-124): one ``forward_inference`` at t = 1 on the task's latents
        with zero simplex channels; the structures are the conditioning's
        own. Returns (atom14 (B, T, L, 14, 3), aa_out (B, 1, L))."""
        kw = prep["model_kwargs"]
        x1 = prep["latents"]
        B, T, L = kw["mask"].shape
        xt = torch.cat([x1, x1.new_zeros(*x1.shape[:-1], 20)], dim=-1)
        logits = self.model.forward_inference(xt, torch.ones(B, device=self.device), kw["mask"],
                                              start_frames=kw["start_frames"],
                                              end_frames=kw["end_frames"], x_cond=kw["x_cond"],
                                              x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
        self.last_counts = {"accepted": 0, "rejected": 0, "evals": 1}
        aat = batch["seqres"][:, None].expand(B, T, L)
        atom14 = G.frames_torsions_to_atom14(prep["rigids"], batch["torsions"].float(), aat)
        return atom14, logits.argmax(-1)

    def sample_with_zs0(self, batch: dict, zs0: torch.Tensor, noise=None,
                        generator: torch.Generator | None = None):
        """Featurized batch + prior latent (B, T, L, lat) -> (atom14, aa_out)
        (src/mdgen/wrapper.py:436). The SDE sampler takes its noise
        (steps, B, T, L, lat) from ``noise``, else from ``generator``.
        ``mpnn`` / ``dynamic_mpnn`` take one evaluation and no prior:
        ``zs0`` is not read."""
        return self._sample(batch, zs0=zs0, noise=noise, generator=generator)

    def sample(self, batch: dict, generator: torch.Generator):
        """Featurized batch -> generated (atom14 (B, T, L, 14, 3), aa_out:
        the batch's sequence (B, T, L), or the designed one)."""
        return self._sample(batch, generator=generator)

    def _batch(self, batch: dict) -> dict:
        """A featurized batch's arrays as tensors on the engine's device."""
        return {k: self._tensor(v) for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    @torch.no_grad()
    def _sample(self, batch: dict, zs0=None, generator=None, noise=None):
        """The JAX package's ``_sample`` (:112-151 and :231-249): ``mpnn`` /
        ``dynamic_mpnn`` are one evaluation (``_sequence_only``); else the
        prior ``zs0``, or one drawn from ``generator``, goes through the
        Euler chain on the flat latent for the ODE sampler's Euler with the
        velocity objective on the fused branch without the design tasks
        (the JAX package's ``flat_scan_ok``), or through ``forward_inference``:
        the reverse SDE of ``transport.make_sde_sampler`` (``noise``, or
        drawn from ``generator`` after the prior), or the generic ODE solve
        of ``sample_ode`` over ``transport.drift_fn``."""
        cfg = self.cfg
        if cfg.task.no_frames:
            raise NotImplementedError(
                "sampling task.no_frames is not supported: the JAX package does not sample it "
                "either (its _sample has no atom37 batch and no rigids to decode)")
        batch = self._batch(batch)
        if self.mesh is None or self.mesh.size <= 1:
            return self._sample_local(batch, zs0, generator, noise)
        B, T, L = batch["trans"].shape[:3]
        b_axes, s_axes = split_axes(self.mesh, B, T, L)
        part = local_slice(self.mesh, b_axes, B)
        if zs0 is None and not (cfg.task.mpnn or cfg.task.dynamic_mpnn):
            zs0 = sample_prior_latent(generator, B, T, L, cfg.latent_dim, self.device,
                                      design=cfg.task.design)
        group = self.mesh.group(b_axes)

        def mean(v):  # dopri5's error norm over every rank's rows
            acc = torch.stack([v.sum(dtype=torch.float64),
                               torch.tensor(v.numel(), dtype=torch.float64, device=v.device)])
            acc = comm.all_reduce(acc, group)
            return (acc[0] / acc[1]).to(v.dtype)

        with kernel_mesh(self.mesh.sub(s_axes)):
            out = self._sample_local(
                {k: v[part] for k, v in batch.items()}, None if zs0 is None else zs0[part],
                generator, None if noise is None else noise[:, part], rows=(part, B),
                mean=None if group is None else mean)
        return tuple(gather(o, group, 0) for o in out)

    def _sample_local(self, batch: dict, zs0, generator, noise, rows=None, mean=None):
        """``_sample`` on a batch of tensors on the engine's device; with
        ``rows`` (slice, B) the batch is those rows of a sharded one, for the
        SDE's noise; ``mean`` dopri5's (``_sample``)."""
        cfg, model = self.cfg, self.model
        prep = prep_batch(cfg, batch)
        if cfg.task.mpnn or cfg.task.dynamic_mpnn:
            return self._sequence_only(batch, prep)
        kw = prep["model_kwargs"]
        mask = kw["mask"].float().contiguous()
        if zs0 is None:
            zs0 = sample_prior_latent(generator, *mask.shape, cfg.latent_dim, self.device,
                                      design=cfg.task.design)
        pack = model.make_trunk_pack()
        frames = dict(start_frames=kw["start_frames"], end_frames=kw["end_frames"])
        consts = model.make_scan_consts(kw["x_cond"], kw["x_cond_mask"], mask,
                                        aatype=kw["aatype"], **frames)
        t0, t1 = check_interval(cfg, eval=True)
        n = cfg.transport.inference_steps
        xc = zs0.to(self.device, torch.float32).clone().contiguous()
        method = cfg.transport.sampling_method
        flat = (not (model.modular or model.layer_ipa or cfg.task.design)
                and self.sampler == "ode")
        if method == "euler" and self.transport.prediction == "velocity" and flat:
            dt = (t1 - t0) / n
            ts = t0 + dt * torch.arange(n, dtype=torch.float32, device=self.device)
            encs = model.encode_steps(ts, mask, consts, pack, **frames)
            modss = model.embed_mods(model.embed_times(ts), pack)
            for i in range(n):
                model.flat_call(xc, mask, consts, pack, dt,
                                enc=None if encs is None else encs[i], mods=modss[i:i + 1])
            self.last_counts = {"accepted": n, "rejected": 0, "evals": n}
        else:
            def model_fn(x, t):
                return model.forward_inference(x, t, mask, trunk_pack=pack, scan_consts=consts,
                                               **frames)

            if self.sampler == "sde":
                sde = self.transport.make_sde_sampler(model_fn, **self.sde_opts)
                xc, self.last_counts = sde(xc, generator=generator, noise=noise, rows=rows)
            else:
                xc, self.last_counts = sample_ode(self.transport.drift_fn(model_fn), xc, t0=t0,
                                                  t1=t1, method=method, num_steps=n, mean=mean)
        return self._decode(xc, prep["rigids"], batch["seqres"])

    # ------------------------------------------------------------------
    def log_likelihood(self, batch: dict, generator: torch.Generator | None = None,
                       num_steps: int = 100, probes=None) -> torch.Tensor:
        """Per-sample log p of the batch's latents in nats, (B,) f32 (JAX
        :263-294; reference Sampler.sample_ode_likelihood,
        src/mdgen/transport/transport.py:452-510): ``ode_likelihood`` runs
        the reversed probability-flow ODE from the latents over
        ``num_steps`` with Rademacher probes (``probes`` (num_steps, B, T,
        L, lat), else drawn from ``generator``) back to x0, and log p =
        ``prior_logp(x0) - delta_logp``. Each step is one
        ``LatentMDGen.forward`` (the trunk's ``FusedTrunkFn``) and its
        backward in x (the modular branch's and ``interleave_ipa``'s
        layers one by one, ``LatentMDGenLayer.forward``). Design configs
        append the one-hot sequence to the latents, as JAX does, and are
        refused (``refuse_input_grad``: JAX's likelihood is NaN there)."""
        cfg, model = self.cfg, self.model
        batch = self._batch(batch)
        prep = prep_batch(cfg, batch)
        kw = prep["model_kwargs"]
        x1 = prep["latents"].float()
        if x1.shape[-1] != cfg.latent_dim:
            aa = torch.nn.functional.one_hot(batch["seqres"].long(), 20).to(x1.dtype)
            x1 = torch.cat([x1, aa[:, None].expand(*x1.shape[:-1], 20)], dim=-1)
        refuse_input_grad(cfg)
        mask = kw["mask"].float().contiguous()
        with torch.no_grad():
            pack = model.make_trunk_pack()
        model_kw = dict(start_frames=kw.get("start_frames"), end_frames=kw.get("end_frames"),
                        x_cond=kw["x_cond"], x_cond_mask=kw["x_cond_mask"],
                        aatype=kw["aatype"], trunk_pack=pack)

        def model_fn(x, t):
            return model(x, t, mask, **model_kw)

        t0, t1 = check_interval(cfg, eval=True)
        x0, delta_logp = ode_likelihood(self.transport.drift_fn(model_fn), x1.contiguous(),
                                        t0=t0, t1=t1, num_steps=num_steps, generator=generator,
                                        probes=probes)
        return self.transport.prior_logp(x0) - delta_logp

    # ------------------------------------------------------------------
    def _expand_frame0(self, atom14_frame0, seqres, mask):
        """One conditioning frame -> a full window (every frame copies frame
        0, src/sim_inference.py:62-80), featurized."""
        T = self.cfg.data.num_frames
        B, L = seqres.shape
        atom14 = atom14_frame0[:, None].expand(B, T, L, 14, 3)
        return featurize_atom14_batch(atom14, seqres, mask)

    def rollout(self, atom14_frame0, seqres, mask, num_rollouts: int,
                generator: torch.Generator) -> np.ndarray:
        """Autoregressive forward simulation (src/sim_inference.py:105-112):
        atom14 (B, num_rollouts * num_frames, L, 14, 3) on the host."""
        cur = self._tensor(atom14_frame0, torch.float32)
        seqres = self._tensor(seqres).long()
        mask = self._tensor(mask, torch.float32)
        chunks = []
        for _ in range(num_rollouts):
            atom14, _ = self.sample(self._expand_frame0(cur, seqres, mask), generator)
            chunks.append(atom14.cpu().numpy())
            cur = atom14[:, -1]
        return np.concatenate(chunks, axis=1)
