"""Training runtime on one GPU: the flow-matching loss, its backward through
the hand-written kernels, global-norm clipping, Adam/AdamW, EMA and
checkpoints.

Counterpart of the JAX package's ``training/trainer.py`` (:40-215;
reference src/mdgen/wrapper.py:46-172, src/train.py:44-77). One step is
featurization, task prep and the loss on the device, the backward
(``FusedTrunkFn`` for the trunk, a plain-math recompute for the encoder),
then the optimizer with optax's semantics (``make_optimizer``) and the EMA.
The state is updated in place and returned (the JAX step donates it).

Every task trains: forward simulation, upsampling, transition paths,
inpainting, and the design tasks (``design``, ``mpnn``, ``dynamic_mpnn``)
with their Dirichlet flow-matching loss; so does every model branch, the
modular layer (``hyena``, ``no_rope``), ``interleave_ipa`` and dropout.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without CUDA they raise. Randomness (t, the prior draw x0, the
design task's simplex point, and with ``model.dropout > 0`` the keep masks)
comes from an explicit ``torch.Generator``: the masks from a generator
seeded by one draw of the step's (JAX's ``split`` for ``rngs={"dropout":
...}``, :116-122).

Over a (dp, sp) mesh of ``torch.distributed`` ranks (``parallel/``; JAX
:49-54), every rank is handed the same global batch and draws every random
tensor of the step at its global shape from the same generator, then keeps
its rows (``kernel_sharding.split_axes``): under the batch fold (the batch
divides the mesh) its B / (dp sp) elements, with no collective inside the
model; under the sequence split (B = 1 at ATLAS, say) its rows of the
batch axes, the trunk split over the rest (``ops/sharded_trunk.py``), the
featurization, the encoder and the loss replicated there; else everything
(replication). One all-reduce then averages the gradients and the metrics
over the batch axes, before the global-norm clip, so that a sharded step
equals the one-process step and every rank keeps equal parameters,
optimizer and EMA state. The weights are broadcast from rank 0 at
``init_state`` and ``restore_checkpoint``; only rank 0 writes a checkpoint
or calls ``fit``'s ``log_fn``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import MDGenConfig
from ..data.featurize import featurize_atom14_batch
from ..geometry import frames as G
from ..geometry.rigid import full_f32
from ..inference.sampling import resolve_device
from ..models.denoiser import LatentMDGen
from ..models.layers import Dropout
from ..parallel import comm
from ..parallel.kernel_sharding import kernel_mesh, split_axes
from ..parallel.mesh import local_slice, make_mesh
from ..tasks import prep_batch
from ..transport import create_transport


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict       # name -> f32 parameter: the trainer's model's own tensors
    opt_state: dict
    ema_params: dict   # name -> f32 tensor, buffers distinct from params


class Optimizer:
    """``optax.chain(clip_by_global_norm(clip), adam(lr) | adamw(lr))``,
    wrapped in ``optax.MultiSteps(every_k)`` when ``every_k > 1``, with
    optax's arithmetic: the clip scales by ``clip / ||g||`` only when
    ``||g|| >= clip``; Adam b1 0.9, b2 0.999, eps 1e-8 with bias correction;
    AdamW adds ``weight_decay * p`` (optax's default 1e-4) before the
    learning rate; MultiSteps feeds the running mean of ``every_k`` gradients
    to the inner chain and updates every ``every_k``-th call. ``lrs``
    {parameter name: learning rate} gives those parameters their own rate
    after the shared clip (optax's ``multi_transform`` of one Adam per
    label, as RTB's adapters and logZ)."""

    def __init__(self, lr: float, clip: float, adamw: bool = False, every_k: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, lrs: Optional[dict] = None):
        self.lr, self.clip, self.adamw, self.every_k = lr, clip, adamw, every_k
        self.lrs = dict(lrs or {})
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def init(self, params: dict) -> dict:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        state = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.every_k > 1:
            state.update(mini_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> None:
        """Update ``params`` and ``state`` in place from ``grads`` (multi-tensor
        ``torch._foreach_*`` ops: a few launches for all the parameters)."""
        keys = list(params)
        gs = [grads[k] for k in keys]
        if self.every_k > 1:
            n = state["mini_step"]
            acc = [state["acc"][k] for k in keys]
            torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(gs, acc), n + 1))
            state["mini_step"] = (n + 1) % self.every_k
            if n != self.every_k - 1:
                return
            gs = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        g_norm = global_norm(dict(zip(keys, gs)))
        factor = torch.where(g_norm < self.clip, torch.ones_like(g_norm), self.clip / g_norm)
        gs = torch._foreach_mul(gs, factor)
        state["count"] += 1
        c1 = 1.0 - self.b1 ** state["count"]
        c2 = 1.0 - self.b2 ** state["count"]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        ps = [params[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        if self.adamw:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        for lr in {self.lrs.get(k, self.lr) for k in keys}:
            sel = [i for i, k in enumerate(keys) if self.lrs.get(k, self.lr) == lr]
            torch._foreach_add_([ps[i] for i in sel], [upd[i] for i in sel], alpha=-lr)


def make_optimizer(cfg: MDGenConfig) -> Optimizer:
    t = cfg.train
    return Optimizer(t.lr, t.grad_clip, adamw=t.adamW, every_k=t.accumulate_grad)


def global_norm(tensors: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors.values()))))


def featurize(cfg: MDGenConfig, atom14: torch.Tensor, seqres: torch.Tensor,
              mask: torch.Tensor) -> dict:
    """A raw batch's features on its device (JAX ``_featurize``, :95-108):
    ``featurize_atom14_batch``, or under ``no_frames`` the atom37
    coordinates and the per-atom37 mask of each residue type
    (``RESTYPE_ATOM37_MASK[seqres]``: the residue mask is not read, as in
    JAX; reference src/mdgen/dataset.py:81-88)."""
    if not cfg.task.no_frames:
        return featurize_atom14_batch(atom14, seqres, mask)
    return {"atom37": G.atom14_to_atom37(atom14, seqres), "seqres": seqres,
            "mask": G._table("RESTYPE_ATOM37_MASK", seqres, atom14.dtype)}


class Trainer:
    def __init__(self, cfg: MDGenConfig, device="cuda", dtype=None):
        """``mesh``: the ranks' (dp, sp) mesh, ``make_mesh(train.dp_size or
        None, train.sp_size)`` over the initialised default group (one
        process without one: ``dp_size`` 2 raises JAX's ``ValueError``). It
        is not registered for the whole process: a step splits the trunk
        only inside its own ``kernel_mesh`` (``_loss_fn``)."""
        self.cfg = cfg
        self.mesh = make_mesh(cfg.train.dp_size or None, cfg.train.sp_size)
        self.device = resolve_device(device)
        full_f32()
        self.dtype = dtype or (torch.bfloat16 if cfg.model.use_bf16 else torch.float32)
        self.transport = create_transport(cfg)
        self.opt = make_optimizer(cfg)
        self.model: Optional[LatentMDGen] = None
        self.workdir = os.path.join(cfg.workdir, cfg.run_name)

    # ------------------------------------------------------------------
    def init_state(self, seed: int) -> TrainState:
        """A fresh model with the JAX package's init, drawn on the CPU from
        ``seed``, and its optimizer and EMA state."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = LatentMDGen(self.cfg, self.cfg.latent_dim, dtype=self.dtype)
        self.model = model.to(self.device)
        params = dict(self.model.named_parameters())
        self._from_rank0(list(params.values()))
        ema = {k: p.detach().clone() for k, p in params.items()}
        return TrainState(step=0, params=params, opt_state=self.opt.init(params), ema_params=ema)

    # ------------------------------------------------------------------
    def _from_rank0(self, tensors: list) -> None:
        """Overwrite ``tensors`` in place with rank 0's (one broadcast)."""
        if self.mesh.size <= 1:
            return
        with torch.no_grad():
            for t, v in zip(tensors, comm.flat(tensors, lambda f: comm.broadcast(f, 0))):
                t.copy_(v)

    def _mean_over(self, axes, tensors: list) -> list:
        """``tensors`` averaged over the ranks of ``axes`` (one all-reduce)."""
        group = self.mesh.group(axes)
        if group is None:
            return tensors
        n = self.mesh.count(axes)
        return comm.flat(tensors, lambda f: comm.all_reduce(f, group).div_(n))

    def layout(self, batch: dict) -> tuple:
        """(batch axes, sequence axes) of a global batch on the mesh
        (``kernel_sharding.split_axes``)."""
        return split_axes(self.mesh, *batch["atom14"].shape[:3])

    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   device=self.device)
                for k, v in batch.items() if k in ("atom14", "seqres", "mask")}

    def _loss_fn(self, batch: dict, generator: Optional[torch.Generator] = None, t=None,
                 x0=None, x_d=None, dropout=None):
        """Mean flow-matching loss of a raw batch (atom14, seqres, mask) and
        its metrics: featurize -> prep_batch -> training_losses. On a mesh
        of more than one rank, ``batch`` (and t, x0, x_d when given) is the
        global batch: the result is this rank's loss and metrics, means over
        its rows (module docstring; ``_grads`` and ``eval_loss`` average them
        over the batch axes)."""
        b = self._device_batch(batch)
        rows = None
        if self.mesh.size > 1:
            b_axes, s_axes = self.layout(b)
            part = local_slice(self.mesh, b_axes, b["atom14"].shape[0])
            rows = (part, b["seqres"].long())
            b = {k: v[part] for k, v in b.items()}
        feats = featurize(self.cfg, b["atom14"].float(), b["seqres"].long(), b["mask"].float())
        if rows is None:
            return self._feature_loss(feats, generator, t, x0, x_d, dropout)
        with kernel_mesh(self.mesh.sub(s_axes)):
            return self._feature_loss(feats, generator, t, x0, x_d, dropout, rows=rows)

    def dropout_for(self, generator: Optional[torch.Generator],
                    rows: Optional[tuple] = None) -> Optional[Dropout]:
        """The step's ``Dropout`` (``model.dropout > 0``): its masks drawn
        from a generator on ``generator``'s device seeded by one draw of
        ``generator`` (None: the global one); ``rows`` (slice, B): this
        rank's rows of a global batch of B (``Dropout``)."""
        rate = self.cfg.model.dropout
        if rate <= 0.0:
            return None
        dev = generator.device if generator is not None else self.device
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=dev))
        return Dropout(rate, torch.Generator(device=dev).manual_seed(seed), rows=rows)

    def _feature_loss(self, feats: dict, generator=None, t=None, x0=None, x_d=None,
                      dropout=None, rows=None):
        """``_loss_fn`` from a featurized batch (``featurize``): the mean
        loss and the metrics {loss, t_mean}, under ``design`` also
        {loss_discrete, loss_continuous} (JAX ``_loss_fn``, :111-137; the
        continuous part is NaN under ``mpnn`` / ``dynamic_mpnn``, as in JAX).
        t, x0 and the design task's simplex point ``x_d`` (B, L, 20) are
        drawn from ``generator`` unless given; with ``model.dropout > 0`` the
        keep masks come from ``dropout`` (``models.layers.Dropout``), else
        from ``dropout_for(generator)``, whose seed is drawn before t and x0
        (JAX splits the dropout key off first). ``rows`` = (slice, seqres
        (B, L)): ``feats`` are those rows of a global batch of B; the draws
        and the masks are made for the whole batch and sliced (t, x0 and
        x_d, when given, are the global ones)."""
        prep = prep_batch(self.cfg, feats)
        kw = prep["model_kwargs"]
        design = self.cfg.task.design
        if dropout is None and self.cfg.model.dropout > 0.0:
            dropout = self.dropout_for(
                generator, None if rows is None else (rows[0], rows[1].shape[0]))
        extra = {} if dropout is None else {"dropout": dropout}
        if rows is not None:
            part, seqres = rows
            x1 = prep["latents"]
            drawn = self.transport.draws(generator, (seqres.shape[0], *x1.shape[1:]), x1.dtype,
                                         x1.device, seqres if design else None, x0=x0, t=t,
                                         x_d=x_d)
            x0, t, x_d = (None if v is None else torch.as_tensor(v)[part] for v in drawn)

        def model_fn(x, tt, mask, **kwargs):
            return self.model(x, tt, mask.float(), **kwargs, **extra)

        terms = self.transport.training_losses(
            model_fn, prep["latents"], mask=prep["loss_mask"], model_kwargs=kw,
            generator=generator, t=t, x0=x0, aatype1=feats["seqres"] if design else None,
            x_d=x_d)
        loss = terms["loss"].mean()
        metrics = {"loss": loss, "t_mean": terms["t"].mean()}
        if design:
            metrics.update(loss_discrete=terms["loss_discrete"].mean(),
                           loss_continuous=terms["loss_continuous"].mean())
        return loss, metrics

    def _grads(self, state: TrainState, batch: dict, generator):
        """The metrics and the gradients of a batch, averaged over the mesh's
        batch axes (one all-reduce) on a mesh of more than one rank."""
        for p in state.params.values():
            p.grad = None
        loss, metrics = self._loss_fn(batch, generator)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in state.params.items()}
        for p in state.params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.mesh.size > 1:
            vals = self._mean_over(self.layout(batch)[0],
                                   list(grads.values()) + list(metrics.values()))
            grads = dict(zip(grads, vals[:len(grads)]))
            metrics = dict(zip(metrics, vals[len(grads):]))
        return metrics, grads

    def train_step(self, state: TrainState, batch: dict, generator: torch.Generator):
        """One step; ``state`` is updated in place and returned with the
        metrics {loss, t_mean, grad_norm} (under ``design`` also
        loss_discrete, loss_continuous) as device scalars."""
        return self.apply_grads(state, *self._grads(state, batch, generator))

    def apply_grads(self, state: TrainState, metrics: dict, grads: dict):
        """The rest of ``train_step`` after ``_grads``: the clip, the
        optimizer and the EMA, in place; returns (state, metrics + grad_norm)."""
        metrics["grad_norm"] = global_norm(grads)
        self.opt.step(state.params, grads, state.opt_state)
        decay = self.cfg.train.ema_decay if self.cfg.train.ema else 0.0
        with torch.no_grad():
            ema = [state.ema_params[k] for k in state.params]
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, list(state.params.values()), alpha=1 - decay)
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_loss(self, state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        """The loss of a batch without gradients, with the EMA weights when
        the config trains them (the JAX CLI's validation step on
        ``state.ema_params``): the metrics of ``_feature_loss`` as device
        scalars. The model's weights are put back after."""
        swap = self.cfg.train.ema
        if swap:
            kept = {k: p.detach().clone() for k, p in state.params.items()}
            for k, p in state.params.items():
                p.copy_(state.ema_params[k])
        try:
            metrics = self._loss_fn(batch, generator)[1]
            if self.mesh.size > 1:
                metrics = dict(zip(metrics, self._mean_over(self.layout(batch)[0],
                                                            list(metrics.values()))))
            return metrics
        finally:
            if swap:
                for k, p in state.params.items():
                    p.copy_(kept[k])

    def check_grad_coverage(self, state: TrainState, batch: dict,
                            generator: torch.Generator) -> list:
        """Parameter names receiving all-zero gradients (reference
        --check_grad, src/mdgen/wrapper.py:115-118)."""
        _, grads = self._grads(state, batch, generator)
        return [k for k, g in grads.items() if not bool(g.abs().max() > 0)]

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, batches: Iterator[dict], num_steps: int,
            generator: torch.Generator, log_every: int = 50, log_fn=None) -> TrainState:
        """``num_steps`` steps over ``batches``; every ``log_every`` steps
        (and at the last) one JSON line of the step's metrics (``train_step``)
        and {step, dur}. The mpnn tasks' ``loss_continuous`` is NaN there, as
        in JAX (JSON's ``NaN``). On a mesh every rank must be handed the same
        global batches; the metrics are already the mean over the ranks
        (``_grads``' all-reduce; JAX :182-195) and only rank 0 logs."""
        t_last = time.time()
        for i in range(num_steps):
            state, metrics = self.train_step(state, next(batches), generator)
            if (i + 1) % log_every == 0 or i == num_steps - 1:
                line = {k: float(v) for k, v in metrics.items()}
                line.update(step=state.step, dur=time.time() - t_last)
                t_last = time.time()
                if self.mesh.rank == 0:
                    (log_fn or (lambda m: print(json.dumps(m), flush=True)))(line)
        return state

    # ------------------------------------------------------------------
    def _barrier(self) -> None:
        """Wait for every rank of the mesh (a one-element all-reduce)."""
        if self.mesh.size > 1:
            comm.all_reduce(torch.zeros(1, device=self.device),
                            self.mesh.group(self.mesh.axis_names))

    def save_checkpoint(self, state: TrainState, path: Optional[str] = None) -> str:
        """``torch.save`` of the step, parameters, optimizer state and EMA
        into ``path/state.pt``, and the config as ``path/config.json``. On a
        mesh rank 0 writes and the others wait for it."""
        path = os.path.abspath(path or os.path.join(self.workdir, f"ckpt_{state.step}"))
        if self.mesh.rank == 0:
            self._write_checkpoint(state, path)
        self._barrier()
        return path

    def _write_checkpoint(self, state: TrainState, path: str) -> None:
        os.makedirs(path, exist_ok=True)

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().cpu() if torch.is_tensor(tree) else tree

        torch.save({"step": state.step, "params": host(state.params),
                    "opt_state": host(state.opt_state), "ema_params": host(state.ema_params)},
                   os.path.join(path, "state.pt"))
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write(self.cfg.to_json())

    def restore_checkpoint(self, path: str, template: TrainState) -> TrainState:
        """Load a checkpoint into ``template``'s tensors (in place) and return
        the restored state; on a mesh rank 0 reads it and broadcasts every
        tensor and counter."""
        if self.mesh.rank == 0:
            state = self._read_checkpoint(path, template)
        else:
            state = template
        if self.mesh.size > 1:
            tensors = []

            def leaves(tree):
                for v in tree.values():
                    if isinstance(v, dict):
                        leaves(v)
                    elif torch.is_tensor(v):
                        tensors.append(v)

            for tree in (state.params, state.opt_state, state.ema_params):
                leaves(tree)
            ints = torch.tensor([state.step, state.opt_state["count"],
                                 state.opt_state.get("mini_step", 0)], dtype=torch.float64,
                                device=self.device)
            self._from_rank0(tensors + [ints])
            state.step, state.opt_state["count"] = int(ints[0]), int(ints[1])
            if "mini_step" in state.opt_state:
                state.opt_state["mini_step"] = int(ints[2])
        return state

    def _read_checkpoint(self, path: str, template: TrainState) -> TrainState:
        saved = torch.load(os.path.join(os.path.abspath(path), "state.pt"), map_location="cpu",
                           weights_only=True)

        def load(dst, src):
            out = {}
            for k, v in src.items():
                if isinstance(v, dict):
                    out[k] = load(dst[k], v)
                elif torch.is_tensor(v):
                    with torch.no_grad():
                        dst[k].copy_(v)
                    out[k] = dst[k]
                else:
                    out[k] = v
            return out

        return TrainState(step=saved["step"], params=load(template.params, saved["params"]),
                          opt_state=load(template.opt_state, saved["opt_state"]),
                          ema_params=load(template.ema_params, saved["ema_params"]))


def read_checkpoint(path: str):
    """The config and the weights to sample with (the EMA when the config
    trains one) of a checkpoint that ``Trainer.save_checkpoint`` wrote, on
    the host, without building a trainer."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = MDGenConfig.from_json(f.read())
    saved = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    return cfg, saved["ema_params"] if cfg.train.ema else saved["params"]
