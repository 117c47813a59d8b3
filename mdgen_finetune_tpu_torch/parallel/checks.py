"""What a rank runs to hold a sharded step or sample to the one-process one
(``launch.run`` targets; the CPU tests and ``chip_smoke.py``'s
``parallel`` phase call them, on every rank and in one process alike).

Each builds its ``Trainer`` / ``InferenceEngine`` over ``make_mesh`` of the
config's ``dp_size`` / ``sp_size`` (one process: a one-rank mesh), loads
the given weights, runs on ``device`` (the card unless the CPU is asked
for; without CUDA the card raises), and returns host tensors and the
counts of the collectives (``comm.COUNTS``) and of the kernel launches of
``wrappers`` ((module, name) pairs of ``ops/``) over the run.
"""
from __future__ import annotations

import importlib
import time

import torch

from . import comm


def _wrappers(pairs):
    return [getattr(importlib.import_module(f"mdgen_finetune_tpu_torch.ops.{m}"), n)
            for m, n in pairs]


def _host(tree):
    return {k: v.detach().float().cpu().clone() for k, v in tree.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_steps(cfg, weights, batch, seed: int, device="cuda", steps: int = 2, wrappers=(),
                timed: int = 0) -> dict:
    """``steps`` training steps on one global ``batch`` from a generator
    seeded ``seed``: the first step's metrics and every gradient
    (``Trainer._grads``, averaged over the batch axes), the parameters after
    the first step and after the last, the collectives and launches of the
    first step; with ``timed`` that many more steps timed (ms each, and the
    peak memory on the card)."""
    from ..training import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(0)
    trainer.model.load_state_dict(weights)
    gen = torch.Generator(device=device).manual_seed(seed)
    fns = _wrappers(wrappers)
    before = [f.launches for f in fns]
    comm.reset()
    metrics, grads = trainer._grads(state, batch, gen)
    out = {"axes": trainer.layout(batch), "counts": dict(comm.COUNTS),
           "bytes": dict(comm.BYTES),
           "launches": {f.__name__: f.launches - b for f, b in zip(fns, before)},
           "metrics": {k: float(v) for k, v in metrics.items()}, "grads": _host(grads)}
    trainer.apply_grads(state, metrics, grads)
    out["params1"] = _host(state.params)
    for _ in range(steps - 1):
        trainer.train_step(state, batch, gen)
    out["params"] = _host(state.params)
    if timed:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(timed):
            trainer.train_step(state, batch, gen)
        _sync(device)
        out["ms_per_step"] = (time.perf_counter() - t0) / timed * 1e3
        if torch.device(device).type == "cuda":
            out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sample(cfg, weights, batch, seed: int, device="cuda", sampler: str = "ode", wrappers=(),
           velocity=None, sde_opts=None) -> dict:
    """One ``InferenceEngine.sample`` of a featurized ``batch`` from a
    generator seeded ``seed``: (atom14, aa_out), the counts, the sampler's
    step counts and seconds; with ``velocity`` = (x, t) also one
    ``forward_inference`` at that point, under the engine's mesh and
    registered sub-mesh as a sample's evaluations run."""
    from ..inference import InferenceEngine
    from ..parallel.kernel_sharding import kernel_mesh, split_axes
    from ..parallel.mesh import make_mesh
    from ..tasks import prep_batch

    mesh = make_mesh(cfg.train.dp_size or None, cfg.train.sp_size)
    eng = InferenceEngine(cfg, weights, device=device, sampler=sampler, sde_opts=sde_opts,
                          mesh=mesh)
    fns = _wrappers(wrappers)
    out = {}
    if velocity is not None:
        x, t = velocity
        b = eng._batch(batch)
        kw = prep_batch(cfg, b)["model_kwargs"]
        B, T, L = kw["mask"].shape
        _, s_axes = split_axes(mesh, B, T, L)
        before = [f.launches for f in fns]
        comm.reset()
        with kernel_mesh(mesh.sub(s_axes)):
            v = eng.model.forward_inference(
                x.to(eng.device), t.to(eng.device), kw["mask"], start_frames=kw["start_frames"],
                end_frames=kw["end_frames"], x_cond=kw["x_cond"],
                x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
        out.update(velocity=v.float().cpu(), velocity_counts=dict(comm.COUNTS),
                   velocity_launches={f.__name__: f.launches - b for f, b in zip(fns, before)})
    gen = torch.Generator(device=device).manual_seed(seed)
    before = [f.launches for f in fns]
    comm.reset()
    _sync(device)
    t0 = time.perf_counter()
    atom14, aa = eng.sample(batch, gen)
    _sync(device)
    out.update(seconds=time.perf_counter() - t0, atom14=atom14.float().cpu(), aa=aa.cpu(),
               counts=dict(comm.COUNTS), steps=eng.last_counts,
               launches={f.__name__: f.launches - b for f, b in zip(fns, before)})
    return out


def run_jobs(jobs) -> list:
    """Several checks in one world: ``jobs`` a list of (name, kwargs) of
    this module's functions; their results in order."""
    return [globals()[name](**kw) for name, kw in jobs]


def train_cli(*argvs) -> list:
    """``cli/train.py`` with each of ``argvs`` in turn (the default group
    from the torchrun environment); the steps they reached."""
    from ..cli import train

    return [train.main(argv).step for argv in argvs]


def collective_ms(device, numels: dict, reps: int = 5) -> dict:
    """Host ms of each collective over the world (synchronised around it,
    the median of ``reps`` after one warm-up) on an f32 tensor of
    ``numels[kind]`` elements on ``device``."""
    import torch.distributed as dist

    n = dist.get_world_size()
    ops = {"all_reduce": lambda t: comm.all_reduce(t, None),
           "all_gather": lambda t: comm.all_gather(t, None),
           "broadcast": lambda t: comm.broadcast(t, 0),
           "all_to_all": lambda t: comm.all_to_all(t.view(n, -1), None)}
    out = {}
    for kind, numel in numels.items():
        t = torch.ones(numel - numel % n, device=device)
        times = []
        for _ in range(reps + 1):
            _sync(device)
            t0 = time.perf_counter()
            ops[kind](t)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out[kind] = {"ms": sorted(times[1:])[reps // 2], "mb": t.numel() * 4 / 1e6}
    return out


def forward_grads(cfg, weights, batch, seed: int, device="cuda") -> dict:
    """``LatentMDGen.forward`` of a featurized global ``batch`` at seeded
    (x, t) under the whole mesh registered (``kernel_mesh``: the trunk split
    over the batch or the sequence, the rest of the model replicated), and
    the gradient of sum(out * w) for a seeded w: the output and every
    parameter's gradient, whole on every rank, and the collectives."""
    from ..inference.sampling import resolve_device
    from ..models.denoiser import LatentMDGen
    from ..parallel.kernel_sharding import kernel_mesh
    from ..parallel.mesh import make_mesh
    from ..tasks import prep_batch

    device = resolve_device(device)
    mesh = make_mesh(cfg.train.dp_size or None, cfg.train.sp_size)
    model = LatentMDGen(cfg, cfg.latent_dim, dtype=torch.float32)
    model.load_state_dict(weights)
    model.to(device)
    kw = prep_batch(cfg, {k: v.to(device) for k, v in batch.items()})["model_kwargs"]
    B, T, L = kw["mask"].shape
    g = torch.Generator().manual_seed(seed)
    x, w = (torch.randn(B, T, L, cfg.latent_dim, generator=g).to(device) for _ in range(2))
    t = (torch.rand(B, generator=g) * 0.9 + 0.05).to(device)
    comm.reset()
    with kernel_mesh(mesh):
        out = model(x, t, kw["mask"], start_frames=kw["start_frames"],
                    end_frames=kw["end_frames"], x_cond=kw["x_cond"],
                    x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
        (out * w).sum().backward()
    return {"out": out.detach().cpu(), "counts": dict(comm.COUNTS),
            "grads": {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
                      for k, p in model.named_parameters()}}
