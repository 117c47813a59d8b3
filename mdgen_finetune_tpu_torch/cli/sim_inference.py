"""Forward-simulation rollout CLI (reference src/sim_inference.py).

Counterpart of the JAX package's ``cli/sim_inference.py`` (:24-102): loads a
checkpoint that ``Trainer.save_checkpoint`` wrote (a directory with
``state.pt`` and ``config.json``) or, with ``--torch_ckpt``, a released
MDGen ``.ckpt`` (PyTorch Lightning; its config from ``--config`` or the
``config.json`` beside it; the EMA weights when the file has them), rolls
out ``num_rollouts`` windows from the first frame of each test peptide with
the config's ODE sampler (or, with ``--sde``, the reverse SDE: ``--sde_steps``,
``--sde_method`` Euler or Heun, ``--diffusion_form``, ``--diffusion_norm``,
``--last_step`` Mean, Tweedie or Euler, ``--last_step_size``), and writes one
multi-MODEL PDB trajectory and one meta JSON line per peptide.
The checkpoint's config chooses the model, the modular configurations
(``interleave_ipa``, ``hyena``, ``no_rope``) included. Runs on the card
unless ``--device cpu`` is given:

    python -m mdgen_finetune_tpu_torch.cli.sim_inference --sim_ckpt CKPT \\
        --data_dir DIR --split DIR/split.csv --out_dir OUT --num_frames 1000 \\
        --num_rollouts 10 [--sde --sde_steps 250] [--device cpu]

``load_params`` serves the other task CLIs too.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..data.dataset import MDGenDataset
from ..geometry.protein import atom14_to_pdb
from ..inference import InferenceEngine
from ..config import MDGenConfig
from ..training import read_checkpoint
from ..utils.torch_compat import load_reference_checkpoint


def load_params(args) -> tuple:
    """(config, state_dict to sample with) of ``--torch_ckpt`` (a released
    ``.ckpt`` and ``--config`` or the ``config.json`` beside it; its EMA
    when present, JAX :24-31) or of ``--sim_ckpt`` (a ``Trainer``
    checkpoint)."""
    if args.torch_ckpt:
        cfg_path = args.config or os.path.join(os.path.dirname(args.torch_ckpt), "config.json")
        with open(cfg_path) as f:
            cfg = MDGenConfig.from_json(f.read())
        params, ema, _ = load_reference_checkpoint(args.torch_ckpt, cfg)
        return cfg, ema or params
    return read_checkpoint(args.sim_ckpt)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, default=None)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--num_rollouts", type=int, default=10)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--all_peptides", action="store_true",
                   help="process every split row (the reference stops after the first, src/sim_inference.py:136)")
    # reverse-SDE sampling (reference Sampler.sample_sde, transport.py:346-450)
    p.add_argument("--sde", action="store_true", help="sample with the reverse SDE instead of the pf-ODE")
    p.add_argument("--sde_steps", type=int, default=250)
    p.add_argument("--sde_method", type=str, default="Euler", choices=["Euler", "Heun"])
    p.add_argument("--diffusion_form", type=str, default="SBDM")
    p.add_argument("--diffusion_norm", type=float, default=1.0)
    p.add_argument("--last_step", type=str, default="Mean", choices=["Mean", "Tweedie", "Euler"])
    p.add_argument("--last_step_size", type=float, default=0.04)
    a = p.parse_args(argv)

    cfg, params = load_params(a)
    if a.num_frames:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_frames=a.num_frames,
                                                   data_dir=a.data_dir, suffix=a.suffix))
    sde_opts = dict(num_steps=a.sde_steps, method=a.sde_method, diffusion_form=a.diffusion_form,
                    diffusion_norm=a.diffusion_norm, last_step=a.last_step,
                    last_step_size=a.last_step_size)
    engine = InferenceEngine(cfg, params, device=a.device, sampler="sde" if a.sde else "ode",
                             sde_opts=sde_opts if a.sde else None)
    ds = MDGenDataset(cfg, a.split, data_dir=a.data_dir)
    os.makedirs(a.out_dir, exist_ok=True)

    gen = torch.Generator(device=engine.device).manual_seed(a.seed)
    for idx, (name, _) in enumerate(ds.entries):
        sample = ds.sample(np.random.default_rng(a.seed), idx=idx)
        start = sample["atom14"][:1][None]  # (1, 1, L, 14, 3) -> frame 0
        t0 = time.time()
        traj = engine.rollout(start[:, 0], sample["seqres"][None], sample["mask"][None],
                              a.num_rollouts, gen)
        dur = time.time() - t0
        out_path = os.path.join(a.out_dir, f"{name}.pdb")
        atom14_to_pdb(traj[0], sample["seqres"], out_path)
        meta = {"name": name, "frames": int(traj.shape[1]), "wall_s": round(dur, 2),
                "frames_per_sec": round(traj.shape[1] / dur, 2)}
        print(json.dumps(meta), flush=True)
        with open(os.path.join(a.out_dir, f"{name}_meta.json"), "w") as f:
            json.dump(meta, f)
        if not a.all_peptides:
            break  # reference behavior: first peptide only (src/sim_inference.py:136)


if __name__ == "__main__":
    main()
