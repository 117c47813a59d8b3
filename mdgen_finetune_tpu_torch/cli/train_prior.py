"""Outsourced-prior distillation CLI (reference src/train_prior.py).

Counterpart of the JAX package's ``cli/train_prior.py``: distils the MDGen
prior-latent distribution (U[-3, 3] draws, src/train_prior.py:52-59) into a
``LatentMDGen`` DDPM v-predictor (``rtb.trainer.DiffuserTrainer``), so that
an RTB chain has exact per-step log-probabilities. The conditioning comes
from the frozen prior's dataset (``--sim_ckpt`` or ``--torch_ckpt`` gives
its config). Runs on the card unless ``--device cpu`` is given:

    python -m mdgen_finetune_tpu_torch.cli.train_prior --sim_ckpt CKPT \\
        --data_dir DIR --split DIR/split.csv --n_steps 10000 [--device cpu]

Writes ``prior_params.pt`` (the distilled state_dict) under
``--workdir/--exp_name`` every ``--print_freq`` steps.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..inference import sample_prior_latent
from ..rtb.priors import MDGenSimulator
from ..rtb.trainer import DiffuserTrainer
from .sim_inference import load_params


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, default=None)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=10000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--traj_length", type=int, default=1000)
    p.add_argument("--exp_name", type=str, default="prior_distill")
    p.add_argument("--workdir", type=str, default="workdir")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)

    cfg, params = load_params(a)
    sim = MDGenSimulator(cfg, params, a.split, data_dir=a.data_dir, batch_size=a.batch_size,
                         device=a.device)
    condition, _ = sim.get_cond_args()
    T, L, D = sim.latent_shape

    def source(generator):
        return sample_prior_latent(generator, a.batch_size, T, L, D, uniform=True)

    dt = DiffuserTrainer(cfg, source, condition, lr=a.lr, num_train_timesteps=a.traj_length,
                         seed=a.seed, device=sim.device)
    prior_params = dt.init_params()
    opt_state = dt.opt.init(prior_params)
    gen = torch.Generator(device=sim.device).manual_seed(a.seed)

    workdir = os.path.join(a.workdir, a.exp_name)
    os.makedirs(workdir, exist_ok=True)
    done = 0
    while done < a.n_steps:
        chunk = min(a.print_freq, a.n_steps - done)
        prior_params, opt_state, losses = dt.train(prior_params, opt_state, chunk, gen)
        done += chunk
        print(json.dumps({"step": done, "loss": float(np.mean(losses))}), flush=True)
        torch.save({k: v.detach().cpu() for k, v in prior_params.items()},
                   os.path.join(workdir, "prior_params.pt"))


if __name__ == "__main__":
    main()
