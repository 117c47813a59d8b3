"""RTB posterior fine-tuning CLI (reference src/outsourced_train_posterior.py).

Counterpart of the JAX package's ``cli/train_posterior.py`` (:26-144): loads
a frozen MDGen prior (``--sim_ckpt``, a ``Trainer`` checkpoint, or
``--torch_ckpt``, a released ``.ckpt``), and fine-tunes a LoRA posterior
over the prior-latent DDPM with the relative-trajectory-balance objective
against an energy reward: OpenMM Amber14 when it is installed, the
differentiable surrogate otherwise (``--reward auto``; the choice is
printed). With several peptides in a batch (``--peptides_per_batch``) it is
the conditional variant: VarGrad estimates one logZ per peptide. Runs on the
card unless ``--device cpu`` is given:

    python -m mdgen_finetune_tpu_torch.cli.train_posterior --sim_ckpt CKPT \\
        --data_dir DIR --split DIR/split.csv --reward surrogate \\
        [--batch_size 4 --sampling_length 10 --traj_length 1000] [--device cpu]

Writes ``log.jsonl`` and ``checkpoint.pt`` (adapters, logZ, optimizer
state) under ``--workdir/--exp_name``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from ..geometry.protein import atom14_to_pdb
from ..rtb.priors import MDGenSimulator
from ..rtb.rewards import SurrogateReward, get_reward
from ..rtb.trainer import RTBConfig, RTBTrainer
from .sim_inference import load_params


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, default=None)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--peptide", type=str, default=None)
    p.add_argument("--peptides_per_batch", type=int, default=1,
                   help=">1 mixes that many distinct peptides per batch (the conditional "
                        "variant, reference outsourced_train_conditional_posterior.py); "
                        "batch_size must be a multiple")
    p.add_argument("--method", type=str, default="rtb", choices=["rtb", "tb"])
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--logz_lr", type=float, default=5e-2)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--n_iterations", type=int, default=1000)
    p.add_argument("--sampling_length", type=int, default=10)
    p.add_argument("--traj_length", type=int, default=1000, help="DDPM train timesteps")
    p.add_argument("--xT_type", type=str, default="gaussian", choices=["gaussian", "uniform"])
    p.add_argument("--vargrad", action="store_true")
    p.add_argument("--learning_cutoff", type=float, default=0.1)
    p.add_argument("--detach_freq", type=float, default=0.0)
    p.add_argument("--lora_rank", type=int, default=32)
    p.add_argument("--replay_buffer", action="store_true")
    p.add_argument("--rb_size", type=int, default=1000)
    p.add_argument("--rb_sample_strategy", type=str, default="uniform",
                   choices=["uniform", "reward"])
    p.add_argument("--back_and_forth", action="store_true",
                   help="train on back-and-forth trajectories (src/rtb_utils/args.py:76)")
    p.add_argument("--bf_freq", type=int, default=4)
    p.add_argument("--bf_noise_level", type=float, default=0.5)
    p.add_argument("--langevin", action="store_true",
                   help="reward-gradient policy correction (samplers.py:120-171)")
    p.add_argument("--prior_sampling", action="store_true")
    p.add_argument("--prior_sampling_ratio", type=float, default=0.1)
    p.add_argument("--reward", type=str, default="auto", choices=["auto", "amber14", "surrogate"])
    p.add_argument("--reward_temperature", type=float, default=1.0)
    p.add_argument("--exp_name", type=str, default="rtb")
    p.add_argument("--workdir", type=str, default="workdir")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def host_reward_fn(reward):
    """An OpenMM reward over the decoded samples: each element written as a
    multi-MODEL PDB in a temporary directory and scored there."""
    def reward_fn(a14, aat):
        aat = np.asarray(aat.cpu())  # (L,) shared or (B, L) per element
        a14 = a14.cpu().numpy()
        with tempfile.TemporaryDirectory() as td:
            paths = []
            for i in range(a14.shape[0]):
                path = os.path.join(td, f"sample_{i}.pdb")
                atom14_to_pdb(a14[i], aat[i] if aat.ndim == 2 else aat, path)
                paths.append(path)
            _, logrs = reward(paths=paths, tmp_dir=td)
        return logrs
    return reward_fn


def main(argv=None):
    a = parser().parse_args(argv)
    cfg, params = load_params(a)
    if a.batch_size % a.peptides_per_batch:
        raise SystemExit(f"--batch_size {a.batch_size} must be a multiple of "
                         f"--peptides_per_batch {a.peptides_per_batch}")
    sim = MDGenSimulator(cfg, params, a.split, data_dir=a.data_dir,
                         batch_size=a.peptides_per_batch,
                         distinct_peptides=a.peptides_per_batch > 1, device=a.device)
    rtb = RTBConfig(
        method=a.method, lr=a.lr, logz_lr=a.logz_lr, batch_size=a.batch_size,
        n_iterations=a.n_iterations, sampling_length=a.sampling_length,
        num_train_timesteps=a.traj_length, xT_type=a.xT_type, vargrad=a.vargrad,
        learning_cutoff=a.learning_cutoff, detach_freq=a.detach_freq,
        lora_rank=a.lora_rank, replay_buffer=a.replay_buffer, rb_size=a.rb_size,
        rb_strategy=a.rb_sample_strategy, back_and_forth=a.back_and_forth,
        bf_freq=a.bf_freq, bf_noise_level=a.bf_noise_level, langevin=a.langevin,
        prior_sampling=a.prior_sampling, prior_sampling_ratio=a.prior_sampling_ratio,
        seed=a.seed)
    workdir = os.path.join(a.workdir, a.exp_name)
    os.makedirs(workdir, exist_ok=True)

    reward = get_reward(a.reward, temperature=a.reward_temperature)
    on_device = isinstance(reward, SurrogateReward)
    print(json.dumps({"reward": type(reward).__name__, "asked": a.reward,
                      "on_device": on_device, "device": str(sim.device)}), flush=True)
    reward_fn = reward if on_device else host_reward_fn(reward)
    trainer = RTBTrainer(cfg, rtb, sim, reward_fn, workdir=workdir, reward_on_device=on_device)
    ckpt_path = os.path.join(workdir, "checkpoint.pt")
    if a.resume and os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
        print(f"resumed from {ckpt_path}", flush=True)

    log_path = os.path.join(workdir, "log.jsonl")

    def log_fn(m):
        print(json.dumps(m), flush=True)
        with open(log_path, "a") as f:
            f.write(json.dumps(m) + "\n")
        trainer.save(ckpt_path)

    trainer.run(log_every=a.print_freq, log_fn=log_fn)
    trainer.save(ckpt_path)


if __name__ == "__main__":
    main()
