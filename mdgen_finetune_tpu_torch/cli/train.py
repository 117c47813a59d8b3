"""Training CLI, flag-compatible with the reference's train.py.

Counterpart of the JAX package's ``cli/train.py`` (:21-105). It writes
``config.json`` and ``log.jsonl`` into ``workdir/run_name``, runs epochs of
``Trainer.fit``, takes the validation loss without gradients on the EMA
weights, and saves a checkpoint every ``ckpt_freq`` epochs (and after the
last) that ``cli/sim_inference.py --sim_ckpt`` reads. It trains on the card
unless ``--device cpu`` is given. The reference's 4AA forward-simulation
command (``scripts/train_4aa_forward_sim.sh``):

    python -m mdgen_finetune_tpu_torch.cli.train --sim_condition \\
        --train_split splits/4AA_train.csv --val_split splits/4AA_val.csv \\
        --data_dir data/4AA_data/ --num_frames 1000 --prepend_ipa --abs_pos_emb \\
        --crop 4 --ckpt_freq 40 --val_repeat 25 --suffix _i100 --epochs 10000 \\
        --grad_checkpointing --run_name forward_sim

Every task trains (``--sim_condition``, ``--tps_condition``,
``--inpainting``, ``--design``, ``--mpnn``, ``--dynamic_mpnn``,
``--cond_interval``). With ``--design --inference_batches N``, every
``designability_freq`` epochs the designability probe (JAX :65-83;
reference src/mdgen/wrapper.py:516-537) samples a validation batch of
``min(batch_size, 2)`` with the EMA weights (when the config trains them)
and logs ``designability_*``: each element's designed sequence scored
against its own with ``analysis.task_metrics.sequence_recovery``, averaged.
``--profile_dir`` writes a ``torch.profiler`` trace of the first epoch.

Several ranks (``parallel/``): under ``torchrun`` (``WORLD_SIZE`` > 1) the
default group starts from the environment (``parallel.launch.init_from_env``:
rank r on ``cuda:(LOCAL_RANK % device_count)``, ``nccl`` when every rank
has a card of its own, else ``gloo``) and ``Trainer`` builds the (dp, sp)
mesh of ``--dp_size`` (0: all ranks) and ``--sp_size``. Every rank reads the
same batches (one seed); a step splits them by the mesh's rules, and so do
the validation step and the designability probe. Rank 0 alone writes
``config.json``, the log and the checkpoints:

    torchrun --nproc_per_node 4 -m mdgen_finetune_tpu_torch.cli.train ... \
        --dp_size 0 --sp_size 1

In one process a mesh of more than one rank raises JAX's ``ValueError``
before anything is written.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.dataset import MDGenDataset, make_batch_iterator
from ..parallel.launch import init_from_env
from ..training import Trainer
from ..utils.logging import profile_trace
from .args import add_train_args, args_to_config


def designability(trainer, state, val_ds, rng, generator) -> dict:
    """The designability probe: sample a validation batch of ``min(B, 2)``
    on the EMA weights when the config trains them, and average over its
    elements the recovery of each one's own sequence (the batch mixes
    peptides)."""
    from ..analysis.task_metrics import sequence_recovery
    from ..data.featurize import featurize_atom14_batch
    from ..inference import InferenceEngine

    cfg, dev = trainer.cfg, trainer.device
    engine = InferenceEngine(cfg, state.ema_params if cfg.train.ema else state.params, device=dev,
                             mesh=trainer.mesh)
    vb = val_ds.batch(rng, min(cfg.train.batch_size, 2))
    feats = featurize_atom14_batch(torch.as_tensor(vb["atom14"], device=dev).float(),
                                   torch.as_tensor(vb["seqres"], device=dev).long(),
                                   torch.as_tensor(vb["mask"], device=dev).float())
    _, aa_out = engine.sample(feats, generator)
    aa = aa_out[:, 0].cpu().numpy()
    seqs = np.asarray(vb["seqres"])
    recs = [sequence_recovery(aa[i:i + 1], seqs[i]) for i in range(aa.shape[0])]
    return {k: float(np.mean([r[k] for r in recs])) for k in recs[0]}


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_train_args(parser)
    parser.add_argument("--steps_per_epoch", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the first epoch's steps here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    a = parser.parse_args(argv)
    cfg = args_to_config(a)
    trainer = Trainer(cfg, device=init_from_env(a.device))  # refuses what is not ported
    lead = trainer.mesh.rank == 0

    workdir = os.path.join(cfg.workdir, cfg.run_name)
    if lead:
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    train_ds = MDGenDataset(cfg, cfg.data.train_split)
    val_ds = MDGenDataset(cfg, cfg.data.val_split, repeat=a.val_repeat)
    it = make_batch_iterator(train_ds, cfg.train.batch_size, seed=cfg.train.seed)
    state = trainer.init_state(cfg.train.seed)
    if a.ckpt:
        state = trainer.restore_checkpoint(a.ckpt, state)
        if lead:
            print(f"resumed from {a.ckpt} at step {state.step}", flush=True)

    # --train_batches caps the epoch length (Lightning limit_train_batches,
    # reference train.py:49); --steps_per_epoch is the explicit override
    steps_per_epoch = a.steps_per_epoch or a.train_batches or max(
        len(train_ds) // cfg.train.batch_size, 1)
    log_path = os.path.join(workdir, "log.jsonl")
    gen = torch.Generator(device=trainer.device).manual_seed(cfg.train.seed + 1)

    def log_fn(m):
        if not lead:
            return
        print(json.dumps(m), flush=True)
        with open(log_path, "a") as f:
            f.write(json.dumps(m) + "\n")

    try:
        for epoch in range(cfg.train.epochs):
            with profile_trace(a.profile_dir if epoch == 0 and lead else None):
                state = trainer.fit(state, it, steps_per_epoch, gen,
                                    log_every=cfg.train.print_freq, log_fn=log_fn)

            if (cfg.task.design and a.inference_batches
                    and (epoch + 1) % a.designability_freq == 0):
                rec = designability(trainer, state, val_ds, np.random.default_rng(epoch), gen)
                log_fn({f"designability_{k}": v for k, v in rec.items()} | {"epoch": epoch})

            if not a.no_validate and (epoch + 1) % a.val_epoch_freq == 0:
                vrng = np.random.default_rng(0)
                vgen = torch.Generator(device=trainer.device).manual_seed(cfg.train.seed + 2)
                vals = [trainer.eval_loss(state, val_ds.batch(vrng, cfg.train.batch_size), vgen)
                        for _ in range(a.val_batches or max(len(val_ds) // cfg.train.batch_size,
                                                            1))]
                mean = {f"val_{k}": float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}
                mean.update(epoch=epoch, step=state.step)
                log_fn(mean)

            if (epoch + 1) % cfg.train.ckpt_freq == 0 or epoch == cfg.train.epochs - 1:
                path = trainer.save_checkpoint(state)
                if lead:
                    print(f"saved {path}", flush=True)
    finally:
        it.close()
    return state


if __name__ == "__main__":
    main()
