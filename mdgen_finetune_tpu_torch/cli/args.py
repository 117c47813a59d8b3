"""argparse -> MDGenConfig bridge, flag-compatible with the reference CLI.

The port's own copy of the JAX package's ``cli/args.py`` (:20-141): it
accepts the reference's training flags (src/mdgen/parsing.py:5-125) so that
users can run the same commands, and maps them onto the structured config
tree. Which of them the port trains with is decided by ``Trainer`` (flags of
branches not ported yet raise ``NotImplementedError`` naming their ROADMAP
item).
"""
from __future__ import annotations

import argparse

from ..config import (
    DataConfig,
    MDGenConfig,
    ModelConfig,
    TaskConfig,
    TrainConfig,
    TransportConfig,
)


def add_train_args(parser: argparse.ArgumentParser):
    p = parser
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--overfit", action="store_true")
    p.add_argument("--overfit_peptide", type=str, default=None)
    p.add_argument("--overfit_frame", action="store_true")
    p.add_argument("--train_batches", type=int, default=None)
    p.add_argument("--val_batches", type=int, default=None)
    p.add_argument("--val_repeat", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--val_epoch_freq", type=int, default=1)
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--inference_batches", type=int, default=0)
    p.add_argument("--designability_freq", type=int, default=1)
    p.add_argument("--check_grad", action="store_true")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--ckpt_freq", type=int, default=1)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--run_name", type=str, default="default")
    p.add_argument("--accumulate_grad", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--grad_checkpointing", action="store_true")
    p.add_argument("--adamW", action="store_true")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "32-true"])
    p.add_argument("--train_split", type=str, required=True)
    p.add_argument("--val_split", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--num_frames", type=int, default=50)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--atlas", action="store_true")
    p.add_argument("--copy_frames", action="store_true")
    p.add_argument("--design_key_frames", action="store_true")
    p.add_argument("--no_aa_emb", action="store_true")
    p.add_argument("--no_torsion", action="store_true")
    p.add_argument("--no_design_torsion", action="store_true")
    p.add_argument("--supervise_no_torsions", action="store_true")
    p.add_argument("--supervise_all_torsions", action="store_true")
    p.add_argument("--no_offsets", action="store_true")
    p.add_argument("--no_frames", action="store_true")
    p.add_argument("--hyena", action="store_true")
    p.add_argument("--no_rope", action="store_true")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--interleave_ipa", action="store_true")
    p.add_argument("--prepend_ipa", action="store_true")
    p.add_argument("--num_layers", type=int, default=5)
    p.add_argument("--embed_dim", type=int, default=384)
    p.add_argument("--mha_heads", type=int, default=16)
    p.add_argument("--ipa_heads", type=int, default=4)
    p.add_argument("--ipa_head_dim", type=int, default=32)
    p.add_argument("--ipa_qk", type=int, default=8)
    p.add_argument("--ipa_v", type=int, default=8)
    p.add_argument("--time_multiplier", type=float, default=100.0)
    p.add_argument("--abs_pos_emb", action="store_true")
    p.add_argument("--abs_time_emb", action="store_true")
    p.add_argument("--path-type", dest="path_type", type=str, default="GVP", choices=["Linear", "GVP", "VP"])
    p.add_argument("--prediction", type=str, default="velocity", choices=["velocity", "score", "noise"])
    p.add_argument("--sampling_method", type=str, default="dopri5", choices=["dopri5", "euler", "heun"])
    p.add_argument("--inference_steps", type=int, default=100)
    p.add_argument("--alpha_max", type=float, default=8)
    p.add_argument("--discrete_loss_weight", type=float, default=0.5)
    p.add_argument("--dirichlet_flow_temp", type=float, default=1.0)
    p.add_argument("--allow_nan_cfactor", action="store_true")
    p.add_argument("--tps_condition", action="store_true")
    p.add_argument("--design", action="store_true")
    p.add_argument("--sim_condition", action="store_true")
    p.add_argument("--inpainting", action="store_true")
    p.add_argument("--dynamic_mpnn", action="store_true")
    p.add_argument("--mpnn", action="store_true")
    p.add_argument("--frame_interval", type=int, default=None)
    p.add_argument("--cond_interval", type=int, default=None)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--dp_size", type=int, default=0, help="0 = all devices (one here)")
    p.add_argument("--sp_size", type=int, default=1)
    p.add_argument("--workdir", type=str, default="workdir")
    return p


def args_to_config(a: argparse.Namespace) -> MDGenConfig:
    return MDGenConfig(
        model=ModelConfig(
            num_layers=a.num_layers, embed_dim=a.embed_dim, mha_heads=a.mha_heads,
            ipa_heads=a.ipa_heads, ipa_head_dim=a.ipa_head_dim, ipa_qk=a.ipa_qk, ipa_v=a.ipa_v,
            dropout=a.dropout, hyena=a.hyena, no_rope=a.no_rope,
            prepend_ipa=a.prepend_ipa, interleave_ipa=a.interleave_ipa, no_aa_emb=a.no_aa_emb,
            abs_pos_emb=a.abs_pos_emb, abs_time_emb=a.abs_time_emb,
            time_multiplier=a.time_multiplier, grad_checkpointing=a.grad_checkpointing,
            use_bf16=(a.precision == "bf16"),
        ),
        transport=TransportConfig(
            path_type=a.path_type, prediction=a.prediction, sampling_method=a.sampling_method,
            inference_steps=a.inference_steps, alpha_max=a.alpha_max,
            discrete_loss_weight=a.discrete_loss_weight, dirichlet_flow_temp=a.dirichlet_flow_temp,
            allow_nan_cfactor=a.allow_nan_cfactor,
        ),
        data=DataConfig(
            data_dir=a.data_dir, train_split=a.train_split, val_split=a.val_split or a.train_split,
            num_frames=a.num_frames, crop=a.crop, suffix=a.suffix, atlas=a.atlas,
            frame_interval=a.frame_interval, overfit=a.overfit, overfit_peptide=a.overfit_peptide,
            overfit_frame=a.overfit_frame, copy_frames=a.copy_frames,
        ),
        task=TaskConfig(
            sim_condition=a.sim_condition, tps_condition=a.tps_condition, inpainting=a.inpainting,
            design=a.design, dynamic_mpnn=a.dynamic_mpnn, mpnn=a.mpnn, cond_interval=a.cond_interval,
            design_key_frames=a.design_key_frames, no_torsion=a.no_torsion,
            no_design_torsion=a.no_design_torsion, supervise_all_torsions=a.supervise_all_torsions,
            supervise_no_torsions=a.supervise_no_torsions, no_offsets=a.no_offsets, no_frames=a.no_frames,
        ),
        train=TrainConfig(
            lr=a.lr, adamW=a.adamW, grad_clip=a.grad_clip, accumulate_grad=a.accumulate_grad,
            ema=a.ema, ema_decay=a.ema_decay, epochs=a.epochs, batch_size=a.batch_size,
            ckpt_freq=a.ckpt_freq, print_freq=a.print_freq, seed=a.seed,
            dp_size=a.dp_size, sp_size=a.sp_size,
        ),
        run_name=a.run_name,
        workdir=a.workdir,
    )
