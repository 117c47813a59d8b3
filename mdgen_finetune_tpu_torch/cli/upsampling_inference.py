"""Trajectory upsampling CLI (reference src/upsampling_inference.py).

Counterpart of the JAX package's ``cli/upsampling_inference.py``: slices a
coarse trajectory into windows, conditions on every ``cond_interval``-th
frame (zeros and identity rotations elsewhere), generates the in-between
frames with the config's ODE sampler and stitches the windows back into
one multi-MODEL PDB per peptide. Runs on the card unless ``--device cpu``
is given:

    python -m mdgen_finetune_tpu_torch.cli.upsampling_inference --ckpt CKPT \\
        --data_dir DIR --split DIR/split.csv --out_dir OUT [--device cpu]

(``--ckpt`` is a ``Trainer`` checkpoint; ``--torch_ckpt`` a released
``.ckpt`` with ``--config`` or the ``config.json`` beside it.)
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..geometry import frames as G
from ..geometry.protein import atom14_to_pdb
from ..geometry.tables import str_sequence_to_aatype
from ..inference import InferenceEngine
from .sim_inference import load_params


def split_windows(item: dict, num_frames: int, cond_interval: int) -> list[dict]:
    """(src/upsampling_inference.py:47-66): each window holds coarse frames at
    ::cond_interval, zeros (identity rots) elsewhere."""
    T_c, L = item["trans"].shape[:2]
    cond_frames = num_frames // cond_interval
    total_items = T_c // cond_frames
    out = []
    for i in range(total_items):
        sel = slice(i * cond_frames, (i + 1) * cond_frames)
        torsions = np.zeros((num_frames, L, 7, 2), np.float32)
        trans = np.zeros((num_frames, L, 3), np.float32)
        rots = np.broadcast_to(np.eye(3, dtype=np.float32), (num_frames, L, 3, 3)).copy()
        torsions[::cond_interval] = item["torsions"][sel]
        trans[::cond_interval] = item["trans"][sel]
        rots[::cond_interval] = item["rots"][sel]
        out.append(
            {"torsions": torsions[None], "torsion_mask": item["torsion_mask"][None],
             "trans": trans[None], "rots": rots[None],
             "seqres": item["seqres"][None], "mask": item["mask"][None]}
        )
    return out


@torch.no_grad()
def coarse_item(arr: np.ndarray, aatype: np.ndarray) -> dict:
    """A coarse atom14 trajectory (T_c, L, 14, 3) -> its frames, torsions
    and masks on the host (the JAX CLI's featurization, :78-88)."""
    T_c, L = arr.shape[:2]
    atom14 = torch.from_numpy(np.asarray(arr, np.float32))
    aat = torch.from_numpy(np.asarray(aatype, np.int64)).expand(T_c, L)
    frames = G.atom14_to_frames(atom14)
    torsions, torsion_mask = G.atom37_to_torsions(G.atom14_to_atom37(atom14, aat), aat)
    return {"torsions": torsions.numpy(), "torsion_mask": torsion_mask.numpy()[0],
            "trans": frames.trans.numpy(), "rots": frames.rot.numpy(),
            "seqres": np.asarray(aatype), "mask": np.ones(L, np.float32)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", dest="sim_ckpt", type=str, default=None)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="_i100")
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)

    cfg, params = load_params(a)
    engine = InferenceEngine(cfg, params, device=a.device)
    os.makedirs(a.out_dir, exist_ok=True)
    cond_interval = cfg.task.cond_interval or 100

    with open(a.split) as f:
        rows = list(csv.DictReader(f))
    gen = torch.Generator(device=engine.device).manual_seed(a.seed)

    for row in rows:
        name, seqres = row["name"], row["seqres"]
        if a.pdb_id and name not in a.pdb_id:
            continue
        aatype = str_sequence_to_aatype(seqres)
        arr = np.load(os.path.join(a.data_dir, f"{name}{a.suffix}.npy")).astype(np.float32)
        windows = split_windows(coarse_item(arr, aatype), cfg.data.num_frames, cond_interval)
        all_atom14 = []
        for w in windows:
            atom14, _ = engine.sample(w, gen)
            all_atom14.append(atom14[0].cpu().numpy())
        full = np.concatenate(all_atom14, axis=0)
        atom14_to_pdb(full, aatype, os.path.join(a.out_dir, f"{name}.pdb"))
        print(f"{name}: upsampled {arr.shape[0]} coarse -> {full.shape[0]} frames", flush=True)


if __name__ == "__main__":
    main()
