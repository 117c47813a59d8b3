"""Transition-path sampling CLI (reference src/tps_inference.py).

Counterpart of the JAX package's ``cli/tps_inference.py``: for each peptide
of the split it fits the MSM of the reference MD (``msm_common``), picks the
least-flux pair of metastable states, draws start and end frames of those
states from ``np.random.default_rng(seed)`` (the JAX CLI's draws, so the
same frames for the same data and seed), builds endpoint-conditioned
windows (frames 0..T-2 hold the start structure, frame T-1 the end one)
and samples one interpolating trajectory for each with the config's ODE
sampler (``tps_condition``). Writes one PDB per path and
``{name}_metadata.json``. Runs on the card unless ``--device cpu`` is
given:

    python -m mdgen_finetune_tpu_torch.cli.tps_inference --torch_ckpt CKPT.ckpt \\
        --data_dir DIR --split DIR/split.csv --out_dir OUT --suffix _i100 \\
        --num_batches 100 --batch_size 10 [--device cpu]

(``--sim_ckpt`` takes a ``Trainer`` checkpoint instead of a released
``.ckpt``.)
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import os

import numpy as np
import torch

from ..data.featurize import featurize_atom14_batch
from ..geometry.protein import atom14_to_pdb
from ..geometry.tables import str_sequence_to_aatype
from ..inference import InferenceEngine
from .msm_common import build_msm_metadata, pick_flux_states
from .sim_inference import load_params


def make_endpoint_batch(arr, aatype, mask, start_idx, end_idx, num_frames, device="cpu"):
    """(src/tps_inference.py:43-80): frames 0..T-2 copy the start structure,
    frame T-1 is the end structure; featurized on ``device``."""
    start = np.asarray(arr[start_idx], dtype=np.float32)
    end = np.asarray(arr[end_idx], dtype=np.float32)
    atom14 = np.broadcast_to(start, (num_frames, *start.shape)).copy()
    atom14[-1] = end
    return featurize_atom14_batch(torch.as_tensor(atom14[None], device=device),
                                  torch.as_tensor(np.asarray(aatype)[None], device=device).long(),
                                  torch.as_tensor(np.asarray(mask)[None], device=device))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sim_ckpt", type=str, default=None)
    p.add_argument("--torch_ckpt", type=str, default=None)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--mddir", type=str, default=None, help="dir of reference MD .npy (default: data_dir)")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--split", type=str, required=True)
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--num_frames", type=int, default=None)
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--n_chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)

    cfg, params = load_params(a)
    if a.num_frames:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_frames=a.num_frames))
    engine = InferenceEngine(cfg, params, device=a.device)
    os.makedirs(a.out_dir, exist_ok=True)
    mddir = a.mddir or a.data_dir

    with open(a.split) as f:
        rows = list(csv.DictReader(f))
    chunk = np.array_split(np.arange(len(rows)), a.n_chunks)[a.chunk_idx]
    rng = np.random.default_rng(a.seed)
    gen = torch.Generator(device=engine.device).manual_seed(a.seed)

    for ridx in chunk:
        name, seqres = rows[ridx]["name"], rows[ridx]["seqres"]
        if a.pdb_id and name not in a.pdb_id:
            continue
        if os.path.exists(f"{a.out_dir}/{name}_metadata.json"):
            continue
        aatype = str_sequence_to_aatype(seqres)
        meta = build_msm_metadata(
            os.path.join(mddir, f"{name}{a.suffix}.npy"), aatype, f"{a.out_dir}/{name}_metadata.pkl"
        )
        if meta is None:
            continue
        msm, cmsm, ref_kmeans = meta["msm"], meta["cmsm"], meta["ref_kmeans"]
        start_state, end_state = pick_flux_states(cmsm, "min")
        ref_discrete = msm.metastable_assignments[ref_kmeans]
        start_idxs = np.where(ref_discrete == start_state)[0]
        end_idxs = np.where(ref_discrete == end_state)[0]
        if not len(start_idxs) or not len(end_idxs):
            print("No start or end state found for", name, "skipping...")
            continue

        arr = np.lib.format.open_memmap(os.path.join(a.data_dir, f"{name}{a.suffix}.npy"), mode="r")
        mask = np.ones(len(aatype), np.float32)
        metadata = []
        for i in range(a.num_batches):
            for j in range(a.batch_size):
                si, ei = int(rng.choice(start_idxs)), int(rng.choice(end_idxs))
                batch = make_endpoint_batch(arr, aatype, mask, si, ei, cfg.data.num_frames,
                                            engine.device)
                atom14, _ = engine.sample(batch, gen)
                idx = i * a.batch_size + j
                path = os.path.join(a.out_dir, f"{name}_{idx}.pdb")
                atom14_to_pdb(atom14[0].cpu().numpy(), aatype, path)
                metadata.append(
                    {"name": name, "start_idx": si, "end_idx": ei,
                     "start_state": start_state, "end_state": end_state, "path": path}
                )
        with open(f"{a.out_dir}/{name}_metadata.json", "w") as f:
            json.dump(metadata, f)
        print(f"{name}: wrote {len(metadata)} transition paths", flush=True)


if __name__ == "__main__":
    main()
