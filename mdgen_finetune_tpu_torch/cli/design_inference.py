"""Inpainting / sequence-design CLI (reference src/design_inference.py).

Counterpart of the JAX package's ``cli/design_inference.py``: for each
peptide of the split it fits the MSM of the reference MD (``msm_common``),
takes the pair of metastable states with the largest flux, and draws, from
``np.random.default_rng(seed)`` as the JAX CLI does, windows of the
trajectory (every ``frame_interval``-th frame) that start in the first
state and end ``num_frames`` frames later in the second (any window with
``--random_start_idx``). Each window conditions the model on residues 0 and
3 in every frame; the sampler inpaints the others' coordinates and, under
``design``, designs residues 1 and 2. Writes one PDB per sample and
``{name}_metadata.json`` with the designed sequences (``aa_out``, frames x
residues). Runs on the card unless ``--device cpu`` is given:

    python -m mdgen_finetune_tpu_torch.cli.design_inference --torch_ckpt CKPT.ckpt \\
        --data_dir DIR --split DIR/split.csv --out_dir OUT --suffix _i100 \\
        --num_batches 100 --batch_size 10 [--device cpu]

(``--sim_ckpt`` takes a ``Trainer`` checkpoint instead of a released
``.ckpt``.) ``cli/analyze_design.py`` reads the output.
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


def window_starts(ref_discrete, start_state, end_state, num_frames, n_frames, random_start):
    """The frames a window may start at (src/design_inference.py:107-118):
    any with ``random_start``, else those in ``start_state`` whose frame
    ``num_frames`` later is in ``end_state``."""
    if random_start:
        return np.arange(max(n_frames - num_frames, 1))
    is_start = ref_discrete == start_state
    is_end = ref_discrete == end_state
    return np.where(is_start[:-num_frames] * is_end[num_frames:])[0]


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
    p.add_argument("--num_frames", type=int, default=100)
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--random_start_idx", action="store_true")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--chunk_idx", type=int, default=0)
    p.add_argument("--n_chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=137)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    a = p.parse_args(argv)

    cfg, params = load_params(a)
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
        aatype = str_sequence_to_aatype(seqres)
        meta = build_msm_metadata(
            os.path.join(mddir, f"{name}{a.suffix}.npy"), aatype, f"{a.out_dir}/{name}_metadata.pkl"
        )
        if meta is None:
            continue
        msm, cmsm, ref_kmeans = meta["msm"], meta["cmsm"], meta["ref_kmeans"]
        start_state, end_state = pick_flux_states(cmsm, "max")
        ref_discrete = msm.metastable_assignments[ref_kmeans]

        arr = np.lib.format.open_memmap(os.path.join(a.data_dir, f"{name}{a.suffix}.npy"), mode="r")
        if cfg.data.frame_interval:
            arr = arr[:: cfg.data.frame_interval]
            ref_discrete = ref_discrete[:: cfg.data.frame_interval]
        ref_discrete = ref_discrete[: len(arr)]
        start_idxs = window_starts(ref_discrete, start_state, end_state, a.num_frames, len(arr),
                                   a.random_start_idx)
        if not len(start_idxs):
            print("No transition path found for", name, "skipping...")
            continue

        mask = torch.ones(1, len(aatype), device=engine.device)
        seq = torch.as_tensor(aatype, device=engine.device).long()[None]
        metadata = []
        for i in range(a.num_batches):
            for j in range(a.batch_size):
                si = int(rng.choice(start_idxs))
                window = np.asarray(arr[si: si + a.num_frames], dtype=np.float32)
                batch = featurize_atom14_batch(torch.as_tensor(window[None], device=engine.device),
                                               seq, mask)
                atom14, aa_out = engine.sample(batch, gen)
                idx = i * a.batch_size + j
                path = os.path.join(a.out_dir, f"{name}_{idx}.pdb")
                atom14_to_pdb(atom14[0].cpu().numpy(), aatype, path)
                metadata.append(
                    {"name": name, "start_idx": si, "end_idx": si + a.num_frames,
                     "start_state": start_state, "end_state": end_state,
                     "aa_out": aa_out[0].cpu().numpy().tolist(), "path": path}
                )
        with open(f"{a.out_dir}/{name}_metadata.json", "w") as f:
            json.dump(metadata, f)
        print(f"{name}: wrote {len(metadata)} design samples", flush=True)


if __name__ == "__main__":
    main()
