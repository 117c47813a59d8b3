"""Trajectory preprocessing CLI (reference src/scripts/prep_sims.py).

Counterpart of the JAX package's ``cli/prep_sims.py``: converts raw MD
output (.xtc/.pdb through mdtraj, when installed) into strided, superposed
float16 atom14 memmaps, the training format (x10 nm -> Angstroms as the
reference, prep_sims.py:54-62). An entry whose ``{name}{suffix}.npy``
already exists in ``--outdir`` is reported as "exists"; without mdtraj
the others are reported as skipped, as in JAX.

    python -m mdgen_finetune_tpu_torch.cli.prep_sims --splits splits/4AA.csv \\
        --sim_dir sims/ --outdir data/4AA_data --suffix _i100 --stride 100
"""
from __future__ import annotations

import argparse
import csv
import os
from multiprocessing import Pool

import numpy as np


def prep_one(task):
    """(name, seqres, args) -> (name, status)."""
    name, seqres, args = task
    out_path = os.path.join(args.outdir, f"{name}{args.suffix}.npy")
    if os.path.exists(out_path):
        return name, "exists"
    try:
        import mdtraj
    except ImportError:
        return name, "skipped (mdtraj not installed; provide .npy inputs instead)"

    from ..geometry import tables as rc
    from ..geometry.tables import restype_1to3, str_sequence_to_aatype

    xtc = os.path.join(args.sim_dir, name, f"{name}.xtc")
    pdb = os.path.join(args.sim_dir, name, f"{name}.pdb")
    traj = mdtraj.load(xtc, top=pdb)
    traj.superpose(traj)
    if args.stride > 1:
        traj = traj[:: args.stride]
    L = len(str_sequence_to_aatype(seqres))
    atom14 = np.zeros((traj.n_frames, L, 14, 3), dtype=np.float32)
    for atom in traj.topology.atoms:
        ri = atom.residue.index
        if ri >= L:
            continue
        names14 = rc.restype_name_to_atom14_names[restype_1to3[seqres[ri]]]
        if atom.name in names14:
            atom14[:, ri, names14.index(atom.name)] = traj.xyz[:, atom.index] * 10.0  # nm -> A
    np.save(out_path, atom14.astype(np.float16))
    return name, f"wrote {atom14.shape}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--splits", type=str, required=True)
    p.add_argument("--sim_dir", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=1)
    args = p.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    with open(args.splits) as f:
        rows = list(csv.DictReader(f))
    tasks = [(r["name"], r["seqres"], args) for r in rows]
    if args.num_workers > 1:
        with Pool(args.num_workers) as pool:
            results = list(pool.imap(prep_one, tasks))
    else:
        results = map(prep_one, tasks)
    for name, status in results:
        print(name, status, flush=True)


if __name__ == "__main__":
    main()
