"""Peptide-simulation analysis CLI (reference
src/scripts/analyze_peptide_sim.py), the JAX package's
``cli/analyze_sim.py``. Host only (numpy / scipy and the port's geometry on
the CPU; no card):

    python -m mdgen_finetune_tpu_torch.cli.analyze_sim --mddir MD --pdbdir OUT \\
        [--suffix _i100] [--pdb_id AAGG] [--save] [--no_msm] [--no_decorr]

Compares the generated trajectories (the multi-MODEL ``{name}.pdb`` that
``sim_inference`` writes, or atom14 ``.npy``) with the reference MD
(``{mddir}/{name}{suffix}.npy`` atom14), prints the first JSDs of each
peptide and with ``--save`` pickles the metric dicts to ``--save_name``.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..analysis import analyze_sim
from ..geometry import frames as G
from ..geometry.protein import from_pdb_string
from ..geometry.tables import str_sequence_to_aatype


def load_traj_atom14(path: str, aatype: np.ndarray) -> np.ndarray:
    """A trajectory as atom14 (T, L, 14, 3) f32: an ``.npy`` as it is, a
    multi-MODEL PDB parsed model by model and mapped atom37 -> atom14."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    with open(path) as f:
        models = f.read().split("ENDMDL")
    atom37 = np.stack([from_pdb_string(m).atom_positions for m in models if "ATOM" in m])
    T, L = atom37.shape[:2]
    aat = torch.as_tensor(np.asarray(aatype), dtype=torch.int64).expand(T, L)
    return G.atom37_to_atom14(torch.from_numpy(atom37).float(), aat).numpy()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mddir", type=str, required=True, help="dir of reference MD .npy files")
    p.add_argument("--pdbdir", type=str, required=True, help="dir of generated trajectories")
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_name", type=str, default="out.pkl")
    p.add_argument("--no_msm", action="store_true")
    p.add_argument("--no_decorr", action="store_true")
    p.add_argument("--truncate", type=int, default=None)
    p.add_argument("--msm_lag", type=int, default=10)
    p.add_argument("--tica_lag", type=int, default=1000)
    a = p.parse_args(argv)

    names = a.pdb_id or [f.split(".")[0] for f in os.listdir(a.pdbdir)
                         if f.endswith(".pdb") and "_traj" not in f]
    out = {}
    for name in names:
        aatype = str_sequence_to_aatype(name)
        ref = np.load(os.path.join(a.mddir, f"{name}{a.suffix}.npy")).astype(np.float32)
        traj = load_traj_atom14(os.path.join(a.pdbdir, f"{name}.pdb"), aatype)
        if a.truncate:
            traj = traj[: a.truncate]
        out[name] = analyze_sim(traj, ref, aatype, tica_lag=a.tica_lag, traj_msm_lag=a.msm_lag,
                                no_msm=a.no_msm, no_decorr=a.no_decorr)
        jsd = out[name]["JSD"]
        print(name, {k: round(v, 4) for k, v in list(jsd.items())[:6]}, flush=True)
    if a.save:
        with open(os.path.join(a.pdbdir, a.save_name), "wb") as f:
            pickle.dump(out, f)
    return out


if __name__ == "__main__":
    main()
