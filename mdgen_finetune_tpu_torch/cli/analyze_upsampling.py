"""Upsampling analysis CLI (reference src/scripts/analyze_upsampling.py),
the JAX package's ``cli/analyze_upsampling.py``: the torsion
autocovariance of the generated trajectory against the full-rate and the
subsampled MD. Host only (no card):

    python -m mdgen_finetune_tpu_torch.cli.analyze_upsampling --mddir MD --pdbdir OUT \\
        [--suffix _i100] [--pdb_id AAGG] [--subsample 100]

Writes ``{pdbdir}/{name}_autocorr.pkl`` per peptide.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..analysis import analyze_upsampling
from ..geometry.tables import str_sequence_to_aatype
from .analyze_sim import load_traj_atom14


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mddir", type=str, required=True, help="reference MD .npy dir")
    p.add_argument("--pdbdir", type=str, required=True)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--subsample", type=int, default=100)
    a = p.parse_args(argv)

    names = a.pdb_id or [f.split(".")[0] for f in os.listdir(a.pdbdir) if f.endswith(".pdb")]
    results = {}
    for name in names:
        aatype = str_sequence_to_aatype(name)
        ref = np.load(os.path.join(a.mddir, f"{name}{a.suffix}.npy")).astype(np.float32)
        traj = load_traj_atom14(os.path.join(a.pdbdir, f"{name}.pdb"), aatype)
        out = results[name] = analyze_upsampling(traj, ref, aatype, subsample=a.subsample)
        with open(os.path.join(a.pdbdir, f"{name}_autocorr.pkl"), "wb") as f:
            pickle.dump(out, f)
        print(name, "features:", len(out["md_autocorr"]), flush=True)
    return results


if __name__ == "__main__":
    main()
