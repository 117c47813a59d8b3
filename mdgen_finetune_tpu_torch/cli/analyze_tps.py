"""Transition-path ensemble analysis CLI (reference
src/scripts/analyze_peptide_tps.py), the JAX package's
``cli/analyze_tps.py``. Host only (no card):

    python -m mdgen_finetune_tpu_torch.cli.analyze_tps --pdbdir TPS_OUT --outdir OUT \\
        [--repdir REPLICA_MD] [--msm_lag 1000] [--pdb_id AGHK] [--save]

Scores the ensembles ``tps_inference`` wrote (``{name}_metadata.json`` /
``.pkl`` and the path PDBs) against bridge samples of the peptide's MSM:
mean path probability, validity rate, state-visitation JSD. With
``--repdir`` also the replica-baseline sweep (analyze_peptide_tps.py:
86-135): paths from MSMs of an independent replica MD cut to shrinking
budgets. One pickle per peptide in ``--outdir``.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..analysis import analyze_tps_ensemble, analyze_tps_replica_sweep
from ..geometry.tables import str_sequence_to_aatype
from .analyze_sim import load_traj_atom14


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pdbdir", type=str, required=True, help="tps_inference output dir")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--repdir", type=str, default=None,
                   help="replica MD dir ({name}.npy atom14 trajectories); enables the "
                        "replica-baseline sweep (reference --repdir, share/4AA_sims_replica)")
    p.add_argument("--msm_lag", type=int, default=1000,
                   help="replica MSM lag (reference lag=1000; clipped to len/4 for short "
                        "replicas)")
    p.add_argument("--pdb_id", nargs="*", default=[])
    p.add_argument("--save", action="store_true")
    p.add_argument("--save_name", type=str, default="out.pkl")
    a = p.parse_args(argv)
    os.makedirs(a.outdir, exist_ok=True)

    names = a.pdb_id or sorted({f.split("_")[0] for f in os.listdir(a.pdbdir)
                                if f.endswith(".pdb")})
    results = {}
    for name in names:
        meta_pkl = os.path.join(a.pdbdir, f"{name}_metadata.pkl")
        meta_json = os.path.join(a.pdbdir, f"{name}_metadata.json")
        if not (os.path.exists(meta_pkl) and os.path.exists(meta_json)):
            continue
        with open(meta_pkl, "rb") as f:
            meta = pickle.load(f)
        with open(meta_json) as f:
            entries = json.load(f)
        aatype = str_sequence_to_aatype(name)
        trajs = [load_traj_atom14(e["path"], aatype) for e in entries]
        start, end = entries[0]["start_state"], entries[0]["end_state"]
        out = analyze_tps_ensemble(trajs, aatype, meta, start, end)
        if a.repdir is not None:
            rep_path = os.path.join(a.repdir, f"{name}.npy")
            if os.path.exists(rep_path):
                rep = np.load(rep_path).astype(np.float32)
                out.update(analyze_tps_replica_sweep(rep, aatype, meta, start, end,
                                                     out["ref_stateprobs"], msm_lag=a.msm_lag))
        results[name] = out
        print(name, {k: round(float(v), 4) for k, v in out.items() if np.ndim(v) == 0},
              flush=True)
        with open(os.path.join(a.outdir, f"{name}.pkl"), "wb") as f:
            pickle.dump(out, f)
    if a.save:
        with open(os.path.join(a.outdir, a.save_name), "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
