"""Design analysis CLI (reference src/scripts/analyze_peptide_design.py):
sequence-recovery statistics over ``design_inference`` outputs, the JAX
package's ``cli/analyze_design.py``. Host only (no card):

    python -m mdgen_finetune_tpu_torch.cli.analyze_design --pdbdir OUT [--pdb_id AGHK]

Prints one line per peptide and a ``MEAN`` line over them.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..analysis import sequence_recovery
from ..geometry.tables import str_sequence_to_aatype


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pdbdir", type=str, required=True, help="design_inference output dir")
    p.add_argument("--pdb_id", nargs="*", default=[])
    a = p.parse_args(argv)

    names = a.pdb_id or sorted(
        {f.split("_metadata")[0] for f in os.listdir(a.pdbdir) if f.endswith("_metadata.json")}
    )
    agg = {}
    for name in names:
        with open(os.path.join(a.pdbdir, f"{name}_metadata.json")) as f:
            entries = json.load(f)
        # aa_out is (frames, L) per sample; the reference reads the first
        # frame (analyze_peptide_design.py:25)
        preds = np.array([np.asarray(e["aa_out"])[0] if np.asarray(e["aa_out"]).ndim > 1
                          else e["aa_out"] for e in entries])
        rec = sequence_recovery(preds, str_sequence_to_aatype(name))
        for k, v in rec.items():
            agg.setdefault(k, []).append(v)
        print(name, {k: round(v, 4) for k, v in rec.items()}, flush=True)
    print("MEAN", {k: round(float(np.mean(v)), 4) for k, v in agg.items()}, flush=True)


if __name__ == "__main__":
    main()
