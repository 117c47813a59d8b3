"""Synthetic dataset CLI: format-identical training data without OpenMM.

Counterpart of the JAX package's ``cli/synth_data.py``:

    python -m mdgen_finetune_tpu_torch.cli.synth_data --outdir DIR --peptides AAGG \\
        --num_frames 1100 --suffix _i100
"""
from __future__ import annotations

import argparse

from ..data.synthetic import make_synthetic_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--peptides", nargs="+", required=True)
    p.add_argument("--num_frames", type=int, default=5000)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    csv_path = make_synthetic_dataset(a.outdir, a.peptides, a.num_frames, a.suffix, a.seed)
    print(f"wrote {csv_path}")


if __name__ == "__main__":
    main()
