"""Multi-peptide conditional RTB fine-tuning CLI
(reference src/outsourced_train_conditional_posterior.py).

Counterpart of the JAX package's ``cli/train_conditional_posterior.py``: one
posterior is trained across peptides. Every batch mixes distinct peptides of
the split, each element's reward is scored with its own sequence, and
VarGrad estimates one logZ per peptide (src/rtb_utils/gfn_diffusion.py:
438-456). It runs ``train_posterior`` with ``--vargrad`` forced on and
``--peptides_per_batch`` defaulted to the largest divisor of the batch size
that the split holds. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import csv
import os
import sys

from .train_posterior import main as _main


def _split_size(argv) -> int:
    try:
        split = argv[argv.index("--split") + 1]
    except (ValueError, IndexError):
        return 1
    if not os.path.exists(split):
        return 1
    with open(split) as f:
        return max(1, sum(1 for _ in csv.DictReader(f)))


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    if "--vargrad" not in argv:
        argv.append("--vargrad")
    if "--peptides_per_batch" not in argv:
        try:
            bs = int(argv[argv.index("--batch_size") + 1])
        except (ValueError, IndexError):
            bs = 4
        n = _split_size(argv)
        ppb = max(d for d in range(1, min(bs, n) + 1) if bs % d == 0)
        argv += ["--peptides_per_batch", str(ppb)]
    return _main(argv)


if __name__ == "__main__":
    main()
