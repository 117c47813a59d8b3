"""Task metrics: the port's copy of ``sequence_recovery`` from the JAX
package's ``analysis/task_metrics.py`` (:160-184; reference
src/scripts/analyze_peptide_design.py:33-96). The other task metrics (TPS
and upsampling statistics) are not ported yet (ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import numpy as np


def sequence_recovery(pred_seqs: np.ndarray, true_seq: np.ndarray) -> dict:
    """Design recovery rates: per-sample recovery of the designed residues
    (1..L-2) and of the conditioning ends, the recovery of each position's
    most frequent residue, and of the most frequent designed middle.
    pred_seqs (N, L) int; true_seq (L,) int."""
    pred = np.asarray(pred_seqs)
    true = np.asarray(true_seq)
    rec = pred == true[None, :]
    out = {
        "design_recovery": float(rec[:, 1:-1].mean()),
        "cond_recovery": float(np.concatenate([rec[:, -1], rec[:, 0]]).mean()),
    }
    max_aa = []
    for i in range(pred.shape[1]):
        vals, counts = np.unique(pred[:, i], return_counts=True)
        max_aa.append(vals[np.argmax(counts)])
    max_aa = np.array(max_aa)
    out["max_design_recovery"] = float((true[1:-1] == max_aa[1:-1]).mean())
    out["max_cond_recovery"] = float(((true[0] == max_aa[0]) + (true[-1] == max_aa[-1])) / 2)

    middles = ["".join(map(str, p[1:-1])) for p in pred]
    vals, idx, counts = np.unique(middles, return_index=True, return_counts=True)
    most_freq = pred[idx[np.argmax(counts)]]
    out["most_frequent_middle_recovery"] = float((most_freq == true)[1:-1].mean())
    return out
