"""Physics-fidelity metrics: torsion JSD, decorrelation curves.

Counterpart of the JAX package's ``analysis/metrics.py`` (reference
src/scripts/analyze_peptide_sim.py:44-151, without statsmodels / pyemma):
Jensen-Shannon distances of the torsion marginals (100 bins over [-pi, pi])
and of the phi / psi pairs (50 x 50), and autocovariance-based decorrelation
of the sin / cos torsion observables and of the TICA components. Host
numpy / scipy in f64.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.distance import jensenshannon


def acovf(x: np.ndarray, nlag: int, adjusted: bool = True, demean: bool = False) -> np.ndarray:
    """Autocovariance by FFT (``statsmodels.tsa.stattools.acovf`` for the
    flags the reference uses); lags 0..min(nlag, n - 1)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    nlag = min(nlag, n - 1)
    if demean:
        x = x - x.mean()
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conjugate(f), nfft)[: nlag + 1].real
    return acov / (n - np.arange(nlag + 1)) if adjusted else acov / n


def torsion_jsd(ref_feats: np.ndarray, traj_feats: np.ndarray, labels: list[str]) -> dict:
    """Per-torsion JSD (100 bins) and the phi / psi pair JSDs (50 x 50) of
    features 1-2 and 3-4 (src/scripts/analyze_peptide_sim.py:51-60)."""
    out = {}
    for i, lab in enumerate(labels):
        ref_p = np.histogram(ref_feats[:, i], range=(-np.pi, np.pi), bins=100)[0]
        traj_p = np.histogram(traj_feats[:, i], range=(-np.pi, np.pi), bins=100)[0]
        out[lab] = float(jensenshannon(ref_p, traj_p))
    box = ((-np.pi, np.pi), (-np.pi, np.pi))
    for i in (1, 3):
        if i + 1 >= len(labels):
            continue
        ref_p = np.histogram2d(ref_feats[:, i], ref_feats[:, i + 1], range=box, bins=50)[0]
        traj_p = np.histogram2d(traj_feats[:, i], traj_feats[:, i + 1], range=box, bins=50)[0]
        out["|".join(labels[i: i + 2])] = float(jensenshannon(ref_p.flatten(), traj_p.flatten()))
    return out


def decorrelation(feats: np.ndarray, labels: list[str], nlag: int) -> dict:
    """The normalized sin + cos autocovariance decay of each torsion
    (src/scripts/analyze_peptide_sim.py:66-97), f16 as the reference keeps it."""
    out = {}
    for i, lab in enumerate(labels):
        ac = acovf(np.sin(feats[:, i]), nlag=nlag) + acovf(np.cos(feats[:, i]), nlag=nlag)
        baseline = np.sin(feats[:, i]).mean() ** 2 + np.cos(feats[:, i]).mean() ** 2
        out[lab] = ((ac - baseline) / (1 - baseline)).astype(np.float16)
    return out


def tica_jsd(ref_tica: np.ndarray, traj_tica: np.ndarray) -> dict:
    """The TICA-0 (100 bins) and TICA-0,1 (50 x 50) JSDs over the two
    trajectories' joint range (src/scripts/analyze_peptide_sim.py:113-125)."""
    lo0 = min(ref_tica[:, 0].min(), traj_tica[:, 0].min())
    hi0 = max(ref_tica[:, 0].max(), traj_tica[:, 0].max())
    lo1 = min(ref_tica[:, 1].min(), traj_tica[:, 1].min())
    hi1 = max(ref_tica[:, 1].max(), traj_tica[:, 1].max())
    ref_p = np.histogram(ref_tica[:, 0], range=(lo0, hi0), bins=100)[0]
    traj_p = np.histogram(traj_tica[:, 0], range=(lo0, hi0), bins=100)[0]
    out = {"TICA-0": float(jensenshannon(ref_p, traj_p))}
    box = ((lo0, hi0), (lo1, hi1))
    ref_p2 = np.histogram2d(*ref_tica[:, :2].T, range=box, bins=50)[0]
    traj_p2 = np.histogram2d(*traj_tica[:, :2].T, range=box, bins=50)[0]
    out["TICA-0,1"] = float(jensenshannon(ref_p2.flatten(), traj_p2.flatten()))
    return out
