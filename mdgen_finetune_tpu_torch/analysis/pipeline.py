"""The peptide-simulation analysis (reference
src/scripts/analyze_peptide_sim.py:29-206 'main', without the plots):
counterpart of the JAX package's ``analysis/pipeline.py``.

A generated trajectory against a reference MD trajectory (atom14 arrays):
per-torsion and TICA JSDs, decorrelation curves, and the Markov-state
statistics over PCCA+ metastable states (probabilities, transition
matrices, stationary distributions). Host numpy / scipy; the torsions come
from the port's geometry on the CPU.
"""
from __future__ import annotations

import numpy as np

from .cluster import KMeans
from .featurize import featurize_trajectory
from .metrics import acovf, decorrelation, tica_jsd, torsion_jsd
from .msm import MarkovStateModel
from .tica import TICA


def _embed(msm: MarkovStateModel, n: int):
    """An active-set transition matrix and stationary distribution written
    into the full n states (identity rows, zero mass elsewhere)."""
    tmat, pi = np.eye(n), np.zeros(n)
    tmat[np.ix_(msm.active_set, msm.active_set)] = msm.transition_matrix
    pi[msm.active_set] = msm.pi
    return tmat, pi


def analyze_sim(traj_atom14: np.ndarray, ref_atom14: np.ndarray, aatype: np.ndarray, *,
                tica_lag: int = 1000, msm_lag: int = 1000, traj_msm_lag: int = 10,
                n_meta: int = 10, no_decorr: bool = False, no_msm: bool = False,
                seed: int = 137) -> dict:
    """The summary dict: ``features``, ``JSD`` (torsions, phi / psi pairs,
    TICA-0, TICA-0,1), ``md_decorrelation`` / ``our_decorrelation`` (unless
    ``no_decorr``) and, unless ``no_msm``, the metastable probabilities,
    transition matrices and stationary distributions of the reference and
    the generated trajectory; an MSM that cannot be fitted is recorded as
    ``msm_error`` (the reference's per-peptide catch, line 200)."""
    out = {}
    labels, traj = featurize_trajectory(traj_atom14, aatype, sidechains=True, cossin=False)
    _, ref = featurize_trajectory(ref_atom14, aatype, sidechains=True, cossin=False)
    out["features"] = labels
    out["JSD"] = torsion_jsd(ref, traj, labels)
    if not no_decorr:
        out["md_decorrelation"] = decorrelation(ref, labels, nlag=100_000)
        out["our_decorrelation"] = decorrelation(traj, labels, nlag=1000)

    # TICA on the cos / sin features, fitted on the reference MD
    _, traj_cs = featurize_trajectory(traj_atom14, aatype, sidechains=True, cossin=True)
    _, ref_cs = featurize_trajectory(ref_atom14, aatype, sidechains=True, cossin=True)
    tica = TICA(lag=tica_lag).fit(ref_cs)
    ref_tica, traj_tica = tica.transform(ref_cs), tica.transform(traj_cs)
    out["JSD"].update(tica_jsd(ref_tica, traj_tica))
    if not no_decorr:
        out["md_decorrelation"]["tica"] = acovf(ref_tica[:, 0], nlag=100_000).astype(np.float16)
        out["our_decorrelation"]["tica"] = acovf(traj_tica[:, 0], nlag=1000).astype(np.float16)

    if not no_msm:
        try:
            kmeans = KMeans(k=100, max_iter=100, seed=seed).fit(ref_tica)
            ref_kmeans = kmeans.transform(ref_tica)
            msm = MarkovStateModel(lag=msm_lag).fit(ref_kmeans, n_states=100).pcca(n_meta)
            ref_discrete = msm.metastable_assignments[ref_kmeans]
            cmsm = MarkovStateModel(lag=msm_lag).fit(ref_discrete, n_states=n_meta)
            traj_discrete = msm.metastable_assignments[kmeans.transform(traj_tica)]
            states = np.arange(n_meta)[:, None]
            out["traj_metastable_probs"] = (traj_discrete == states).mean(1)
            out["ref_metastable_probs"] = (ref_discrete == states).mean(1)
            out["msm_transition_matrix"], out["msm_pi"] = _embed(cmsm, n_meta)
            out["pcca_pi"] = msm.pi_coarse
            traj_msm = MarkovStateModel(lag=traj_msm_lag).fit(traj_discrete, n_states=n_meta)
            out["traj_transition_matrix"], out["traj_pi"] = _embed(traj_msm, n_meta)
        except Exception as e:  # recorded per peptide, as the reference does (line 200)
            out["msm_error"] = repr(e)
    return out
