"""MSM metadata for the transition-path CLI: the port's copy of the JAX
package's ``cli/msm_common.py`` (reference src/tps_inference.py:84-118).

The peptide's reference MD, atom14 ``.npy``, is featurized (backbone and
sidechain torsions as cos / sin), projected by TICA, clustered by k-means,
and a Markov state model is fitted and coarse-grained by PCCA+ into
metastable states; the result is pickle-cached beside the outputs.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..analysis import KMeans, MarkovStateModel, TICA, featurize_trajectory


def build_msm_metadata(
    md_npy_path: str, aatype: np.ndarray, out_path: str, tica_lag: int = 1000, msm_lag: int = 1000,
    n_meta: int = 10
) -> dict | None:
    """Returns {msm, cmsm, tica, kmeans, ref_kmeans} (pickle-cached at
    out_path), or None when the MSM fit fails (the reference's behaviour:
    the CLI skips that peptide)."""
    if os.path.exists(out_path):
        with open(out_path, "rb") as f:
            return pickle.load(f)
    ref = np.load(md_npy_path).astype(np.float32)
    _, ref_cs = featurize_trajectory(ref, aatype, sidechains=True, cossin=True)
    tica = TICA(lag=min(tica_lag, len(ref_cs) // 4)).fit(ref_cs)
    ref_tica = tica.transform(ref_cs)
    kmeans = KMeans(k=min(100, max(len(ref_tica) // 20, 2)), seed=137).fit(ref_tica)
    ref_kmeans = kmeans.transform(ref_tica)
    try:
        msm = MarkovStateModel(lag=min(msm_lag, len(ref_kmeans) // 4)).fit(ref_kmeans).pcca(n_meta)
        cmsm = MarkovStateModel(lag=min(msm_lag, len(ref_kmeans) // 4)).fit(
            msm.metastable_assignments[ref_kmeans], n_states=n_meta
        )
    except Exception as e:
        print("MSM ERROR", e, md_npy_path, flush=True)
        return None
    meta = {"msm": msm, "cmsm": cmsm, "tica": tica, "kmeans": kmeans, "ref_kmeans": ref_kmeans}
    with open(out_path, "wb") as f:
        pickle.dump(meta, f)
    return meta


def pick_flux_states(cmsm, mode: str) -> tuple[int, int]:
    """argmin-flux pair for TPS (src/tps_inference.py:110-112) or argmax for
    design (src/design_inference.py:103-105)."""
    flux = cmsm.transition_matrix * cmsm.pi[None, :]
    if mode == "min":
        flux = flux.copy()
        flux[flux < 1e-7] = np.inf
        a, b = np.unravel_index(np.argmin(flux), flux.shape)
    else:
        flux = flux.copy()
        np.fill_diagonal(flux, 0)
        a, b = np.unravel_index(np.argmax(flux), flux.shape)
    # map active-set indices back to metastable labels
    return int(cmsm.active_set[a]), int(cmsm.active_set[b])
