"""Task metrics: transition-path validity, upsampling autocorrelation
recovery, design sequence recovery.

Counterpart of the JAX package's ``analysis/task_metrics.py`` (reference
src/scripts/analyze_peptide_tps.py:63-135, analyze_upsampling.py:15-36,
analyze_peptide_design.py:33-96; the plots omitted, pyemma replaced by the
port's analysis stack). Host numpy / scipy.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial.distance import jensenshannon

from .featurize import featurize_trajectory
from .metrics import acovf
from .msm import MarkovStateModel, get_state_probs, get_tp_likelihood, sample_tp


def _to_active(cmsm):
    """A state -> its position in ``cmsm``'s active set; a state outside it
    maps to the most probable state's position (analyze_peptide_tps.py)."""
    pos = {int(v): i for i, v in enumerate(cmsm.active_set)}
    highest = pos[int(cmsm.active_set[np.argmax(cmsm.pi)])]
    return pos, np.vectorize(lambda s: pos.get(int(s), highest))


def _path_scores(tp: np.ndarray, to_active, trans: np.ndarray) -> tuple:
    """(mean path probability, mean over the valid paths, valid share) of
    paths ``tp`` under the coarse MSM's ``trans``."""
    prob = get_tp_likelihood(to_active(tp), trans).prod(-1)
    valid = prob > 0
    return float(prob.mean()), float(prob[valid].mean()) if valid.any() else 0.0, \
        float(valid.mean())


def analyze_tps_ensemble(gen_trajs_atom14: list, aatype: np.ndarray, meta: dict,
                         start_state: int, end_state: int, stride: int = 10,
                         n_ref_samples: int = 1000, seed: int = 137) -> dict:
    """The validity rate, mean path probability and state-visitation JSD of
    a generated transition-path ensemble against bridge samples of the
    coarse MSM (src/scripts/analyze_peptide_tps.py:63-84). ``meta``: {msm,
    cmsm, tica, kmeans} of ``cli.msm_common.build_msm_metadata``."""
    msm, cmsm, tica, kmeans = meta["msm"], meta["cmsm"], meta["tica"], meta["kmeans"]
    rng = np.random.default_rng(seed)
    pos, to_active = _to_active(cmsm)
    ref_tp = sample_tp(cmsm.transition_matrix, pos[start_state], pos[end_state], traj_len=11,
                       n_samples=n_ref_samples, rng=rng)
    ref_stateprobs = get_state_probs(cmsm.active_set[ref_tp])

    feats = [featurize_trajectory(t, aatype, sidechains=True, cossin=True)[1]
             for t in gen_trajs_atom14]
    gen_discrete = msm.metastable_assignments[
        kmeans.transform(tica.transform(np.concatenate(feats, axis=0)))]
    gen_all = gen_discrete.reshape(len(gen_trajs_atom14), -1)
    gen_tp = np.concatenate([gen_all[:, ::stride], gen_all[:, -1:]], axis=1)
    gen_stateprobs = get_state_probs(gen_tp)
    prob, valid_prob, valid_rate = _path_scores(gen_tp, to_active, cmsm.transition_matrix)
    return {"gen_prob": prob, "gen_valid_prob": valid_prob, "gen_valid_rate": valid_rate,
            "gen_JSD": float(jensenshannon(ref_stateprobs, gen_stateprobs)),
            "ref_stateprobs": ref_stateprobs, "gen_stateprobs": gen_stateprobs}


def analyze_tps_replica_sweep(rep_atom14: np.ndarray, aatype: np.ndarray, meta: dict,
                              start_state: int, end_state: int, ref_stateprobs: np.ndarray,
                              rep_fracs: tuple = (1.0, 0.5, 0.3, 0.2, 0.1, 0.05, 0.02),
                              rep_names: tuple = ("100ns", "50ns", "30ns", "20ns", "10ns", "5ns",
                                                  "2ns"),
                              msm_lag: int = 1000, traj_len: int = 11, n_samples: int = 1000,
                              seed: int = 137) -> dict:
    """The replica-baseline sweep (src/scripts/analyze_peptide_tps.py:
    86-135): transition paths bridge-sampled from MSMs estimated on an
    independent replica MD cut to shrinking budgets, scored as generated
    ensembles are. Each budget: the replica's first ``frac`` of frames
    (at least 8) through the reference's TICA / k-means / metastable map, an
    MSM at lag min(``msm_lag``, frames / 4), ``n_samples`` bridges between
    the endpoint states. A budget whose MSM lacks an endpoint, or cannot be
    fitted, scores 0 (probability and validity) and JSD 1, the reference's
    branch (:101-110). The reference's absolute frame counts (999,999 ...
    20,000 of a 100 ns replica) are fractions here."""
    msm, cmsm, tica, kmeans = meta["msm"], meta["cmsm"], meta["tica"], meta["kmeans"]
    rng = np.random.default_rng(seed)
    _, rep_cs = featurize_trajectory(rep_atom14, aatype, sidechains=True, cossin=True)
    _, to_active = _to_active(cmsm)
    out = {}
    for frac, nm in zip(rep_fracs, rep_names):
        n = max(int(round(len(rep_cs) * frac)), 8)
        zero = {f"{nm}_rep_prob": 0.0, f"{nm}_rep_valid_prob": 0.0,
                f"{nm}_rep_valid_rate": 0.0, f"{nm}_rep_JSD": 1.0}
        try:
            rep_discrete = msm.metastable_assignments[kmeans.transform(tica.transform(rep_cs[:n]))]
            rep_msm = MarkovStateModel(lag=min(msm_lag, n // 4)).fit(
                rep_discrete, n_states=len(ref_stateprobs))
        except (ValueError, np.linalg.LinAlgError):
            out.update(zero)
            continue
        rep_pos = {int(v): i for i, v in enumerate(rep_msm.active_set)}
        if start_state not in rep_pos or end_state not in rep_pos:
            out.update(zero)
            continue
        rep_tp = rep_msm.active_set[sample_tp(rep_msm.transition_matrix, rep_pos[start_state],
                                              rep_pos[end_state], traj_len=traj_len,
                                              n_samples=n_samples, rng=rng)]
        prob, valid_prob, valid_rate = _path_scores(rep_tp, to_active, cmsm.transition_matrix)
        rep_stateprobs = get_state_probs(rep_tp, num_states=len(ref_stateprobs))
        out.update({f"{nm}_rep_prob": prob, f"{nm}_rep_valid_prob": valid_prob,
                    f"{nm}_rep_valid_rate": valid_rate,
                    f"{nm}_rep_JSD": float(jensenshannon(ref_stateprobs, rep_stateprobs))})
    return out


def analyze_upsampling(traj_atom14: np.ndarray, ref_atom14: np.ndarray, aatype: np.ndarray,
                       subsample: int = 100) -> dict:
    """The sin + cos torsion autocovariance of the generated trajectory, of
    the full-rate MD and of the MD subsampled by ``subsample``
    (src/scripts/analyze_upsampling.py:15-27), each to its full length."""
    labels, ref = featurize_trajectory(ref_atom14, aatype, sidechains=True, cossin=False)
    _, traj = featurize_trajectory(traj_atom14, aatype, sidechains=True, cossin=False)
    sub = ref[::subsample]

    def ac(f, i):
        return acovf(np.sin(f[:, i]), nlag=len(f) - 1) + acovf(np.cos(f[:, i]), nlag=len(f) - 1)

    return {"md_autocorr": {lab: ac(ref, i) for i, lab in enumerate(labels)},
            "our_autocorr": {lab: ac(traj, i) for i, lab in enumerate(labels)},
            "subsample_autocorr": {lab: ac(sub, i) for i, lab in enumerate(labels)}}


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
