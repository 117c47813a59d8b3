"""Markov state models: reversible MLE, PCCA+ coarse-graining, TP sampling;
the numpy / scipy copy of the JAX package's ``analysis/msm.py``.

Replaces pyemma.msm.estimate_markov_model + msm.pcca (reference
src/mdgen/analysis.py:40-48) and ports the transition-path utilities
(analysis.py:61-100):

- count matrix at lag (sliding window) restricted to the largest strongly
  connected set ("active set");
- reversible maximum-likelihood transition matrix via the standard
  self-consistent iteration (Prinz et al. 2011, eq. 27);
- PCCA+ metastable decomposition via the inner-simplex vertex search on the
  dominant right eigenvectors;
- committor-guided transition-path sampling and path likelihoods.
"""
from __future__ import annotations

import numpy as np


def count_matrix(dtraj: np.ndarray, lag: int, n_states: int) -> np.ndarray:
    C = np.zeros((n_states, n_states))
    np.add.at(C, (dtraj[:-lag], dtraj[lag:]), 1.0)
    return C


def largest_connected_set(C: np.ndarray) -> np.ndarray:
    """Largest strongly-connected component of the count graph (Tarjan via
    scipy)."""
    from scipy.sparse.csgraph import connected_components
    from scipy.sparse import csr_matrix

    n, labels = connected_components(csr_matrix(C > 0), directed=True, connection="strong")
    sizes = np.bincount(labels, weights=C.sum(1) + C.sum(0))
    return np.where(labels == np.argmax(sizes))[0]


def reversible_mle(C: np.ndarray, tol: float = 1e-10, max_iter: int = 10_000) -> tuple[np.ndarray, np.ndarray]:
    """Reversible MLE transition matrix + stationary distribution."""
    C = np.asarray(C, dtype=np.float64)
    c_i = C.sum(1)
    X = 0.5 * (C + C.T)
    X = X / X.sum()
    for _ in range(max_iter):
        x_i = X.sum(1)
        denom = c_i[:, None] / np.maximum(x_i[:, None], 1e-300) + c_i[None, :] / np.maximum(x_i[None, :], 1e-300)
        X_new = np.where(C + C.T > 0, (C + C.T) / np.maximum(denom, 1e-300), 0.0)
        X_new = X_new / X_new.sum()
        if np.abs(X_new - X).max() < tol:
            X = X_new
            break
        X = X_new
    pi = X.sum(1)
    T = X / np.maximum(pi[:, None], 1e-300)
    T = T / T.sum(1, keepdims=True)
    return T, pi


def pcca_plus(T: np.ndarray, pi: np.ndarray, n_meta: int) -> np.ndarray:
    """PCCA+ memberships (n_states, n_meta) via the inner-simplex algorithm."""
    # right eigenvectors of T, sorted by eigenvalue (real spectrum for reversible T)
    # symmetrize in the pi-weighted inner product for numerical stability
    sqrt_pi = np.sqrt(np.maximum(pi, 1e-300))
    S = (T * sqrt_pi[:, None]) / sqrt_pi[None, :]
    S = 0.5 * (S + S.T)
    evals, evecs = np.linalg.eigh(S)
    order = np.argsort(evals)[::-1][:n_meta]
    X = evecs[:, order] / sqrt_pi[:, None]
    X = X / X[:, 0:1][np.argmax(np.abs(X[:, 0]))]  # first column ~ constant

    # inner simplex: greedily pick the most exterior rows as vertices
    n = X.shape[0]
    verts = [int(np.argmax(np.linalg.norm(X - X.mean(0), axis=1)))]
    for _ in range(1, n_meta):
        # distance to affine span of chosen vertices
        V = X[verts]
        d = np.zeros(n)
        A = (V[1:] - V[0]).T if len(verts) > 1 else np.zeros((X.shape[1], 0))
        for i in range(n):
            r = X[i] - V[0]
            if A.shape[1]:
                coef, *_ = np.linalg.lstsq(A, r, rcond=None)
                r = r - A @ coef
            d[i] = np.linalg.norm(r)
        verts.append(int(np.argmax(d)))

    V = X[verts]  # (n_meta, n_meta)
    try:
        A = np.linalg.inv(V)
    except np.linalg.LinAlgError:
        A = np.linalg.pinv(V)
    chi = X @ A
    # feasibility: clip and renormalize rows
    chi = np.clip(chi, 0.0, None)
    chi = chi / np.maximum(chi.sum(1, keepdims=True), 1e-300)
    return chi


class MarkovStateModel:
    """Estimated on a discrete trajectory; mirrors the pyemma attributes the
    reference touches: transition_matrix, pi, active_set, metastable
    assignments, coarse MSM (src/scripts/analyze_peptide_sim.py:153-198)."""

    def __init__(self, lag: int = 1000, reversible: bool = True):
        self.lag = lag
        self.reversible = reversible

    def fit(self, dtraj: np.ndarray, n_states: int | None = None) -> "MarkovStateModel":
        dtraj = np.asarray(dtraj, dtype=np.int64)
        n = n_states or int(dtraj.max()) + 1
        lag = min(self.lag, max(len(dtraj) // 2, 1))
        C = count_matrix(dtraj, lag, n)
        self.active_set = largest_connected_set(C)
        Ca = C[np.ix_(self.active_set, self.active_set)]
        if self.reversible:
            self.transition_matrix, self.pi = reversible_mle(Ca)
        else:
            self.transition_matrix = Ca / np.maximum(Ca.sum(1, keepdims=True), 1e-300)
            evals, evecs = np.linalg.eig(self.transition_matrix.T)
            i = np.argmin(np.abs(evals - 1))
            pi = np.real(evecs[:, i])
            self.pi = pi / pi.sum()
        self.n_states_full = n
        return self

    def pcca(self, n_meta: int) -> "MarkovStateModel":
        self.memberships = pcca_plus(self.transition_matrix, self.pi, n_meta)
        active_assign = np.argmax(self.memberships, axis=1)
        # full-state assignment: inactive states -> nearest active metastable set
        self.metastable_assignments = np.zeros(self.n_states_full, dtype=np.int64)
        self.metastable_assignments[self.active_set] = active_assign
        self.pi_coarse = self.memberships.T @ self.pi
        self.n_meta = n_meta
        return self


def sample_tp(trans: np.ndarray, start_state: int, end_state: int, traj_len: int, n_samples: int, rng=None):
    """Bridge sampling of transition paths through an MSM
    (src/mdgen/analysis.py:61-76)."""
    rng = rng or np.random.default_rng()
    N = traj_len
    s_t = np.full(n_samples, start_state, dtype=int)
    states = [s_t]
    for t in range(1, N - 1):
        numerator = np.linalg.matrix_power(trans, N - t - 1)[:, end_state] * trans[s_t, :]
        denom = np.linalg.matrix_power(trans, N - t)[s_t, end_state][:, None]
        probs = numerator / np.maximum(denom, 1e-300)
        probs = probs / probs.sum(1, keepdims=True)
        s_t = np.array([rng.choice(len(trans), p=p) for p in probs])
        states.append(s_t)
    states.append(np.full(n_samples, end_state, dtype=int))
    return np.stack(states, axis=1)


def get_tp_likelihood(tp: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Per-step bridge probabilities of given paths (src/mdgen/analysis.py:79-95)."""
    N, n_samples = tp.shape[1], tp.shape[0]
    s_N = tp[0, -1]
    out = []
    for i in range(N - 1):
        t = i + 1
        s_t = tp[:, i]
        numerator = np.linalg.matrix_power(trans, N - t - 1)[:, s_N] * trans[s_t, :]
        denom = np.linalg.matrix_power(trans, N - t)[s_t, s_N][:, None]
        probs = numerator / np.maximum(denom, 1e-300)
        out.append(probs[np.arange(n_samples), tp[:, i + 1]])
    probs = np.stack(out, axis=1)
    probs[np.isnan(probs)] = 0
    return probs


def get_state_probs(tp: np.ndarray, num_states: int = 10) -> np.ndarray:
    stationary = np.bincount(tp.reshape(-1), minlength=num_states)
    return stationary / stationary.sum()
