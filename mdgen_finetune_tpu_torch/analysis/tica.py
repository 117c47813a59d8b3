"""Time-lagged independent component analysis (kinetic-map TICA), the numpy
copy of the JAX package's ``analysis/tica.py``.

Replaces pyemma.coordinates.tica (reference src/mdgen/analysis.py:31-34):
symmetrized (reversible) covariance estimation at the given lag, generalized
eigenproblem via whitening, kinetic-map scaling of the projections, dimension
chosen by 95% cumulative kinetic variance (pyemma defaults).
"""
from __future__ import annotations

import numpy as np


class TICA:
    def __init__(self, lag: int = 1000, kinetic_map: bool = True, var_cutoff: float = 0.95, epsilon: float = 1e-6):
        self.lag = lag
        self.kinetic_map = kinetic_map
        self.var_cutoff = var_cutoff
        self.epsilon = epsilon

    def fit(self, X: np.ndarray) -> "TICA":
        X = np.asarray(X, dtype=np.float64)
        lag = min(self.lag, max(X.shape[0] // 2, 1))
        x0, xt = X[:-lag], X[lag:]
        # symmetrized (reversible) moments
        self.mean_ = 0.5 * (x0.mean(0) + xt.mean(0))
        a, b = x0 - self.mean_, xt - self.mean_
        n = a.shape[0]
        c00 = (a.T @ a + b.T @ b) / (2 * n)
        c0t = (a.T @ b + b.T @ a) / (2 * n)

        # whiten by c00, drop near-null directions
        evals, evecs = np.linalg.eigh(c00)
        keep = evals > self.epsilon * evals.max()
        W = evecs[:, keep] / np.sqrt(evals[keep])
        m = W.T @ c0t @ W
        m = 0.5 * (m + m.T)
        tl, tv = np.linalg.eigh(m)
        order = np.argsort(tl)[::-1]
        self.eigenvalues_ = np.clip(tl[order], -1 + 1e-12, 1 - 1e-12)
        self.eigenvectors_ = W @ tv[:, order]

        kinetic_var = self.eigenvalues_**2
        cum = np.cumsum(kinetic_var) / kinetic_var.sum()
        self.dim_ = max(int(np.searchsorted(cum, self.var_cutoff) + 1), 2)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        Y = (np.asarray(X, dtype=np.float64) - self.mean_) @ self.eigenvectors_[:, : self.dim_]
        if self.kinetic_map:
            Y = Y * self.eigenvalues_[: self.dim_]
        return Y

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)

    @property
    def timescales(self) -> np.ndarray:
        return -self.lag / np.log(np.abs(self.eigenvalues_))
