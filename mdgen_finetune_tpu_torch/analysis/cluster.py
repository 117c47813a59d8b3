"""K-means clustering, the numpy copy of the JAX package's
``analysis/cluster.py`` (it replaces pyemma.coordinates.cluster_kmeans,
reference src/mdgen/analysis.py:36-38): kmeans++ init, fixed seed,
assignment by vectorized nearest center."""
from __future__ import annotations

import numpy as np


class KMeans:
    def __init__(self, k: int = 100, max_iter: int = 100, seed: int = 137):
        self.k = k
        self.max_iter = max_iter
        self.seed = seed

    def _init_centers(self, X: np.ndarray, rng) -> np.ndarray:
        # kmeans++
        n = X.shape[0]
        centers = [X[rng.integers(n)]]
        d2 = np.sum((X - centers[0]) ** 2, axis=1)
        for _ in range(1, min(self.k, n)):
            probs = d2 / max(d2.sum(), 1e-30)
            centers.append(X[rng.choice(n, p=probs)])
            d2 = np.minimum(d2, np.sum((X - centers[-1]) ** 2, axis=1))
        return np.stack(centers)

    def fit(self, X: np.ndarray) -> "KMeans":
        X = np.asarray(X, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        centers = self._init_centers(X, rng)
        for _ in range(self.max_iter):
            assign = self.predict(X, centers)
            new_centers = centers.copy()
            for j in range(len(centers)):
                pts = X[assign == j]
                if len(pts):
                    new_centers[j] = pts.mean(0)
            if np.allclose(new_centers, centers):
                break
            centers = new_centers
        self.cluster_centers_ = centers
        return self

    def predict(self, X: np.ndarray, centers: np.ndarray | None = None) -> np.ndarray:
        centers = centers if centers is not None else self.cluster_centers_
        # chunked to bound memory for long trajectories
        out = np.empty(X.shape[0], dtype=np.int64)
        for s in range(0, X.shape[0], 100_000):
            chunk = X[s : s + 100_000]
            d2 = ((chunk[:, None, :] - centers[None]) ** 2).sum(-1)
            out[s : s + 100_000] = np.argmin(d2, axis=1)
        return out

    def transform(self, X: np.ndarray) -> np.ndarray:
        return self.predict(np.asarray(X, dtype=np.float64))
