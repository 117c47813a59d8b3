"""Fine-tuning diagnostics plots, the numpy / scipy copy of the JAX
package's ``rtb/plots.py``.

Rebuild of the reference's plotting helpers (src/rtb_utils/plot_utils.py:14-282
and FinetunePlotter.generate_plots, src/rtb_utils/gfn_diffusion.py:283-358):
energy/log-reward distribution comparison with JS divergence, pairwise
relative-distance histograms, and TICA/PCA scatter of generated vs reference
ensembles. Written as pure matplotlib-on-arrays (no wandb dependency; the
caller logs the files)."""
from __future__ import annotations

import os

import numpy as np
from scipy.spatial.distance import jensenshannon


def js_divergence(a: np.ndarray, b: np.ndarray, bins: int = 50) -> float:
    """JS divergence between two scalar samples via shared-range histograms
    (src/rtb_utils/plot_utils.py JS helpers)."""
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    pa = np.histogram(a, bins=bins, range=(lo, hi))[0] + 1e-10
    pb = np.histogram(b, bins=bins, range=(lo, hi))[0] + 1e-10
    return float(jensenshannon(pa, pb) ** 2)


def plot_energy_distributions(logr_gen: np.ndarray, logr_target: np.ndarray, out_path: str) -> float:
    """Histogram overlay of generated vs target log-rewards; returns JSD."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jsd = js_divergence(np.asarray(logr_gen), np.asarray(logr_target))
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(logr_target), bins=50, alpha=0.6, density=True, label="target")
    ax.hist(np.asarray(logr_gen), bins=50, alpha=0.6, density=True, label="generated")
    ax.set_xlabel("log r(x)")
    ax.set_title(f"log-reward distributions (JSD={jsd:.4f})")
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return jsd


def rel_distance_histograms(atom14_gen: np.ndarray, atom14_ref: np.ndarray, out_path: str):
    """CA-CA pairwise-distance histograms, generated vs reference
    (src/rtb_utils/plot_utils.py rel-distance panels)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def ca_dists(a14):
        ca = np.asarray(a14)[..., 1, :]  # (N, L, 3)
        d = np.linalg.norm(ca[:, :, None] - ca[:, None, :], axis=-1)
        iu = np.triu_indices(d.shape[-1], 1)
        return d[:, iu[0], iu[1]]

    dg, dr = ca_dists(atom14_gen), ca_dists(atom14_ref)
    n = dg.shape[1]
    fig, axs = plt.subplots(1, n, figsize=(3 * n, 3), squeeze=False)
    for i in range(n):
        axs[0, i].hist(dr[:, i], bins=40, alpha=0.6, density=True, label="ref")
        axs[0, i].hist(dg[:, i], bins=40, alpha=0.6, density=True, label="gen")
        axs[0, i].set_title(f"pair {i}")
    axs[0, 0].legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def tica_scatter(gen_feats: np.ndarray, ref_feats: np.ndarray, out_path: str, lag: int = 100):
    """2D TICA scatter of generated vs reference featurized ensembles
    (src/rtb_utils/plot_utils.py TICA/PCA scatter panels)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..analysis import TICA

    tica = TICA(lag=min(lag, len(ref_feats) // 4)).fit(ref_feats)
    yr, yg = tica.transform(ref_feats), tica.transform(gen_feats)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(yr[:, 0], yr[:, 1], s=2, alpha=0.3, label="ref")
    ax.scatter(yg[:, 0], yg[:, 1], s=2, alpha=0.3, label="gen")
    ax.set_xlabel("TIC 0")
    ax.set_ylabel("TIC 1")
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
