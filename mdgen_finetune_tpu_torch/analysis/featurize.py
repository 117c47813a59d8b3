"""Torsion featurization of all-atom trajectories for MSM/TICA analysis.

Counterpart of the JAX package's ``analysis/featurize.py`` (it replaces the
reference's pyemma featurizers, src/mdgen/analysis.py:8-29): backbone
phi/psi (+ sidechain chi) torsions per frame, as angles or (cos, sin)
pairs, with stable labels. The torsions come from the port's geometry
(``geometry.frames.atom14_to_atom37`` / ``atom37_to_torsions``) on the CPU
in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import frames as G
from ..geometry import tables as rc


def feature_labels(aatype: np.ndarray, sidechains: bool = False) -> list[str]:
    """Labels in the featurization order: all backbone (PHI/PSI per residue),
    then sidechain CHI1-4 per residue; undefined angles excluded."""
    labels = []
    aatype = np.asarray(aatype)
    L = len(aatype)
    for i in range(L):
        if i > 0:
            labels.append(f"PHI {rc.restype_1to3[rc.restypes_with_x[aatype[i]]]} {i + 1}")
        if i < L - 1:
            labels.append(f"PSI {rc.restype_1to3[rc.restypes_with_x[aatype[i]]]} {i + 1}")
    if sidechains:
        for i in range(L):
            n_chi = int(np.sum(rc.CHI_ANGLES_MASK21[aatype[i]]))
            for c in range(n_chi):
                labels.append(f"CHI{c + 1} {rc.restype_1to3[rc.restypes_with_x[aatype[i]]]} {i + 1}")
    return labels


@torch.no_grad()
def featurize_trajectory(
    atom14: np.ndarray, aatype: np.ndarray, sidechains: bool = False, cossin: bool = True
) -> tuple[list[str], np.ndarray]:
    """atom14 (T, L, 14, 3), aatype (L,) -> (labels, features (T, F)).

    Backbone features come first (phi_1..psi_{L-1}); chi features follow.
    With cossin=True each angle contributes (cos, sin) columns, matching
    pyemma's cossin layout.
    """
    atom14 = np.asarray(atom14, dtype=np.float32)
    aatype = np.asarray(aatype)
    T, L = atom14.shape[:2]
    aat = torch.from_numpy(aatype.astype(np.int64))
    atom37 = G.atom14_to_atom37(torch.from_numpy(atom14), aat)
    sin_cos, _ = G.atom37_to_torsions(atom37, aat)
    sin_cos = sin_cos.numpy()  # (T, L, 7, 2) as (sin, cos)
    angles = np.arctan2(sin_cos[..., 0], sin_cos[..., 1])  # (T, L, 7)

    cols = []
    for i in range(L):
        if i > 0:
            cols.append(angles[:, i, 1])  # phi
        if i < L - 1:
            cols.append(angles[:, i, 2])  # psi
    if sidechains:
        for i in range(L):
            n_chi = int(np.sum(rc.CHI_ANGLES_MASK21[aatype[i]]))
            for c in range(n_chi):
                cols.append(angles[:, i, 3 + c])
    feats = np.stack(cols, axis=1) if cols else np.zeros((T, 0), np.float32)
    labels = feature_labels(aatype, sidechains)
    if cossin:
        feats = np.concatenate([np.cos(feats)[..., None], np.sin(feats)[..., None]], axis=-1).reshape(T, -1)
        labels = [f"{fn}({lab})" for lab in labels for fn in ("COS", "SIN")]
    return labels, feats
