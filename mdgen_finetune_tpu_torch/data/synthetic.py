"""Synthetic peptide trajectories for tests and smoke runs.

Counterpart of the JAX package's ``data/synthetic.py`` (:24-81): format-
identical atom14 .npy files with smooth dynamics. Backbone frames follow a
random walk on SE(3) and torsions a wrapped Ornstein-Uhlenbeck process;
all-atom coordinates come from the idealized reconstruction (the port's own
geometry, on the CPU). The random walk is numpy's, seeded per peptide, so
both packages draw the same frames and torsions from a seed.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import frames as G
from ..geometry import tables as rc
from ..geometry.rigid import Rigid, quat_to_rotmat


def synthesize_trajectory(seqres: str, num_frames: int, seed: int = 0,
                          torsion_stiffness: float = 0.05) -> np.ndarray:
    """Returns atom14 (T, L, 14, 3) float16 in Angstroms."""
    rng = np.random.default_rng(seed)
    L = len(seqres)
    aatype = rc.str_sequence_to_aatype(seqres)

    # backbone: residues laid out along x with a small SE(3) random walk over time
    base_trans = np.stack([3.8 * np.arange(L), np.zeros(L), np.zeros(L)], axis=-1)
    quats = rng.normal(size=(L, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    trans = np.zeros((num_frames, L, 3))
    qs = np.zeros((num_frames, L, 4))
    trans[0], qs[0] = base_trans, quats
    for t in range(1, num_frames):
        trans[t] = trans[t - 1] + 0.05 * rng.normal(size=(L, 3))
        dq = qs[t - 1] + 0.02 * rng.normal(size=(L, 4))
        qs[t] = dq / np.linalg.norm(dq, axis=-1, keepdims=True)

    # torsions: wrapped OU around per-residue means
    means = rng.uniform(-np.pi, np.pi, size=(L, 7))
    angles = np.zeros((num_frames, L, 7))
    angles[0] = means + 0.3 * rng.normal(size=(L, 7))
    for t in range(1, num_frames):
        angles[t] = (angles[t - 1] + torsion_stiffness * np.sin(means - angles[t - 1])
                     + 0.15 * rng.normal(size=(L, 7)))
    torsions = np.stack([np.sin(angles), np.cos(angles)], axis=-1)

    frames = Rigid(quat_to_rotmat(torch.as_tensor(qs, dtype=torch.float32)),
                   torch.as_tensor(trans, dtype=torch.float32))
    aat = torch.as_tensor(aatype).long().expand(num_frames, L)
    atom14 = G.frames_torsions_to_atom14(frames, torch.as_tensor(torsions, dtype=torch.float32), aat)
    return atom14.numpy().astype(np.float16)


def make_synthetic_dataset(out_dir: str, peptides: list, num_frames: int = 200,
                           suffix: str = "", seed: int = 0, replicas: tuple = ()) -> str:
    """Writes per-peptide .npy files and a split CSV; returns the CSV path.
    ``peptides``: sequences, or (name, seqres) pairs. ``replicas``: the
    ATLAS layout instead, one trajectory per replica r as
    ``{name}_R{r}{suffix}.npy`` (each from its own seed)."""
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "split.csv")
    with open(csv_path, "w") as f:
        f.write("name,seqres\n")
        for i, pep in enumerate(peptides):
            name, seq = pep if isinstance(pep, tuple) else (pep, pep)
            f.write(f"{name},{seq}\n")
            files = [(f"{name}_R{r}", 100 * r) for r in replicas] or [(name, 0)]
            for full, offset in files:
                np.save(os.path.join(out_dir, f"{full}{suffix}.npy"),
                        synthesize_trajectory(seq, num_frames, seed=seed + i + offset))
    return csv_path
