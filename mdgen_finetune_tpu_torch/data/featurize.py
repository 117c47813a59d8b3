"""Trajectory featurization: raw atom14 windows -> the model's batch dict.

Counterpart of the JAX package's ``data/featurize.py`` (reference
src/mdgen/dataset.py:73-91); runs on whatever device the tensors are on.
"""
from __future__ import annotations

import torch

from ..geometry import frames as G


def featurize_atom14_batch(atom14: torch.Tensor, seqres: torch.Tensor,
                           mask: torch.Tensor) -> dict:
    """atom14 (B, T, L, 14, 3) Angstroms; seqres (B, L) int; mask (B, L) float.

    Returns torsions (B, T, L, 7, 2), torsion_mask (B, L, 7), rots
    (B, T, L, 3, 3), trans (B, T, L, 3), seqres, mask. Padded residues
    (mask 0) get identity frames and zero torsions, as in the reference
    (src/mdgen/dataset.py:105-108)."""
    atom14 = atom14.float()
    frames = G.atom14_to_frames(atom14)
    # aatype stays frame-factored (B, L): the geometry broadcasts over frames
    atom37 = G.atom14_to_atom37(atom14, seqres)
    torsions, torsion_mask = G.atom37_to_torsions(atom37, seqres)

    valid = mask.bool()
    eye = torch.eye(3, dtype=atom14.dtype, device=atom14.device)
    rots = torch.where(valid[:, None, :, None, None], frames.rot, eye)
    trans = torch.where(valid[:, None, :, None], frames.trans, 0.0)
    torsions = torch.where(valid[:, None, :, None, None], torsions, 0.0)
    torsion_mask = torsion_mask * mask[..., None]
    return {"torsions": torsions, "torsion_mask": torsion_mask, "rots": rots,
            "trans": trans, "seqres": seqres, "mask": mask}
