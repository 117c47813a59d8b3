"""Geometry transforms: atom14 <-> frames/torsions <-> atom37, in float32.

Counterpart of the JAX package's ``geometry/frames.py`` (reference
src/mdgen/geometry.py). Where the JAX package replaced per-restype gathers
with one-hot selection matmuls (a TPU choice), the port gathers directly:
a one-hot product at full precision and a gather give the same numbers.

Conventions (as in the reference):
- backbone frames are ``Rigid.from_3_points(C, CA, N)`` composed with
  diag(-1, 1, -1) (src/mdgen/geometry.py:218-231);
- 7 torsions as (sin, cos) pairs, psi flipped by [1,1,-1,1,1,1,1]
  (src/mdgen/geometry.py:195-200);
- atoms rebuilt from 8 rigid groups and idealized literature coordinates
  (src/mdgen/geometry.py:236-334).

``aatype`` may omit the frame axis of the coordinates (aatype (B, L) with
atom14 (B, T, L, 14, 3)), as the featurizer passes it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import tables as rc
from .rigid import Rigid, rigid_vecs_flip


@functools.lru_cache(maxsize=None)
def _table_np(name: str) -> np.ndarray:
    if name == "chi_atoms":
        return rc.get_chi_atom_indices().reshape(rc.restype_num + 1, 16)
    return np.asarray(getattr(rc, name))


@functools.lru_cache(maxsize=None)
def _table_on(name: str, device: torch.device) -> torch.Tensor:
    """A table on a device, copied there once (a copy per call would make
    the host wait for the device every time); shared by every caller: never
    write into it."""
    return torch.as_tensor(_table_np(name), device=device)


@functools.lru_cache(maxsize=None)
def _psi_flip(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The per-torsion sign (psi flipped), made once per device; shared:
    never write into it."""
    return torch.tensor([1.0, 1.0, -1.0, 1.0, 1.0, 1.0, 1.0], dtype=dtype, device=device)


def _table(name: str, aatype: torch.Tensor, dtype=None) -> torch.Tensor:
    """TABLE[aatype] — per-residue rows of a numpy table, on aatype's device."""
    t = _table_on(name, aatype.device)
    if dtype is not None:
        t = t.to(dtype)
    return t[aatype.long()]


def _expand_aatype(aatype: torch.Tensor, lead: tuple) -> torch.Tensor:
    """aatype (..., L) broadcast to the coordinates' leading dims ``lead``
    (..., [T,] L): a frame axis missing from aatype is inserted."""
    if aatype.ndim == len(lead) - 1:
        aatype = aatype.unsqueeze(-2)
    return aatype.expand(*lead)


def _expand_rows(sel: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Per-residue selection rows (..., L, K) broadcast to ``lead`` + (K,),
    inserting a frame axis missing from the selection."""
    if sel.ndim == len(lead):
        sel = sel.unsqueeze(-3)
    return sel.expand(*lead, sel.shape[-1])


def _gather_atoms(pos: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pos (..., L, A, 3), idx (..., L, K) -> (..., L, K, 3)."""
    return torch.gather(pos, -2, idx[..., None].expand(*idx.shape, 3))


def atom14_to_atom37(atom14: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
    """(..., L, 14, 3) + (..., L) int -> (..., L, 37, 3); absent atoms zero."""
    lead = atom14.shape[:-2]
    idx = _expand_rows(_table("RESTYPE_ATOM37_TO_ATOM14", aatype).long(), lead)
    mask = _expand_rows(_table("RESTYPE_ATOM37_MASK", aatype, atom14.dtype), lead)
    return _gather_atoms(atom14, idx) * mask[..., None]


def atom37_to_atom14(atom37: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
    """(..., L, 37, 3) + (..., L) int -> (..., L, 14, 3); absent atoms zero
    (JAX :67-73)."""
    lead = atom37.shape[:-2]
    idx = _expand_rows(_table("RESTYPE_ATOM14_TO_ATOM37", aatype).long(), lead)
    mask = _expand_rows(_table("RESTYPE_ATOM14_MASK", aatype, atom37.dtype), lead)
    return _gather_atoms(atom37, idx) * mask[..., None]


def atom14_to_frames(atom14: torch.Tensor) -> Rigid:
    """Backbone frames from N/CA/C; atom14 (..., L, 14, 3) -> Rigid (..., L)."""
    n = atom14[..., rc.atom_order["N"], :]
    ca = atom14[..., rc.atom_order["CA"], :]
    c = atom14[..., rc.atom_order["C"], :]
    return _flipped_frames(c, ca, n)


def _flipped_frames(c, ca, n) -> Rigid:
    """``Rigid.from_3_points(C, CA, N)`` composed with diag(-1, 1, -1)."""
    frames = Rigid.from_3_points(c, ca, n)
    flip = rigid_vecs_flip(ca.device).to(frames.rot.dtype).expand_as(frames.rot)
    return frames.compose(Rigid(flip, torch.zeros_like(frames.trans)))


def atom37_to_torsions(all_atom_positions: torch.Tensor, aatype: torch.Tensor,
                       all_atom_mask: torch.Tensor | None = None):
    """7 torsion angles as (sin, cos) + validity mask.

    all_atom_positions (..., L, 37, 3); aatype (..., L) int (may omit the
    frame axis); all_atom_mask optional (..., L, 37). Returns torsions
    (..., L, 7, 2) and torsion_mask over aatype's dims (..., L, 7)."""
    pos = all_atom_positions
    if all_atom_mask is None:
        all_atom_mask = _table("RESTYPE_ATOM37_MASK", aatype, pos.dtype)
    mask = all_atom_mask

    def shift_prev(a, feat_dims):
        # previous residue, zero-padded at the N-terminus
        pad = [0, 0] * feat_dims + [1, 0]
        return torch.nn.functional.pad(a.narrow(-1 - feat_dims, 0, a.shape[-1 - feat_dims] - 1), pad)

    prev_pos = shift_prev(pos, 2)
    prev_mask = shift_prev(mask, 1)

    pre_omega_pos = torch.cat([prev_pos[..., 1:3, :], pos[..., :2, :]], dim=-2)
    phi_pos = torch.cat([prev_pos[..., 2:3, :], pos[..., :3, :]], dim=-2)
    psi_pos = torch.cat([pos[..., :3, :], pos[..., 4:5, :]], dim=-2)

    pre_omega_mask = prev_mask[..., 1:3].prod(-1) * mask[..., :2].prod(-1)
    phi_mask = prev_mask[..., 2] * mask[..., :3].prod(-1)
    psi_mask = mask[..., :3].prod(-1) * mask[..., 4]

    chi_idx = _table("chi_atoms", aatype).long()  # (..., L, 16)
    chis_pos = _gather_atoms(pos, _expand_rows(chi_idx, pos.shape[:-2])).reshape(
        *pos.shape[:-2], 4, 4, 3)
    chis_mask = _table("CHI_ANGLES_MASK21", aatype, pos.dtype)  # (..., L, 4)
    chi_atoms_mask = torch.gather(mask, -1, chi_idx).reshape(*chi_idx.shape[:-1], 4, 4).prod(-1)
    chis_mask = chis_mask * chi_atoms_mask

    torsions_pos = torch.cat([pre_omega_pos[..., None, :, :], phi_pos[..., None, :, :],
                              psi_pos[..., None, :, :], chis_pos], dim=-3)  # (..., L, 7, 4, 3)
    torsion_mask = torch.cat([pre_omega_mask[..., None], phi_mask[..., None],
                              psi_mask[..., None], chis_mask], dim=-1)

    torsion_frames = Rigid.from_3_points(torsions_pos[..., 1, :], torsions_pos[..., 2, :],
                                         torsions_pos[..., 0, :], eps=1e-8)
    fourth_rel = torsion_frames.invert_apply(torsions_pos[..., 3, :])
    sin_cos = torch.stack([fourth_rel[..., 2], fourth_rel[..., 1]], dim=-1)
    sin_cos = sin_cos / torch.sqrt((sin_cos ** 2).sum(-1, keepdim=True) + 1e-8)
    return sin_cos * _psi_flip(sin_cos.device, sin_cos.dtype)[:, None], torsion_mask


def torsion_angles_to_frames(frames: Rigid, alpha: torch.Tensor, aatype: torch.Tensor) -> Rigid:
    """Backbone frames (..., L) + 7 (sin, cos) torsions (..., L, 7, 2) ->
    the 8 rigid-group-to-global frames, Rigid (..., L, 8)."""
    aat = _expand_aatype(aatype, alpha.shape[:-2])
    default_r = Rigid.from_tensor_4x4(
        _table("restype_rigid_group_default_frame", aat, alpha.dtype))  # (..., L, 8)
    bb_rot = alpha.new_tensor([0.0, 1.0]).expand(*alpha.shape[:-2], 1, 2)
    alpha = torch.cat([bb_rot, alpha], dim=-2)  # (..., L, 8, 2)
    sin_a, cos_a = alpha[..., 0], alpha[..., 1]
    zeros, ones = torch.zeros_like(sin_a), torch.ones_like(sin_a)
    # rotation about the x-axis by the torsion angle
    rot = torch.stack([torch.stack([ones, zeros, zeros], -1),
                       torch.stack([zeros, cos_a, -sin_a], -1),
                       torch.stack([zeros, sin_a, cos_a], -1)], dim=-2)
    all_frames = default_r.compose(Rigid(rot, torch.zeros(*sin_a.shape, 3, dtype=alpha.dtype,
                                                          device=alpha.device)))
    chi1 = all_frames[..., 4]
    chi2 = chi1.compose(all_frames[..., 5])
    chi3 = chi2.compose(all_frames[..., 6])
    chi4 = chi3.compose(all_frames[..., 7])
    all_to_bb = Rigid.cat([all_frames[..., :5], chi2.unsqueeze(-1), chi3.unsqueeze(-1),
                           chi4.unsqueeze(-1)], dim=-1)
    return frames.unsqueeze(-1).compose(all_to_bb)


def frames_torsions_to_atom14(frames: Rigid, torsions: torch.Tensor,
                              aatype: torch.Tensor) -> torch.Tensor:
    """Backbone frames (..., L) + torsions (..., L, 7, 2) -> atom14 (..., L, 14, 3)."""
    group_frames = torsion_angles_to_frames(frames, torsions, aatype)  # (..., L, 8)
    aat = _expand_aatype(aatype, torsions.shape[:-2])
    group = _table("restype_atom14_to_rigid_group", aat).long()  # (..., L, 14)
    lit = _table("restype_atom14_rigid_group_positions", aat, torsions.dtype)
    mask = _table("RESTYPE_ATOM14_MASK", aat, torsions.dtype)
    rot = torch.gather(group_frames.rot, -3, group[..., None, None].expand(*group.shape, 3, 3))
    trans = torch.gather(group_frames.trans, -2, group[..., None].expand(*group.shape, 3))
    pos = Rigid(rot, trans).apply(lit)
    return pos * mask[..., None]


def frames_torsions_to_atom37(frames: Rigid, torsions: torch.Tensor,
                              aatype: torch.Tensor) -> torch.Tensor:
    """Backbone frames (..., L) + torsions (..., L, 7, 2) -> atom37
    (..., L, 37, 3) (JAX :203-204)."""
    return atom14_to_atom37(frames_torsions_to_atom14(frames, torsions, aatype), aatype)


def prot_to_frames(ca_coords, c_coords, n_coords) -> Rigid:
    """Backbone coordinates (..., 3) of CA, C and N (arrays or tensors) ->
    the flipped backbone frames, f32 (src/mdgen/geometry.py:205-215; JAX
    :207-211)."""
    ca, c, n = (torch.as_tensor(v, dtype=torch.float32) for v in (ca_coords, c_coords, n_coords))
    return _flipped_frames(c, ca, n)
