"""Residue constant tables, derived at import time from raw chemical data.

The raw data (atom names, chi-angle atom quadruples, idealized rigid-group
coordinates) lives in ``residue_data.json`` — public AlphaFold chemical
constants. Everything else here (index maps between the atom37 / atom14
encodings, masks, rigid-group default frames, chi-atom gather indices) is
derived by the functions below.

Parity targets in the reference: src/mdgen/residue_constants.py:854-1486
(restype orders, atom37/atom14 maps, rigid group constants) and
src/mdgen/geometry.py:337-358 (chi atom indices). All tables are plain numpy;
compute code converts them to tensors as needed. This is the PyTorch port's
own copy (with its own ``residue_data.json``), so the port reads nothing of
the JAX package.
"""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

_DATA = json.loads((pathlib.Path(__file__).parent / "residue_data.json").read_text())

# ---------------------------------------------------------------------------
# Orders and names
# ---------------------------------------------------------------------------
restypes: list[str] = _DATA["restypes"]  # 20 one-letter codes
restype_order: dict[str, int] = {r: i for i, r in enumerate(restypes)}
restype_num = len(restypes)  # 20
unk_restype_index = restype_num  # 20 == UNK
restype_1to3: dict[str, str] = _DATA["restype_1to3"]
restype_3to1: dict[str, str] = {v: k for k, v in restype_1to3.items()}
restypes_with_x: list[str] = restypes + ["X"]
restype_order_with_x: dict[str, int] = {r: i for i, r in enumerate(restypes_with_x)}

atom_types: list[str] = _DATA["atom_types"]  # 37 names
atom_order: dict[str, int] = {a: i for i, a in enumerate(atom_types)}
atom_type_num = len(atom_types)  # 37

restype_name_to_atom14_names: dict[str, list[str]] = _DATA["restype_name_to_atom14_names"]
chi_angles_atoms: dict[str, list[list[str]]] = _DATA["chi_angles_atoms"]
chi_angles_mask: list[list[float]] = _DATA["chi_angles_mask"]
chi_pi_periodic: list[list[float]] = _DATA["chi_pi_periodic"]
rigid_group_atom_positions: dict[str, list] = _DATA["rigid_group_atom_positions"]


def aatype_to_str_sequence(aatype) -> str:
    return "".join(restypes_with_x[int(a)] for a in aatype)


def str_sequence_to_aatype(seq: str) -> np.ndarray:
    return np.array([restype_order[c] for c in seq], dtype=np.int32)


# ---------------------------------------------------------------------------
# atom14 <-> atom37 index maps and masks
# ---------------------------------------------------------------------------
def _make_atom_maps():
    n = restype_num + 1  # include UNK row (all zeros)
    a14_to_a37 = np.zeros((n, 14), dtype=np.int32)
    a37_to_a14 = np.zeros((n, 37), dtype=np.int32)
    a14_mask = np.zeros((n, 14), dtype=np.float32)
    a37_mask = np.zeros((n, 37), dtype=np.float32)
    for i, letter in enumerate(restypes):
        names14 = restype_name_to_atom14_names[restype_1to3[letter]]
        for j, name in enumerate(names14):
            if not name:
                continue
            k = atom_order[name]
            a14_to_a37[i, j] = k
            a37_to_a14[i, k] = j
            a14_mask[i, j] = 1.0
            a37_mask[i, k] = 1.0
    return a14_to_a37, a37_to_a14, a14_mask, a37_mask


(
    RESTYPE_ATOM14_TO_ATOM37,
    RESTYPE_ATOM37_TO_ATOM14,
    RESTYPE_ATOM14_MASK,
    RESTYPE_ATOM37_MASK,
) = _make_atom_maps()

# lowercase aliases matching the reference's non-capitalized tables
restype_atom14_mask = RESTYPE_ATOM14_MASK
restype_atom37_mask = RESTYPE_ATOM37_MASK


# ---------------------------------------------------------------------------
# Rigid-group constants
# ---------------------------------------------------------------------------
def _rigid_frame_4x4(ex: np.ndarray, ey: np.ndarray, translation: np.ndarray) -> np.ndarray:
    """Gram-Schmidt a right-handed frame with x-axis along ``ex`` and build a 4x4."""
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = ex, ey, ez, translation
    return m


def _make_rigid_group_constants():
    n = restype_num + 1
    # frames for undefined chi groups stay all-zero (matching the reference);
    # groups 0 (backbone) and 1 (pre-omega) are identity
    default_frame = np.zeros((n, 8, 4, 4), dtype=np.float32)
    default_frame[:restype_num, 0] = np.eye(4)  # UNK row stays all-zero
    default_frame[:restype_num, 1] = np.eye(4)
    group_idx14 = np.zeros((n, 14), dtype=np.int32)
    positions14 = np.zeros((n, 14, 3), dtype=np.float32)

    for i, letter in enumerate(restypes):
        resname = restype_1to3[letter]
        names14 = restype_name_to_atom14_names[resname]
        atom_pos = {name: np.asarray(p, dtype=np.float64) for name, _, p in rigid_group_atom_positions[resname]}

        for name, group, pos in rigid_group_atom_positions[resname]:
            j = names14.index(name)
            group_idx14[i, j] = group
            positions14[i, j] = pos

        # groups 0 (backbone) and 1 (pre-omega) are identity; phi (2) and psi (3)
        # frames come from the idealized backbone geometry
        default_frame[i, 2] = _rigid_frame_4x4(
            ex=atom_pos["N"] - atom_pos["CA"], ey=np.array([1.0, 0.0, 0.0]), translation=atom_pos["N"]
        )
        default_frame[i, 3] = _rigid_frame_4x4(
            ex=atom_pos["C"] - atom_pos["CA"], ey=atom_pos["CA"] - atom_pos["N"], translation=atom_pos["C"]
        )
        if chi_angles_mask[i][0]:
            base = [atom_pos[a] for a in chi_angles_atoms[resname][0]]
            default_frame[i, 4] = _rigid_frame_4x4(
                ex=base[2] - base[1], ey=base[0] - base[1], translation=base[2]
            )
        # chi_{k} frame relative to chi_{k-1}: x-axis through the axis-end atom,
        # whose coordinates are expressed in the previous group's frame
        for chi in range(1, 4):
            if chi_angles_mask[i][chi]:
                axis_end = atom_pos[chi_angles_atoms[resname][chi][2]]
                default_frame[i, chi + 4] = _rigid_frame_4x4(
                    ex=axis_end, ey=np.array([-1.0, 0.0, 0.0]), translation=axis_end
                )
    return default_frame, group_idx14, positions14


(
    restype_rigid_group_default_frame,
    restype_atom14_to_rigid_group,
    restype_atom14_rigid_group_positions,
) = _make_rigid_group_constants()


@functools.lru_cache(maxsize=None)
def get_chi_atom_indices() -> np.ndarray:
    """atom37 indices of the 4 atoms defining each chi angle; (21, 4, 4)."""
    out = np.zeros((restype_num + 1, 4, 4), dtype=np.int32)
    for i, letter in enumerate(restypes):
        for chi, atoms in enumerate(chi_angles_atoms[restype_1to3[letter]]):
            out[i, chi] = [atom_order[a] for a in atoms]
    return out


# chi mask with the UNK row appended, as used by the torsion featurizer
CHI_ANGLES_MASK21 = np.concatenate(
    [np.asarray(chi_angles_mask, dtype=np.float32), np.zeros((1, 4), dtype=np.float32)], axis=0
)
