"""Minimal protein PDB I/O in numpy: multi-MODEL trajectory writer and
parser.

Counterpart of the JAX package's ``geometry/protein.py`` (:17-133; reference
src/mdgen/protein.py:45-370 and the trajectory writer src/mdgen/utils.py:
59-103), over the port's own residue tables: the same fixed-width text for
the same coordinates.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import tables as rc


@dataclasses.dataclass
class Protein:
    atom_positions: np.ndarray  # (L, 37, 3)
    atom_mask: np.ndarray  # (L, 37)
    aatype: np.ndarray  # (L,)
    residue_index: np.ndarray  # (L,)
    b_factors: np.ndarray | None = None
    chain_index: np.ndarray | None = None


def to_pdb_lines(prot: Protein, model_idx: int | None = None) -> list[str]:
    lines = []
    if model_idx is not None:
        lines.append(f"MODEL      {model_idx}")
    serial = 1
    L = prot.aatype.shape[0]
    b = prot.b_factors if prot.b_factors is not None else np.zeros((L, 37))
    for i in range(L):
        resname = rc.restype_1to3.get(rc.restypes_with_x[int(prot.aatype[i])], "UNK")
        for a in range(37):
            if prot.atom_mask[i, a] < 0.5:
                continue
            name = rc.atom_types[a]
            pos = prot.atom_positions[i, a]
            pad_name = f" {name:<3}" if len(name) < 4 else name
            element = name[0]
            lines.append(
                f"ATOM  {serial:>5} {pad_name}{'':1}{resname:>3} A{int(prot.residue_index[i]) + 1:>4}    "
                f"{pos[0]:8.3f}{pos[1]:8.3f}{pos[2]:8.3f}{1.00:6.2f}{b[i, a]:6.2f}          {element:>2}"
            )
            serial += 1
    lines.append("TER")
    if model_idx is not None:
        lines.append("ENDMDL")
    return lines


def atom37_traj_to_pdb(atom37: np.ndarray, aatype: np.ndarray, path: str,
                       atom_mask: np.ndarray | None = None):
    """Multi-MODEL trajectory PDB (src/mdgen/utils.py:59-67 semantics).
    ``atom_mask`` (L, 37) selects which atoms exist; it defaults to the
    residue chemistry table."""
    aatype = np.asarray(aatype)
    if atom_mask is None:
        atom_mask = np.asarray(rc.RESTYPE_ATOM37_MASK)[aatype]
    mask = np.asarray(atom_mask, np.float32)
    lines = []
    for m, pos in enumerate(np.asarray(atom37)):
        prot = Protein(atom_positions=pos, atom_mask=mask, aatype=aatype,
                       residue_index=np.arange(len(aatype)))
        lines.extend(to_pdb_lines(prot, model_idx=m))
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def atom14_to_atom37(atom14: np.ndarray, aatype: np.ndarray) -> np.ndarray:
    """(T, L, 14, 3) + (L,) -> (T, L, 37, 3); absent atoms zero."""
    aat = np.asarray(aatype)
    idx = rc.RESTYPE_ATOM37_TO_ATOM14[aat]  # (L, 37)
    mask = rc.RESTYPE_ATOM37_MASK[aat].astype(atom14.dtype)
    out = np.take_along_axis(atom14, np.broadcast_to(idx[None, :, :, None],
                                                      (atom14.shape[0], *idx.shape, 3)), axis=2)
    return out * mask[None, :, :, None]


def atom14_to_pdb(atom14: np.ndarray, aatype: np.ndarray, path: str):
    """(T, L, 14, 3) + (L,) -> multi-model PDB file (src/mdgen/utils.py:59)."""
    atom14 = np.asarray(atom14)
    atom37_traj_to_pdb(atom14_to_atom37(atom14, aatype), np.asarray(aatype), path)


def from_pdb_models(path: str) -> list:
    """All MODELs of a PDB as [(aatype (L,), xyz (masked atoms, 3))], flat
    per-frame coordinates in file order."""
    with open(path) as f:
        text = f.read()
    out = []
    for chunk in text.split("ENDMDL"):
        if "ATOM" not in chunk:
            continue
        prot = from_pdb_string(chunk)
        out.append((prot.aatype, prot.atom_positions[prot.atom_mask > 0.5]))
    return out


def from_pdb_string(pdb_str: str) -> Protein:
    """Parse the first MODEL of a PDB into atom37 arrays."""
    positions, mask, aatypes, res_index = {}, {}, {}, []
    for line in pdb_str.splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith("ATOM"):
            continue
        name = line[12:16].strip()
        resname = line[17:20].strip()
        resseq = int(line[22:26])
        if name not in rc.atom_order:
            continue
        x, y, z = float(line[30:38]), float(line[38:46]), float(line[46:54])
        if resseq not in positions:
            positions[resseq] = np.zeros((37, 3))
            mask[resseq] = np.zeros(37)
            aatypes[resseq] = rc.restype_order.get(rc.restype_3to1.get(resname, "X"),
                                                   rc.unk_restype_index)
            res_index.append(resseq)
        positions[resseq][rc.atom_order[name]] = (x, y, z)
        mask[resseq][rc.atom_order[name]] = 1.0
    res_index = sorted(res_index)
    return Protein(
        atom_positions=np.stack([positions[r] for r in res_index]),
        atom_mask=np.stack([mask[r] for r in res_index]),
        aatype=np.array([aatypes[r] for r in res_index]),
        residue_index=np.arange(len(res_index)),
    )
