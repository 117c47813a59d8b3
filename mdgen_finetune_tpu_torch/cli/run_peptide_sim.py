"""Ground-truth MD data generation CLI (reference src/scripts/run_peptide_sim.py).

Counterpart of the JAX package's ``cli/run_peptide_sim.py``: OpenMM Amber14
Langevin MD at 350 K per peptide (implicit gbn2 or explicit tip3pfb
solvent), writing a DCD trajectory per entry. The starting structure is an
extended chain from idealized geometry (``build_extended_peptide``; the
reference builds one with pymol's ``fab``, run_peptide_sim.py:33-51). The
MD needs OpenMM; without it ``main`` exits with a message pointing to
``cli/synth_data.py``, whose synthetic trajectories have the training
format.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch


def build_extended_peptide(seqres: str) -> np.ndarray:
    """Extended-conformation atom14 (L, 14, 3) f32: residue frames 3.8
    Angstroms apart along x with identity rotations, every torsion trans
    (cos 1), through the idealized-geometry reconstruction."""
    from ..geometry import frames as G
    from ..geometry.rigid import Rigid
    from ..geometry.tables import str_sequence_to_aatype

    L = len(seqres)
    aatype = torch.from_numpy(np.asarray(str_sequence_to_aatype(seqres))).long()
    trans = torch.from_numpy(np.stack([3.8 * np.arange(L), np.zeros(L), np.zeros(L)], -1)
                             .astype(np.float32))
    frames = Rigid(torch.eye(3).expand(1, L, 3, 3), trans[None])
    torsions = torch.zeros(1, L, 7, 2)
    torsions[..., 1] = 1.0  # cos = 1: all-trans
    return G.frames_torsions_to_atom14(frames, torsions, aatype[None])[0].numpy()


def simulate(name: str, seqres: str, args) -> str:
    """One peptide's MD (OpenMM); returns the DCD path."""
    import openmm
    from openmm import app, unit

    from ..geometry.protein import atom14_to_pdb
    from ..geometry.tables import str_sequence_to_aatype

    outdir = os.path.join(args.outdir, name)
    os.makedirs(outdir, exist_ok=True)
    start_pdb = os.path.join(outdir, f"{name}_start.pdb")
    atom14_to_pdb(build_extended_peptide(seqres)[None], str_sequence_to_aatype(seqres),
                  start_pdb)
    pdb = app.PDBFile(start_pdb)
    if args.solvent == "implicit":
        ff = app.ForceField("amber14-all.xml", "implicit/gbn2.xml")
    else:
        ff = app.ForceField("amber14-all.xml", "amber14/tip3pfb.xml")
    modeller = app.Modeller(pdb.topology, pdb.positions)
    modeller.addHydrogens(ff)
    if args.solvent != "implicit":
        modeller.addSolvent(ff, padding=1.0 * unit.nanometer)
    system = ff.createSystem(
        modeller.topology,
        nonbondedMethod=app.PME if args.solvent != "implicit" else app.NoCutoff)
    integrator = openmm.LangevinMiddleIntegrator(350 * unit.kelvin, 1 / unit.picosecond,
                                                 0.002 * unit.picoseconds)
    sim = app.Simulation(modeller.topology, system, integrator)
    sim.context.setPositions(modeller.positions)
    sim.minimizeEnergy()
    sim.step(10_000)  # NVT equilibration (run_peptide_sim.py:98)
    dcd = os.path.join(outdir, f"{name}.dcd")
    sim.reporters.append(app.DCDReporter(dcd, args.report_interval))
    sim.step(args.n_steps)
    return dcd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--splits", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--solvent", type=str, default="explicit", choices=["implicit", "explicit"])
    p.add_argument("--n_steps", type=int, default=50_000_000)
    p.add_argument("--report_interval", type=int, default=5000)
    p.add_argument("--worker_id", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=1)
    args = p.parse_args(argv)
    try:
        import openmm  # noqa: F401
    except ImportError:
        raise SystemExit("OpenMM is not installed. Use `python -m "
                         "mdgen_finetune_tpu_torch.cli.synth_data` to generate synthetic "
                         "training data instead.")
    with open(args.splits) as f:
        rows = list(csv.DictReader(f))
    for i, row in enumerate(rows):
        if i % args.num_workers != args.worker_id:  # SLURM-style striding (:131-140)
            continue
        print(simulate(row["name"], row["seqres"], args), flush=True)


if __name__ == "__main__":
    main()
