"""Reward oracles for RTB fine-tuning: log r(x) = -E(x) / temperature.

Counterpart of the JAX package's ``rtb/rewards.py``. The reference scores
rollouts with OpenMM Amber14 potential energies through PDB files on disk
(src/rtb_utils/rewards.py:40-160). Here:

- ``SurrogateReward``: a differentiable molecular-mechanics surrogate
  (idealized backbone bond lengths + steric clash repulsion) in torch ops on
  the sample's device, for hosts without OpenMM; it needs no copy of the
  sample to the host;
- ``Amber14Reward``: OpenMM when it is installed (implicit gbn2 or explicit
  tip3pfb solvent, LangevinMiddleIntegrator at 350 K), over multi-MODEL PDB
  files; an ``energy_backend`` stands in for OpenMM where it is absent;
- ``get_reward``: ``auto`` picks Amber14 when OpenMM imports, else the
  surrogate (a choice of reward, not of device).
"""
from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ..geometry import tables as rc
from ..geometry.protein import from_pdb_models

_IDEAL_BONDS = [  # (atom14 idx a, atom14 idx b, ideal length A) backbone
    (0, 1, 1.459),  # N-CA
    (1, 2, 1.525),  # CA-C
    (2, 3, 1.229),  # C=O
]
_PEPTIDE_BOND = 1.336  # C(i) - N(i+1)


class SurrogateReward:
    """log_r = -E / temperature with E = bonded deviations + clash repulsion
    (JAX :32-77)."""

    def __init__(self, temperature: float = 1.0, k_bond: float = 100.0, k_clash: float = 10.0,
                 clash_radius: float = 2.5):
        self.temperature = temperature
        self.k_bond = k_bond
        self.k_clash = k_clash
        self.clash_radius = clash_radius

    def energy(self, atom14: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
        """atom14 (B, T, L, 14, 3), aatype (L,) or (B, L) -> per-frame
        energy (B, T)."""
        L = atom14.shape[-3]
        table = torch.as_tensor(rc.RESTYPE_ATOM14_MASK, dtype=atom14.dtype,
                                device=atom14.device)
        m = table[aatype.long()].reshape(*aatype.shape[:-1], L * 14)
        if aatype.ndim == 2:  # one sequence per element, shared by its frames
            m = m[:, None]
        e = 0.0
        for a, b, d0 in _IDEAL_BONDS:
            d = torch.linalg.vector_norm(atom14[..., a, :] - atom14[..., b, :], dim=-1)
            e = e + self.k_bond * ((d - d0) ** 2).sum(-1)
        d = torch.linalg.vector_norm(atom14[..., 1:, 0, :] - atom14[..., :-1, 2, :], dim=-1)
        e = e + self.k_bond * ((d - _PEPTIDE_BOND) ** 2).sum(-1)

        # steric clashes between atoms of non-adjacent residues
        pos = atom14.reshape(*atom14.shape[:-3], L * 14, 3)
        dist = torch.linalg.vector_norm(pos[..., :, None, :] - pos[..., None, :, :] + 1e-9, dim=-1)
        res_i = torch.arange(L, device=atom14.device).repeat_interleave(14)
        nonadj = ((res_i[:, None] - res_i[None, :]).abs() >= 2).to(atom14.dtype)
        pair_mask = nonadj * m[..., :, None] * m[..., None, :]
        clash = torch.clamp(self.clash_radius - dist, min=0.0) ** 2
        return e + 0.5 * self.k_clash * (clash * pair_mask).sum((-1, -2))

    def __call__(self, atom14, aatype) -> torch.Tensor:
        """atom14 (B, T, L, 14, 3) -> log_r (B,) averaged over frames.
        ``aatype`` is one shared sequence (L,) or per-element sequences
        (B, L): a conditional multi-peptide batch scores each element with
        its own sequence (src/rtb_utils/gfn_diffusion.py:438-456)."""
        atom14 = torch.as_tensor(atom14)
        aatype = torch.as_tensor(aatype, device=atom14.device)
        return -self.energy(atom14, aatype).mean(-1) / self.temperature


def choose_platform() -> str:
    """'CUDA' if OpenMM exposes it, else 'CPU' (src/rtb_utils/rewards.py:24-37)."""
    from openmm import Platform

    names = [Platform.getPlatform(i).getName() for i in range(Platform.getNumPlatforms())]
    return "CUDA" if "CUDA" in names else "CPU"


class Amber14Reward:
    """OpenMM Amber14 potential-energy reward over whole trajectories
    (JAX :80-249; src/rtb_utils/rewards.py:40-160): per-frame energies of
    every frame of each peptide's trajectory in ``tmp_dir``, grouped by the
    4-letter peptide prefix; implicit (amber14-all + gbn2, HBonds
    constraints) or explicit solvent (tip3pfb, 1 nm padding, PME 1 nm
    cutoff, MonteCarloBarostat at 1 bar); hydrogens added at pH 7;
    LangevinMiddleIntegrator at 350 K; platform CUDA if available. Returns
    ``(logs, logrs)``: ``logs[peptide]`` = {'log_r', 'x', 'torsions'} for the
    target-distribution cache, ``logrs`` aligned with ``paths``.
    Trajectories are multi-MODEL PDB files (``MDGenSimulator.
    fix_and_save_pdbs``).

    ``energy_backend``: ``(aatype (L,), xyz (atoms, 3) Angstrom) -> float``,
    which replaces OpenMM so that the grouping, caching and cleanup run on
    hosts without it; when unset OpenMM is required at construction."""

    def __init__(self, platform: str | None = None, implicit: bool = True,
                 friction_coeff: float = 1.0, dt_fs: float = 2.0,
                 energy_temperature: float = 1.0, energy_backend=None, cleanup: bool = True):
        self.implicit = implicit
        self.friction_coeff = friction_coeff
        self.dt_fs = dt_fs
        self.energy_temperature = energy_temperature
        self.energy_backend = energy_backend
        self.cleanup = cleanup
        self.platform_name = platform
        self._ff = None
        if energy_backend is None:
            try:
                import openmm  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "OpenMM is not installed; use SurrogateReward, or pass energy_backend=") from e
            self.platform_name = platform or choose_platform()

    # ------------------------------------------------------------------
    def _forcefield(self):
        from openmm.app import ForceField

        if self._ff is None:
            water = "implicit/gbn2.xml" if self.implicit else "amber14/tip3pfb.xml"
            self._ff = ForceField("amber14-all.xml", water)
        return self._ff

    def _openmm_frame_energy(self, topology, positions) -> float:
        """One frame -> potential energy in kJ/mol (rewards.py:110-146)."""
        import openmm
        from openmm import unit
        from openmm.app import PME, HBonds, Modeller, Simulation

        ff = self._forcefield()
        modeller = Modeller(topology, positions)
        modeller.addHydrogens(ff, pH=7)
        if self.implicit:
            system = ff.createSystem(modeller.topology, constraints=HBonds)
        else:
            modeller.addSolvent(ff, padding=1.0 * unit.nanometer)
            system = ff.createSystem(modeller.topology, nonbondedMethod=PME,
                                     nonbondedCutoff=1.0 * unit.nanometer, constraints=HBonds)
        integrator = openmm.LangevinMiddleIntegrator(
            350 * unit.kelvin, self.friction_coeff / unit.picosecond,
            self.dt_fs * unit.femtosecond)
        sim = Simulation(modeller.topology, system, integrator,
                         openmm.Platform.getPlatformByName(self.platform_name))
        sim.context.setPositions(modeller.positions)
        if not self.implicit:
            system.addForce(openmm.MonteCarloBarostat(1 * unit.bar, 350 * unit.kelvin))
            sim.context.reinitialize(preserveState=True)
        state = sim.context.getState(getEnergy=True)
        return float(state.getPotentialEnergy().value_in_unit(unit.kilojoule_per_mole))

    # ------------------------------------------------------------------
    def energies_for_pdb(self, pdb_path: str) -> np.ndarray:
        """Per-MODEL energies (kJ/mol) of a (multi-model) PDB."""
        if self.energy_backend is not None:
            return np.asarray([float(self.energy_backend(aatype, xyz))
                               for aatype, xyz in from_pdb_models(pdb_path)], np.float64)
        from openmm.app import PDBFile

        pdb = PDBFile(pdb_path)
        return np.asarray([self._openmm_frame_energy(pdb.topology, pdb.getPositions(frame=i))
                           for i in range(pdb.getNumFrames())], np.float64)

    def __call__(self, paths: list[str] | None = None, tmp_dir: str | None = None,
                 data_path: str | None = None) -> tuple:
        """(logs, logrs) over every peptide trajectory in ``tmp_dir``
        (rewards.py:70-160); the sampled PDB files are removed afterwards
        (:152-155) unless ``cleanup`` is off."""
        tmp_dir = tmp_dir or "."
        if paths is None:
            def frame_key(p):
                stem = os.path.basename(p)[:-4].split("_")
                return (stem[0], int(stem[-1]) if stem[-1].isdigit() else -1)

            paths = sorted((p for p in glob.glob(os.path.join(tmp_dir, "*_*.pdb"))
                            if not p.endswith("_traj.pdb")), key=frame_key)
        peptides = sorted({os.path.basename(p).split("_")[0] for p in paths})
        logs, logrs = {}, np.zeros(len(paths), np.float64)
        for peptide in peptides:
            idx = [i for i, p in enumerate(paths) if peptide in os.path.basename(p)]
            if not idx:
                continue
            traj_path = os.path.join(tmp_dir, f"{peptide}_traj.pdb")
            if os.path.exists(traj_path):
                energies = self.energies_for_pdb(traj_path)
                xyz = np.stack([x for _, x in from_pdb_models(traj_path)])
            else:
                energies = np.concatenate([self.energies_for_pdb(paths[i]) for i in idx])
                xyz = np.stack([from_pdb_models(paths[i])[0][1] for i in idx])
            log_r = -energies / self.energy_temperature
            if len(idx) == len(energies):
                logrs[np.asarray(idx)] = log_r
            tor_path = os.path.join(tmp_dir, f"{peptide}_torsions.npy")
            torsions = np.load(tor_path) if os.path.exists(tor_path) else None
            logs[peptide] = {"log_r": log_r, "x": xyz, "torsions": torsions}
        if self.cleanup:
            for f in glob.glob(os.path.join(tmp_dir, "*.pdb")):
                os.remove(f)
        return logs, logrs


def get_reward(kind: str = "auto", temperature: float = 1.0, **kw):
    """``amber14`` (raises without OpenMM), ``surrogate``, or ``auto``:
    Amber14 when OpenMM imports, else the surrogate (JAX :252-259), both at
    ``temperature``. The JAX package hands ``temperature`` to
    ``Amber14Reward``, which has no such argument, and its surrogate
    fall-back drops it; here it is each reward's temperature."""
    if kind in ("auto", "amber14"):
        try:
            return Amber14Reward(energy_temperature=temperature, **kw)
        except ImportError:
            if kind == "amber14":
                raise
    return SurrogateReward(temperature=temperature)
