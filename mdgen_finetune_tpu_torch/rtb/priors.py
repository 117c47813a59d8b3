"""The frozen MDGen prior that RTB fine-tuning decodes through.

Counterpart of the JAX package's ``rtb/priors.py`` (:31-147; reference
MDGenSimulator, src/rtb_utils/priors.py:26-278): a trained flow-matching
model as a fixed decoder from prior latents zs0 to all-atom trajectories,
the conditioning the policies see drawn from the dataset, and the PDB export
and target-distribution cache the OpenMM reward reads. The decode runs on
the device through ``InferenceEngine.sample_with_zs0`` (the flat Euler
chain for the flagship config; the reference round-trips through PDBFixer
and pdb / xtc files, priors.py:205-243).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import MDGenConfig
from ..data.dataset import MDGenDataset
from ..data.featurize import featurize_atom14_batch
from ..geometry import frames as G
from ..geometry import tables as rc
from ..geometry.protein import atom14_to_pdb, atom37_traj_to_pdb
from ..inference.sampling import InferenceEngine, resolve_device
from ..tasks import prep_batch


def rc_restype_order(c: str) -> int:
    return rc.restype_order.get(c, rc.unk_restype_index)


class MDGenSimulator:
    def __init__(self, cfg: MDGenConfig, params, split: str, data_dir: Optional[str] = None,
                 batch_size: int = 1, out_dir: Optional[str] = None,
                 distinct_peptides: bool = False, device="cuda"):
        """``params``: the prior's state_dict (or a flax tree), or None when
        only the dataset, the PDB export and the cache are needed (no
        decode). ``distinct_peptides``: draw the ``batch_size`` dataset
        entries without replacement, so that a conditional batch mixes
        different peptides (src/rtb_utils/gfn_diffusion.py:438-456)."""
        self.cfg = cfg
        self.engine = (InferenceEngine(cfg, params, device=device)
                       if params is not None else None)
        self.device = self.engine.device if self.engine is not None else resolve_device(device)
        self.dataset = MDGenDataset(cfg, split, data_dir=data_dir)
        self.batch_size = batch_size
        self.distinct_peptides = distinct_peptides
        self.rng = np.random.default_rng(cfg.train.seed)
        # sample / target-dist scratch space (reference out_dir + target_dist.pt,
        # src/rtb_utils/priors.py:88-93)
        self.out_dir = out_dir or os.path.join(cfg.workdir, "samples")
        self.target_dist_path = os.path.join(self.out_dir, "..", "target_dist.npz")
        self.target_dist: dict = {}
        if os.path.exists(self.target_dist_path):
            self.target_dist = dict(np.load(self.target_dist_path, allow_pickle=True)["d"].item())

    # ------------------------------------------------------------------
    def save_target_dist(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.target_dist_path)), exist_ok=True)
        np.savez(self.target_dist_path, d=np.asarray(self.target_dist, dtype=object))

    def fix_and_save_pdbs(self, frames_atom14: np.ndarray, peptide: str,
                          aatype: Optional[np.ndarray] = None) -> list:
        """One PDB per frame, a multi-MODEL ``{peptide}_traj.pdb`` and the
        frames' torsions (``{peptide}_torsions.npy``, (N, L, 7, 2)), as the
        reference's atom14_to_pdb + PDBFixer + mdtraj join (priors.py:
        205-243). The decode reconstructs every heavy atom from ideal
        geometry, so there is nothing for PDBFixer to add."""
        os.makedirs(self.out_dir, exist_ok=True)
        frames_atom14 = np.asarray(frames_atom14, np.float32)  # (N, L, 14, 3)
        if aatype is None:
            _, seqres = self.dataset.entries[0]
            aatype = np.asarray([rc_restype_order(c) for c in seqres[:frames_atom14.shape[1]]],
                                np.int32)
        aat = torch.from_numpy(np.asarray(aatype)).long()
        atom37 = G.atom14_to_atom37(torch.from_numpy(frames_atom14), aat)
        torsions, _ = G.atom37_to_torsions(atom37, aat)
        paths = []
        for i in range(len(frames_atom14)):
            p = os.path.join(self.out_dir, f"{peptide}_{i}.pdb")
            atom14_to_pdb(frames_atom14[i][None], aatype, p)
            paths.append(p)
        atom37_traj_to_pdb(atom37.numpy(), aatype, os.path.join(self.out_dir, f"{peptide}_traj.pdb"))
        np.save(os.path.join(self.out_dir, f"{peptide}_torsions.npy"), torsions.numpy())
        return paths

    def ensure_target_dist(self, reward_fn, peptides: Optional[list] = None,
                           sample_size: int = 64) -> dict:
        """Compute and cache each peptide's data energy distribution (the
        reference's gfn_diffusion.py:296-310): ``sample_size`` random frames
        of its trajectory written as PDBs, scored by ``reward_fn(tmp_dir=)``,
        the cache saved."""
        peptides = peptides or [n for n, _ in self.dataset.entries]
        todo = [p for p in peptides if p not in self.target_dist]
        if not todo:
            return self.target_dist
        for name, seqres in self.dataset.entries:
            if name not in todo:
                continue
            arr = np.load(self.dataset._path(name), mmap_mode="r")
            idx = self.rng.integers(0, len(arr), size=sample_size)
            frames = np.asarray(arr[np.sort(idx)], np.float32)
            aatype = np.asarray([rc_restype_order(c) for c in seqres], np.int32)
            self.fix_and_save_pdbs(frames, name, aatype=aatype)
        logs, _ = reward_fn(tmp_dir=self.out_dir)
        self.target_dist.update(logs)
        self.save_target_dist()
        return self.target_dist

    @property
    def latent_shape(self) -> tuple:
        return (self.cfg.data.num_frames, self.cfg.data.crop, self.cfg.latent_dim)

    # ------------------------------------------------------------------
    def get_batch(self) -> dict:
        """A featurized dataset batch on the device, with its ``name`` list."""
        if self.distinct_peptides and self.batch_size > 1:
            n = len(self.dataset.entries)
            idxs = self.rng.choice(n, size=min(self.batch_size, n), replace=False)
            samples = [self.dataset.sample(self.rng, idx=int(i)) for i in idxs]
            raw = {k: np.stack([s[k] for s in samples]) for k in ("atom14", "seqres", "mask")}
            raw["name"] = [s["name"] for s in samples]
        else:
            raw = self.dataset.batch(self.rng, self.batch_size)
        feats = featurize_atom14_batch(torch.as_tensor(raw["atom14"], device=self.device),
                                       torch.as_tensor(raw["seqres"], device=self.device).long(),
                                       torch.as_tensor(raw["mask"], device=self.device))
        feats["name"] = raw["name"]
        return feats

    def get_cond_args(self, batch: Optional[dict] = None) -> tuple:
        """(model kwargs, batch): the conditioning the policies see
        (src/rtb_utils/priors.py:149-161)."""
        batch = batch or self.get_batch()
        prep = prep_batch(self.cfg, {k: v for k, v in batch.items() if k != "name"})
        return prep["model_kwargs"], batch

    def sample(self, batch: dict, zs0: torch.Tensor):
        """zs0 -> (atom14 (B, T, L, 14, 3), aa_out) through the frozen flow
        (src/rtb_utils/priors.py:163-203), without gradients."""
        clean = {k: v for k, v in batch.items() if k != "name"}
        return self.engine.sample_with_zs0(clean, zs0.detach())
