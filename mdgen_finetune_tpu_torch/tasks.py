"""Task conditioning: latent tokenization and conditioning masks.

Counterpart of the JAX package's ``tasks.py`` (reference
src/mdgen/wrapper.py:254-365). Latent token: 7-dim rigid offset
(quat ‖ trans) then 14 torsion channels (7 x sin/cos) = 21; with
``tps_condition``, ``inpainting`` or ``dynamic_mpnn`` the offsets are
doubled, the forward offsets in frame 0 then the reverse ones in the last
frame, 7 + 7 + 14 = 28 (the design task's 20 simplex channels are appended
by the sampler, not here). The inpainting / design tasks condition on
residues 0 and 3 in every frame, and ``design`` masks the aatype of
residues 1 and 2 (20); ``design_key_frames``, ``no_torsion`` and
``no_design_torsion`` are the reference's ablations, and so are
``no_offsets`` (the forward offsets are the absolute frames as 7-tensors)
and ``no_frames`` (``_prep_batch_no_frames``: the raw atom37 coordinates,
111 channels, from a batch of ``atom37`` and the per-atom37 ``mask``).
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import MDGenConfig
from .geometry.rigid import Rigid

# residue index conventions of inpainting/design (src/mdgen/wrapper.py:41-43)
DESIGN_IDX = (1, 2)
COND_IDX = (0, 3)
DESIGN_MAP_TO_COND = (0, 0, 3, 3)


def get_offsets(ref_frame: Rigid, rigids: Rigid) -> torch.Tensor:
    """Relative 7-tensors of ``rigids`` in ``ref_frame`` (src/mdgen/utils.py:7-14)."""
    return ref_frame.invert().compose(rigids).to_tensor_7()


def _fix_quat_sign(offsets: torch.Tensor) -> torch.Tensor:
    """Quaternion sign with a non-negative real part (src/mdgen/wrapper.py:308-309)."""
    sign = torch.where(offsets[..., 0:1] < 0, -1.0, 1.0)
    return torch.cat([offsets[..., :4] * sign, offsets[..., 4:]], dim=-1)


def make_cond_mask(cfg: MDGenConfig, B: int, T: int, L: int, device=None) -> torch.Tensor:
    """(B, T, L) int mask of conditioning positions (src/mdgen/wrapper.py:337-346)."""
    task = cfg.task
    mask = torch.zeros(B, T, L, dtype=torch.int32, device=device)
    if task.sim_condition:
        mask[:, 0] = 1
    if task.tps_condition:
        mask[:, 0] = 1
        mask[:, -1] = 1
    if task.cond_interval:
        mask[:, ::task.cond_interval] = 1
    if task.inpainting or task.dynamic_mpnn or task.mpnn:
        mask[:, :, list(COND_IDX)] = 1
    return mask


def prep_batch(cfg: MDGenConfig, batch: Dict[str, torch.Tensor]) -> Dict:
    """Batch dict -> {rigids, latents, loss_mask, model_kwargs}: forward
    simulation, upsampling, transition paths, inpainting / design and
    (dynamic) mpnn (src/mdgen/wrapper.py:283-365); under ``no_frames``
    {latents, loss_mask, model_kwargs} (``_prep_batch_no_frames``)."""
    task = cfg.task
    if task.no_frames:
        return _prep_batch_no_frames(cfg, batch)
    rigids = Rigid(batch["rots"], batch["trans"])  # (B, T, L)
    B, T, L = rigids.shape
    if task.design_key_frames:
        # the key residues' rigids in the first and last frames
        key = list(DESIGN_MAP_TO_COND)
        first = Rigid(rigids.rot[:, :1, key], rigids.trans[:, :1, key])
        last = Rigid(rigids.rot[:, -1:, key], rigids.trans[:, -1:, key])
        rigids = Rigid.cat([first, rigids[:, 1:-1], last], dim=1)
    offsets = _fix_quat_sign(rigids.to_tensor_7() if task.no_offsets
                             else get_offsets(rigids[:, 0:1], rigids))

    frame_loss_mask = batch["mask"][..., None].expand(B, L, 7)
    torsion_loss_mask = batch["torsion_mask"][..., None].expand(B, L, 7, 2).reshape(B, L, 14)
    if cfg.doubled_offsets:  # tps_condition: the offsets in the last frame too
        offsets_r = _fix_quat_sign(get_offsets(rigids[:, -1:], rigids))
        offsets = torch.cat([offsets, offsets_r], dim=-1)
        frame_loss_mask = torch.cat([frame_loss_mask, frame_loss_mask], dim=-1)
    torsions = batch["torsions"].reshape(B, T, L, 14)
    if task.no_torsion:
        torsions = torch.zeros_like(torsions)
    elif task.no_design_torsion:
        torsions = torsions.clone()
        torsions[:, :, list(DESIGN_IDX)] = 0.0
    latents = torch.cat([offsets, torsions], dim=-1)
    if task.supervise_all_torsions:
        torsion_loss_mask = torch.ones_like(torsion_loss_mask)
    elif task.supervise_no_torsions:
        torsion_loss_mask = torch.zeros_like(torsion_loss_mask)
    loss_mask = torch.cat([frame_loss_mask, torsion_loss_mask], dim=-1)
    loss_mask = loss_mask[:, None].expand(B, T, L, loss_mask.shape[-1])

    cond_mask = make_cond_mask(cfg, B, T, L, device=latents.device)
    aatype = batch["seqres"]
    if task.design:
        aatype = aatype.clone()
        aatype[:, list(DESIGN_IDX)] = 20
    return {
        "rigids": rigids,
        "latents": latents,
        "loss_mask": loss_mask,
        "model_kwargs": {
            "start_frames": rigids[:, 0],
            "end_frames": rigids[:, -1],
            "mask": batch["mask"][:, None].expand(B, T, L),
            "aatype": aatype,
            "x_cond": torch.where(cond_mask[..., None].bool(), latents, 0.0),
            "x_cond_mask": cond_mask,
        },
    }


def _prep_batch_no_frames(cfg: MDGenConfig, batch: Dict[str, torch.Tensor]) -> Dict:
    """The raw-coordinate ablation (src/mdgen/wrapper.py:254-280; JAX
    :122-145): latents are the atom37 coordinates (B, T, L, 37, 3) flattened
    to 111 channels; ``batch["mask"]`` is the per-atom37 mask (B, L, 37),
    whose column 1 (CA) is the residue mask and whose atoms are the loss
    mask; only ``sim_condition`` conditions (frame 0). As in JAX the masks
    come from the atom table alone, not from the residue-validity mask."""
    atom37 = batch["atom37"]
    B, T, L = atom37.shape[:3]
    latents = atom37.reshape(B, T, L, 111)
    amask = batch["mask"]
    loss_mask = amask[:, None, :, :, None].expand(B, T, L, 37, 3).reshape(B, T, L, 111)
    cond_mask = torch.zeros(B, T, L, dtype=torch.int32, device=latents.device)
    if cfg.task.sim_condition:
        cond_mask[:, 0] = 1
    return {
        "latents": latents,
        "loss_mask": loss_mask,
        "model_kwargs": {
            "mask": amask[:, None, :, 1].expand(B, T, L),
            "aatype": batch["seqres"],
            "x_cond": torch.where(cond_mask[..., None].bool(), latents, 0.0),
            "x_cond_mask": cond_mask,
        },
    }
