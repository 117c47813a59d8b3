"""PyTorch port, geometry and data: rigid algebra, frames / torsions / atoms,
featurization and batch preparation held against the JAX functions on the
same numpy inputs (float32, CPU).

Tolerances: rtol 1e-4 / atol 1e-5 for transforms and coordinates of unit
scale. Coordinates in Angstrom (|x| up to ~30) get atol 1e-4: f32 keeps
~7 digits, and the two frameworks sum the frame products in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import MDGenConfig, TaskConfig
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.geometry import frames as JG
from mdgen_finetune_tpu.geometry import rigid as JR
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry import rigid as TR
from mdgen_finetune_tpu_torch.tasks import make_cond_mask as t_cond_mask
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch

RTOL, ATOL = 1e-4, 1e-5
ATOL_ANGSTROM = 1e-4


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


def _t7(rng, shape):
    t7 = rng.normal(size=shape + (7,)).astype(np.float32)
    t7[..., 4:] *= 5.0
    return t7


@pytest.fixture(scope="module")
def structures():
    """Atom14 windows built by the JAX package from random frames and
    torsions: B=2, T=3, L=4, all 20 residue types represented."""
    rng = np.random.default_rng(0)
    B, T, L = 2, 3, 4
    aatype = rng.permutation(np.arange(20))[:B * L].reshape(B, L).astype(np.int32)
    frames = JR.Rigid.from_tensor_7(jnp.asarray(_t7(rng, (B, T, L))))
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    aat = np.broadcast_to(aatype[:, None], (B, T, L))
    atom14 = np.array(JG.frames_torsions_to_atom14(frames, jnp.asarray(tors), jnp.asarray(aat)))
    return atom14, aatype, tors, frames


def test_rigid_algebra():
    rng = np.random.default_rng(1)
    a7, b7 = _t7(rng, (3, 5)), _t7(rng, (3, 5))
    pts = rng.normal(size=(3, 5, 3)).astype(np.float32) * 4
    ja, jb = JR.Rigid.from_tensor_7(jnp.asarray(a7)), JR.Rigid.from_tensor_7(jnp.asarray(b7))
    ta, tb = TR.Rigid.from_tensor_7(torch.from_numpy(a7)), TR.Rigid.from_tensor_7(torch.from_numpy(b7))
    _close(ta.rot, ja.rot)
    c_j, c_t = ja.compose(jb), ta.compose(tb)
    _close(c_t.rot, c_j.rot)
    _close(c_t.trans, c_j.trans, atol=ATOL_ANGSTROM)
    _close(ta.invert().trans, ja.invert().trans, atol=ATOL_ANGSTROM)
    _close(ta.apply(torch.from_numpy(pts)), ja.apply(jnp.asarray(pts)), atol=ATOL_ANGSTROM)
    _close(ta.invert_apply(torch.from_numpy(pts)), ja.invert_apply(jnp.asarray(pts)),
           atol=ATOL_ANGSTROM)
    # quaternion sign is arbitrary: compare the rotation the 7-tensor encodes
    t7 = c_t.to_tensor_7()
    _close(TR.quat_to_rotmat(t7[..., :4]), JR.quat_to_rotmat(c_j.to_tensor_7()[..., :4]))
    _close(t7[..., 4:], c_j.trans, atol=ATOL_ANGSTROM)
    np.testing.assert_allclose(np.abs(t7[..., :4].numpy()),
                               np.abs(np.asarray(c_j.to_tensor_7()[..., :4])), atol=ATOL)


def test_atom14_frames_atom37_torsions(structures):
    atom14, aatype, _, _ = structures
    t14, tat = torch.from_numpy(atom14), torch.from_numpy(aatype).long()
    jf, tf = JG.atom14_to_frames(jnp.asarray(atom14)), TG.atom14_to_frames(t14)
    _close(tf.rot, jf.rot)
    _close(tf.trans, jf.trans, atol=ATOL_ANGSTROM)
    j37 = JG.atom14_to_atom37(jnp.asarray(atom14), jnp.asarray(aatype))
    t37 = TG.atom14_to_atom37(t14, tat)
    _close(t37, j37, atol=ATOL_ANGSTROM)
    jt, jm = JG.atom37_to_torsions(j37, jnp.asarray(aatype))
    tt, tm = TG.atom37_to_torsions(t37, tat)
    _close(tt, jt, atol=1e-4)
    _close(tm, jm)


def test_torsions_to_atom14(structures):
    atom14, aatype, tors, frames = structures
    B, T, L = tors.shape[:3]
    aat = np.broadcast_to(aatype[:, None], (B, T, L)).copy()
    tframes = TR.Rigid(torch.from_numpy(np.array(frames.rot)), torch.from_numpy(np.array(frames.trans)))
    jg = JG.torsion_angles_to_frames(frames, jnp.asarray(tors), jnp.asarray(aat))
    tg = TG.torsion_angles_to_frames(tframes, torch.from_numpy(tors), torch.from_numpy(aat).long())
    _close(tg.rot, jg.rot)
    _close(tg.trans, jg.trans, atol=ATOL_ANGSTROM)
    out = TG.frames_torsions_to_atom14(tframes, torch.from_numpy(tors), torch.from_numpy(aatype).long())
    _close(out, atom14, atol=ATOL_ANGSTROM)


def test_featurize_and_prep_batch(structures):
    atom14, aatype, _, _ = structures
    mask = np.ones(aatype.shape, np.float32)
    mask[1, -1] = 0.0
    jb = j_featurize(jnp.asarray(atom14), jnp.asarray(aatype), jnp.asarray(mask))
    tb = t_featurize(torch.from_numpy(atom14), torch.from_numpy(aatype).long(), torch.from_numpy(mask))
    for k in ("torsions", "torsion_mask", "rots", "trans"):
        _close(tb[k], jb[k], atol=ATOL_ANGSTROM)
    cfg = MDGenConfig(task=TaskConfig(sim_condition=True))
    jp = j_prep_batch(cfg, jb)
    tp = t_prep_batch(tcfg.MDGenConfig(task=tcfg.TaskConfig(sim_condition=True)), tb)
    # offsets' quaternions are sign-canonicalised, so latents compare directly
    _close(tp["latents"], jp["latents"], atol=ATOL_ANGSTROM)
    _close(tp["loss_mask"], jp["loss_mask"])
    for k in ("mask", "aatype", "x_cond", "x_cond_mask"):
        _close(tp["model_kwargs"][k], jp["model_kwargs"][k], atol=ATOL_ANGSTROM)
    _close(tp["model_kwargs"]["start_frames"].rot, jp["model_kwargs"]["start_frames"].rot)


@pytest.mark.parametrize("task", [dict(sim_condition=True), dict(tps_condition=True),
                                  dict(sim_condition=True, cond_interval=2),
                                  dict(inpainting=True)])
def test_make_cond_mask(task):
    from mdgen_finetune_tpu.tasks import make_cond_mask as j_cond_mask

    j = j_cond_mask(MDGenConfig(task=TaskConfig(**task)), 2, 5, 4)
    t = t_cond_mask(tcfg.MDGenConfig(task=tcfg.TaskConfig(**task)), 2, 5, 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_prep_batch_refuses_unported_tasks(structures):
    """``no_offsets``, once refused, now prepares as JAX does: the offsets
    are the frames themselves as sign-fixed 7-tensors."""
    atom14, aatype, _, _ = structures
    tb = t_featurize(torch.from_numpy(atom14), torch.from_numpy(aatype).long(),
                     torch.ones(aatype.shape))
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    tp = t_prep_batch(tcfg.MDGenConfig(task=tcfg.TaskConfig(sim_condition=True, no_offsets=True)),
                      tb)
    jp = j_prep_batch(MDGenConfig(task=TaskConfig(sim_condition=True, no_offsets=True)), jb)
    assert tp["latents"].shape == (2, 3, 4, 21)
    _close(tp["latents"], jp["latents"], atol=ATOL_ANGSTROM)
    _close(tp["model_kwargs"]["x_cond"], jp["model_kwargs"]["x_cond"], atol=ATOL_ANGSTROM)
    assert (tp["latents"][..., 0] >= 0).all()
