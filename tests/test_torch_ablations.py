"""PyTorch port, the reference's ``no_offsets`` and ``no_frames`` ablations
and the geometry helpers they bring, held against the JAX package on the
CPU:

- ``prep_batch`` under ``no_offsets`` with the doubled offsets
  (``tps_condition``) and ``_prep_batch_no_frames`` (111 atom37 channels,
  the per-atom37 mask, only ``sim_condition`` conditions);
- ``no_offsets`` sampling and decoding: ``InferenceEngine.sample_with_zs0``
  (the flat Euler chain, the offsets decoded as the frames themselves)
  against the JAX engine's ``_sample_with_zs0`` with the same weights
  (``to_flax``) and prior;
- ``no_frames`` training: ``Trainer._loss_fn`` (the atom37 featurizer,
  latent 111 through ``FusedTrunkFn``: the embed's K and the head's N are
  111) and every parameter's gradient against ``jax.value_and_grad`` of the
  JAX loss with the JAX package's ``Trainer._featurize``, t and x0 given as
  ``tests/test_torch_training.py`` gives them; ``no_frames`` with the
  prepend-IPA encoder raises ``ValueError`` (no rigids), and sampling it
  raises (the JAX package does not sample it either);
- ``atom37_to_atom14``, ``frames_torsions_to_atom37`` and
  ``prot_to_frames`` against JAX's.

Sizes: 2 layers, C = 96, 4 heads, T = 5, L = 4 with one padded residue,
B = 2, 3 Euler steps, f32. Tolerances: coordinates atol 1e-4 Angstrom and
transforms rtol 1e-4 / atol 1e-5 (``tests/test_torch_geometry.py``); atom14
after sampling 1e-3 Angstrom (``tests/test_torch_sampling.py``); the loss
rtol 1e-5 and each gradient max |port - JAX| <= 1e-4 x max(max |JAX|,
1e-2 x the largest gradient) (``tests/test_torch_training.py``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.geometry import frames as JG
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu.training.trainer import Trainer as JTrainer
from mdgen_finetune_tpu.transport.paths import expand_t as j_expand_t
from mdgen_finetune_tpu.transport.paths import get_path as j_get_path
from mdgen_finetune_tpu.transport.transport import mean_flat as j_mean_flat
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.training.trainer import featurize as t_featurize_cfg
from mdgen_finetune_tpu_torch.utils.weights import from_flax, randomize_, to_flax

B, T, L, C, H, NL, STEPS = 2, 5, 4, 96, 4, 2, 3
ATOL_ANGSTROM = 1e-4


def _close(t, j, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t.detach() if torch.is_tensor(t) else t),
                               np.asarray(j), rtol=rtol, atol=atol)


def _cfg(task, prepend_ipa=True):
    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=prepend_ipa,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(**task),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS))


@pytest.fixture(scope="module")
def structures():
    """Atom14 windows (B, T, L) built from random frames and torsions;
    residue 3 of element 1 is padding."""
    rng = np.random.default_rng(0)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    atom14 = TG.frames_torsions_to_atom14(
        TG.Rigid.from_tensor_7(torch.from_numpy(t7)), torch.from_numpy(tors),
        torch.from_numpy(aatype).long()[:, None].expand(B, T, L)).numpy()
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    tb = t_featurize(torch.from_numpy(atom14), torch.from_numpy(aatype).long(),
                     torch.from_numpy(mask))
    return dict(atom14=atom14, aatype=aatype, mask=mask, t7=t7, tors=tors, tb=tb, rng=rng,
                jb={k: jnp.asarray(v.numpy()) for k, v in tb.items()})


def test_prep_batch_no_offsets_doubled_matches_jax(structures):
    s = structures
    task = dict(tps_condition=True, no_offsets=True)
    tp = t_prep_batch(tcfg.MDGenConfig(task=tcfg.TaskConfig(**task)), s["tb"])
    jp = j_prep_batch(MDGenConfig(task=TaskConfig(**task)), s["jb"])
    assert tp["latents"].shape == (B, T, L, 28)
    _close(tp["latents"], jp["latents"], atol=ATOL_ANGSTROM)
    _close(tp["loss_mask"], jp["loss_mask"])
    _close(tp["model_kwargs"]["x_cond"], jp["model_kwargs"]["x_cond"], atol=ATOL_ANGSTROM)


def test_prep_batch_no_frames_matches_jax(structures):
    s = structures
    cfg = _cfg(dict(sim_condition=True, no_frames=True), prepend_ipa=False)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    batch = dict(atom14=s["atom14"], seqres=s["aatype"], mask=s["mask"])
    jf = JTrainer._featurize(types.SimpleNamespace(cfg=cfg),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    tf = t_featurize_cfg(tc, *(torch.from_numpy(batch[k]) for k in ("atom14", "seqres", "mask")))
    for k in ("atom37", "mask"):
        _close(tf[k], jf[k], atol=ATOL_ANGSTROM)
    jp, tp = j_prep_batch(cfg, jf), t_prep_batch(tc, tf)
    assert tp["latents"].shape == (B, T, L, 111) and "rigids" not in tp
    _close(tp["latents"], jp["latents"], atol=ATOL_ANGSTROM)
    _close(tp["loss_mask"], jp["loss_mask"])
    for k in ("mask", "aatype", "x_cond", "x_cond_mask"):
        _close(tp["model_kwargs"][k], jp["model_kwargs"][k], atol=ATOL_ANGSTROM)


def test_no_offsets_sample_matches_jax(structures):
    s = structures
    cfg = _cfg(dict(sim_condition=True, no_offsets=True))
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    model = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(1), scale=0.1)
    tree = to_flax(model.state_dict(), tc)
    zs0 = s["rng"].normal(size=(B, T, L, 21)).astype(np.float32)
    ref, _ = jax.jit(JEngine(cfg, tree)._sample_with_zs0)(tree, s["jb"], jnp.asarray(zs0))
    eng = TEngine(tc, model.state_dict(), device="cpu")
    out, _ = eng.sample_with_zs0(s["tb"], torch.from_numpy(zs0))
    assert eng.last_counts["evals"] == STEPS and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    # the decode takes the offsets as the frames: a latent of a frame's own
    # 7-tensor and torsions rebuilds that frame's atoms
    lat = torch.cat([torch.from_numpy(s["t7"]), torch.from_numpy(s["tors"]).reshape(B, T, L, 14)],
                    -1)
    atoms, _ = eng._decode(lat, None, torch.from_numpy(s["aatype"]).long())
    _close(atoms, s["atom14"], atol=ATOL_ANGSTROM)


@pytest.fixture(scope="module")
def no_frames():
    cfg = _cfg(dict(sim_condition=True, no_frames=True), prepend_ipa=False)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    trainer = Trainer(tc, device="cpu")
    trainer.init_state(0)
    params = jax.tree_util.tree_map(jnp.asarray, to_flax(
        randomize_(trainer.model, torch.Generator().manual_seed(2), scale=0.1).state_dict(), tc))
    return dict(cfg=cfg, tc=tc, trainer=trainer, params=params)


def test_no_frames_loss_and_grads_match_jax(structures, no_frames):
    s, nf = structures, no_frames
    cfg, trainer = nf["cfg"], nf["trainer"]
    rng = np.random.default_rng(3)
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    x0 = rng.normal(size=(B, T, L, 111)).astype(np.float32)
    batch = dict(atom14=s["atom14"], seqres=s["aatype"], mask=s["mask"])
    jm = JModel(cfg, cfg.latent_dim)

    @jax.jit
    def loss_and_grads(params, b):
        prep = j_prep_batch(cfg, JTrainer._featurize(types.SimpleNamespace(cfg=cfg), b))
        x1, tt = prep["latents"], jnp.asarray(t)
        xt, ut = j_get_path(cfg.transport.path_type).interpolate(j_expand_t(tt, x1),
                                                                 jnp.asarray(x0), x1)

        def loss(p):
            out = jm.apply(p, xt, tt, **prep["model_kwargs"])
            return jnp.mean(j_mean_flat((out - ut) ** 2, prep["loss_mask"]))

        return jax.value_and_grad(loss)(params)

    ref_loss, ref_grads = loss_and_grads(nf["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _ = trainer._loss_fn(batch, t=torch.from_numpy(t), x0=torch.from_numpy(x0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = from_flax(jax.tree_util.tree_map(np.asarray, ref_grads), trainer.cfg)
    got = {k: p.grad for k, p in trainer.model.named_parameters()}
    trainer.model.zero_grad(set_to_none=True)
    assert set(got) == set(ref) and got["latent_to_emb.weight"].shape == (C, 111)
    floor = 1e-2 * max(np.abs(r.numpy()).max() for r in ref.values())
    bad = [(k, float(np.abs(g.numpy() - ref[k].numpy()).max())) for k, g in got.items()
           if not np.abs(g.numpy() - ref[k].numpy()).max()
           <= 1e-4 * max(np.abs(ref[k].numpy()).max(), floor)]
    assert not bad, bad


def test_no_frames_refusals(no_frames):
    tc = no_frames["tc"]
    with pytest.raises(ValueError, match="no rigids"):
        LatentMDGen(dataclasses.replace(tc, model=dataclasses.replace(tc.model, prepend_ipa=True)))
    eng = TEngine(tc, no_frames["trainer"].model.state_dict(), device="cpu")
    with pytest.raises(NotImplementedError, match="JAX package does not sample it"):
        eng.sample({}, torch.Generator().manual_seed(0))


def test_geometry_helpers_match_jax(structures):
    s = structures
    aat = jnp.asarray(s["aatype"])
    j37 = JG.atom14_to_atom37(jnp.asarray(s["atom14"]), aat)
    t37 = TG.atom14_to_atom37(torch.from_numpy(s["atom14"]), torch.from_numpy(s["aatype"]))
    _close(TG.atom37_to_atom14(t37, torch.from_numpy(s["aatype"])),
           JG.atom37_to_atom14(j37, aat), atol=ATOL_ANGSTROM)
    _close(TG.atom37_to_atom14(t37, torch.from_numpy(s["aatype"])), s["atom14"],
           atol=ATOL_ANGSTROM)
    aat3 = np.broadcast_to(s["aatype"][:, None], (B, T, L))
    jf = JRigid.from_tensor_7(jnp.asarray(s["t7"]))
    tf = TG.Rigid.from_tensor_7(torch.from_numpy(s["t7"]))
    _close(TG.frames_torsions_to_atom37(tf, torch.from_numpy(s["tors"]),
                                        torch.from_numpy(aat3.copy())),
           JG.frames_torsions_to_atom37(jf, jnp.asarray(s["tors"]), jnp.asarray(aat3)),
           atol=ATOL_ANGSTROM)
    a = s["atom14"]
    ca, c, n = a[..., 1, :], a[..., 2, :], a[..., 0, :]
    tp, jp = TG.prot_to_frames(ca, c, n), JG.prot_to_frames(ca, c, n)
    _close(tp.rot, jp.rot)
    _close(tp.trans, jp.trans, atol=ATOL_ANGSTROM)
    _close(tp.rot, TG.atom14_to_frames(torch.from_numpy(a)).rot)
