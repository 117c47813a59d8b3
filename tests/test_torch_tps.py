"""PyTorch port, the transition-path task (``tps_condition``, the doubled
offsets) on the CPU, held against the JAX package with the same weights
(``from_flax``) and the same numpy inputs: ``prep_batch``, the denoiser's
``forward`` and ``forward_inference`` (the encoder's forward / reverse token
pair over the end / start frames), and ``InferenceEngine.sample_with_zs0``
on the flat Euler chain and on Heun with the same prior latent.

Sizes: 2 layers, C = 48, 2 heads (head dim 24), a 2-head IPA, T = 6, L = 4
with one padded residue, B = 2, 3 steps, f32. Tolerances: latents and
frames 1e-5; velocity rtol 1e-4 / atol 5e-5 (as ``test_torch_sampling.py``);
atom14 1e-3 Angstrom.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.geometry import frames as JG
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch

B, T, L, C, H, NL, STEPS = 2, 6, 4, 48, 2, 2, 3


def _random_tree(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        a = rng.normal(size=v.shape).astype(np.float32)
        if "embedding" in name:
            return a * 0.5
        if "ipa_norm" in name and "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.1 if v.ndim == 2 else 0.05)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _cfg(method="euler"):
    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, ipa_heads=2,
                          prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(tps_condition=True),
        transport=TransportConfig(sampling_method=method, inference_steps=STEPS))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    atom14 = np.array(JG.frames_torsions_to_atom14(
        JRigid.from_tensor_7(jnp.asarray(t7)), jnp.asarray(tors),
        jnp.asarray(np.broadcast_to(aatype[:, None], (B, T, L)))))
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    jbatch = j_featurize(jnp.asarray(atom14), jnp.asarray(aatype), jnp.asarray(mask))
    engine = JEngine(cfg, None)
    ident = JRigid.identity((B, L))
    params = jax.jit(engine.model.init)(
        jax.random.key(0), jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
        jnp.ones((B, T, L)), start_frames=ident, end_frames=ident,
        x_cond=jnp.zeros((B, T, L, cfg.latent_dim)),
        x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.asarray(aatype))
    params = _random_tree(params, 2)
    engine.params = params
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert "latent_to_emb_f" in tree["params"] and "latent_to_emb_r" in tree["params"]
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tengine = TEngine(tc, tree, device="cpu")
    return dict(cfg=cfg, tc=tc, engine=engine, params=params, tree=tree, tengine=tengine,
                atom14=atom14, aatype=aatype, mask=mask, jbatch=jbatch, rng=rng)


def _tbatch(s):
    return t_featurize(torch.from_numpy(s["atom14"]), torch.from_numpy(s["aatype"]).long(),
                       torch.from_numpy(s["mask"]))


def _kwargs(s):
    jkw = j_prep_batch(s["cfg"], s["jbatch"])["model_kwargs"]
    tkw = t_prep_batch(s["tc"], _tbatch(s))["model_kwargs"]
    return jkw, tkw


def test_prep_batch_matches_jax(setup):
    s = setup
    jp = j_prep_batch(s["cfg"], s["jbatch"])
    tp = t_prep_batch(s["tc"], _tbatch(s))
    assert tp["latents"].shape == (B, T, L, 28) and tp["loss_mask"].shape == (B, T, L, 28)
    for k in ("latents", "loss_mask"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)
    # the reverse offsets: frame T - 1 is the identity in itself, quaternion (1, 0, 0, 0)
    np.testing.assert_allclose(tp["latents"][:, -1, :, 7:14].numpy(),
                               np.broadcast_to([1, 0, 0, 0, 0, 0, 0], (B, L, 7)), atol=1e-5)
    jkw, tkw = jp["model_kwargs"], tp["model_kwargs"]
    for k in ("mask", "aatype", "x_cond", "x_cond_mask"):
        np.testing.assert_allclose(np.asarray(tkw[k], np.float32), np.asarray(jkw[k], np.float32),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tkw["x_cond_mask"][:, [0, -1]].numpy(), 1)
    np.testing.assert_array_equal(tkw["x_cond_mask"][:, 1:-1].numpy(), 0)
    for k in ("start_frames", "end_frames"):
        np.testing.assert_allclose(tkw[k].rot.numpy(), np.asarray(jkw[k].rot), atol=1e-5)
        np.testing.assert_allclose(tkw[k].trans.numpy(), np.asarray(jkw[k].trans), atol=1e-5)


@pytest.mark.parametrize("call", ["forward", "forward_inference"])
def test_velocity_matches_jax_call(setup, call):
    s = setup
    jm, params = s["engine"].model, s["params"]
    jkw, tkw = _kwargs(s)
    x = s["rng"].normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), **jkw)
    fn = getattr(s["tengine"].model, call)
    with torch.no_grad():
        out = fn(torch.from_numpy(x), torch.from_numpy(t), tkw["mask"].float(),
                 start_frames=tkw["start_frames"], end_frames=tkw["end_frames"],
                 x_cond=tkw["x_cond"], x_cond_mask=tkw["x_cond_mask"], aatype=tkw["aatype"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=5e-5)


def test_token_pair_in_one_call_equals_two_passes(setup):
    """``run_ipa`` encodes the pair as one call over 2 B elements; the sum
    equals x_r encoded over the start frames plus x_f over the end frames."""
    s = setup
    m = s["tengine"].model
    _, tkw = _kwargs(s)
    mask_l = tkw["mask"][:, 0].float()
    with torch.no_grad():
        pack = m.make_trunk_pack()
        tokens = m.make_encoder_tokens(mask_l, tkw["aatype"], tkw["start_frames"],
                                       tkw["end_frames"])
        t_emb = m.embed_times(torch.tensor([0.3, 0.8]))
        both = m.run_ipa(t_emb, mask_l, tkw["start_frames"], tkw["end_frames"], tokens, pack)
        x_f, x_r = tokens
        r = m.run_ipa(t_emb, mask_l, tkw["start_frames"], None, (x_r,), pack)
        f = m.run_ipa(t_emb, mask_l, tkw["end_frames"], None, (x_f,), pack)
        swapped = m.run_ipa(t_emb, mask_l, tkw["end_frames"], tkw["start_frames"], tokens, pack)
    np.testing.assert_allclose(both.numpy(), (r + f).numpy(), rtol=1e-5, atol=1e-5)
    assert (both - swapped).abs().max() > 1e-2  # the pairing is not symmetric


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_sample_with_zs0_matches_jax_engine(setup, method):
    s = setup
    zs0 = np.random.default_rng(5).normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    cfg = _cfg(method)
    eng = JEngine(cfg, s["params"])
    ref, _ = jax.jit(eng._sample_with_zs0)(s["params"], s["jbatch"], jnp.asarray(zs0))
    teng = TEngine(tcfg.MDGenConfig.from_json(cfg.to_json()), s["tree"], device="cpu")
    out, aa = teng.sample_with_zs0(_tbatch(s), torch.from_numpy(zs0))
    assert teng.last_counts["evals"] == STEPS * (1 if method == "euler" else 2)
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_decode_reads_torsions_after_the_reverse_offsets(setup):
    """With the doubled offsets the torsions are channels 14:28; putting
    garbage in the reverse offsets (7:14) leaves the decoded atoms as they
    are."""
    s = setup
    eng = s["tengine"]
    tp = t_prep_batch(s["tc"], _tbatch(s))
    lat = tp["latents"].clone()
    a, _ = eng._decode(lat, tp["rigids"], torch.from_numpy(s["aatype"]).long())
    lat[..., 7:14] = torch.randn(lat[..., 7:14].shape, generator=torch.Generator().manual_seed(1))
    b, _ = eng._decode(lat, tp["rigids"], torch.from_numpy(s["aatype"]).long())
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    valid = s["mask"].astype(bool)  # frame 0's backbone is the input's
    np.testing.assert_allclose(a[:, 0, :, :3].numpy()[valid], s["atom14"][:, 0, :, :3][valid],
                               atol=1e-3)


def test_training_the_tps_task_is_refused(setup):
    """Training TPS is no longer refused: ``Trainer`` builds and takes one
    finite step on the CPU (``test_torch_train_tasks.py`` holds the loss and
    every gradient to JAX)."""
    from mdgen_finetune_tpu_torch.training import Trainer

    s = setup
    tc = s["tc"]
    trainer = Trainer(tc, device="cpu")
    state = trainer.init_state(0)
    batch = dict(atom14=s["atom14"], seqres=s["aatype"], mask=s["mask"])
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and set(metrics) == {"loss", "t_mean", "grad_norm"}
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
