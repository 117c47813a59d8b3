"""PyTorch port, the slice end to end on the CPU: the plain denoiser call and
``InferenceEngine.sample_with_zs0`` (flat Euler chain, decode to atom14)
held against the JAX package with the same weights (``from_flax``) and the
same numpy prior latent; rollout and the device rules of the entry points.

Sizes: 2 layers, C = 96, 4 heads (head dim 24), T = 6, L = 4 with one
padded residue, B = 2, 3 Euler steps, f32. Tolerances: velocity rtol 1e-4 /
atol 5e-5; atom14 1e-3 Angstrom (the latent differences of ~1e-5 pass
through quaternion normalisation and frame composition, scaled by
coordinates of ~10 Angstrom).
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

B, T, L, C, H, NL, STEPS = 2, 6, 4, 96, 4, 2, 3


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


@pytest.fixture(scope="module")
def setup():
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS))
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
    params = jax.jit(engine.model.init)(
        jax.random.key(0), jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
        jnp.ones((B, T, L)), start_frames=JRigid.identity((B, L)),
        end_frames=JRigid.identity((B, L)), x_cond=jnp.zeros((B, T, L, cfg.latent_dim)),
        x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.asarray(aatype))
    params = _random_tree(params, 2)
    engine.params = params
    tree = jax.tree_util.tree_map(np.asarray, params)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tengine = TEngine(tc, tree, device="cpu")
    return dict(cfg=cfg, tc=tc, engine=engine, params=params, tree=tree, tengine=tengine,
                atom14=atom14, aatype=aatype, mask=mask, jbatch=jbatch, rng=rng)


def _tbatch(s):
    return t_featurize(torch.from_numpy(s["atom14"]), torch.from_numpy(s["aatype"]).long(),
                       torch.from_numpy(s["mask"]))


def test_forward_matches_jax_call(setup):
    s = setup
    jm, params = s["engine"].model, s["params"]
    jkw = j_prep_batch(s["cfg"], s["jbatch"])["model_kwargs"]
    x = s["rng"].normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t), **jkw)
    tkw = t_prep_batch(s["tc"], _tbatch(s))["model_kwargs"]
    out = s["tengine"].model(torch.from_numpy(x), torch.from_numpy(t), tkw["mask"].float(),
                             start_frames=tkw["start_frames"], end_frames=tkw["end_frames"],
                             x_cond=tkw["x_cond"], x_cond_mask=tkw["x_cond_mask"],
                             aatype=tkw["aatype"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=5e-5)


def test_sample_with_zs0_matches_jax_engine(setup):
    s = setup
    zs0 = s["rng"].normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    eng = s["engine"]
    ref, _ = jax.jit(eng._sample_with_zs0)(s["params"], s["jbatch"], jnp.asarray(zs0))
    out, aa = s["tengine"].sample_with_zs0(_tbatch(s), torch.from_numpy(zs0))
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(aa.numpy(), np.broadcast_to(s["aatype"][:, None], (B, T, L)))


def test_rollout_on_cpu_keeps_ideal_bonds(setup):
    s = setup
    g = torch.Generator().manual_seed(7)
    traj = s["tengine"].rollout(s["atom14"][:, 0], s["aatype"], s["mask"], 2, g)
    assert traj.shape == (B, 2 * T, L, 14, 3) and np.isfinite(traj).all()
    valid = s["mask"].astype(bool)
    n_ca = np.linalg.norm(traj[..., 0, :] - traj[..., 1, :], axis=-1)[:, :, valid[0]]
    ca_c = np.linalg.norm(traj[..., 1, :] - traj[..., 2, :], axis=-1)[:, :, valid[0]]
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2


def test_entry_points_refuse_a_missing_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEngine(setup["tc"], setup["tree"])  # device defaults to "cuda"


@pytest.mark.parametrize("change", [dict(sampler="sde"), dict(no_frames=True)])
def test_unported_samplers_raise(setup, change):
    """The reverse-SDE sampler is accepted and an unknown sampler raises
    ``ValueError`` (as in JAX); the raw-coordinate task (``no_frames``,
    without the encoder, which it cannot feed) builds an engine but does not
    sample, as the JAX package does not (``tests/test_torch_sde.py`` holds
    the SDE sampler to JAX)."""
    tc = setup["tc"]
    if "sampler" in change:
        eng = TEngine(tc, setup["tree"], device="cpu", **change)
        assert eng.sampler == "sde"
        with pytest.raises(ValueError, match="unknown sampler"):
            TEngine(tc, setup["tree"], device="cpu", sampler="bogus")
        return
    tc = tc.replace(task=tcfg.TaskConfig(**{**tc.task.__dict__, **change}),
                    model=tcfg.ModelConfig(**{**tc.model.__dict__, "prepend_ipa": False}))
    from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen

    eng = TEngine(tc, LatentMDGen(tc).state_dict(), device="cpu")
    with pytest.raises(NotImplementedError, match="JAX package does not sample it"):
        eng.sample(_tbatch(setup), torch.Generator().manual_seed(0))
