"""PyTorch port: the model, data and task options that no other test held to
the JAX package, on the CPU.

- ``model.no_aa_emb`` and ``model.abs_time_emb``: the port's
  ``LatentMDGen`` (fused trunk, prepend-IPA, tiny widths: 2 layers, C = 48,
  2 heads, T = 6, L = 4, B = 2, one padded residue) against JAX
  ``LatentMDGen.apply`` after ``from_flax`` of the same seeded weights, on
  the same numpy batch and noise. f32 on both sides: rtol 1e-4, atol 5e-5
  (sums in other orders, as tests/test_torch_modular.py holds the modular
  layer). Without ``aatype_to_emb`` the sequence must not reach the output;
  with the frame table the output must differ from the model without it.
- ``data.frame_interval``, ``overfit``, ``overfit_peptide``,
  ``overfit_frame`` and ``copy_frames``: the port's
  ``MDGenDataset.sample`` against JAX's over one synthetic dataset, the
  same numpy generators: every field of every sample the same, bit for
  bit.
- ``task.supervise_all_torsions`` / ``supervise_no_torsions``: the port's
  ``prep_batch`` against JAX's on the same features: loss masks equal,
  latents and conditioning within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.data.dataset import MDGenDataset as JDataset
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset as TDataset
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset, synthesize_trajectory
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch

jax.config.update("jax_platforms", "cpu")

B, T, L, C, H, NL = 2, 6, 4, 48, 2, 2
RTOL, ATOL = 1e-4, 5e-5


def _port(cfg):
    return tcfg.MDGenConfig.from_json(cfg.to_json())


def _features(seed=0):
    """Featurized synthetic trajectories of "AAGG" and "GHKL" (the port's
    featurizer, held to JAX's by tests/test_torch_geometry.py), the second
    peptide's last residue padded."""
    atom14 = np.stack([synthesize_trajectory(s, T, seed=seed + i)
                       for i, s in enumerate(("AAGG", "GHKL"))]).astype(np.float32)
    seqres = np.stack([str_sequence_to_aatype(s) for s in ("AAGG", "GHKL")]).astype(np.int64)
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    return t_featurize(torch.from_numpy(atom14), torch.from_numpy(seqres), torch.from_numpy(mask))


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        a = rng.normal(size=v.shape).astype(np.float32)
        if "embedding" in name:
            return a * 0.5
        if "ipa_norm" in name and "scale" in name:
            return 1.0 + 0.05 * a
        return a * (0.1 if v.ndim == 2 else 0.05)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _velocities(option, seqres_of_second=None, jax_too=True):
    """(port, JAX or None) velocity of one seeded model with ``option`` set,
    and the port's model; ``seqres_of_second`` replaces the second
    sequence."""
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False,
                          **({option: True} if option else {})),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))
    feats = _features()
    if seqres_of_second is not None:
        feats["seqres"][1] = torch.as_tensor(seqres_of_second)
    jm = JModel(cfg, cfg.latent_dim)
    lat = cfg.latent_dim
    shapes = jax.eval_shape(
        jm.init, jax.random.key(0), jnp.zeros((B, T, L, lat)), jnp.ones((B,)),
        jnp.ones((B, T, L)), start_frames=JRigid.identity((B, L)),
        end_frames=JRigid.identity((B, L)), x_cond=jnp.zeros((B, T, L, lat)),
        x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.zeros((B, L), jnp.int32))
    params = jax.tree_util.tree_map(jnp.asarray, _random_tree(shapes, 3))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, L, lat)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    ref = None
    if jax_too:
        jkw = j_prep_batch(cfg, {k: jnp.asarray(v.numpy()) for k, v in feats.items()})
        ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                           **jkw["model_kwargs"]))
    tc = _port(cfg)
    model = TEngine(tc, jax.tree_util.tree_map(np.array, params), device="cpu").model
    tkw = t_prep_batch(tc, feats)["model_kwargs"]
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), tkw["mask"].float(),
                    start_frames=tkw["start_frames"], x_cond=tkw["x_cond"],
                    x_cond_mask=tkw["x_cond_mask"], aatype=tkw["aatype"])
    return out.numpy(), ref, model


def test_no_aa_emb_matches_jax():
    out, ref, model = _velocities("no_aa_emb")
    assert not any("aatype_to_emb" in k for k in model.state_dict())
    assert np.abs(ref).max() > 0.1  # the random weights reach the output
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    other, _, _ = _velocities("no_aa_emb", seqres_of_second=[5, 6, 7, 8], jax_too=False)
    np.testing.assert_array_equal(other, out)  # the sequence does not reach the output


def test_abs_time_emb_matches_jax():
    out, ref, model = _velocities("abs_time_emb")
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    without, _, _ = _velocities(None, jax_too=False)
    assert np.abs(without - out).max() > 1e-3  # the frame table is added


DATA_OPTIONS = {
    "frame_interval": dict(frame_interval=3),
    "overfit": dict(overfit=True),
    "overfit_peptide": dict(overfit_peptide="GHKL"),
    "overfit_frame": dict(overfit_frame=True),
    "copy_frames": dict(copy_frames=True),
}


@pytest.mark.parametrize("option", sorted(DATA_OPTIONS))
def test_dataset_sample_option_matches_jax(option, tmp_path):
    split = make_synthetic_dataset(str(tmp_path), ["AAGG", "GHKL", "MKTA"], num_frames=40,
                                   seed=1)
    cfg = MDGenConfig(data=DataConfig(data_dir=str(tmp_path), num_frames=5, crop=4,
                                      **DATA_OPTIONS[option]))
    jd, td = JDataset(cfg, split), TDataset(_port(cfg), split)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    samples = []
    for _ in range(6):
        a, b = jd.sample(jr), td.sample(tr)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
        samples.append(b)
    w = samples[0]["atom14"]
    if option == "copy_frames":
        assert all((s["atom14"] == s["atom14"][:1]).all() for s in samples)
    elif option == "overfit_frame":
        assert all(s["frame_start"] == 0 for s in samples)
    elif option in ("overfit", "overfit_peptide"):
        name = "AAGG" if option == "overfit" else "GHKL"
        assert all(s["name"] == name for s in samples)
    else:  # frame_interval: the window's frames are every third of the trajectory
        full = np.load(str(tmp_path / f"{samples[0]['name']}.npy")).astype(np.float32)
        s0 = samples[0]["frame_start"]
        np.testing.assert_array_equal(w, full[::3][s0:s0 + 5])


@pytest.mark.parametrize("option", ["default", "supervise_all_torsions", "supervise_no_torsions"])
def test_prep_batch_torsion_supervision_matches_jax(option):
    cfg = MDGenConfig(data=DataConfig(num_frames=T, crop=L),
                      task=TaskConfig(sim_condition=True,
                                      **({option: True} if option != "default" else {})))
    feats = _features(seed=2)
    got = t_prep_batch(_port(cfg), feats)
    want = j_prep_batch(cfg, {k: jnp.asarray(v.numpy()) for k, v in feats.items()})
    np.testing.assert_array_equal(got["loss_mask"].numpy(), np.asarray(want["loss_mask"]))
    np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want["latents"]), atol=1e-5)
    np.testing.assert_allclose(got["model_kwargs"]["x_cond"].numpy(),
                               np.asarray(want["model_kwargs"]["x_cond"]), atol=1e-5)
    tors = got["loss_mask"][..., 7:].numpy()
    if option == "supervise_all_torsions":
        assert (tors == 1).all()
    elif option == "supervise_no_torsions":
        assert (tors == 0).all()
    else:
        assert 0 < tors.mean() < 1  # the featurizer's torsion mask
