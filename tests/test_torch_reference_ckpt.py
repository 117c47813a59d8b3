"""Released MDGen checkpoints (``--torch_ckpt``) on the CPU: a Lightning-style
``.ckpt`` in the reference's names (``state_dict`` under ``model.``, the EMA
under ``ema.params``) and its ``config.json`` are written locally from a
seeded random init of the port (``utils.torch_compat.write_reference_checkpoint``,
the inverse of ``convert_state_dict``'s names), then loaded by both
packages' ``load_reference_checkpoint``; the two forwards agree. Models: a
prepend-IPA model of the transition-path task (its ``latent_to_emb_f`` /
``_r``) and a Hyena model, each with and without an EMA. Last,
``sim_inference --torch_ckpt`` samples from such a file.

Sizes: 2 layers, C = 32, 4 heads, a 2-head IPA of widths (8, 4, 4), T = 6,
L = 4, B = 2, f32. Tolerance: velocity rtol 1e-4 / atol 5e-5 (as
``tests/test_torch_sampling.py``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import MDGenConfig as JConfig
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.utils.torch_compat import (
    load_reference_checkpoint as j_load_reference_checkpoint)
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_string
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.utils.torch_compat import (load_reference_checkpoint,
                                                         write_reference_checkpoint)
from mdgen_finetune_tpu_torch.utils.weights import randomize_

B, T, L, C, H, NL = 2, 6, 4, 32, 4, 2
MODELS = {"prepend_ipa_tps": (dict(prepend_ipa=True, abs_pos_emb=True), dict(tps_condition=True)),
          "hyena": (dict(hyena=True), dict(sim_condition=True))}
_JITTED = {}


def _cfg(kind, method="euler", steps=2):
    model, task = MODELS[kind]
    return tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, ipa_heads=2,
                               ipa_head_dim=8, ipa_qk=4, ipa_v=4, use_bf16=False, **model),
        data=tcfg.DataConfig(num_frames=T, crop=L), task=tcfg.TaskConfig(**task),
        transport=tcfg.TransportConfig(sampling_method=method, inference_steps=steps))


def _write(tmp_path, cfg, seed, ema):
    """A reference .ckpt of seeded random weights (EMA: half of them) and
    its config.json beside it."""
    sd = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(seed), scale=0.1).state_dict()
    path = tmp_path / "model.ckpt"
    write_reference_checkpoint(str(path), sd, cfg,
                               ema={k: 0.5 * v for k, v in sd.items()} if ema else None,
                               hparams={"args": {"num_layers": NL}})
    (tmp_path / "config.json").write_text(cfg.to_json())
    return path, sd


@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
@pytest.mark.parametrize("kind", list(MODELS))
def test_both_packages_load_the_same_model(tmp_path, kind, ema):
    cfg = _cfg(kind)
    path, sd = _write(tmp_path, cfg, seed=3, ema=ema)
    params, ema_sd, hparams = load_reference_checkpoint(str(path), cfg)
    jparams, jema, jhparams = j_load_reference_checkpoint(str(path))
    assert hparams == jhparams == {"args": {"num_layers": NL}}
    assert set(params) == set(sd) and all(torch.equal(params[k], sd[k]) for k in sd)
    assert (ema_sd is None) == (jema is None) == (not ema)
    use, juse = (ema_sd, jema) if ema else (params, jparams)
    if ema:
        assert all(torch.equal(use[k], 0.5 * sd[k]) for k in sd)

    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)
    t7 = rng.normal(size=(2, B, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    aatype = rng.integers(0, 20, size=(B, L))
    x_cond_mask = np.zeros((B, T, L), np.int32)
    x_cond_mask[:, 0] = 1
    x_cond = x * x_cond_mask[..., None]

    jcfg = JConfig.from_json(cfg.to_json())
    if kind not in _JITTED:
        _JITTED[kind] = jax.jit(JModel(jcfg, jcfg.latent_dim).apply)
    jframes = [JRigid.from_tensor_7(jnp.asarray(a)) for a in t7]
    ref = _JITTED[kind](juse, jnp.asarray(x), jnp.asarray(t), jnp.ones((B, T, L)),
                        start_frames=jframes[0], end_frames=jframes[1],
                        x_cond=jnp.asarray(x_cond), x_cond_mask=jnp.asarray(x_cond_mask),
                        aatype=jnp.asarray(aatype, jnp.int32))

    model = LatentMDGen(cfg)
    model.load_state_dict(use)
    frames = [Rigid.from_tensor_7(torch.from_numpy(a)) for a in t7]
    with torch.no_grad():
        out = model.forward_inference(
            torch.from_numpy(x), torch.from_numpy(t), torch.ones(B, T, L),
            start_frames=frames[0], end_frames=frames[1], x_cond=torch.from_numpy(x_cond),
            x_cond_mask=torch.from_numpy(x_cond_mask), aatype=torch.from_numpy(aatype))
    assert np.abs(np.asarray(ref)).max() > 0.1  # the random weights reach the output
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=5e-5)


def test_sim_inference_samples_from_a_reference_checkpoint(tmp_path, capsys):
    """``sim_inference --torch_ckpt`` with the config.json beside the file,
    on the CPU: one 6-frame window, parsed back with ideal bonds."""
    cfg = tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, ipa_heads=2,
                               ipa_head_dim=8, ipa_qk=4, ipa_v=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        data=tcfg.DataConfig(num_frames=T, crop=L, suffix="_i100"),
        task=tcfg.TaskConfig(sim_condition=True),
        transport=tcfg.TransportConfig(sampling_method="euler", inference_steps=2))
    path, _ = _write(tmp_path, cfg, seed=5, ema=True)
    data = tmp_path / "data"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", "20",
                     "--suffix", "_i100"])
    capsys.readouterr()
    sim_inference.main(["--torch_ckpt", str(path), "--data_dir", str(data), "--split",
                        str(data / "split.csv"), "--out_dir", str(tmp_path / "out"),
                        "--num_rollouts", "1", "--suffix", "_i100", "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["frames"] == T
    text = (tmp_path / "out" / "AAGG.pdb").read_text()
    pos = np.stack([from_pdb_string(c).atom_positions for c in text.split("ENDMDL") if "ATOM" in c])
    assert pos.shape[:2] == (T, L)  # (frames, residues, atom37, 3)
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    assert np.isfinite(pos).all()
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2
