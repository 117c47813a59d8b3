"""PyTorch port, the reverse-SDE sampler held against the JAX package on the
CPU:

- ``transport.sample_sde`` (Euler-Maruyama and Heun, each with the ``Mean``
  and the ``Euler`` last step) and ``Transport.make_sde_sampler``'s
  ``Tweedie`` last step against JAX's on an analytic velocity field, with
  the same noise: the test draws it as JAX does inside its scan,
  ``jax.random.split(key, num_steps)`` then ``jax.random.normal(k, shape)``;
- ``InferenceEngine(sampler="sde").sample_with_zs0`` against the JAX
  engine's ``_sample`` with the same weights (``to_flax``), the prior of
  ``k_prior`` and the noise of ``k_sde`` of ``jax.random.split(key)`` (JAX
  ``inference/sampling.py:133``): (Euler, Mean), (Heun, Euler) and
  (Euler, Tweedie);
- ``sim_inference --sde`` with ``--last_step Tweedie --diffusion_form
  sigma`` on the CPU, writing a PDB with ideal backbone bonds.

Sizes: 2 layers, C = 96, 4 heads, a prepend-IPA encoder, T = 5, L = 4 with
one padded residue, B = 2, 3 SDE steps, f32. Tolerances: the analytic
samplers rtol 1e-5 / atol 1e-5 (the first step multiplies by the SBDM
diffusion, ~1e3 at t = 1e-3); atom14 1e-3 Angstrom, as
``tests/test_torch_sampling.py``; bonds 1e-2 Angstrom of 1.458 / 1.522.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.transport import Transport as JTransport
from mdgen_finetune_tpu.transport.samplers import sample_sde as j_sample_sde
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry import protein as tprotein
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.transport import Transport as TTransport
from mdgen_finetune_tpu_torch.transport import sample_sde as t_sample_sde
from mdgen_finetune_tpu_torch.utils.weights import randomize_, to_flax

B, T, L, C, H, NL, STEPS = 2, 5, 4, 96, 4, 2, 3


def jax_noise(key, steps, shape):
    """The normals JAX's SDE scan draws: one per step from split(key, steps)."""
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                     for k in jax.random.split(key, steps)])


def _cfg(**transport):
    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(**transport))


def _analytic(xp):
    """A velocity that depends on x and t: v = 0.7 x + sin(3 t) (x + 1)."""
    def v(x, t):
        return 0.7 * x + xp.sin(3 * t)[:, None, None] * (x + 1)
    return v


@pytest.mark.parametrize("method, last_step", [("Euler", "Mean"), ("Euler", "Euler"),
                                               ("Heun", "Mean"), ("Heun", "Euler")])
def test_sample_sde_matches_jax(method, last_step):
    cfg = _cfg()
    jt, tt = JTransport(cfg), TTransport(tcfg.MDGenConfig.from_json(cfg.to_json()))
    x = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(np.float32)
    key = jax.random.key(1)
    kw = dict(t0=1e-3, t1=0.96, num_steps=6, method=method, last_step=last_step,
              last_step_size=0.04)

    def parts(tr, xp):
        v = _analytic(xp)
        return (tr.drift_fn(v), lambda x, te: tr.path.diffusion(x, te), tr.score_fn(v))

    ref = j_sample_sde(*parts(jt, jnp), key, jnp.asarray(x), **kw)
    noise = torch.from_numpy(jax_noise(key, 6, x.shape))
    got, counts = t_sample_sde(*parts(tt, torch), torch.from_numpy(x), noise=noise, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert counts["evals"] == 6 * (1 if method == "Euler" else 2) + 1


def test_tweedie_last_step_matches_jax():
    cfg = _cfg()
    opts = dict(num_steps=5, method="Euler", diffusion_form="sigma", diffusion_norm=0.5,
                last_step="Tweedie", last_step_size=0.04)
    jt, tt = JTransport(cfg), TTransport(tcfg.MDGenConfig.from_json(cfg.to_json()))
    x = np.random.default_rng(2).normal(size=(2, 3, 4)).astype(np.float32)
    key = jax.random.key(3)
    ref = jt.make_sde_sampler(_analytic(jnp), **opts)(key, jnp.asarray(x))
    got, counts = tt.make_sde_sampler(_analytic(torch), **opts)(
        torch.from_numpy(x), noise=torch.from_numpy(jax_noise(key, 5, x.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert counts["evals"] == 5 + 1


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg(sampling_method="euler", inference_steps=STEPS)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    model = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(4), scale=0.1)
    tree = to_flax(model.state_dict(), tc)
    rng = np.random.default_rng(5)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    atom14 = TG.frames_torsions_to_atom14(TRigid.from_tensor_7(torch.from_numpy(t7)),
                                          torch.from_numpy(tors),
                                          torch.from_numpy(aatype).long()[:, None].expand(B, T, L))
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    tbatch = t_featurize(atom14, torch.from_numpy(aatype).long(), torch.from_numpy(mask))
    # both packages read the port's features: the first residue's degenerate
    # pre-omega torsion rounds differently in each featurizer
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    return dict(cfg=cfg, tc=tc, tree=tree, sd=model.state_dict(), jbatch=jbatch,
                tbatch=tbatch, mask=mask)


@pytest.mark.parametrize("method, last_step", [("Euler", "Mean"), ("Heun", "Euler"),
                                               ("Euler", "Tweedie")])
def test_engine_sde_sample_matches_jax(setup, method, last_step):
    s = setup
    opts = dict(num_steps=STEPS, method=method, last_step=last_step, last_step_size=0.04)
    jeng = JEngine(s["cfg"], None, sampler="sde", sde_opts=opts)
    key = jax.random.key(6)
    ref, _ = jax.jit(jeng._sample)(s["tree"], s["jbatch"], key)
    k_prior, k_sde = jax.random.split(key)
    zs0 = np.asarray(jax.random.normal(jax.random.split(k_prior)[0], (B, T, L, 21)))
    noise = jax_noise(k_sde, STEPS, (B, T, L, 21))
    teng = TEngine(s["tc"], s["sd"], device="cpu", sampler="sde", sde_opts=opts)
    out, aa = teng.sample_with_zs0(s["tbatch"], torch.from_numpy(zs0),
                                   noise=torch.from_numpy(noise))
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    evals = STEPS * (2 if method == "Heun" else 1) + 1
    assert teng.last_counts == {"accepted": STEPS, "rejected": 0, "evals": evals}
    # two generators give two samples
    a, _ = teng.sample(s["tbatch"], torch.Generator().manual_seed(1))
    b, _ = teng.sample(s["tbatch"], torch.Generator().manual_seed(2))
    assert not torch.allclose(a, b)


def test_sim_inference_sde_tweedie_on_cpu(tmp_path, capsys):
    synth_data.main(["--outdir", str(tmp_path / "data"), "--peptides", "AAGG",
                     "--num_frames", "12", "--suffix", "_i100"])
    cfg = tcfg.preset_4aa_sim(
        model=tcfg.ModelConfig(num_layers=1, embed_dim=32, mha_heads=2, ipa_heads=2,
                               ipa_head_dim=8, ipa_qk=4, ipa_v=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        workdir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(1), scale=0.05)
    ckpt = trainer.save_checkpoint(state, str(tmp_path / "ckpt"))
    sim_inference.main(["--sim_ckpt", ckpt, "--data_dir", str(tmp_path / "data"),
                        "--split", str(tmp_path / "data" / "split.csv"),
                        "--out_dir", str(tmp_path / "out"), "--num_frames", "4",
                        "--num_rollouts", "1", "--suffix", "_i100", "--device", "cpu", "--sde",
                        "--sde_steps", "3", "--last_step", "Tweedie", "--diffusion_form", "sigma",
                        "--diffusion_norm", "0.5"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["name"] == "AAGG" and meta["frames"] == 4
    pdb = open(tmp_path / "out" / "AAGG.pdb").read()
    chunks = [c for c in pdb.split("ENDMDL") if "ATOM" in c]
    pos = np.stack([tprotein.from_pdb_string(c).atom_positions for c in chunks])
    assert pos.shape[:2] == (4, 4) and np.isfinite(pos).all()
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2
