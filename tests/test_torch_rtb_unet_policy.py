"""PyTorch port, an RTB loss with a ``UNet3DSeq`` posterior held against
the JAX package on the CPU (``rtb/trainer.py``'s ``policy=`` /
``policy_params=`` / ``lora_targets=``, on the tiny config of
``tests/test_rtb_e2e.py``): the same adapter keys, every adapter gradient
of the RTB loss and, at b = 0, the posterior equal to the prior bit for
bit. The UNets themselves are held to flax in
``test_torch_rtb_denoisers.py``.

The UNet's every parameter leaf, the zero-initialised heads included, is
drawn from numpy (N(0, 0.2^2)) in the port's layout and handed to JAX by
``unet_to_flax``. JAX's draws are rebuilt from its keys and handed to the
port. Tolerances: the RTB loss and logZ's gradient 1e-4 relative (they
square and average a difference of two f32 log-prob sums near -2.5e3, whose
ulp is 2.4e-4), pf_divergence 1e-4, every adapter gradient 1e-3 relative L2
(as ``test_torch_rtb.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TrainConfig, TransportConfig)
from mdgen_finetune_tpu.rtb import denoisers as JD
from mdgen_finetune_tpu.rtb.priors import MDGenSimulator as JSim
from mdgen_finetune_tpu.rtb.trainer import RTBConfig as JConfig
from mdgen_finetune_tpu.rtb.trainer import RTBTrainer as JTrainer
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.rtb import denoisers as TD
from mdgen_finetune_tpu_torch.rtb.priors import MDGenSimulator as TSim
from mdgen_finetune_tpu_torch.rtb.trainer import RTBConfig as TConfig
from mdgen_finetune_tpu_torch.rtb.trainer import RTBTrainer as TTrainer
from mdgen_finetune_tpu_torch.utils.weights import lora_from_flax, randomize_, to_flax, unet_to_flax


def close(got, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), rtol=tol, atol=tol)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


B, T, L, S, NT = 2, 6, 4, 3, 30
DIM = (T, L, 21)
RTB = dict(batch_size=B, sampling_length=S, num_train_timesteps=NT, lora_rank=4, lr=1e-3,
           learning_cutoff=0.0)
UNET = dict(out_dim=21, model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_head_channels=8)


def kernel_targets(p):
    return p.endswith("kernel")


@pytest.fixture(scope="module")
def rtb_unet(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rtb_unet"))
    split = make_synthetic_dataset(d, ["AGHK"], num_frames=16)
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        transport=TransportConfig(sampling_method="euler", inference_steps=3),
        data=DataConfig(data_dir=d, num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=B), workdir=d)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    sd = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(3), scale=0.15).state_dict()
    unet = TD.UNet3DSeq(**UNET)
    g = np.random.default_rng(21)  # every leaf drawn, the zero heads too
    usd = {k: torch.from_numpy((g.standard_normal(v.shape) * 0.2).astype(np.float32))
           for k, v in unet.state_dict().items()}
    utree = jax.tree.map(jnp.asarray, unet_to_flax(usd, unet))
    jtr = JTrainer(cfg, JConfig(**RTB), JSim(cfg, to_flax(sd, tc), split, batch_size=1),
                   lambda a, s: jnp.zeros(a.shape[0]), workdir=d, policy=JD.UNet3DSeq(**UNET),
                   policy_params=utree, lora_targets=kernel_targets)
    rng = np.random.default_rng(4)
    jtr.lora = {p: {"a": ab["a"], "b": jnp.asarray(0.3 * rng.standard_normal(ab["b"].shape),
                                                   jnp.float32)}
                for p, ab in jtr.lora.items()}
    ttr = TTrainer(tc, TConfig(**RTB), TSim(tc, sd, split, device="cpu"),
                   lambda a, s: torch.zeros(a.shape[0]), workdir=d, policy=unet,
                   policy_params=usd, lora_targets=kernel_targets)
    return dict(jtr=jtr, ttr=ttr)


def test_unet_policy_adapters_match_jax(rtb_unet):
    jtr, ttr = rtb_unet["jtr"], rtb_unet["ttr"]
    assert set(ttr.lora) == set(jtr.lora) and ttr.lora
    assert all("Conv" not in p and p.startswith("UNet2D_0/") for p in ttr.lora)
    for p, ab in jtr.lora.items():
        for k in ("a", "b"):
            assert tuple(ttr.lora[p][k].shape) == ab[k].shape


def test_unet_policy_rtb_gradients_match_jax(rtb_unet):
    jtr, ttr = rtb_unet["jtr"], rtb_unet["ttr"]
    g = np.random.default_rng(5)
    cond = {"mask": g.integers(0, 2, (B, L)).astype(np.float32), "x_cond": g.normal(size=(B, L))}
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    tcond = {k: torch.from_numpy(v) for k, v in cond.items()}
    key = jax.random.key(12)
    logr = np.array([-3.0, 5.0], np.float32)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jtr._loss, has_aux=True), static_argnums=4)(
        {"lora": jtr.lora, "logZ": jnp.asarray(0.4)}, key, jcond, jnp.asarray(logr), B)

    with torch.no_grad():
        for p, ab in lora_from_flax(jtr.lora).items():
            for k in ("a", "b"):
                ttr.lora[p][k].copy_(ab[k])
        ttr.logZ.fill_(0.4)
    k_init, _, k_scan = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, *DIM)))
                      for k in jax.random.split(k_scan, S)])
    draws = dict(x_start=torch.from_numpy(np.array(jax.random.normal(k_init, (B, *DIM)))),
                 noise=torch.from_numpy(noise), detach_flags=np.zeros(S, bool))
    res = ttr.sampler.sample_fwd(None, ttr.posterior_context(), tcond, B, **draws)
    loss, aux = ttr.objective(res, torch.from_numpy(logr))
    loss.backward()
    # the loss squares a difference of two f32 sums near -2.5e3 (ulp 2.4e-4)
    close(loss, jloss, 1e-4)
    close(aux["pf_divergence"], jaux["pf_divergence"], 1e-4)
    params = ttr._trainables()
    for p, ab in jg["lora"].items():
        for k in ("a", "b"):
            err = rel_l2(params[f"lora/{p}/{k}"].grad, ab[k])
            assert err <= 1e-3, (p, k, err)
    close(params["logZ"].grad, jg["logZ"], 1e-4)  # the mean of the same difference
    for t in params.values():
        t.grad = None

    # b = 0: the posterior is the prior, bit for bit, under grad
    with torch.no_grad():
        for ab in ttr.lora.values():
            ab["b"].zero_()
    res = ttr.sampler.sample_fwd(None, ttr.posterior_context(), tcond, B, **draws)
    assert res["logpf_posterior"].requires_grad
    assert torch.equal(res["logpf_posterior"], res["logpf_prior"])
