"""PyTorch port, prepend-IPA encoder (``ops/ipa_encoder.py::ipa_encoder``)
and IPA (``models/ipa.py::ipa_forward``) held against the JAX package on the
CPU, with one JAX model's weights carried across by ``from_flax``:

- ``ipa_forward`` against the JAX ``ipa_forward``;
- the encoder's plain twin against ``encoder_xla`` and against the Pallas
  encoder kernel in interpret mode (``_encoder_pallas``).

``ipa_attention`` against its plain twin on a card: test_torch_kernels_cuda.py.

Sizes: 2 layers, C = 96, 4 MHA heads (head dim 24), IPA 4 heads x 32 with
8/8 points, L = 4, B = 2 with one padded residue (the IPA square mask and
the MHA key bias). Seeded random weights of scale 0.05-0.1. Tolerance:
rtol 1e-4 / atol 5e-5, f32 both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.models.ipa import ipa_forward as j_ipa_forward
from mdgen_finetune_tpu.ops.ipa_encoder import _encoder_pallas, encoder_xla
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.models.ipa import ipa_forward as t_ipa_forward
from mdgen_finetune_tpu_torch.ops.ipa_encoder import ipa_encoder
from mdgen_finetune_tpu_torch.utils.weights import from_flax

RTOL, ATOL = 1e-4, 5e-5
B, T, L, C, Hm, NL = 2, 6, 4, 96, 4, 2
Hi, Ch, Pq, Pv = 4, 32, 8, 8


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
def models():
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=Hm, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))
    jm = JModel(cfg, cfg.latent_dim)
    x = jnp.zeros((B, T, L, cfg.latent_dim))
    fr = JRigid.identity((B, L))
    params = jax.jit(jm.init)(jax.random.key(0), x, jnp.ones((B,)), jnp.ones((B, T, L)),
                              start_frames=fr, end_frames=fr, x_cond=x,
                              x_cond_mask=jnp.zeros((B, T, L), jnp.int32),
                              aatype=jnp.zeros((B, L), jnp.int32))
    params = _random_tree(params, 4)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tm = TModel(tc)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tc))
    return dict(cfg=cfg, jm=jm, params=params, tm=tm)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, L, C)) * 0.5).astype(np.float32)
    t7 = rng.normal(size=(B, L, 7)).astype(np.float32)
    t7[..., 4:] *= 3.0
    mask = np.ones((B, L), np.float32)
    mask[0, -1] = 0.0
    temb = rng.normal(size=(B, C)).astype(np.float32)
    return x, t7, mask, temb


def _frames(t7):
    jf = JRigid.from_tensor_7(jnp.asarray(t7))
    return jf, TRigid(torch.from_numpy(np.array(jf.rot)), torch.from_numpy(np.array(jf.trans)))


def test_ipa_forward_matches_jax(models):
    m = models
    x, t7, mask, _ = _inputs(5)
    jf, tf = _frames(t7)
    p = m["params"]["params"]["ipa_layers_0"]["ipa"]
    ws = tuple(p[n][k] for n in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points")
               for k in ("kernel", "bias")) + (p["head_weights"],) \
        + (p["linear_out"]["kernel"], p["linear_out"]["bias"])
    ref = j_ipa_forward(jnp.asarray(x), jf, jnp.asarray(mask), ws, Hi, Ch, Pq, Pv, jnp.float32)
    out = t_ipa_forward(torch.from_numpy(x), tf, torch.from_numpy(mask), m["tm"].ipa_layers[0].ipa)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_encoder_matches_encoder_xla_and_pallas(models):
    m = models
    jm, params = m["jm"], m["params"]
    x, t7, mask, temb = _inputs(6)
    jf, tf = _frames(t7)
    wmods, bmods, ws = jm.apply(params, method=jm.make_trunk_pack)[4]
    mods = jax.nn.silu(jnp.asarray(temb)) @ wmods + bmods
    lws = [tuple(w[i] for w in ws) for i in range(NL)]
    ref_xla = encoder_xla(jnp.asarray(x), mods, lws, jf, jnp.asarray(mask),
                          Hm, Hi, Ch, Pq, Pv, jnp.float32)
    ref_kernel = _encoder_pallas(jnp.asarray(x), mods, ws, jf.rot, jf.trans, jnp.asarray(mask),
                                 Hm, Hi, Ch, Pq, Pv, True)

    with torch.no_grad():
        tenc = m["tm"].make_trunk_pack()["enc"]
    tmods = torch.nn.functional.silu(torch.from_numpy(temb)) @ tenc["wmods"] + tenc["bmods"]
    out = ipa_encoder(torch.from_numpy(x), tmods, tenc["layers"], tf, torch.from_numpy(mask),
                      num_heads_mha=Hm, Hi=Hi, Ch=Ch, Pq=Pq, Pv=Pv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), rtol=RTOL, atol=ATOL)
