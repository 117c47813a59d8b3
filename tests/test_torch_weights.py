"""PyTorch port, weights: ``from_flax`` maps a ``LatentMDGen.init`` tree of
the JAX package onto the port's parameters (every key, every shape, strict
load) and ``to_flax`` maps it back bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.utils.weights import from_flax, randomize_, to_flax


@pytest.fixture(scope="module")
def tree_and_cfg():
    B, T, L = 1, 3, 4
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=2, embed_dim=48, mha_heads=2, ipa_heads=2,
                          ipa_head_dim=8, ipa_qk=4, ipa_v=3, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))
    m = JModel(cfg, cfg.latent_dim)
    x = jnp.zeros((B, T, L, cfg.latent_dim))
    fr = JRigid.identity((B, L))
    params = jax.jit(m.init)(jax.random.key(3), x, jnp.ones((B,)), jnp.ones((B, T, L)),
                             start_frames=fr, end_frames=fr, x_cond=x,
                             x_cond_mask=jnp.zeros((B, T, L), jnp.int32),
                             aatype=jnp.zeros((B, L), jnp.int32))
    # distinct values everywhere, so a swapped or mis-split column shows
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda v: rng.normal(size=v.shape).astype(np.float32), params)
    return tree, tcfg.MDGenConfig.from_json(cfg.to_json())


def test_from_flax_loads_strictly_and_round_trips(tree_and_cfg):
    tree, cfg = tree_and_cfg
    sd = from_flax(tree, cfg)
    model = TModel(cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = to_flax(model.state_dict(), cfg)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(map(jax.tree_util.keystr, flat_a)) == set(map(jax.tree_util.keystr, flat_b))
    by_key = {jax.tree_util.keystr(k): v for k, v in flat_b.items()}
    for k, v in flat_a.items():
        np.testing.assert_array_equal(by_key[jax.tree_util.keystr(k)], v,
                                      err_msg=jax.tree_util.keystr(k))


def test_ipa_kv_split_matches_the_encoder_fold(tree_and_cfg):
    """The split of the fused kv projections equals the JAX package's
    fold_encoder_ws split (the kernel's weight order)."""
    from mdgen_finetune_tpu.ops.ipa_encoder import fold_encoder_ws

    tree, cfg = tree_and_cfg
    m = cfg.model
    sd = from_flax(tree, cfg)
    p = tree["params"]["ipa_layers_1"]
    ipa = p["ipa"]
    raw = (p["ipa_norm"]["scale"], p["ipa_norm"]["bias"],
           *[ipa[n][k] for n in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points")
             for k in ("kernel", "bias")], ipa["head_weights"],
           ipa["linear_out"]["kernel"], ipa["linear_out"]["bias"],
           *[p["mha_l"][n][k] for n in ("q_proj", "k_proj", "v_proj", "out_proj")
             for k in ("kernel", "bias")], p["mha_l"]["bias_k"], p["mha_l"]["bias_v"],
           p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"], p["fc2"]["bias"])
    folded = fold_encoder_ws(raw, m.mha_heads, m.ipa_heads, m.ipa_head_dim, m.ipa_qk,
                             m.ipa_v, jnp.float32)
    pre = "ipa_layers.1.ipa."
    for idx, name in ((4, "linear_k"), (6, "linear_v"), (10, "linear_k_points"),
                      (12, "linear_v_points")):
        np.testing.assert_array_equal(sd[pre + name + ".weight"].numpy().T, np.asarray(folded[idx]))
        np.testing.assert_array_equal(sd[pre + name + ".bias"].numpy(), np.asarray(folded[idx + 1]))


def test_randomize_is_seeded(tree_and_cfg):
    _, cfg = tree_and_cfg
    a = randomize_(TModel(cfg), torch.Generator().manual_seed(5))
    b = randomize_(TModel(cfg), torch.Generator().manual_seed(5))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.layers[0].adaLN.weight.abs().sum() > 0  # no zero-init left
