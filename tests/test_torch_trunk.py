"""PyTorch port, trunk (``ops/fused_layer.py::fused_trunk``) held against
the JAX package's trunk on the CPU, with one JAX model's weights carried
across by ``from_flax``:

- the plain twin against the JAX XLA twin (``fused_trunk`` -> ``_layer_xla``),
  with and without the folded output head;
- one whole Euler step (embed + trunk + head + update, ``flat_call``)
  against the Pallas kernel itself in interpret mode
  (``_trunk_call(..., interpret=True)`` with ``embed``, ``final``,
  ``step_dt``).

The CUDA kernels against their twins on a card: test_torch_kernels_cuda.py.

Sizes: 2 layers, C = 96 with 4 heads (head dim 24, as the flagship), T = 6
(not a multiple of the TPU's 8-row pad), L = 4, B = 2, one residue of one
element padded. Weights are seeded random (the init's zero AdaLN would make
the trunk the identity). Tolerance: rtol 1e-4 / atol 5e-5 on activations of
unit scale, f32 both sides (different summation orders, exp2 vs exp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.models.denoiser import flat_to_latent, latent_to_flat
from mdgen_finetune_tpu.ops import fused_layer as jfl
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.ops.fused_layer import fused_trunk
from mdgen_finetune_tpu_torch.utils.weights import from_flax

RTOL, ATOL = 1e-4, 5e-5
B, T, L, C, H, NL = 2, 6, 4, 96, 4, 2


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
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))
    jm = JModel(cfg, cfg.latent_dim)
    rng = np.random.default_rng(0)
    lat = cfg.latent_dim
    x = jnp.zeros((B, T, L, lat))
    fr = JRigid.identity((B, L))
    params = jax.jit(jm.init)(jax.random.key(0), x, jnp.ones((B,)), jnp.ones((B, T, L)),
                              start_frames=fr, end_frames=fr, x_cond=x,
                              x_cond_mask=jnp.zeros((B, T, L), jnp.int32),
                              aatype=jnp.zeros((B, L), jnp.int32))
    params = _random_tree(params, 1)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tm = TModel(tc)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tc))
    mask = np.ones((B, T, L), np.float32)
    mask[1, :, -1] = 0.0
    return dict(cfg=cfg, jm=jm, params=params, tm=tm, mask=mask, rng=rng)


def _np(t):
    return np.asarray(t, np.float32)


def _trunk_inputs(m, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, T, L, C)).astype(np.float32)
    mods = (rng.normal(size=(B, NL * 9 * C + 2 * C)) * 0.3).astype(np.float32)
    return h, mods


def test_trunk_twin_matches_jax_layer_chain(models):
    m = models
    h, mods = _trunk_inputs(m, 2)
    jpack = m["jm"].apply(m["params"], method=m["jm"].make_trunk_pack)
    Tp = -(-T // 8) * 8
    hp = jnp.pad(jnp.asarray(h).reshape(B, T, L * C), ((0, 0), (0, Tp - T), (0, 0)))
    jmods = jnp.asarray(mods[:, :NL * 9 * C])
    ref = jfl.fused_trunk(hp, jmods, jpack[2], jnp.asarray(m["mask"]), num_heads=H, tl=(T, L))
    ref = np.asarray(ref)[:, :T].reshape(B, T, L, C)
    with torch.no_grad():
        tpack = m["tm"].make_trunk_pack()
    out = fused_trunk(torch.from_numpy(h.copy()), torch.from_numpy(mods[:, :NL * 9 * C]),
                      tpack["layers"], torch.from_numpy(m["mask"]), num_heads=H)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)

    # with the folded FinalLayer head
    jfin = (jnp.asarray(mods[:, NL * 9 * C:]), *jpack[3])
    ref = jfl.fused_trunk(hp, jmods, jpack[2], jnp.asarray(m["mask"]), num_heads=H,
                          tl=(T, L), final=jfin)
    ref = flat_to_latent(ref, T, L, m["cfg"].latent_dim)
    out = fused_trunk(torch.from_numpy(h.copy()), torch.from_numpy(mods[:, :NL * 9 * C]),
                      tpack["layers"], torch.from_numpy(m["mask"]), num_heads=H,
                      final=(torch.from_numpy(mods[:, NL * 9 * C:]), *tpack["fin"]))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_euler_step_matches_pallas_trunk_kernel(models):
    """One flat Euler step of the port (embed, trunk, head, x + dt*v) against
    the JAX package's streaming trunk kernel run in interpret mode with the
    same folds (embed, final, step_dt) and against its XLA twin."""
    m = models
    jm, params, cfg = m["jm"], m["params"], m["cfg"]
    rng = np.random.default_rng(3)
    lat = cfg.latent_dim
    P = -(-lat // 128) * 128
    zs = rng.normal(size=(B, T, L, lat)).astype(np.float32)
    x_cond = np.where(np.arange(T)[None, :, None, None] == 0, zs, 0.0).astype(np.float32)
    x_cond_mask = np.zeros((B, T, L), np.int32)
    x_cond_mask[:, 0] = 1
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    enc = (rng.normal(size=(B, L, C)) * 0.5).astype(np.float32)
    t, dt = 0.3, 1.0 / 3
    mask = jnp.asarray(m["mask"])

    pack = jm.apply(params, method=jm.make_trunk_pack)
    consts = jm.apply(params, jnp.asarray(x_cond), jnp.asarray(x_cond_mask), mask,
                      aatype=jnp.asarray(aatype), method=jm.make_scan_consts)
    temb = jm.apply(params, jnp.full((B,), t, jnp.float32), method=jm.embed_times)
    mods_all = jax.nn.silu(temb) @ pack[0] + pack[1]
    mods, modf = mods_all[:, :NL * 9 * C], mods_all[:, NL * 9 * C:]
    xf = latent_to_flat(jnp.asarray(zs), P)
    args = (xf, mods, pack[2], mask)
    kw = dict(final=(modf, *pack[3]), embed=(consts[0], consts[1], jnp.asarray(enc).reshape(B, L * C)),
              step_dt=dt, biases=consts[2])
    ref_kernel = flat_to_latent(jfl._trunk_call(*args, H, T, L, interpret=True, **kw), T, L, lat)
    ref_xla = flat_to_latent(jfl.fused_trunk(*args, num_heads=H, tl=(T, L), **kw), T, L, lat)

    tm = m["tm"]
    with torch.no_grad():
        tpack = tm.make_trunk_pack()
    tconsts = tm.make_scan_consts(torch.from_numpy(x_cond), torch.from_numpy(x_cond_mask),
                                  torch.from_numpy(m["mask"]), aatype=torch.from_numpy(aatype))
    tmods = tm.embed_mods(tm.embed_times(torch.full((1,), t)), tpack)
    xc = torch.from_numpy(zs.copy())
    tm.flat_call(xc, torch.from_numpy(m["mask"]), tconsts, tpack, dt,
                 enc=torch.from_numpy(enc), mods=tmods)
    np.testing.assert_allclose(xc.numpy(), _np(ref_xla), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xc.numpy(), _np(ref_kernel), rtol=RTOL, atol=ATOL)
