"""PyTorch port, the routes of the trunk layer's backward
(``MDGEN_FUSED_BWD``), the micro-op probe's plain ops and the IPA widths,
held against the JAX package on the CPU:

- ``merged``: the port's ``fused_layer_bwd`` against the JAX package's merged
  whole-layer backward (``_kmerged``, interpret mode), both in bf16 and held
  to the f32 truth under the rule of ``tests/test_fused_layer_bwd.py``
  (error <= 2 x the XLA-bf16 error + 0.01 per gradient), B = 2, T = 12,
  L = 4, C = 192, 8 heads; on the CPU the merged route is the split route
  bit for bit, and one ``Trainer.train_step`` gives the default's loss and
  gradient norm;
- ``xla``: the JAX package's escape hatch (``jax.vjp`` of its plain layer)
  against the port's plain composition, the split route on CPU tensors (the
  port has no ``xla`` route: the value raises), at that test file's shape
  (B = 2, T = 8, L = 4, C = 128, 8 heads), in f32 and within 1e-5 of each
  gradient's largest magnitude (the JAX test's 1e-5, taken relative: the two
  frameworks sum in other orders, ~1.4e-6 of the scale here, where its own
  test compares one framework with itself);
- the probe's plain ops (``tools/micro_ops.OPS``) against the JAX probe's
  ``build_ops()`` (``tools/micro_ops.py``, loaded by path) for every op that
  the JAX probe computes outside a kernel (all but ``roll_pair``, whose
  ``pltpu.roll`` runs only inside one, and the three dots whose weight does
  not reshape, which the JAX probe reports as failed), at k = 0 and 3;
- the prepend-IPA encoder at IPA widths other than the model's, at L = 72
  (the key-tiled kernel's range), against ``encoder_xla``: rtol 1e-4 and
  1e-4 of the output's scale, f32 both sides.

The kernels against these plain versions on a card: test_torch_kernels_cuda.py.
"""
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdgen_finetune_tpu.ops.fused_layer_bwd as j_flb
from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.ops.fused_layer import _layer_xla, fused_layer
from mdgen_finetune_tpu.ops.ipa_encoder import encoder_xla
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.ops.fused_layer import LAYER_KEYS, trunk_layer
from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import fused_layer_bwd, layer_bwd_split
from mdgen_finetune_tpu_torch.ops.fused_layer_bwd_merged import _check, fused_layer_bwd_merged_plain
from mdgen_finetune_tpu_torch.ops.ipa_encoder import ipa_encoder
from mdgen_finetune_tpu_torch.tools import micro_ops as t_probe
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.weights import from_flax

NAMES = ["x", "mod", "wqkv_l", "bqkv_l", "wout_l", "bout_l", "wqkv_t", "bqkv_t", "wout_t",
         "bout_t", "w1", "b1", "w2", "b2", "bkl", "bvl", "bkt", "bvt"]
ROOT = Path(__file__).resolve().parent.parent


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _make(B, T, L, C, seed):
    """Inputs of tests/test_fused_layer_bwd.py's ``_make`` (same draws)."""
    rng = np.random.default_rng(seed)
    shapes = dict(x=(B, T * L, C), mod=(B, 9 * C), wqkv_l=(C, 3 * C), bqkv_l=(3 * C,),
                  wout_l=(C, C), bout_l=(C,), wqkv_t=(C, 3 * C), bqkv_t=(3 * C,),
                  wout_t=(C, C), bout_t=(C,), w1=(C, 4 * C), b1=(4 * C,),
                  w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,), bkt=(C,), bvt=(C,))
    vals = {k: (rng.normal(size=shapes[k]) * (C ** -0.5 if k.startswith("w") else 0.4))
            .astype(np.float32) for k in NAMES}
    mask = np.ones((B, T, L), np.float32)
    mask[:, -2:, -1] = 0.0
    w_out = rng.normal(size=(B, T * L, C)).astype(np.float32)
    return vals, mask, w_out


def _jax_grads(vals, mask, w_out, H, T, L, dtype, which):
    vs = [jnp.asarray(vals[k], dtype) for k in NAMES]

    def loss(*vv):
        if which == "pallas":
            out = fused_layer(*vv, jnp.asarray(mask), num_heads=H, tl=(T, L), force_pallas=True)
        else:
            out = _layer_xla(*vv, jnp.asarray(mask), H, T, L)
        return jnp.sum(out.astype(jnp.float32) * w_out)

    return dict(zip(NAMES, jax.jit(jax.grad(loss, argnums=tuple(range(18))))(*vs)))


def _port_grads(vals, mask, w_out, H, T, L, dtype, bwd=fused_layer_bwd):
    B, _, C = vals["x"].shape
    x = _t(vals["x"].reshape(-1, C), dtype)
    mod = _t(vals["mod"], dtype)
    w = {k: _t(vals[k], dtype) for k in LAYER_KEYS}
    mk = _t(mask)
    x1, x2, _ = trunk_layer(x, mod, w, mk, B=B, T=T, L=L, num_heads=H)
    dx, dmod, dw = bwd(x, x1, x2, _t(w_out.reshape(-1, C)), mod, w, mk, H)
    return dict(x=dx.reshape(B, T * L, C), mod=dmod, **dw)


def test_merged_route_held_to_f32_truth_with_jax_merged(monkeypatch):
    B, T, L, C, H = 2, 12, 4, 192, 8
    vals, mask, w_out = _make(B, T, L, C, seed=7)
    truth = _jax_grads(vals, mask, w_out, H, T, L, jnp.float32, "xla")
    xla = _jax_grads(vals, mask, w_out, H, T, L, jnp.bfloat16, "xla")
    calls, kernel = [], j_flb._kmerged

    def kmerged(*a, **k):
        calls.append(1)
        return kernel(*a, **k)

    monkeypatch.setattr(j_flb, "_kmerged", kmerged)
    monkeypatch.setenv("MDGEN_FUSED_BWD", "merged")
    jax.clear_caches()  # fused_layer_bwd reads the variable at trace time
    merged = _jax_grads(vals, mask, w_out, H, T, L, jnp.bfloat16, "pallas")
    port = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16)
    jax.clear_caches()
    assert calls, "the JAX package's merged kernel was not traced"
    for k in NAMES:
        gt = np.asarray(truth[k], np.float64)
        denom = max(np.abs(gt).max(), 1e-6)

        def err(g):
            return np.abs(np.asarray(g, np.float64) - gt).max() / denom

        e_xla = err(np.asarray(xla[k], np.float32))
        assert err(port[k].float().numpy()) <= 2.0 * e_xla + 0.01, (k, e_xla)
        assert err(np.asarray(merged[k], np.float32)) <= 2.0 * e_xla + 0.01, (k, e_xla)


def test_merged_route_is_the_split_route_on_the_cpu(monkeypatch):
    B, T, L, C, H = 2, 6, 4, 96, 4
    vals, mask, w_out = _make(B, T, L, C, seed=11)
    split = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16, bwd=layer_bwd_split)
    plain = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16,
                        bwd=fused_layer_bwd_merged_plain)
    monkeypatch.setenv("MDGEN_FUSED_BWD", "merged")
    merged = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16)
    monkeypatch.delenv("MDGEN_FUSED_BWD")
    default = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16)
    for k in NAMES:
        for got in (plain, merged, default):
            assert torch.equal(got[k], split[k]), k


def test_plain_layer_bwd_matches_jax_xla_hatch(monkeypatch):
    B, T, L, C, H = 2, 8, 4, 128, 8
    vals, mask, w_out = _make(B, T, L, C, seed=3)
    monkeypatch.setenv("MDGEN_FUSED_BWD", "xla")
    ref = _jax_grads(vals, mask, w_out, H, T, L, jnp.float32, "pallas")
    monkeypatch.delenv("MDGEN_FUSED_BWD")
    got = _port_grads(vals, mask, w_out, H, T, L, torch.float32, bwd=layer_bwd_split)
    for k in NAMES:
        r = np.asarray(ref[k], np.float32)
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)


def test_route_variable_and_merged_shapes():
    B, T, L, C, H = 2, 6, 4, 96, 4
    vals, mask, w_out = _make(B, T, L, C, seed=1)
    for route in ("merge", "xla"):
        os.environ["MDGEN_FUSED_BWD"] = route
        try:
            with pytest.raises(ValueError, match="MDGEN_FUSED_BWD"):
                _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16)
        finally:
            del os.environ["MDGEN_FUSED_BWD"]
    bf = torch.bfloat16
    w = {k: _t(vals[k], bf) for k in LAYER_KEYS}

    def args(Bc, Tc, Lc, Cc=C, Hc=H, wc=w):
        M = Bc * Tc * Lc
        x = torch.zeros(M, Cc, dtype=bf)
        return (x, x, x, torch.zeros(M, Cc), torch.zeros(Bc, 9 * Cc, dtype=bf), wc,
                torch.ones(Bc, Tc, Lc), Hc, None)

    assert _check(*args(B, T, L)) == (B, T, L, C, C // H)
    for bad in (args(1, 6, 12), args(1, 300, 4), args(2, 6, 4, Hc=2)):
        with pytest.raises(ValueError, match="fused_layer_bwd_merged"):
            _check(*bad)


def test_trainer_step_under_merged_matches_default(monkeypatch):
    cfg = tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=2, embed_dim=96, mha_heads=4, prepend_ipa=True,
                               abs_pos_emb=True),
        data=tcfg.DataConfig(num_frames=6, crop=4), task=tcfg.TaskConfig(sim_condition=True),
        train=tcfg.TrainConfig(batch_size=2))
    from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory
    from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype

    atom14 = np.stack([synthesize_trajectory(s, 6, seed=i) for i, s in enumerate(["AAGG", "GHKL"])])
    batch = dict(atom14=torch.from_numpy(atom14.astype(np.float32)),
                 seqres=torch.from_numpy(np.stack([str_sequence_to_aatype(s)
                                                   for s in ("AAGG", "GHKL")]).astype(np.int64)),
                 mask=torch.ones(2, 4))
    out = {}
    for route in ("", "merged"):
        monkeypatch.setenv("MDGEN_FUSED_BWD", route)
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(0)
        _, m = trainer.train_step(state, batch, torch.Generator().manual_seed(4))
        out[route] = (m["loss"].item(), m["grad_norm"].item())
    assert out["merged"] == out[""]


# ---------------------------------------------------------------------------
# the micro-op probe's plain ops
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _jax_probe():
    spec = importlib.util.spec_from_file_location("jax_micro_ops", ROOT / "tools" / "micro_ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX probe's weight of these three does not reshape (the tool's note)
JAX_FAILS = ("dot_416x384x1536", "dot_832x384x1536", "dot_bf16out_416x384x1536")
# pltpu.roll has no evaluation rule outside a Pallas kernel: not plain jnp
JAX_KERNEL_ONLY = ("roll_pair_416x384",)


def test_probe_names_are_the_jax_probe_names():
    assert tuple(_jax_probe().build_ops()) == t_probe.NAMES


@pytest.mark.parametrize("name", [n for n in t_probe.NAMES
                                  if n not in JAX_FAILS + JAX_KERNEL_ONLY])
def test_probe_plain_op_matches_jax(name):
    jp = _jax_probe()
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(jp.R, jp.C)) * 0.1).astype(np.float32)
    y = (rng.normal(size=(jp.R, 4 * jp.C)) * 0.1).astype(np.float32)
    jx, jy = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    tx, ty = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    op = jp.build_ops()[name]
    for k in (0, 3):
        ref = np.asarray(op(jx, jy, k).astype(jnp.float32), np.float64)
        got = t_probe.OPS[name](tx, ty, k).double().numpy()
        assert got.shape == ref.shape, (got.shape, ref.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"{name} k={k}")


def test_probe_jax_fails_where_the_note_says():
    jp = _jax_probe()
    x = jnp.zeros((jp.R, jp.C), jnp.bfloat16)
    y = jnp.zeros((jp.R, 4 * jp.C), jnp.bfloat16)
    for name in JAX_FAILS:
        with pytest.raises(TypeError):
            jp.build_ops()[name](x, y, 0)


# ops moved to the wrong place: the plain sum cannot see them, the weighted
# sum must (k, x, y as in the probe's OPS)
_rot = t_probe._rot
MOVED = {
    "roll_pair_416x384": lambda x, y, k: (torch.roll(_rot(x, k).float(), 13, 1)
                                          + torch.roll(_rot(x, k).float(), 371, 1)),
    "lane_concat5_416x384": lambda x, y, k: torch.cat([x, _rot(x, k)] * 2 + [x], dim=1),
    "row_tile4_104x384": lambda x, y, k: torch.cat([_rot(x, k)[:t_probe.TP].roll(1, 0)] * 4),
    "mask_stack_16x104x512": lambda x, y, k: (
        _rot(y, k)[:t_probe.TP, :512][None]
        * t_probe._group_masks(32, 16, y.dtype, y.device).roll(1, 0)).reshape(16 * t_probe.TP, 512),
}


@pytest.mark.parametrize("name", sorted(MOVED))
def test_probe_check_sees_moved_elements(name):
    x, y = t_probe.inputs("cpu", seed=2, programs=1)
    ref, mag = t_probe.micro_ops_plain(x, y, name, 2)
    t_probe.compare(name, ref.float(), ref, mag)  # the f32 result of the kernel passes
    moved, _ = t_probe.micro_ops_plain(x, y, name, 2, ops={name: MOVED[name]})
    assert (moved[:, 0] - ref[:, 0]).abs().max() <= t_probe.REL * mag[:, 0].min()
    with pytest.raises(AssertionError, match="weighted sum"):
        t_probe.compare(name, moved.float(), ref, mag)


# ---------------------------------------------------------------------------
# the prepend-IPA encoder at other IPA widths, L = 72
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(16, 4, 6), (8, 6, 2)])
def test_ipa_encoder_other_widths_at_L72(widths):
    Ch, Pq, Pv = widths
    B, T, L, C, Hm, Hi, NL = 2, 2, 72, 64, 4, 2, 1
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=Hm, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False, ipa_heads=Hi, ipa_head_dim=Ch,
                          ipa_qk=Pq, ipa_v=Pv),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tm = TModel(tc)
    jm = JModel(cfg, cfg.latent_dim)
    from mdgen_finetune_tpu_torch.utils.weights import randomize_, to_flax

    randomize_(tm, torch.Generator().manual_seed(5), scale=0.1)
    params = to_flax(tm.state_dict(), tc)
    tm.load_state_dict(from_flax(params, tc))
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(B, L, C)) * 0.5).astype(np.float32)
    t7 = rng.normal(size=(B, L, 7)).astype(np.float32)
    t7[..., 4:] *= 3.0
    mask = np.ones((B, L), np.float32)
    mask[0, 50:] = 0.0
    temb = rng.normal(size=(B, C)).astype(np.float32)
    jf = JRigid.from_tensor_7(jnp.asarray(t7))
    tf = TRigid(torch.from_numpy(np.array(jf.rot)), torch.from_numpy(np.array(jf.trans)))
    wmods, bmods, ws = jm.apply(params, method=jm.make_trunk_pack)[4]
    mods = jax.nn.silu(jnp.asarray(temb)) @ wmods + bmods
    lws = [tuple(w[i] for w in ws) for i in range(NL)]
    ref = encoder_xla(jnp.asarray(x), mods, lws, jf, jnp.asarray(mask), Hm, Hi, Ch, Pq, Pv,
                      jnp.float32)
    with torch.no_grad():
        tenc = tm.make_trunk_pack()["enc"]
        tmods = torch.nn.functional.silu(torch.from_numpy(temb)) @ tenc["wmods"] + tenc["bmods"]
        out = ipa_encoder(torch.from_numpy(x), tmods, tenc["layers"], tf, torch.from_numpy(mask),
                          num_heads_mha=Hm, Hi=Hi, Ch=Ch, Pq=Pq, Pv=Pv)
    # f32 both sides; at L = 72 the point logits reach ~1e2, whose f32
    # rounding moves an output by up to ~4e-5 of the largest (Pq = 6)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
