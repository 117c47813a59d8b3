"""PyTorch port, the modular layer (``interleave_ipa``, ``hyena``,
``no_rope``) held against the JAX package on the CPU:

- the natural-softmax attention cores against the TPU kernels in interpret
  mode and their XLA twins: row 12 (``residue_attention._pallas_fwd``, the
  port's ``residue_attention`` over ``rope_attention``), row 11a
  (``time_attention._pallas_fwd``, the port's ``time_attention``), row 11b
  (``_pallas_fwd_blocked`` at T = 264 and, axes swapped, at L = 9: the
  port's ``tiled_attention_plain(base2=False)``) with a large-logit case,
  and row 11c (``_block_pallas_fwd``, the port's ``time_attention_block``
  short route, and ``_block_xla``) at L = 4, T = 100;
- ``MultiheadAttention`` (residue, frame and dense ``no_rope`` routes) and
  ``HyenaOperator`` against the JAX modules;
- the whole ``LatentMDGen`` velocity for each configuration after
  ``from_flax``, the Euler sample of ``interleave_ipa`` against
  ``_sample_with_zs0``, the weights round trip, each configuration
  training in the Trainer, and a ``dropout = 0.1`` model sampling as the
  same weights at ``dropout = 0`` and training with its masks.

Sizes: the cores as ``tests/test_residue_attention.py`` and
``tests/test_time_attention.py`` (B = 2, C = 32, 4 heads); the model 2
layers, C = 48, 2 heads (head dim 24, as the flagship), IPA 2 x 8 with 4 / 4
points, L = 4, T = 6, B = 2, the absolute position table on and one residue
masked (none for ``hyena``, which, like JAX and the reference, ignores the
mask). Inputs are seeded numpy, f32 on both sides. Tolerance: rtol 1e-4 /
atol 5e-5 on outputs of unit scale (the rule of
``tests/test_torch_long_t.py``); atom14 within 1e-3 Angstrom (the rule of
``tests/test_torch_sampling.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.models.attention import MultiheadAttention as JMHA
from mdgen_finetune_tpu.models.hyena import HyenaOperator as JHyena
from mdgen_finetune_tpu.ops import residue_attention as jra
from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.models.attention import MultiheadAttention as TMHA
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.models.hyena import HyenaOperator as THyena
from mdgen_finetune_tpu_torch.ops.residue_attention import (residue_attention,
                                                            residue_attention_plain)
from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention_plain
from mdgen_finetune_tpu_torch.ops.time_attention import (time_attention, time_attention_block,
                                                         time_attention_plain)
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.weights import from_flax, randomize_, to_flax

RTOL, ATOL = 1e-4, 5e-5
FLAGS = ("interleave_ipa", "hyena", "no_rope")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, ref, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **{"rtol": RTOL, "atol": ATOL, **kw})


def _core_inputs(B=2, T=10, L=4, C=32, seed=0, masked=False, q_scale=0.5):
    """q, k, v (B, T, L, C), bias_k / bias_v (C,) and the mask (B, T, L)
    with at least frame 0 and residue 0 valid."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, L, C)).astype(np.float32) * s
               for s in (q_scale, 0.5, 0.5))
    bk, bv = (rng.normal(size=C).astype(np.float32) * 0.1 for _ in range(2))
    mask = np.ones((B, T, L), np.float32)
    if masked:
        mask = rng.integers(0, 2, size=(B, T, L)).astype(np.float32)
        mask[:, 0] = 1.0
        mask[:, :, 0] = 1.0
    return q, k, v, bk, bv, mask


def _qkv(q, k, v):
    return _t(np.concatenate([q, k, v], -1))


@pytest.mark.parametrize("T,L,masked", [(10, 4, True), (16, 8, True)])
def test_residue_core_matches_row_12(T, L, masked):
    """Row 12: the pair-loop TPU kernel over L <= 8 (interpret mode) and its
    XLA twin; the port's core is ``rope_attention(base2=False)`` over the
    (B*T, L, 1) view."""
    q, k, v, bk, bv, mask = _core_inputs(T=T, L=L, masked=masked)
    jargs = [jnp.asarray(a) for a in (q, k, v, bk.reshape(1, 1, -1), bv.reshape(1, 1, -1), mask)]
    ref = jra._xla_impl(*jargs, 4)
    kern = jra._pallas_fwd(*jargs, 4, interpret=True)
    out = residue_attention_plain(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4)
    _close(out, ref)
    _close(out, kern)
    again = residue_attention(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4)
    np.testing.assert_array_equal(again.numpy(), out.numpy())


@pytest.mark.parametrize("T,masked", [(100, True), (300, False)])
def test_time_core_matches_row_11a(T, masked):
    """Row 11a (L <= 8, T <= 256: ``rope_attention``) and, at T = 300,
    the route above it: the port's ``time_attention`` against the TPU
    kernel ``_pallas_fwd`` in interpret mode and ``_xla_impl``."""
    q, k, v, bk, bv, mask = _core_inputs(T=T, L=3, masked=masked)
    jargs = [jnp.asarray(a) for a in (q, k, v, bk.reshape(1, 1, -1), bv.reshape(1, 1, -1),
                                      mask.transpose(0, 2, 1))]
    ref = jta._xla_impl(*jargs, 4)
    out = time_attention(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4)
    _close(out, ref)
    if T <= jta.MAX_T:
        _close(out, jta._pallas_fwd(*jargs, 4, interpret=True))
    np.testing.assert_array_equal(
        time_attention_plain(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4).numpy(),
        out.numpy())


@pytest.mark.parametrize("view,q_scale", [("frames_T264", 0.5), ("residues_L9", 0.5),
                                          ("frames_T264_large_logits", 60.0)])
def test_tiled_natural_matches_row_11b(view, q_scale):
    """Row 11b: ``tiled_attention_plain(base2=False)`` against the blocked
    TPU kernel ``_pallas_fwd_blocked`` (interpret mode) and ``_xla_impl``,
    at T = 264 over frames and at L = 9 over residues (JAX swaps the axes and
    runs the same kernel). In the large-logit case q is scaled so that the
    logits reach ~1e3: exp without its max would overflow f32 (above 88),
    so agreement shows the max is subtracted. There the weights are nearly
    one-hot and a logit's f32 rounding (~1e-4 at 1e3) moves an output by as
    much: atol 5e-4."""
    frames = view.startswith("frames")
    T, L = (264, 3) if frames else (5, 9)
    q, k, v, bk, bv, mask = _core_inputs(T=T, L=L, seed=2, masked=True, q_scale=q_scale)
    bkj, bvj = jnp.asarray(bk.reshape(1, 1, -1)), jnp.asarray(bv.reshape(1, 1, -1))
    if frames:
        jq = [jnp.asarray(a) for a in (q, k, v)]
        jmask = jnp.asarray(mask.transpose(0, 2, 1))
        ref = jta._xla_impl(*jq, bkj, bvj, jmask, 4)
        kern = jta._pallas_fwd_blocked(*jq, bkj, bvj, jmask, 4, interpret=True)
        out = tiled_attention_plain(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4,
                                    base2=False)
    else:
        jq = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
        jmask = jnp.asarray(mask)
        ref = jta._xla_impl(*jq, bkj, bvj, jmask, 4).transpose(0, 2, 1, 3)
        kern = jta._pallas_fwd_blocked(*jq, bkj, bvj, jmask, 4,
                                       interpret=True).transpose(0, 2, 1, 3)
        out = residue_attention(_qkv(q, k, v), _t(bk), _t(bv), _t(mask), num_heads=4)
    tol = dict(atol=5e-4) if q_scale > 1 else {}
    if q_scale > 1:
        logits = np.einsum("btld,bsld->blts", q, k)
        with np.errstate(over="ignore"):
            assert np.abs(logits).max() > 300 and np.isinf(np.exp(logits)).any()
    assert torch.isfinite(out).all()
    _close(out, ref, **tol)
    _close(out, kern, **tol)


def test_frame_block_short_route_matches_row_11c():
    """Row 11c: the port's ``time_attention_block`` short route (adaln_linear
    + rope_attention + adaln_linear) at L = 4, T = 100 against the whole-block
    TPU kernel ``_block_pallas_fwd`` (interpret mode) and ``_block_xla``;
    q columns carry head_dim**-0.5 * log2(e), as the fused trunk folds."""
    rng = np.random.default_rng(3)
    B, T, L, C, H = 2, 100, 4, 32, 4

    def r(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    x = r(B, T * L, C, sc=0.5)
    sh, sc_, g = r(B, C, sc=0.2), r(B, C, sc=0.2), r(B, C, sc=0.5)
    wqkv, bqkv, wout, bout = r(C, 3 * C, sc=0.1), r(3 * C, sc=0.05), r(C, C, sc=0.1), r(C, sc=0.05)
    bk, bv = r(C, sc=0.1), r(C, sc=0.1)
    mask = rng.integers(0, 2, size=(B, T, L)).astype(np.float32)
    mask[:, 0] = 1.0
    jm = jnp.asarray(mask.transpose(0, 2, 1))
    jargs = [jnp.asarray(a) for a in (x, sh, sc_, g, wqkv, bqkv, wout, bout)]
    jb = [jnp.asarray(bk.reshape(1, 1, C)), jnp.asarray(bv.reshape(1, 1, C))]
    ref = jta._block_xla(*jargs, *jb, jm, H, T, L)
    kern = jta._block_pallas_fwd(*jargs, *jb, jm, H, T, L, interpret=True)
    out = time_attention_block(_t(x.reshape(-1, C)), *map(_t, (sh, sc_, g, wqkv, bqkv, wout,
                                                                bout, bk, bv, mask)),
                               B=B, T=T, L=L, num_heads=H)
    _close(out.view(B, T * L, C), ref, atol=3e-5)
    _close(out.view(B, T * L, C), kern, atol=3e-5)


def _mha_pair(C, H, use_rope, x, seed):
    jm = JMHA(C, H, use_rope=use_rope)
    params = jm.init(jax.random.key(seed), jnp.asarray(x.reshape(-1, x.shape[-2], C)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                                    * (0.2 if a.ndim == 2 else 0.1), params)
    tm = TMHA(C, H, use_rope=use_rope)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.array, params),
                                 tcfg.MDGenConfig()), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("route", ["residue", "time", "no_rope"])
def test_multihead_attention_matches_jax_module(route):
    """The port's ``MultiheadAttention`` (fused qkv product with
    head_dim**-0.5 on q only, the core, the out-projection) against the JAX
    module's ``apply`` on the same weights: the factorized routes over
    (B, T*L, C) with ``tl`` and the dense route without RoPE on (S, N, C)."""
    B, T, L, C, H = 2, 6, 4, 48, 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T, L, C)).astype(np.float32)
    mask = np.ones((B, T, L), np.float32)
    mask[1, :, -1] = 0.0
    jm, params, tm = _mha_pair(C, H, route != "no_rope", x, 6)
    with torch.no_grad():
        if route == "no_rope":
            xs, ms = x.reshape(B * T, L, C), mask.reshape(B * T, L)
            ref = jm.apply(params, jnp.asarray(xs), mask=jnp.asarray(ms))
            out = tm(_t(xs), _t(ms))
        else:
            xs = x.reshape(B, T * L, C)
            jmask = mask.transpose(0, 2, 1) if route == "time" else mask
            ref = jm.apply(params, jnp.asarray(xs), mask=jnp.asarray(jmask), axis=route,
                           tl=(T, L))
            out = tm(_t(xs), _t(mask), axis=route, tl=(T, L))
    _close(out, ref)


def test_hyena_operator_matches_jax_module():
    """``HyenaOperator`` (in_proj, the short depthwise convolution, the
    implicit filter, two FFT long convolutions, out_proj) against the JAX
    module on the same random weights (every leaf redrawn, the positional
    features included)."""
    Bn, T, C = 3, 12, 16
    rng = np.random.default_rng(7)
    u = rng.normal(size=(Bn, T, C)).astype(np.float32)
    jm = JHyena(d_model=C, l_max=T, order=2, filter_order=16)
    params = jm.init(jax.random.key(0), jnp.asarray(u))
    params = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32)
                                    * 0.3, params)
    ref = jax.jit(jm.apply)(params, jnp.asarray(u))
    tm = THyena(C, l_max=T, order=2, filter_order=16)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.array, params),
                                 tcfg.MDGenConfig()), strict=True)
    with torch.no_grad():
        out = tm(_t(u))
    _close(out, ref)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
B, T, L, C, H, NL, STEPS = 2, 6, 4, 48, 2, 2, 3


def _random_tree(shapes, seed):
    """Seeded values for every leaf of the JAX model's parameter tree (its
    structure from ``jax.eval_shape`` of ``init``: nothing is compiled)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = jax.tree_util.keystr(path)
        a = rng.normal(size=v.shape).astype(np.float32)
        if "embedding" in name or "pos_z" in name:
            return a * 0.5
        if ("ipa_norm" in name and "scale" in name) or "freq" in name:
            return 1.0 + 0.05 * a
        return a * (0.1 if v.ndim == 2 else 0.05)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jcfg(flag, **model):
    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True,
                          use_bf16=False, **{flag: True}, **model),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS))


@pytest.fixture(scope="module", params=FLAGS)
def setup(request):
    flag = request.param
    cfg = _jcfg(flag)
    rng = np.random.default_rng(0)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    # the port's reconstruction and featurization (held to the JAX package's
    # by tests/test_torch_geometry.py): both sides take the same numpy batch
    atom14 = TG.frames_torsions_to_atom14(
        TRigid.from_tensor_7(torch.from_numpy(t7)), torch.from_numpy(tors),
        torch.from_numpy(np.broadcast_to(aatype[:, None], (B, T, L)).astype(np.int64))).numpy()
    mask = np.ones((B, L), np.float32)
    if flag != "hyena":
        mask[1, -1] = 0.0
    feats = t_featurize(torch.from_numpy(atom14), torch.from_numpy(aatype).long(),
                        torch.from_numpy(mask))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in feats.items()}
    engine = JEngine(cfg, None)
    shapes = jax.eval_shape(engine.model.init,
        jax.random.key(0), jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
        jnp.ones((B, T, L)), start_frames=JRigid.identity((B, L)),
        end_frames=JRigid.identity((B, L)), x_cond=jnp.zeros((B, T, L, cfg.latent_dim)),
        x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.asarray(aatype))
    params = jax.tree_util.tree_map(jnp.asarray, _random_tree(shapes, 2))
    engine.params = params
    tree = jax.tree_util.tree_map(np.array, params)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    tengine = TEngine(tc, tree, device="cpu")
    return dict(flag=flag, cfg=cfg, tc=tc, engine=engine, params=params, tree=tree,
                tengine=tengine, atom14=atom14, aatype=aatype, mask=mask, jbatch=jbatch,
                rng=rng)


def _tbatch(s):
    return t_featurize(torch.from_numpy(s["atom14"]), torch.from_numpy(s["aatype"]).long(),
                       torch.from_numpy(s["mask"]))


def test_velocity_matches_jax_call(setup):
    """``LatentMDGen`` (modular branch: embed, the encoder, 2 modular
    layers, the head) against JAX ``LatentMDGen.apply`` after ``from_flax``."""
    s = setup
    jkw = j_prep_batch(s["cfg"], s["jbatch"])["model_kwargs"]
    x = s["rng"].normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    t = np.array([0.25, 0.7], np.float32)
    ref = jax.jit(s["engine"].model.apply)(s["params"], jnp.asarray(x), jnp.asarray(t), **jkw)
    tkw = t_prep_batch(s["tc"], _tbatch(s))["model_kwargs"]
    model = s["tengine"].model
    assert model.modular or model.layer_ipa  # interleave_ipa: IPA, then the fused layer
    out = model(torch.from_numpy(x), torch.from_numpy(t), tkw["mask"].float(),
                start_frames=tkw["start_frames"], x_cond=tkw["x_cond"],
                x_cond_mask=tkw["x_cond_mask"], aatype=tkw["aatype"])
    assert np.abs(np.asarray(ref)).max() > 0.1  # the random weights reach the output
    _close(out, ref)


def test_weights_round_trip_and_training_refused(setup):
    """``from_flax`` loads the modular tree strictly (the layers' IPA and
    ``ipa_norm``, Hyena's ``mha_t`` tree) and ``to_flax`` maps it back bit
    for bit; the Trainer takes the configuration and trains the loaded
    weights: a finite loss whose gradient reaches every layer's weights
    (its values against JAX: ``tests/test_torch_modular_train.py``)."""
    s = setup
    sd = from_flax(s["tree"], s["tc"])
    assert set(sd) == set(TModel(s["tc"]).state_dict())
    back = to_flax(sd, s["tc"])
    flat_a = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path({"params": s["tree"]["params"]})}
    flat_b = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_a) == set(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=k)
    trainer = Trainer(s["tc"], device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(sd)
    feats = {k: torch.from_numpy(np.array(v)) for k, v in s["jbatch"].items()}
    feats["seqres"] = feats["seqres"].long()
    loss, _ = trainer._feature_loss(feats, torch.Generator().manual_seed(1))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in trainer.model.layers.named_parameters():
        if name.endswith("weight") and ".ipa_norm" not in name:
            assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("setup", ["interleave_ipa"], indirect=True)
def test_interleave_euler_sample_matches_jax_engine(setup):
    """``InferenceEngine.sample_with_zs0`` with Euler (3 steps) takes the
    generic ODE route for the modular branch, as JAX's ``_sample`` does
    (``flat_scan_ok`` is False): against ``_sample_with_zs0`` with the same
    prior latent."""
    s = setup
    zs0 = s["rng"].normal(size=(B, T, L, s["cfg"].latent_dim)).astype(np.float32)
    ref, _ = jax.jit(s["engine"]._sample_with_zs0)(s["params"], s["jbatch"], jnp.asarray(zs0))
    out, _ = s["tengine"].sample_with_zs0(_tbatch(s), torch.from_numpy(zs0))
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    assert s["tengine"].last_counts == {"accepted": STEPS, "rejected": 0, "evals": STEPS}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize("setup", ["interleave_ipa"], indirect=True)
def test_dropout_at_inference_samples_as_without(setup):
    """``dropout > 0`` builds and samples on the fused branch (JAX takes the
    fused trunk when not training, :270); its samples equal those of the
    same seeded random weights at ``dropout = 0``. The Trainer trains it on
    the modular branch with keep masks drawn from its generator (JAX :270
    with ``train=True``): a finite loss, and each layer's and encoder
    layer's masks drawn."""
    s = setup
    base = tcfg.MDGenConfig.from_json(_jcfg("interleave_ipa").to_json())
    base = base.replace(model=dataclasses.replace(base.model, interleave_ipa=False))
    drop = base.replace(model=dataclasses.replace(base.model, dropout=0.1))
    sd = randomize_(TModel(base), torch.Generator().manual_seed(3)).state_dict()
    zs0 = torch.from_numpy(s["rng"].normal(size=(B, T, L, base.latent_dim)).astype(np.float32))
    outs = [TEngine(c, sd, device="cpu").sample_with_zs0(_tbatch(s), zs0)[0] for c in (base, drop)]
    assert torch.equal(outs[0], outs[1])
    trainer = Trainer(drop, device="cpu")
    trainer.init_state(0)
    trainer.model.load_state_dict(sd)
    gen = torch.Generator().manual_seed(2)
    dropout = trainer.dropout_for(gen)
    loss, _ = trainer._loss_fn(dict(atom14=s["atom14"], seqres=s["aatype"], mask=s["mask"]),
                               gen, dropout=dropout)
    loss.backward()
    assert torch.isfinite(loss)
    assert {k.split("#")[0] for k in dropout.drawn} == {
        f"{p}_{i}/{m}" for i in range(NL) for p, m in
        (("layers", "mha_l"), ("layers", "mha_t"), ("ipa_layers", "ipa"), ("ipa_layers", "mha_l"))}
