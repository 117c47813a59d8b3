"""PyTorch port, training the modular layer held against the JAX package on
the CPU: ``hyena``, ``no_rope``, ``interleave_ipa``, ``dropout = 0.1`` and
``interleave_ipa`` with dropout.

- the loss, its metrics and every parameter's gradient of the port's
  ``Trainer._feature_loss`` (the modular stages through
  ``ops/modular_stage.StageFn``, ``ResidueAttentionFn``, the dense route's
  ``FusedAttentionFn``, Hyena's FFT, ``interleave_ipa``'s ``IPABlockFn`` and
  ``FusedLayerFn``, the FinalLayer through ``FinalLayerFn``; with dropout
  the dense-probabilities path and the encoder's plain path) against
  ``jax.value_and_grad`` of the JAX package's own ``Trainer._loss_fn``
  with the same weights (``from_flax``), the same featurized batch and the
  same draws (t and x0 put in place of JAX's ``jax.random`` draws inside
  its transport, as ``test_torch_train_tasks.py`` does);
- dropout with the same keep masks on both sides: ``flax.linen.Dropout.
  __call__`` is replaced for the test by one that takes its keep mask from
  numpy, seeded by the module's path (``layers_0/mha_l#0``), and records
  it; the port gets the same dict through ``models.layers.Dropout(masks=)``;
- ``rope_attention_bwd_math(base2=False)`` against ``jax.vjp`` of JAX's
  ``residue_attention._xla_impl(base2=False)``, at unit logits and with q
  scaled 400x (logits ~1e3, where the max subtraction matters), and the
  natural route at N > 16 (``natural_long_bwd``) on the CPU;
- the velocity's VJP in x (the log-likelihood's step) against JAX's for
  ``hyena`` and ``interleave_ipa``.

``cli/train.py`` with each of the four flags: ``tests/test_torch_train_cli.py``.

Sizes: 1 layer, C = 48, 2 heads, a 2-head IPA of widths
(8, 4, 4), B = 2, T = 5, L = 4 with one padded residue, f32. Tolerances, as
``test_torch_train_tasks.py``: the loss and its metrics rtol 1e-5; each
gradient tensor max |port - JAX| <= 1e-4 x max(its max |JAX|, 1e-2 x the
largest gradient of the model); the attention backward 1e-4 x max(1, max
|JAX|); the VJP in x 1e-4 x max |JAX|.
"""
import types
import zlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdgen_finetune_tpu.transport.transport as jtransport
from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.ops import residue_attention as jra
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu.training.trainer import Trainer as JTrainer
from mdgen_finetune_tpu.transport import create_transport as j_create_transport
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.models.layers import Dropout
from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import (natural_long_bwd,
                                                             rope_attention_bwd_math)
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.weights import from_flax

GRAD_TOL, FLOOR = 1e-4, 1e-2
B, T, L = 2, 5, 4
RATE = 0.1
CASES = {
    "hyena": dict(hyena=True),
    "no_rope": dict(no_rope=True),
    "interleave_ipa": dict(interleave_ipa=True),
    "dropout": dict(dropout=RATE),
    "interleave_ipa_dropout": dict(interleave_ipa=True, dropout=RATE),
}


def _cfg(flags, layers=1):
    return MDGenConfig(
        model=ModelConfig(num_layers=layers, embed_dim=48, mha_heads=2, ipa_heads=2,
                          ipa_head_dim=8, ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True,
                          use_bf16=False, **flags),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True))


def _compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's lowest backend
    optimisation level: the same program in half the compile time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})


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
def data():
    """Two synthetic peptides, the second with its last residue padded; the
    raw batch and the JAX featurizer's output."""
    seqs = ["AAGG", "GHKL"]
    atom14 = np.stack([synthesize_trajectory(s, T, seed=i).astype(np.float32)
                       for i, s in enumerate(seqs)])
    seqres = np.stack([str_sequence_to_aatype(s) for s in seqs]).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    jfeats = jax.jit(j_featurize)(jnp.asarray(atom14), jnp.asarray(seqres), jnp.asarray(mask))
    return dict(batch=dict(atom14=atom14, seqres=seqres, mask=mask), jfeats=jfeats)


class _GivenDraws:
    """``jax`` as the JAX transport module sees it, with the uniform draw of
    t and the normal draw of x0 replaced by given arrays."""

    def __init__(self, t, x0):
        self.random = types.SimpleNamespace(
            split=jax.random.split, uniform=lambda key, shape, dtype: jnp.asarray(t),
            normal=lambda key, shape, dtype: jnp.asarray(x0))

    def __getattr__(self, name):
        return getattr(jax, name)


def _numpy_dropout(masks):
    """A ``flax.linen.Dropout.__call__`` whose keep mask comes from numpy,
    seeded by the module's path without its own name and the call count
    there, recorded in ``masks``."""

    def call(self, inputs, deterministic=None, rng=None):
        path = "/".join(self.scope.path[:-1])
        n = sum(k.startswith(path + "#") for k in masks)
        key = f"{path}#{n}"
        rng_np = np.random.default_rng(zlib.crc32(key.encode()))
        keep = rng_np.random(inputs.shape) < 1.0 - self.rate
        masks[key] = keep
        return jnp.where(keep, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    return call


def _tfeats(data):
    out = {k: torch.from_numpy(np.array(v)) for k, v in data["jfeats"].items()}
    out["seqres"] = out["seqres"].long()
    return out


@pytest.fixture(scope="module", params=list(CASES))
def case(request, data):
    """One flag set: the port's trainer with seeded random weights, the same
    weights' flax tree, the draws, the keep masks, and JAX's loss, metrics
    and gradients."""
    name = request.param
    cfg = _cfg(CASES[name])
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    trainer = Trainer(tc, device="cpu")
    trainer.init_state(0)
    jm = JModel(cfg, cfg.latent_dim)
    ident = JRigid.identity((B, L))
    kw = dict(start_frames=ident, end_frames=ident, x_cond=jnp.zeros((B, T, L, cfg.latent_dim)),
              x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.zeros((B, L), jnp.int32))
    shapes = jax.eval_shape(lambda *a: jm.init(*a, **kw), jax.random.key(0),
                            jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
                            jnp.ones((B, T, L)))
    params = _random_tree(shapes, 3)
    trainer.model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tc))

    rng = np.random.default_rng(7)
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    x0 = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    jt = JTrainer.__new__(JTrainer)  # its _loss_fn without a mesh
    jt.cfg, jt.model = cfg, jm
    jt.model_train = JModel(cfg, cfg.latent_dim, train=True) if cfg.model.dropout > 0 else jm
    jt.transport = j_create_transport(cfg)
    jt._featurize = lambda b: b  # handed the featurized batch
    masks = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtransport, "jax", _GivenDraws(t, x0))
        mp.setattr(fnn.Dropout, "__call__", _numpy_dropout(masks))
        args = (params, jax.random.key(0), data["jfeats"])
        (jloss, jmetrics), jgrads = _compiled(jax.value_and_grad(jt._loss_fn, has_aux=True),
                                              *args)(*args)
    if cfg.model.dropout > 0:
        assert masks, "the JAX model drew no dropout mask"
    return dict(name=name, cfg=cfg, tc=tc, trainer=trainer, t=t, x0=x0, params=params,
                masks={k: torch.from_numpy(v) for k, v in masks.items()},
                jloss=float(jloss), jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=from_flax(jax.tree_util.tree_map(np.asarray, jgrads), tc))


def test_loss_metrics_and_grads_match_jax(case, data):
    s = case
    trainer = s["trainer"]
    drop = Dropout(RATE, masks=s["masks"]) if s["cfg"].model.dropout > 0 else None
    loss, metrics = trainer._feature_loss(_tfeats(data), t=torch.from_numpy(s["t"]),
                                          x0=torch.from_numpy(s["x0"]), dropout=drop)
    loss.backward()
    if drop is not None:  # every JAX mask was used, and no other
        assert set(drop.drawn) == set(s["masks"])
    np.testing.assert_allclose(loss.item(), s["jloss"], rtol=1e-5)
    assert set(metrics) == set(s["jmetrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), s["jmetrics"][k], rtol=1e-5, err_msg=k)
    ref = s["jgrads"]
    got = {k: p.grad for k, p in trainer.model.named_parameters()}
    trainer.model.zero_grad(set_to_none=True)
    assert set(got) == set(ref)
    floor = FLOOR * max(np.abs(r.numpy()).max() for r in ref.values())
    bad = []
    for k, g in got.items():
        r = ref[k].numpy()
        scale = np.abs(r).max()
        if g is None:
            assert scale == 0.0, k
            continue
        err = np.abs(g.numpy() - r).max()
        if not err <= GRAD_TOL * max(scale, floor):
            bad.append((k, float(err), float(scale), float(floor)))
    assert not bad, bad


@pytest.mark.parametrize("q_scale", [1.0, 400.0])
def test_natural_rope_attention_bwd_matches_jax_vjp(q_scale):
    """The natural-softmax backward's plain twin against ``jax.vjp`` of
    ``residue_attention._xla_impl(base2=False)`` (the JAX ``_ra_bwd``),
    over (B*T, L, 1) at L = 4 with masked keys."""
    rng = np.random.default_rng(11)
    Bc, Tc, Lc, C, H = 2, 3, 4, 48, 2
    q, k, v = (rng.normal(size=(Bc, Tc, Lc, C)).astype(np.float32) for _ in range(3))
    q *= (C // H) ** -0.5 * q_scale
    bk, bv = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    kv = np.ones((Bc, Tc, Lc), np.float32)
    kv[1, :, -1] = 0.0
    kv[0, 2, 1:] = 0.0
    g = rng.normal(size=(Bc, Tc, Lc, C)).astype(np.float32)
    def vjp(args, gg):
        return jax.vjp(lambda *a: jra._xla_impl(*a, kv, H, base2=False), *args)[1](gg)

    args = (tuple(map(jnp.asarray, (q, k, v, bk, bv))), jnp.asarray(g))
    jdq, jdk, jdv, jdbk, jdbv = (np.asarray(a) for a in _compiled(vjp, *args)(*args))
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).view(Bc * Tc, Lc, 1, 3 * C)
    dqkv, dbk, dbv = rope_attention_bwd_math(
        qkv, torch.from_numpy(g).view(Bc * Tc, Lc, 1, C), torch.from_numpy(bk),
        torch.from_numpy(bv), torch.from_numpy(kv).view(Bc * Tc, Lc, 1), num_heads=H,
        base2=False)
    dqkv = dqkv.view(Bc, Tc, Lc, 3 * C).numpy()
    for got, ref in ((dqkv[..., :C], jdq), (dqkv[..., C:2 * C], jdk), (dqkv[..., 2 * C:], jdv),
                     (dbk.numpy(), jdbk.reshape(C)), (dbv.numpy(), jdbv.reshape(C))):
        assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_natural_long_route_matches_the_plain_math():
    """``natural_long_bwd`` (the N > 16 route through ``fused_attention``'s
    plain twins on the CPU) against ``rope_attention_bwd_math(base2=False)``
    at N = 20, I = 3."""
    rng = np.random.default_rng(12)
    G, N, I, C, H = 2, 20, 3, 48, 2
    qkv = torch.from_numpy(rng.normal(size=(G, N, I, 3 * C)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(G, N, I, C)).astype(np.float32))
    bk, bv = (torch.from_numpy(rng.normal(size=(C,)).astype(np.float32)) for _ in range(2))
    kv = torch.from_numpy((rng.random((G, N, I)) > 0.2).astype(np.float32))
    want = rope_attention_bwd_math(qkv, dout, bk, bv, kv, num_heads=H, base2=False)
    got = natural_long_bwd(qkv, dout, bk, bv, kv, num_heads=H)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", ["hyena", "interleave_ipa"])
def test_velocity_vjp_in_x_matches_jax(flag, data):
    """The log-likelihood's step: ``LatentMDGen.forward`` and its VJP in x
    on the modular branch (1 layer) against ``jax.vjp`` of the JAX
    ``forward_inference`` with the same weights."""
    cfg = _cfg(CASES[flag], layers=1)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    jm = JModel(cfg, cfg.latent_dim)
    jkw = j_prep_batch(cfg, data["jfeats"])["model_kwargs"]
    shapes = jax.eval_shape(lambda *a: jm.init(*a, **jkw), jax.random.key(0),
                            jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)))
    params = _random_tree(shapes, 5)
    trainer = Trainer(tc, device="cpu")
    trainer.init_state(0)
    model = trainer.model
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tc))
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([0.3, 0.8], np.float32)

    def out_and_vjp(xx, gg):
        out, vjp = jax.vjp(lambda y: jm.apply(params, y, jnp.asarray(t),
                                              method=jm.forward_inference, **jkw), xx)
        return out, vjp(gg)[0]

    args = (jnp.asarray(x), jnp.asarray(g))
    jout, jdx = (np.asarray(a) for a in _compiled(out_and_vjp, *args)(*args))
    tkw = t_prep_batch(tc, _tfeats(data))["model_kwargs"]
    with torch.no_grad():
        pack = model.make_trunk_pack()
    xg = torch.from_numpy(x).requires_grad_()
    out = model(xg, torch.from_numpy(t), tkw["mask"].float(), start_frames=tkw["start_frames"],
                x_cond=tkw["x_cond"], x_cond_mask=tkw["x_cond_mask"], aatype=tkw["aatype"],
                trunk_pack=pack)
    (dx,) = torch.autograd.grad(out, xg, torch.from_numpy(g))
    assert np.abs(jout).max() > 0.1  # the random weights reach the output
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4, atol=5e-5)
    assert np.abs(dx.numpy() - jdx).max() <= 1e-4 * np.abs(jdx).max()


@pytest.mark.parametrize("flag", list(CASES))
def test_rtb_fine_tuning_of_the_modular_layer_is_refused(flag):
    """The modular layer trains, but its RTB posterior fine-tuning is not
    ported: ``refuse_rtb_unported`` (called by the RTB trainers) raises for
    each flag set, and not for the trunk."""
    from mdgen_finetune_tpu_torch.models.denoiser import refuse_rtb_unported

    refuse_rtb_unported(tcfg.MDGenConfig.from_json(_cfg({}).to_json()))
    with pytest.raises(NotImplementedError, match="RTB fine-tuning with model"):
        refuse_rtb_unported(tcfg.MDGenConfig.from_json(_cfg(CASES[flag]).to_json()))
