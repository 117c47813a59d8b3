"""PyTorch port, the inpainting / sequence-design tasks on the CPU, held
against the JAX package with the same weights (``from_flax``) and the same
numpy inputs:

- ``prep_batch`` for ``inpainting``, ``inpainting + design``, ``mpnn +
  design``, ``dynamic_mpnn + design`` and the ``no_torsion``,
  ``no_design_torsion`` and ``design_key_frames`` flags;
- the denoiser under ``design``: its output (the continuous channels and the
  logits added to the head's last 20) and ``forward_inference`` (the
  continuous part and the Dirichlet flow); the ``mpnn`` / ``dynamic_mpnn``
  logits;
- ``InferenceEngine.sample_with_zs0`` with the same prior latent: Euler on
  the flat chain for ``inpainting``, on the generic chain for ``inpainting +
  design``, and the one evaluation of ``mpnn`` / ``dynamic_mpnn``;
- the Dirichlet prior, a design checkpoint's round trip through the
  released format, and one training step of each design task.

Sizes: 1 layer, C = 32, 4 heads, a 2-head IPA of widths (8, 4, 4), L = 4
with one padded residue, T = 8, B = 2, 2 Euler steps, f32. The Dirichlet
table (``alpha_max`` 8, as the design preset) is built once for the module
and lent to the JAX model (``test_torch_dirichlet.py`` holds the two
packages' tables equal). Tolerances: latents and frames 1e-5; outputs rtol
1e-4 / atol 5e-5; atom14 1e-4 Angstrom; designed sequences equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdgen_finetune_tpu.models.denoiser as jden
from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.geometry import frames as JG
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu.transport.dirichlet import DirichletConditionalFlow as JFlow
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.inference.sampling import sample_prior_latent
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.transport.dirichlet import _dcdf_table
from mdgen_finetune_tpu_torch.utils.torch_compat import (load_reference_checkpoint,
                                                         write_reference_checkpoint)
from mdgen_finetune_tpu_torch.utils.weights import randomize_

B, T, L, STEPS = 2, 8, 4, 2
TASKS = {
    "inpainting": dict(inpainting=True),
    "design": dict(inpainting=True, design=True),
    "mpnn": dict(mpnn=True, design=True),
    "dynamic_mpnn": dict(dynamic_mpnn=True, design=True),
}
FLAGS = {"no_torsion": dict(no_torsion=True), "no_design_torsion": dict(no_design_torsion=True),
         "design_key_frames": dict(design_key_frames=True)}


def _cfg(task, method="euler"):
    return MDGenConfig(
        model=ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(**task),
        transport=TransportConfig(sampling_method=method, inference_steps=STEPS))


def _tc(cfg):
    return tcfg.MDGenConfig.from_json(cfg.to_json())


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
def flow_table():
    """The design preset's Dirichlet table, built once (the port's builder)
    and lent to the JAX model in place of its per-trace build."""
    alphas, bs, dcdf = _dcdf_table(20, 1.0, 8.0, 0.001)
    jflow = JFlow.__new__(JFlow)
    jflow.K, jflow.alpha_min, jflow.alpha_max, jflow.alpha_spacing = 20, 1.0, 8.0, 0.001
    jflow._alphas, jflow._bs, jflow._dcdf = (jnp.asarray(a) for a in (alphas, bs, dcdf))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jden, "DirichletConditionalFlow", lambda **kw: jflow)
        yield jflow


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    # jitted: eager JAX dispatches these op by op, several times slower
    atom14 = np.array(jax.jit(lambda a, b, c: JG.frames_torsions_to_atom14(
        JRigid.from_tensor_7(a), b, c))(jnp.asarray(t7), jnp.asarray(tors),
                                        jnp.asarray(np.broadcast_to(aatype[:, None], (B, T, L)))))
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    jbatch = jax.jit(j_featurize)(jnp.asarray(atom14), jnp.asarray(aatype), jnp.asarray(mask))
    return dict(atom14=atom14, aatype=aatype, mask=mask, jbatch=jbatch)


def _tbatch(d):
    """The JAX package's featurized batch as tensors: both packages' task
    code reads the same inputs. (The featurizers are held to each other in
    ``test_torch_geometry.py``; a torsion that the mask drops, residue 0's
    pre-omega over the padding, is an ill-conditioned dihedral on which they
    may disagree, and the design tasks feed residue 0's torsions to the
    model as conditioning.)"""
    out = {k: torch.from_numpy(np.array(v)) for k, v in d["jbatch"].items()}
    out["seqres"] = out["seqres"].long()
    return out


_MODELS = {}


def _models(name, flow_table):
    """(config, JAX engine with random params, the params, their numpy tree,
    the port's engine with the same weights) for a task set, made once for
    the module (``flow_table`` lends the JAX model its table)."""
    if name not in _MODELS:
        cfg = _cfg(TASKS[name])
        eng = JEngine(cfg, None)
        lat = cfg.latent_dim
        cond = lat - (20 if cfg.task.design else 0)
        ident = JRigid.identity((B, L))
        kw = dict(start_frames=ident, end_frames=ident, x_cond=jnp.zeros((B, T, L, cond)),
                  x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.zeros((B, L), jnp.int32))
        # the tree's shapes only (every leaf is drawn anew): no init to compile
        shapes = jax.eval_shape(lambda *a: eng.model.init(*a, **kw), jax.random.key(0),
                                jnp.zeros((B, T, L, lat)), jnp.ones((B,)), jnp.ones((B, T, L)))
        eng.params = params = _random_tree(shapes, 2)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _MODELS[name] = (cfg, eng, params, tree, TEngine(_tc(cfg), tree, device="cpu"))
    return _MODELS[name]


@pytest.mark.parametrize("case", [*TASKS, *FLAGS])
def test_prep_batch_matches_jax(data, case):
    task = TASKS.get(case) or dict(TASKS["design"], **FLAGS[case])
    cfg = _cfg(task)
    jp = j_prep_batch(cfg, data["jbatch"])
    tp = t_prep_batch(_tc(cfg), _tbatch(data))
    width = 21 if task.get("mpnn") else 28
    assert tp["latents"].shape == (B, T, L, width)
    for k in ("latents", "loss_mask"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-5)
    jkw, tkw = jp["model_kwargs"], tp["model_kwargs"]
    for k in ("mask", "aatype", "x_cond", "x_cond_mask"):
        np.testing.assert_allclose(np.asarray(tkw[k], np.float32), np.asarray(jkw[k], np.float32),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tkw["x_cond_mask"][:, :, [0, 3]].numpy(), 1)
    for k in ("start_frames", "end_frames"):
        np.testing.assert_allclose(tkw[k].rot.numpy(), np.asarray(jkw[k].rot), atol=1e-5)
        np.testing.assert_allclose(tkw[k].trans.numpy(), np.asarray(jkw[k].trans), atol=1e-5)
    if task.get("design"):
        np.testing.assert_array_equal(tkw["aatype"][:, [1, 2]].numpy(), 20)
    if case == "no_torsion":
        assert not tp["latents"][..., 14:].any()
    if case == "no_design_torsion":
        assert not tp["latents"][:, :, [1, 2], 14:].any() and tp["latents"][:, :, 0, 14:].any()


def _kwargs(cfg, data):
    jkw = j_prep_batch(cfg, data["jbatch"])["model_kwargs"]
    tkw = t_prep_batch(_tc(cfg), _tbatch(data))["model_kwargs"]
    return jkw, tkw


def _call_both(name, flow_table, data, x, t, call):
    cfg, eng, params, _, teng = _models(name, flow_table)
    jkw, tkw = _kwargs(cfg, data)
    method = eng.model.forward_inference if call == "forward_inference" else None
    ref = jax.jit(lambda p, a, b: eng.model.apply(p, a, b, method=method, **jkw))(
        params, jnp.asarray(x), jnp.asarray(t))
    fn = getattr(teng.model, call)
    out = fn(torch.from_numpy(x), torch.from_numpy(t), tkw["mask"].float(),
             start_frames=tkw["start_frames"], end_frames=tkw["end_frames"],
             x_cond=tkw["x_cond"], x_cond_mask=tkw["x_cond_mask"], aatype=tkw["aatype"])
    return out.numpy(), np.asarray(ref)


def _design_x(seed, lat):
    """A carry with its simplex channels on the simplex, frame-constant."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, L, lat)).astype(np.float32)
    zd = rng.dirichlet(np.ones(20), size=(B, L)).astype(np.float32)
    x[..., -20:] = zd[:, None]
    return x


@pytest.mark.parametrize("call", ["denoise", "forward_inference"])
def test_design_output_matches_jax(flow_table, data, call):
    """``denoise`` is JAX's ``__call__``: the continuous channels and the
    logits added to the head's last 20; ``forward_inference`` replaces the
    latter with the Dirichlet flow."""
    x = _design_x(3, 48)
    t = np.array([0.3, 0.7], np.float32)
    out, ref = _call_both("design", flow_table, data, x, t, call)
    assert out.shape == (B, T, L, 48) and np.isfinite(out).all()
    np.testing.assert_allclose(out[..., :28], ref[..., :28], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(out[..., 28:], ref[..., 28:], rtol=1e-4, atol=5e-5)
    if call == "forward_inference":
        # the flow moves along the simplex: its channels sum to zero
        np.testing.assert_allclose(out[..., 28:].sum(-1), 0.0, atol=1e-4)
        assert np.abs(out[..., 28:]).max() > 1e-3


@pytest.mark.parametrize("name", ["mpnn", "dynamic_mpnn"])
def test_sequence_logits_match_jax(flow_table, data, name):
    cfg, *_ = _models(name, flow_table)
    x = _design_x(4, cfg.latent_dim)
    out, ref = _call_both(name, flow_table, data, x, np.ones(B, np.float32), "forward_inference")
    assert out.shape == (B, 1, L, 20)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("name", ["inpainting", "design", "mpnn", "dynamic_mpnn"])
def test_sample_with_zs0_matches_jax_engine(flow_table, data, name):
    cfg, eng, params, _, teng = _models(name, flow_table)
    rng = np.random.default_rng(5)
    zs0 = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    if cfg.task.design:
        zs0[..., -20:] = rng.dirichlet(np.ones(20), size=(B, L)).astype(np.float32)[:, None]
    ref, ref_aa = jax.jit(eng._sample_with_zs0)(params, data["jbatch"], jnp.asarray(zs0))
    calls = {"flat_call": 0, "forward_inference": 0}
    for k in calls:
        fn = getattr(teng.model, k)

        def counted(*a, _k=k, _fn=fn, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        setattr(teng.model, k, counted)
    try:
        out, aa = teng.sample_with_zs0(_tbatch(data), torch.from_numpy(zs0))
    finally:
        for k in calls:
            delattr(teng.model, k)
    flat = name == "inpainting"
    evals = 1 if name in ("mpnn", "dynamic_mpnn") else STEPS
    assert calls == {"flat_call": STEPS if flat else 0, "forward_inference": 0 if flat else evals}
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(aa.numpy(), np.asarray(ref_aa))
    if cfg.task.design:
        assert aa.min() >= 0 and aa.max() < 20


def test_dirichlet_prior():
    gen = lambda: torch.Generator().manual_seed(9)  # noqa: E731
    z = sample_prior_latent(gen(), 3, T, L, 48, design=True)
    assert z.shape == (3, T, L, 48)
    zd = z[..., 28:]
    assert (zd >= 0).all() and torch.equal(zd, zd[:, :1].expand_as(zd))
    torch.testing.assert_close(zd.sum(-1), torch.ones(3, T, L), rtol=0, atol=1e-6)
    assert torch.equal(z, sample_prior_latent(gen(), 3, T, L, 48, design=True))
    assert not torch.equal(z, sample_prior_latent(torch.Generator().manual_seed(10), 3, T, L, 48,
                                                  design=True))
    # Dirichlet(1) is uniform on the simplex: each channel's mean is 1 / 20
    big = sample_prior_latent(gen(), 4000, 1, 1, 20, design=True)
    assert abs(big.mean().item() - 0.05) < 1e-3 and big.std(0).max() < 0.06


def test_design_checkpoint_round_trip(tmp_path):
    cfg = _tc(_cfg(TASKS["design"]))
    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(3))
    sd = model.state_dict()
    assert sd["cond_to_emb.weight"].shape == (32, 28)
    for name, shape in (("x_d_to_emb", (32, 20)), ("fc1", (32, 32)), ("fc2", (32, 32)),
                        ("fc3", (32, 32)), ("emb_to_logits", (20, 32))):
        assert sd[f"{name}.weight"].shape == shape
    assert not any(k.startswith("condflow") for k in sd)  # the table is not a weight
    path = str(tmp_path / "design.ckpt")
    write_reference_checkpoint(path, sd, cfg)
    params, ema, _ = load_reference_checkpoint(path, cfg)
    assert ema is None and params.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(params[k], v), k
    mp = _tc(_cfg(TASKS["mpnn"]))
    sd = randomize_(LatentMDGen(mp), torch.Generator().manual_seed(4)).state_dict()
    assert sd["cond_to_emb.weight"].shape == (32, 21)
    assert not any(k.startswith("emb_to_latent") for k in sd)
    write_reference_checkpoint(path, sd, mp)
    params, _, _ = load_reference_checkpoint(path, mp)
    assert params.keys() == sd.keys() and all(torch.equal(params[k], v) for k, v in sd.items())


@pytest.mark.parametrize("name", list(TASKS))
def test_training_the_design_tasks_is_refused(data, name):
    """Training the design tasks is no longer refused: ``Trainer`` builds
    and takes one finite step on the CPU (``test_torch_train_tasks.py``
    holds the loss and every gradient to JAX)."""
    cfg = _tc(_cfg(TASKS[name]))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    batch = dict(atom14=data["atom14"], seqres=data["aatype"], mask=data["mask"])
    state, metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1
    want = {"loss", "t_mean", "grad_norm"} | ({"loss_discrete", "loss_continuous"}
                                             if cfg.task.design else set())
    assert set(metrics) == want
    finite = [k for k in want if not (k == "loss_continuous" and (cfg.task.mpnn
                                                                 or cfg.task.dynamic_mpnn))]
    assert all(np.isfinite(float(metrics[k])) for k in finite), metrics
    # no_frames is no longer refused as unported: the model refuses the
    # prepend-IPA encoder it cannot feed (no rigids), as JAX cannot run it
    no_frames = dataclasses.replace(cfg, task=dataclasses.replace(cfg.task, no_frames=True))
    with pytest.raises(ValueError, match="no rigids"):
        TEngine(no_frames, {}, device="cpu")
