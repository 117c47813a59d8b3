"""PyTorch port, training every task pipeline held against the JAX package
on the CPU: the design / inpainting task (``inpainting + design +
no_torsion``, the design preset's flags), inpainting alone, ``mpnn`` and
``dynamic_mpnn`` (+ design) and the transition-path task
(``tps_condition``, whose ``prep_batch`` doubles the frame loss mask).

For each, the loss, its metrics and every parameter's gradient of the
port's ``Trainer._feature_loss`` (prep_batch -> ``training_losses`` with
the Dirichlet flow-matching terms -> ``LatentMDGen.forward``: the trunk
through ``FusedTrunkFn``, without its head under ``design``, the
FinalLayer through ``FinalLayerFn``, the design head, the encoder with its
tokens' gradient) against ``jax.value_and_grad`` of the JAX package's own
``Trainer._loss_fn``, with the same weights (``from_flax``), the same
featurized batch (the JAX featurizer's, as ``test_torch_design.py`` hands
it over) and the same draws: t, x0 and the design task's simplex point
made with numpy and passed to the port, and put in place of JAX's
``jax.random`` draws inside its transport. Then ``check_grad_coverage``:
empty, but for ``x_d_to_emb.weight`` under ``mpnn`` / ``dynamic_mpnn``,
whose simplex channels are zeros in both packages, so that this one
gradient is exactly zero in JAX too (asserted).

Sizes: 1 layer, C = 48, 2 heads, a 2-head IPA of widths (8, 4, 4), B = 2,
T = 5, L = 4 with one padded residue, f32. The Dirichlet table is built
once (the port's builder) and lent to the JAX model. Tolerances, as
``test_torch_training.py``: the loss and its metrics rtol 1e-5; each
gradient tensor max |port - JAX| <= 1e-4 x max(its max |JAX|, 1e-2 x the
largest gradient of the model).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdgen_finetune_tpu.models.denoiser as jden
import mdgen_finetune_tpu.transport.transport as jtransport
from mdgen_finetune_tpu.config import DataConfig, MDGenConfig, ModelConfig, TaskConfig
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.training.trainer import Trainer as JTrainer
from mdgen_finetune_tpu.transport import create_transport as j_create_transport
from mdgen_finetune_tpu.transport.dirichlet import DirichletConditionalFlow as JFlow
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.transport.dirichlet import _dcdf_table
from mdgen_finetune_tpu_torch.utils.weights import from_flax

GRAD_TOL, FLOOR = 1e-4, 1e-2
B, T, L = 2, 5, 4
TASKS = {
    "design": dict(inpainting=True, design=True, no_torsion=True),
    "inpainting": dict(inpainting=True),
    "mpnn": dict(mpnn=True, design=True),
    "dynamic_mpnn": dict(dynamic_mpnn=True, design=True),
    "tps": dict(tps_condition=True),
}


def _cfg(task):
    return MDGenConfig(
        model=ModelConfig(num_layers=1, embed_dim=48, mha_heads=2, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True,
                          use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(**task))


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
    """The Dirichlet table (``alpha_max`` 8), built once by the port's
    builder and lent to the JAX model in place of its per-trace build."""
    alphas, bs, dcdf = _dcdf_table(20, 1.0, 8.0, 0.001)
    jflow = JFlow.__new__(JFlow)
    jflow.K, jflow.alpha_min, jflow.alpha_max, jflow.alpha_spacing = 20, 1.0, 8.0, 0.001
    jflow._alphas, jflow._bs, jflow._dcdf = (jnp.asarray(a) for a in (alphas, bs, dcdf))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jden, "DirichletConditionalFlow", lambda **kw: jflow)
        yield jflow


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


@pytest.fixture(scope="module", params=list(TASKS))
def case(request, flow_table, data):
    """One task: the port's trainer with seeded random weights, the same
    weights' flax tree, the draws, and JAX's loss, metrics and gradients."""
    name = request.param
    cfg = _cfg(TASKS[name])
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    trainer = Trainer(tc, device="cpu")
    state = trainer.init_state(0)
    jm = JModel(cfg, cfg.latent_dim)
    cond = cfg.latent_dim - (20 if cfg.task.design else 0)
    ident = JRigid.identity((B, L))
    kw = dict(start_frames=ident, end_frames=ident, x_cond=jnp.zeros((B, T, L, cond)),
              x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.zeros((B, L), jnp.int32))
    # the tree's shapes only (every leaf is drawn anew): no init to compile
    shapes = jax.eval_shape(lambda *a: jm.init(*a, **kw), jax.random.key(0),
                            jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
                            jnp.ones((B, T, L)))
    params = _random_tree(shapes, 3)
    trainer.model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params), tc))

    rng = np.random.default_rng(7)
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    x0 = rng.normal(size=(B, T, L, cond)).astype(np.float32)
    # the design task's simplex point: Dir(1 + onehot(seqres) (alpha(t) - 1))
    alpha = 1 + t * (cfg.transport.alpha_max - 1)
    conc = np.ones((B, L, 20))
    conc[np.arange(B)[:, None], np.arange(L)[None], data["batch"]["seqres"]] = alpha[:, None]
    x_d = np.array([[rng.dirichlet(conc[b, i]) for i in range(L)] for b in range(B)],
                   np.float32)

    jt = JTrainer.__new__(JTrainer)  # its _loss_fn without a mesh
    jt.cfg, jt.model = cfg, jm
    jt.model_train, jt.transport = jm, j_create_transport(cfg)
    jt._featurize = lambda b: b  # handed the featurized batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtransport, "jax", _GivenDraws(t, x0))
        mp.setattr(jtransport, "_sample_dirichlet", lambda key, alphas: jnp.asarray(x_d))
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
            params, jax.random.key(0), data["jfeats"])
    return dict(name=name, tc=tc, trainer=trainer, state=state, t=t, x0=x0, x_d=x_d,
                jloss=float(jloss), jmetrics={k: float(v) for k, v in jmetrics.items()},
                jgrads=from_flax(jax.tree_util.tree_map(np.asarray, jgrads), tc))


def _tfeats(data):
    out = {k: torch.from_numpy(np.array(v)) for k, v in data["jfeats"].items()}
    out["seqres"] = out["seqres"].long()
    return out


def test_loss_metrics_and_grads_match_jax(case, data):
    s = case
    trainer = s["trainer"]
    loss, metrics = trainer._feature_loss(_tfeats(data), t=torch.from_numpy(s["t"]),
                                          x0=torch.from_numpy(s["x0"]),
                                          x_d=torch.from_numpy(s["x_d"]))
    loss.backward()
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
        err = np.abs(g.numpy() - r).max()
        if not err <= GRAD_TOL * max(scale, floor):
            bad.append((k, float(err), float(scale), float(floor)))
    assert not bad, bad


def test_grad_coverage_matches_jax(case, data):
    s = case
    missing = s["trainer"].check_grad_coverage(s["state"], data["batch"],
                                               torch.Generator().manual_seed(0))
    zero_in_jax = sorted(k for k, g in s["jgrads"].items() if not bool(g.abs().max() > 0))
    mpnn = s["name"] in ("mpnn", "dynamic_mpnn")
    assert zero_in_jax == (["x_d_to_emb.weight"] if mpnn else [])
    assert sorted(missing) == zero_in_jax
