"""PyTorch port, training held against the JAX package on the CPU.

- The loss and every parameter's gradient of the port's differentiable
  ``LatentMDGen.forward`` (trunk through ``FusedTrunkFn`` and the stage
  backwards of ``ops/fused_layer_bwd.py``, encoder through its recompute),
  driven by ``Trainer._loss_fn`` (featurize -> prep_batch ->
  training_losses with t and x0 given), against ``jax.value_and_grad`` of
  ``mean(mean_flat((model.apply(params, xt, t, **kw) - ut)**2, loss_mask))``
  with the same weights (``from_flax``) and the same numpy draws. Three
  configs: tiny (2 layers, C = 96, 4 heads, T = 6, L = 4, B = 2), one
  layer at flagship width (C = 384, 16 heads, T = 4, L = 4, B = 1), and
  the long-T training path with ``grad_checkpointing`` on both sides
  (2 layers, C = 48, 2 heads, T = 264, L = 4, B = 2: the frame stage's
  backward runs ``time_attention_block_bwd`` with the ``fused_attention``
  twins, the JAX model its ``nn.remat`` layers); all prepend-IPA with one
  padded residue in the batch where B = 2. And ATLAS in small
  (``atlas_tiny``: 2 layers, C = 48, 2 heads, T = 5, L = 12, B = 1, a
  9-residue protein zero-padded to 12 with mask 0): the residue stage at
  L > MAX_L (``residue_rows_block``, frame core ``tiled_attention``).
- One optimizer step (clip, Adam or AdamW, MultiSteps, EMA) against optax.
- A checkpoint round trip, ``fit`` on a synthetic dataset, the device rule,
  ``dp_size`` 2 in one process (JAX's ``make_mesh`` ``ValueError``), the
  options once refused (dropout, the modular layer), and
  ``grad_checkpointing`` leaving the
  loss and every gradient bit for bit as they are without it.

Weights are seeded random (the init's zero AdaLN and FinalLayer would make
every trunk gradient exactly zero). Tolerances, f32 on both sides: the loss
rtol 1e-5; each gradient tensor max |port - JAX| <= 1e-4 x its max |JAX|
(sums in other orders, exp2 against exp; the gradients of a 2-layer
network carry ~1e-6 relative noise), where a tensor's max |JAX| is taken
as at least 1e-2 x the largest gradient of the model: a gradient that is
exactly zero in exact arithmetic (IPA's key bias: a bias shared by every
key does not move the softmax) holds only rounding on both sides.
The optimizer: rtol 1e-5 / atol 1e-7 on the parameters after the steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TrainConfig)
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu.training.trainer import make_optimizer as j_make_optimizer
from mdgen_finetune_tpu.transport.paths import expand_t as j_expand_t
from mdgen_finetune_tpu.transport.paths import get_path as j_get_path
from mdgen_finetune_tpu.transport.transport import mean_flat as j_mean_flat
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset, make_batch_iterator
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset, synthesize_trajectory
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.training.trainer import Optimizer
from mdgen_finetune_tpu_torch.utils.weights import from_flax, to_flax

GRAD_TOL, FLOOR = 1e-4, 1e-2


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


def _setup(NL, C, H, T, L, B, seed, remat=False, seqs=None):
    """``seqs``: the sequences (default the first B of "AAGG", "GHKL"); one
    shorter than L is zero-padded with mask 0, as the ATLAS dataset pads."""
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False, grad_checkpointing=remat),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=B))
    rng = np.random.default_rng(seed)
    seqs = seqs or ["AAGG", "GHKL"][:B]
    from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
    atom14 = np.zeros((B, T, L, 14, 3), np.float32)
    seqres = np.zeros((B, L), np.int32)
    mask = np.zeros((B, L), np.float32)
    for i, s in enumerate(seqs):
        atom14[i, :, :len(s)] = synthesize_trajectory(s, T, seed=seed + i)
        seqres[i, :len(s)] = str_sequence_to_aatype(s)
        mask[i, :len(s)] = 1.0
    if B > 1:
        mask[1, -1] = 0.0
    jm = JModel(cfg, cfg.latent_dim)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    trainer = Trainer(tc, device="cpu")
    state = trainer.init_state(seed)
    # the flax tree from the port's own parameters (test_torch_weights holds
    # to_flax to jm.init's tree): jitting jm.init costs ~5 s on the CPU
    params = _random_tree(to_flax(trainer.model.state_dict(), tc), seed + 1)
    trainer.model.load_state_dict(from_flax(params, tc))
    t = rng.uniform(0.05, 0.95, size=B).astype(np.float32)
    x0 = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    batch = dict(atom14=atom14, seqres=seqres, mask=mask)
    return dict(cfg=cfg, jm=jm, params=params, trainer=trainer, state=state, batch=batch,
                t=t, x0=x0, share_feats=T > 100)


def _jax_loss_and_grads(s):
    cfg, jm = s["cfg"], s["jm"]
    b = s["batch"]
    # prep_batch jitted (op by op it costs ~3 s on the CPU); featurize is
    # not: compiled, the first residue's degenerate pre-omega torsion rounds
    # differently and moves the loss by ~1e-3. Over 264 frames even the
    # eager featurizations differ on a few such torsions (3e-5 of the loss),
    # so that case hands JAX the port's features.
    if s["share_feats"]:
        feats = {k: jnp.asarray(v.numpy()) for k, v in t_featurize(
            *(torch.from_numpy(b[k]) for k in ("atom14", "seqres", "mask"))).items()}
    else:
        feats = j_featurize(jnp.asarray(b["atom14"]), jnp.asarray(b["seqres"]),
                            jnp.asarray(b["mask"]))
    prep = jax.jit(lambda f: j_prep_batch(cfg, f))(feats)
    x1 = prep["latents"]
    t = jnp.asarray(s["t"])
    xt, ut = j_get_path(cfg.transport.path_type).interpolate(j_expand_t(t, x1),
                                                             jnp.asarray(s["x0"]), x1)

    def loss(params):
        out = jm.apply(params, xt, t, **prep["model_kwargs"])
        return jnp.mean(j_mean_flat((out - ut) ** 2, prep["loss_mask"]))

    return jax.jit(jax.value_and_grad(loss))(s["params"])


@pytest.fixture(scope="module", params=["tiny", "flagship_width", "t264_remat", "atlas_tiny"])
def setup(request):
    if request.param == "tiny":
        return _setup(NL=2, C=96, H=4, T=6, L=4, B=2, seed=10)
    if request.param == "t264_remat":
        return _setup(NL=2, C=48, H=2, T=264, L=4, B=2, seed=30, remat=True)
    if request.param == "atlas_tiny":  # L > MAX_L: the residue stage's rows route
        return _setup(NL=2, C=48, H=2, T=5, L=12, B=1, seed=50, seqs=["MKTAYIAKQ"])
    return _setup(NL=1, C=384, H=16, T=4, L=4, B=1, seed=20)


def test_loss_and_grads_match_jax(setup):
    s = setup
    ref_loss, ref_grads = _jax_loss_and_grads(s)
    trainer = s["trainer"]
    loss, _ = trainer._loss_fn(s["batch"], t=torch.from_numpy(s["t"]),
                               x0=torch.from_numpy(s["x0"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = from_flax(jax.tree_util.tree_map(np.asarray, ref_grads), trainer.cfg)
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


def test_grad_coverage_is_full_with_random_weights(setup):
    s = setup
    missing = s["trainer"].check_grad_coverage(s["state"], s["batch"], torch.Generator().manual_seed(0))
    assert missing == []


@pytest.mark.parametrize("opt", [dict(), dict(adamW=True, grad_clip=1e9),
                                 dict(accumulate_grad=2, ema=False)])
def test_optimizer_step_matches_optax(opt):
    cfg = MDGenConfig(train=TrainConfig(lr=1e-2, grad_clip=opt.get("grad_clip", 0.5),
                                        adamW=opt.get("adamW", False), ema=opt.get("ema", True),
                                        accumulate_grad=opt.get("accumulate_grad", 1)))
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in
              (("a", (4, 3)), ("b", (5,)), ("c", (2, 2, 2)))}
    steps = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(opt.get("accumulate_grad", 1) + 1)]
    tx = j_make_optimizer(cfg)
    jp, st = dict(params), tx.init(params)
    decay = cfg.train.ema_decay if cfg.train.ema else 0.0
    jema = dict(params)
    for g in steps:
        upd, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, jema, jp)
    t = cfg.train
    opt_t = Optimizer(t.lr, t.grad_clip, adamw=t.adamW, every_k=t.accumulate_grad)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tema = {k: v.clone() for k, v in tp.items()}
    ts = opt_t.init(tp)
    for g in steps:
        opt_t.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in tema:
            tema[k].mul_(decay).add_(tp[k], alpha=1 - decay)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tema[k].numpy(), np.asarray(jema[k]), rtol=1e-5, atol=1e-7)


def test_train_step_and_checkpoint_round_trip(setup, tmp_path):
    s = setup
    trainer, state = s["trainer"], s["state"]
    before = {k: v.detach().clone() for k, v in state.params.items()}
    before_ema = {k: v.clone() for k, v in state.ema_params.items()}
    path = trainer.save_checkpoint(state, str(tmp_path / "ckpt"))
    state, metrics = trainer.train_step(state, s["batch"], torch.Generator().manual_seed(1))
    assert state.step == 1 and all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(before[k], p) for k, p in state.params.items())
    state = trainer.restore_checkpoint(path, state)
    assert state.step == 0 and state.opt_state["count"] == 0
    for k, p in state.params.items():
        assert torch.equal(p, before[k]) and torch.equal(state.ema_params[k], before_ema[k])
        assert p is dict(trainer.model.named_parameters())[k]


def test_fit_on_synthetic_data(tmp_path):
    cfg = tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=2, embed_dim=64, mha_heads=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        data=tcfg.DataConfig(data_dir=str(tmp_path), num_frames=6, crop=4),
        task=tcfg.TaskConfig(sim_condition=True),
        train=tcfg.TrainConfig(batch_size=2, lr=1e-3, ema=True))
    split = make_synthetic_dataset(str(tmp_path), ["AAGG", "GHKL"], num_frames=16)
    it = make_batch_iterator(MDGenDataset(cfg, split), 2, seed=0)
    trainer = Trainer(cfg, device="cpu")
    logs = []
    state = trainer.fit(trainer.init_state(0), it, num_steps=4, generator=torch.Generator().manual_seed(0),
                        log_every=2, log_fn=logs.append)
    it.close()
    assert state.step == 4 and [m["step"] for m in logs] == [2, 4]
    assert all(np.isfinite(m[k]) for m in logs for k in ("loss", "t_mean", "grad_norm", "dur"))


def test_cached_tables_are_not_written_by_a_train_step():
    """The geometry and RoPE tables are made once per (device, shape) and
    every caller gets the same tensor (functools.lru_cache): one train step
    (featurize, the trunk's plain twins forward and backward) hits each
    cache and writes into none of them."""
    from mdgen_finetune_tpu_torch.geometry import frames, rigid
    from mdgen_finetune_tpu_torch.models import rope

    cfg = tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=1, embed_dim=64, mha_heads=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        data=tcfg.DataConfig(num_frames=6, crop=4), task=tcfg.TaskConfig(sim_condition=True))
    from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
    batch = dict(atom14=np.stack([synthesize_trajectory(q, 6, seed=i).astype(np.float32)
                                  for i, q in enumerate(["AAGG", "GHKL"])]),
                 seqres=np.stack([str_sequence_to_aatype(q) for q in ["AAGG", "GHKL"]]),
                 mask=np.ones((2, 4), np.float32))
    trainer = Trainer(cfg, device="cpu")
    trainer.train_step(trainer.init_state(0), batch, torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    D = 64 // 4
    calls = [(rigid.rigid_vecs_flip, (cpu,), {}),
             (frames._psi_flip, (cpu, torch.float32), {}),
             (rope.rope_tables, (4 + 1, D), dict(device=cpu)),   # residue axis
             (rope.rope_tables, (6 + 1, D), dict(device=cpu))]  # frame axis
    calls += [(frames._table_on, (name, cpu), {}) for name in
              ("RESTYPE_ATOM37_TO_ATOM14", "RESTYPE_ATOM37_MASK", "chi_atoms",
               "CHI_ANGLES_MASK21")]
    for fn, args, kw in calls:
        hits = fn.cache_info().hits
        got = fn(*args, **kw)
        assert fn.cache_info().hits == hits + 1, (fn.__name__, args)  # the callers' tensor
        fresh = fn.__wrapped__(*args, **kw)
        for g, f in zip(*((got, fresh) if isinstance(got, tuple) else ((got,), (fresh,)))):
            assert g._version == 0 and torch.equal(g, f), (fn.__name__, args)


def test_trainer_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tcfg.MDGenConfig())  # device defaults to "cuda"


def test_grad_checkpointing_is_bit_identical():
    """``grad_checkpointing`` (save each trunk layer's input only, recompute
    the rest in the backward) changes memory, not numbers: the loss and
    every gradient equal the run without it bit for bit."""
    s = _setup(NL=2, C=64, H=4, T=6, L=4, B=2, seed=40)
    got = {}
    for remat in (False, True):
        cfg = s["trainer"].cfg
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, grad_checkpointing=remat))
        trainer = Trainer(cfg, device="cpu")
        trainer.init_state(0)
        trainer.model.load_state_dict(s["trainer"].model.state_dict())
        loss, _ = trainer._loss_fn(s["batch"], t=torch.from_numpy(s["t"]),
                                   x0=torch.from_numpy(s["x0"]))
        loss.backward()
        got[remat] = (loss.detach(), {k: p.grad for k, p in trainer.model.named_parameters()})
    assert torch.equal(got[True][0], got[False][0])
    bad = [k for k, g in got[True][1].items() if not torch.equal(g, got[False][1][k])]
    assert not bad, bad


@pytest.mark.parametrize("change", [
    dict(model=tcfg.ModelConfig(dropout=0.1)),
    dict(train=tcfg.TrainConfig(dp_size=2)),
    dict(model=tcfg.ModelConfig(hyena=True)),
    dict(model=tcfg.ModelConfig(interleave_ipa=True)),
])
def test_unported_training_options_raise(change):
    """``dp_size`` 2 in one process raises JAX's ``make_mesh``
    ``ValueError`` (a mesh of 2 needs 2 ranks; the sharded step:
    ``tests/test_torch_parallel.py``); dropout and the modular layer's
    flags, once refused, build their trainer (their training against JAX:
    ``tests/test_torch_modular_train.py``)."""
    cfg = tcfg.MDGenConfig(**change)
    if cfg.train.dp_size > 1:
        with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
            Trainer(cfg, device="cpu").init_state(0)
        return
    state = Trainer(cfg, device="cpu").init_state(0)
    assert set(state.params) == set(state.ema_params) and state.step == 0
