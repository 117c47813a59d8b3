"""PyTorch port, data and sequence parallelism (``parallel/``) on the CPU
over gloo, held against the JAX package's mesh step and the port's own
one-process runs.

One world of 4 ranks (``parallel.launch.run``, spawned processes running
``parallel.checks``) runs every sharded case of this file:

- training steps (``Trainer`` over ``make_mesh`` from the config) at
  B = 4 on 2 x 2 (the batch fold: one element a rank), B = 2 on 2 x 2 (dp
  plus the sequence split: the trunk's frames, then residues, over sp) and
  B = 1, L = 16 on 1 x 4 (the sequence split on the L > 8 route,
  ``residue_rows_block``); each held, in the loss, every parameter's
  gradient and the parameters after one step, to JAX's
  ``Trainer(mesh=make_mesh(dp, sp))`` step (one jit of ``_step``'s body,
  its ``_loss_fn`` gradient and its optimizer, over the virtual devices,
  at XLA's lowest optimisation level; the same weights, the
  port's draws put in place of ``jax.random``'s, the batch featurized once
  by JAX's featurizer, compiled at the same level) and to the port's one-process step; the
  parameters bit-equal across the 4 ranks after 2 steps; the collectives
  counted where JAX's compiled step has them (all-reduce; under sp a
  resharding collective);
- ``InferenceEngine(mesh=)`` at B = 4 (the batch fold: Euler, 3 steps, the
  flat chain; dopri5, its error norm's mean over every rank's rows; the
  reverse SDE, 3 Euler-Maruyama steps, its noise drawn for the whole batch)
  and at B = 1, L = 16 (Heun, 2 steps, the generic chain, sequence split),
  equal to the one-process engine, steps and evaluations included.

- ``interleave_ipa`` (B = 1, 1 x 4: its fused layers sequence-split one
  at a time) and dropout (B = 4, 2 x 2: the keep masks drawn for the whole
  batch) trained a step, against the port's one-process step;
- ``LatentMDGen.forward`` and its backward with the whole 2 x 2 mesh
  registered (``kernel_mesh``, as JAX's dry run calls its model) at
  B = 4, 2 and 1: the trunk split over the batch (``shard_map_batch0``,
  over dp x sp or dp alone) or the sequence (``shard_map_batch_seq``,
  B = 1), equal to the one-process forward in the output and every
  gradient.

A world of 2 runs ``cli/train.py`` under the torchrun environment: one
log and one checkpoint, written by rank 0, its logged losses equal to a
one-process run of the same global batches; then a run resumed from that
checkpoint. A world of 4 runs ``parallel/dryrun.py::dryrun_multichip``.

Sizes: 2 layers, C = 32, 2 heads, a 2-head IPA of widths (8, 4, 4), T = 8,
f32, prepend-IPA, ``sim_condition``; one padded residue. Tolerances, f32:
the loss rtol 1e-5; a gradient tensor or parameter max |a - b| <= 1e-5 x
max(its max |b|, 1e-2 x the largest of the model) against the port's
one-process step (the same kernels' plain twins, sums in another order);
1e-4 of the same against JAX's (exp2 against exp, as
``test_torch_training.py``), but for the leaves ``NEAR_JAX`` names at
L = 16 with their readings, held to the one-process step's own distance
from JAX's plus 1e-5; a parameter whose gradient is rounding alone (IPA's
key bias, zero in exact arithmetic) within 2 lr after its first Adam step;
samples 1e-4 x max(1, max |b|).
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mdgen_finetune_tpu.parallel.kernel_sharding as jks
import mdgen_finetune_tpu.transport.transport as jtransport
from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TrainConfig, TransportConfig)
from mdgen_finetune_tpu.data.featurize import featurize_atom14_batch as j_featurize
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.parallel.mesh import make_mesh as j_make_mesh
from mdgen_finetune_tpu.parallel.mesh import replicated_sharding, shard_batch as j_shard_batch
from mdgen_finetune_tpu.training.trainer import Trainer as JTrainer
from mdgen_finetune_tpu.training.trainer import TrainState as JState
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import synth_data
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch
from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.parallel import checks, launch
from mdgen_finetune_tpu_torch.transport import create_transport
from mdgen_finetune_tpu_torch.utils.weights import from_flax

SEED, LR = 5, 1e-3
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# (name, dp, sp, B, T, L)
TRAIN_CASES = [("fold_B4", 2, 2, 4, 8, 4), ("seq_B2", 2, 2, 2, 8, 4),
               ("seq_B1_L16", 1, 4, 1, 8, 16)]
# other branches, against the one-process step only: (name, dp, sp, B, model flags)
BRANCH_CASES = [("interleave_ipa_B1", 1, 4, 1, dict(interleave_ipa=True)),
                ("dropout_B4", 2, 2, 4, dict(dropout=0.1))]
# the model's forward and backward under the whole mesh: (name, B, axes split over)
FORWARD_CASES = [("fwd_B4", 4, "batch over dp x sp"), ("fwd_B2", 2, "batch over dp"),
                 ("fwd_B1", 1, "sequence over dp x sp")]
# leaves that sit further than 1e-4 from JAX's in the one-process step as
# well ({case: {quantity: names}}); each is held to that step's own distance
# from JAX's plus 1e-5, every other leaf of every case to 1e-4. Readings, max
# |a - b| over the leaf's scale (``_close``), the sharded step's equal to the
# one-process step's:
NEAR_JAX = {"seq_B1_L16": {
    # the IPA's point projections, gradients below the floor: k 1.07e-4,
    # q 1.25e-4
    "grads": {"ipa_layers.0.ipa.linear_k_points.weight",
              "ipa_layers.0.ipa.linear_q_points.weight"},
    # after Adam's first step, which divides each gradient element by
    # |g| + 1e-8, so that an element of tiny |g| moves on its rounding:
    # 2.40e-4, 4.87e-4, 3.14e-4, 2.07e-4, 1.65e-4
    "params1": {"ipa_layers.0.fc1.weight", "ipa_layers.0.ipa.linear_k_points.weight",
                "ipa_layers.0.ipa.linear_q.weight", "ipa_layers.0.ipa.linear_q_points.bias",
                "ipa_layers.1.mha_l.v_proj.weight"}}}
# (name, dp, sp, B, L, method, steps, sampler)
SAMPLE_CASES = [("euler_B4", 2, 2, 4, 4, "euler", 3, "ode"),
                ("dopri5_B4", 2, 2, 4, 4, "dopri5", 0, "ode"),
                ("sde_B4", 2, 2, 4, 4, "euler", 0, "sde"),
                ("heun_B1_L16", 1, 4, 1, 16, "heun", 2, "ode")]


def _jcfg(dp, sp, B, T, L, method="euler", steps=2, **flags):
    return MDGenConfig(
        model=ModelConfig(num_layers=2, embed_dim=32, mha_heads=2, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True,
                          use_bf16=False, **flags),
        transport=TransportConfig(sampling_method=method, inference_steps=steps),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=B, lr=LR, dp_size=dp, sp_size=sp))


def _tcfg(cfg):
    return tcfg.MDGenConfig.from_json(cfg.to_json())


def _batch(B, T, L, seed=0):
    """B synthetic peptides of L residues; the second element's last residue
    padded, and at L > 8 the last two residues of the first."""
    atom14 = np.zeros((B, T, L, 14, 3), np.float32)
    seqres = np.zeros((B, L), np.int64)
    mask = np.ones((B, L), np.float32)
    for i in range(B):
        s = ("AAGGHKLA" * 4)[i:i + L]
        atom14[i] = synthesize_trajectory(s, T, seed=seed + i)
        seqres[i] = str_sequence_to_aatype(s)
    if B > 1:
        mask[1, -1] = 0.0
    if L > 8:
        mask[0, -2:] = 0.0
        atom14[0, :, -2:] = 0.0
    return {"atom14": atom14, "seqres": seqres, "mask": mask}


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


def _weights(cfg, seed=3):
    """A seeded random flax tree of ``cfg``'s model (its shapes only: no
    init to compile) and the port's state dict of it."""
    B, T, L = cfg.train.batch_size, cfg.data.num_frames, cfg.data.crop
    from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
    ident = JRigid.identity((B, L))
    kw = dict(start_frames=ident, end_frames=ident, x_cond=jnp.zeros((B, T, L, cfg.latent_dim)),
              x_cond_mask=jnp.zeros((B, T, L), jnp.int32), aatype=jnp.zeros((B, L), jnp.int32))
    jm = JModel(cfg, cfg.latent_dim)
    shapes = jax.eval_shape(lambda *a: jm.init(*a, **kw), jax.random.key(0),
                            jnp.zeros((B, T, L, cfg.latent_dim)), jnp.ones((B,)),
                            jnp.ones((B, T, L)))
    params = jax.tree_util.tree_map(np.asarray, _random_tree(shapes, seed))
    return params, from_flax(params, _tcfg(cfg))


class _GivenDraws:
    """``jax`` as the JAX transport module sees it, with the uniform draw of
    t and the normal draw of x0 replaced by given arrays."""

    def __init__(self, t, x0):
        self.random = types.SimpleNamespace(
            split=jax.random.split, uniform=lambda key, shape, dtype: jnp.asarray(t),
            normal=lambda key, shape, dtype: jnp.asarray(x0))

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_step(cfg, params, batch):
    """JAX's mesh step on the virtual devices: the loss, every gradient and
    the parameters after one step (one jit), with the draws the port's
    trainer makes from its generator, and the compiled step's collectives."""
    dp, sp = cfg.train.dp_size, cfg.train.sp_size
    B, T, L = batch["atom14"].shape[:3]
    tc = _tcfg(cfg)
    gen = torch.Generator().manual_seed(SEED)
    x0, t, _ = create_transport(tc).draws(gen, (B, T, L, cfg.latent_dim), torch.float32, "cpu")
    args = (jnp.asarray(batch["atom14"]), jnp.asarray(batch["seqres"], jnp.int32),
            jnp.asarray(batch["mask"]))
    feats = jax.jit(j_featurize).lower(*args).compile(O0)(*args)
    mesh = j_make_mesh(dp, sp)
    with jks.kernel_mesh(None):  # JAX's Trainer registers its mesh; leave it as found
        jt = JTrainer(cfg, mesh=mesh, dtype=jnp.float32)
    jt._featurize = lambda b: b  # handed the featurized batch
    state = jax.device_put(JState(step=jnp.zeros((), jnp.int32), params=params,
                                  opt_state=jt.tx.init(params),
                                  ema_params=jax.tree_util.tree_map(jnp.array, params)),
                           replicated_sharding(mesh))

    def step(state, b, key):  # Trainer._step, its gradients kept
        (_, metrics), grads = jax.value_and_grad(jt._loss_fn, has_aux=True)(state.params, key, b)
        updates, _ = jt.tx.update(grads, state.opt_state, state.params)
        return metrics, grads, optax.apply_updates(state.params, updates)

    with pytest.MonkeyPatch.context() as mp, jks.kernel_mesh(mesh):
        mp.setattr(jtransport, "jax", _GivenDraws(t.numpy(), x0.numpy()))
        db = j_shard_batch(mesh, dict(feats))
        compiled = jax.jit(step).lower(state, db, jax.random.key(1)).compile(O0)
        metrics, grads, new = compiled(state, db, jax.random.key(1))
    hlo = compiled.as_text()
    reshard = sum(hlo.count(c) for c in ("all-to-all", "collective-permute", "all-gather"))
    return dict(loss=float(metrics["loss"]),
                grads=from_flax(jax.tree_util.tree_map(np.asarray, grads), tc),
                params1=from_flax(jax.tree_util.tree_map(np.asarray, new), tc),
                all_reduce=hlo.count("all-reduce"), reshard=reshard)


def _close(got, want, tol, what, noise=(), near=None, near_keys=()):
    """Every tensor within ``tol`` (module docstring); those in ``noise``
    within 2 lr (parameters whose gradient is rounding alone, below); those
    in ``near_keys`` may also be as far from ``want`` as ``near`` (another
    result) is, plus 1e-5 of the same scale."""
    big = max(v.abs().max().item() for v in want.values())
    bad = {}
    for k, v in want.items():
        err = (got[k].float() - v.float()).abs().max().item()
        scale = max(v.abs().max().item(), 1e-2 * big)
        lim = 2 * LR if k in noise else tol * scale
        if k in near_keys:
            lim = max(lim, (near[k].float() - v.float()).abs().max().item() + 1e-5 * scale)
        if not err <= lim:
            bad[k] = (err, lim) if near is None else (
                err, lim, (near[k].float() - v.float()).abs().max().item() / scale)
    assert not bad, (what, bad)


def _rounding_only(grads):
    """Parameters whose gradient is zero in exact arithmetic and rounding
    alone in f32 (IPA's key bias: a bias shared by every key does not move
    the softmax): below 1e-5 of the largest. Adam's first step there is
    lr x the sign of the rounding, in each run its own."""
    big = max(g.abs().max().item() for g in grads.values())
    return {k for k, g in grads.items() if g.abs().max().item() < 1e-5 * big}


@pytest.fixture(scope="module")
def world4():
    """Every 4-rank case in one spawned world, and their inputs."""
    train, jobs, order = {}, [], []
    for name, dp, sp, B, T, L in TRAIN_CASES:
        cfg = _jcfg(dp, sp, B, T, L)
        params, weights = _weights(cfg)
        batch = {k: torch.from_numpy(v) for k, v in _batch(B, T, L).items()}
        train[name] = dict(cfg=cfg, params=params, weights=weights, batch=batch)
        jobs.append(("train_steps", dict(cfg=_tcfg(cfg), weights=weights, batch=batch,
                                         seed=SEED, device="cpu")))
        order.append(train[name])
    samples = {}
    for name, dp, sp, B, L, method, steps, sampler in SAMPLE_CASES:
        cfg = _jcfg(dp, sp, B, 8, L, method, steps or 2)
        _, weights = _weights(cfg, seed=4)
        raw = _batch(B, 8, L, seed=10)
        feats = featurize_atom14_batch(*(torch.from_numpy(raw[k]) for k in
                                         ("atom14", "seqres", "mask")))
        feats["seqres"] = feats["seqres"].long()
        opts = dict(sampler=sampler, sde_opts={"num_steps": 3} if sampler == "sde" else None)
        samples[name] = dict(cfg=cfg, weights=weights, batch=feats, opts=opts)
        jobs.append(("sample", dict(cfg=_tcfg(cfg), weights=weights, batch=feats, seed=SEED,
                                    device="cpu", **opts)))
        order.append(samples[name])
    for name, dp, sp, B, flags in BRANCH_CASES:
        cfg = _jcfg(dp, sp, B, 8, 4, **flags)
        _, weights = _weights(cfg, seed=7)
        batch = {k: torch.from_numpy(v) for k, v in _batch(B, 8, 4, seed=30).items()}
        train[name] = dict(cfg=cfg, weights=weights, batch=batch)
        jobs.append(("train_steps", dict(cfg=_tcfg(cfg), weights=weights, batch=batch,
                                         seed=SEED, device="cpu")))
        order.append(train[name])
    forward = {}
    for name, B, _ in FORWARD_CASES:
        cfg = _jcfg(2, 2, B, 8, 4)
        _, weights = _weights(cfg, seed=6)
        raw = _batch(B, 8, 4, seed=20)
        feats = featurize_atom14_batch(*(torch.from_numpy(raw[k]) for k in
                                         ("atom14", "seqres", "mask")))
        feats["seqres"] = feats["seqres"].long()
        forward[name] = dict(cfg=cfg, weights=weights, batch=feats)
        jobs.append(("forward_grads", dict(cfg=_tcfg(cfg), weights=weights, batch=feats,
                                           seed=SEED, device="cpu")))
        order.append(forward[name])
    ranks = launch.run(checks.run_jobs, 4, jobs)
    for i, case in enumerate(order):
        case["ranks"] = [r[i] for r in ranks]
    return dict(train=train, samples=samples, forward=forward)


@pytest.mark.parametrize("case", [c[0] for c in TRAIN_CASES])
def test_sharded_step_matches_jax_mesh_and_one_process(world4, case):
    c = world4["train"][case]
    cfg, ranks = c["cfg"], c["ranks"]
    one_cfg = _tcfg(cfg).replace(train=tcfg.TrainConfig(batch_size=cfg.train.batch_size,
                                                         lr=cfg.train.lr))
    one = checks.train_steps(one_cfg, c["weights"], c["batch"], SEED, device="cpu")
    jx = _jax_step(cfg, c["params"], {k: v.numpy() for k, v in c["batch"].items()})
    r0 = ranks[0]
    np.testing.assert_allclose(r0["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["metrics"]["loss"], jx["loss"], rtol=1e-5)
    noise = _rounding_only(one["grads"])
    assert noise <= {k for k in one["grads"] if "linear_k.bias" in k}, noise
    _close(r0["grads"], one["grads"], 1e-5, "grads vs one process")
    _close(r0["params1"], one["params1"], 1e-5, "params vs one process", noise)
    near = NEAR_JAX.get(case, {})
    _close(r0["grads"], jx["grads"], 1e-4, "grads vs JAX's mesh step", near=one["grads"],
           near_keys=near.get("grads", ()))
    _close(r0["params1"], jx["params1"], 1e-4, "params vs JAX's mesh step", noise,
           near=one["params1"], near_keys=near.get("params1", ()))
    for r in ranks[1:]:
        assert r["metrics"] == r0["metrics"]
        assert all(torch.equal(r["params"][k], v) for k, v in r0["params"].items())
    counts = r0["counts"]
    assert jx["all_reduce"] > 0 and counts["all_reduce"] > 0, (jx, counts)
    if cfg.train.sp_size > 1 and r0["axes"][1]:
        assert jx["reshard"] > 0 and counts["all_to_all"] > 0 and counts["all_gather"] > 0
    want_axes = {"fold_B4": (("dp", "sp"), ()), "seq_B2": (("dp",), ("sp",)),
                 "seq_B1_L16": (("dp",), ("sp",))}[case]
    assert r0["axes"] == want_axes


@pytest.mark.parametrize("case", [c[0] for c in BRANCH_CASES])
def test_sharded_step_of_other_branches_matches_one_process(world4, case):
    """``interleave_ipa`` at B = 1 on 1 x 4 (its fused layers split over
    the sequence one at a time, ``FusedLayerFn``'s region; its IPA blocks
    replicated) and dropout at B = 4 on 2 x 2 (the batch fold, every keep
    mask drawn for the whole batch and sliced, ``Dropout(rows=)``): the
    loss, every gradient and the parameters after a step equal the
    one-process step's; the parameters bit-equal across ranks."""
    c = world4["train"][case]
    cfg, ranks = c["cfg"], c["ranks"]
    one_cfg = _tcfg(cfg).replace(train=tcfg.TrainConfig(batch_size=cfg.train.batch_size,
                                                         lr=cfg.train.lr))
    one = checks.train_steps(one_cfg, c["weights"], c["batch"], SEED, device="cpu")
    r0 = ranks[0]
    np.testing.assert_allclose(r0["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-5)
    _close(r0["grads"], one["grads"], 1e-5, "grads vs one process")
    _close(r0["params1"], one["params1"], 1e-5, "params vs one process",
           _rounding_only(one["grads"]))
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], v) for k, v in r0["params"].items())
    if case.startswith("interleave"):
        assert r0["counts"]["all_to_all"] > 0


@pytest.mark.parametrize("case", [c[0] for c in SAMPLE_CASES])
def test_sharded_sampling_matches_one_process(world4, case):
    c = world4["samples"][case]
    cfg = _tcfg(c["cfg"])
    one_cfg = cfg.replace(train=tcfg.TrainConfig(batch_size=cfg.train.batch_size))
    one = checks.sample(one_cfg, c["weights"], c["batch"], SEED, device="cpu", **c["opts"])
    for r in c["ranks"]:
        for k in ("atom14", "aa"):
            assert r[k].shape == one[k].shape
        scale = max(1.0, one["atom14"].abs().max().item())
        assert (r["atom14"] - one["atom14"]).abs().max().item() <= 1e-4 * scale
        assert torch.equal(r["aa"], one["aa"]) and r["steps"] == one["steps"]
        assert r["counts"]["all_gather"] > 0
        if case.startswith("heun"):
            assert r["counts"]["all_to_all"] > 0


@pytest.mark.parametrize("case", [c[0] for c in FORWARD_CASES])
def test_forward_under_the_whole_mesh_matches_one_process(world4, case):
    """``LatentMDGen.forward`` and its backward with the 2 x 2 mesh
    registered and the global batch on every rank: the trunk split as JAX's
    kernels split (``shard_map_batch0`` over the batch where it divides,
    else ``shard_map_batch_seq``), its weights' gradients summed over the
    region by ``CopyToRegion``; the output and every gradient equal to the
    one-process forward's."""
    c = world4["forward"][case]
    cfg = _tcfg(c["cfg"])
    one = checks.forward_grads(cfg.replace(train=tcfg.TrainConfig()), c["weights"], c["batch"],
                               SEED, device="cpu")
    assert sum(one["counts"].values()) == 0
    for r in c["ranks"]:
        scale = max(1.0, one["out"].abs().max().item())
        assert (r["out"] - one["out"]).abs().max().item() <= 1e-5 * scale
        _close(r["grads"], one["grads"], 1e-5, f"{case} gradients")
        counts = r["counts"]
        assert counts["all_gather"] > 0 and counts["all_reduce"] > 0, counts
        assert (counts["all_to_all"] > 0) == case.endswith("B1"), counts


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    synth_data.main(["--outdir", str(root / "data"), "--peptides", "AAGG", "GHKL",
                     "--num_frames", "20", "--suffix", "_i100"])
    return root


def _cli_argv(root, run, *extra):
    split = str(root / "data" / "split.csv")
    return ["--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--crop", "4",
            "--num_frames", "8", "--num_layers", "2", "--embed_dim", "32", "--mha_heads", "2",
            "--ipa_heads", "2", "--ipa_head_dim", "8", "--ipa_qk", "4", "--ipa_v", "4",
            "--suffix", "_i100", "--precision", "32-true", "--batch_size", "2",
            "--data_dir", str(root / "data"), "--train_split", split, "--val_split", split,
            "--workdir", str(root / "work"), "--run_name", run, "--epochs", "1",
            "--steps_per_epoch", "2", "--val_batches", "1", "--print_freq", "1",
            "--device", "cpu", *extra]


def test_train_cli_on_two_ranks(cli_data):
    """``cli/train.py`` under the torchrun environment on 2 gloo ranks
    (``--dp_size 0``: all ranks): rank 0 alone writes the log and the
    checkpoint; the logged train and validation losses equal a one-process
    run's on the same global batches; the same ranks resume from that
    checkpoint (rank 0 reads it and broadcasts it) and train on to step 4."""
    from mdgen_finetune_tpu_torch.cli import train

    resume = _cli_argv(cli_data, "two_resumed", "--dp_size", "0", "--ckpt",
                       str(cli_data / "work" / "two" / "ckpt_2"))
    steps = launch.run(checks.train_cli, 2, _cli_argv(cli_data, "two", "--dp_size", "0"),
                       resume, init=False)
    assert steps == [[2, 4], [2, 4]]
    resumed = cli_data / "work" / "two_resumed"
    lines = [json.loads(x) for x in (resumed / "log.jsonl").read_text().splitlines()]
    assert [m.get("step") for m in lines] == [3, 4, 4] and (resumed / "ckpt_4").is_dir()
    train.main(_cli_argv(cli_data, "one"))
    logs = {}
    for run in ("two", "one"):
        d = cli_data / "work" / run
        logs[run] = [json.loads(x) for x in (d / "log.jsonl").read_text().splitlines()]
        assert sorted(p.name for p in d.iterdir()) == ["ckpt_2", "config.json", "log.jsonl"]
        assert sorted(p.name for p in (d / "ckpt_2").iterdir()) == ["config.json", "state.pt"]
    assert [m.get("step") for m in logs["two"]] == [1, 2, 2]
    for a, b in zip(logs["two"], logs["one"]):
        for k in ("loss", "t_mean", "val_loss"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)


def test_dryrun_multichip_on_four_ranks():
    """``parallel/dryrun.py::dryrun_multichip(4, "cpu")``, the port's
    ``__graft_entry__.dryrun_multichip``: the flagship's full-width train
    step on a 2 x 2 mesh and the B = 1 crop-64 forward split over all four
    ranks, each line JAX's, with nonzero collective counts."""
    import re

    from mdgen_finetune_tpu_torch.parallel.dryrun import dryrun_multichip

    step, forward = dryrun_multichip(4, "cpu")
    m = re.fullmatch(r"dryrun_multichip OK: mesh dp=2 sp=2, flagship 5x384 T=64, loss=[0-9.]+, "
                     r"collectives: all-reduce=(\d+) reshard=(\d+)", step)
    assert m and int(m[1]) > 0 and int(m[2]) > 0, step
    m = re.fullmatch(r"dryrun_multichip OK: B=1 < n_devices=4 large-L \(crop 64, T=16\) "
                     r"forward, collectives=(\d+)", forward)
    assert m and int(m[1]) > 0, forward
