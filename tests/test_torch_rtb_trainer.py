"""PyTorch port, RTB fine-tuning behaviours on the CPU: the port's copies of
``tests/test_rtb_e2e.py`` and ``tests/test_amber_reward.py`` that need no
OpenMM, plus what the port adds.

- the training step: finite values, the adapters move, the checkpoint
  round-trips; at b = 0 the posterior's log-probs equal the prior's exactly;
- VarGrad, the batched trainer (its adapter gradient is the full-trajectory
  gradient over ``replay_chunk`` on the same trajectory, also when the
  chunk does not divide the chain), the forced
  replay-buffer draw, back-and-forth, Langevin, prior sampling, the host
  (OpenMM-style) reward path;
- the conditional multi-peptide logZ (one VarGrad estimate per peptide) and
  per-element rewards;
- ``policy_params`` with the default policy (a frozen copy at those weights);
- ``DiffuserTrainer``'s loss on fixed held-out draws falls, for ``LatentMDGen``
  and for an outsourced ``UNet3DSeq`` (``model=``), which then serves as the
  posterior of an RTB step (``policy=``, adapters on its Dense kernels);
- the PDB export, the Amber14 reward's grouping with a stand-in energy and
  the target-distribution cache; ``get_reward``;
- ``sample_prior_latent(uniform=True)``;
- ``train_posterior``, ``train_conditional_posterior`` and ``train_prior``
  with ``--device cpu``, and their refusal without a card.

The tiny config of ``tests/test_rtb_e2e.py`` (1 layer, 32 wide, 4 heads, IPA
2 x 8, T = 6, L = 4, f32) on seeded random weights (no prior is trained).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from mdgen_finetune_tpu_torch.cli import (train_conditional_posterior, train_posterior,
                                          train_prior)
from mdgen_finetune_tpu_torch.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                             TrainConfig, TransportConfig)
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models
from mdgen_finetune_tpu_torch.inference import sample_prior_latent
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.rtb.denoisers import UNet3DSeq
from mdgen_finetune_tpu_torch.rtb.priors import MDGenSimulator
from mdgen_finetune_tpu_torch.rtb.rewards import (Amber14Reward, SurrogateReward, get_reward)
from mdgen_finetune_tpu_torch.rtb.trainer import (DiffuserTrainer, RTBBatchedTrainer, RTBConfig,
                                                  RTBTrainer)
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.weights import randomize_

SMALL = dict(batch_size=2, sampling_length=3, num_train_timesteps=30, lora_rank=4)


def _cfg(d, workdir):
    return MDGenConfig(
        model=ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        transport=TransportConfig(sampling_method="euler", inference_steps=3),
        data=DataConfig(data_dir=d, num_frames=6, crop=4), task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=2), workdir=workdir)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rtb_data"))
    split = make_synthetic_dataset(d, ["AGHK"], num_frames=64)
    split2 = make_synthetic_dataset(os.path.join(d, "two"), ["AGHK", "KHGA"], num_frames=64)
    cfg = _cfg(d, str(tmp_path_factory.mktemp("rtb_work")))
    sd = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(1), scale=0.1).state_dict()
    return dict(cfg=cfg, sd=sd, split=split, split2=split2, dir=d)


def _sim(s, **kw):
    return MDGenSimulator(s["cfg"], s["sd"], kw.pop("split", s["split"]), device="cpu", **kw)


REWARD = SurrogateReward(temperature=100.0)


def _snapshot(tr):
    return {p: ab["b"].detach().clone() for p, ab in tr.lora.items()}


def _moved(tr, before):
    return any(not torch.equal(tr.lora[p]["b"], b) for p, b in before.items())


def _trainer(s, tmp_path, cls=RTBTrainer, sim=None, **rtb):
    return cls(s["cfg"], RTBConfig(**{**SMALL, **rtb}), sim or _sim(s), REWARD,
               workdir=str(tmp_path))


# ---------------------------------------------------------------------------
def test_rtb_training_step_and_checkpoint(setup, tmp_path):
    tr = _trainer(setup, tmp_path, lr=1e-3, learning_cutoff=0.0)
    # b = 0: the posterior is the prior, bit for bit
    cond, _ = tr.prior_sim.get_cond_args()
    res = tr.sampler.sample_fwd(torch.Generator().manual_seed(0), tr.posterior_context(),
                                tr._replicate(cond, 2), 2)
    assert torch.equal(res["logpf_posterior"], res["logpf_prior"])
    assert torch.isfinite(res["logpb"]).all() and res["x"].shape == (2, 6, 4, 21)

    before = _snapshot(tr)
    hist = tr.run(n_iterations=3, log_every=1, log_fn=lambda m: None)
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["logr"]) for h in hist)
    assert _moved(tr, before)
    path = tr.save()
    saved = {p: {k: v.clone() for k, v in ab.items()} for p, ab in tr.lora.items()}
    logZ, count = float(tr.logZ.detach()), tr.opt_state["count"]
    with torch.no_grad():
        for ab in tr.lora.values():
            ab["b"].add_(1.0)
        tr.logZ.fill_(7.0)
    tr.load(path)
    assert float(tr.logZ.detach()) == logZ and tr.opt_state["count"] == count == 3
    assert all(torch.equal(tr.lora[p][k], saved[p][k]) for p in saved for k in ("a", "b"))


def test_vargrad_and_prior_sampling(setup, tmp_path):
    tr = _trainer(setup, tmp_path, vargrad=True)
    m = tr.step(0)
    assert np.isfinite(m["loss"]) and np.isfinite(m["logZ"])
    assert float(tr.logZ.detach()) == m["logZ"]  # logZ is the batch estimate
    tr = _trainer(setup, tmp_path, prior_sampling=True, prior_sampling_ratio=1.0)
    assert np.isfinite(tr.step(0)["loss"])


def _batched_vs_full(s, tmp_path, sampling_length, m):
    """The full-trajectory and the batched trainer's gradients on the same
    trajectory: the batched adapter gradient times m is the full one, and
    logZ's times m / S (every replayed transition carries logZ), within
    1e-4 relative L2 per tensor; then both train."""
    kw = dict(sampling_length=sampling_length, num_train_timesteps=20, lr=1e-3,
              learning_cutoff=0.0)
    grads = {}
    for name, cls, extra in (("full", RTBTrainer, {}),
                             ("batched", RTBBatchedTrainer, {"replay_chunk": m})):
        tr = cls(s["cfg"], RTBConfig(**{**SMALL, **kw}), _sim(s), REWARD,
                 workdir=str(tmp_path), **extra)
        with torch.no_grad():  # a nonzero b: the gradient is not the init's
            for ab in tr.lora.values():
                ab["b"].normal_(generator=torch.Generator().manual_seed(2)).mul_(0.1)
        draws = tr.sampler.draws(torch.Generator().manual_seed(3), 2)
        kept = tr._apply_gradients

        def capture(tr=tr, name=name, kept=kept):
            grads[name] = {k: p.grad.clone() for k, p in tr._trainables().items()}
            kept()

        tr._apply_gradients = capture
        before = _snapshot(tr)
        mt = tr.step(0, draws=draws)
        assert np.isfinite(mt["loss"]) and np.isfinite(mt["logr"]) and _moved(tr, before)
    # relative L2 per tensor: the replayed state is the stored one up to the
    # rounding of (target - mean) / std
    for k, g in grads["full"].items():
        scale = m / sampling_length if k == "logZ" else m
        assert (grads["batched"][k] * scale - g).norm() <= 1e-4 * g.norm(), k


def test_batched_gradient_is_the_trajectory_gradient(setup, tmp_path):
    """On the same trajectory the batched trainer's adapter gradient is the
    full-trajectory RTB gradient over ``replay_chunk`` (each chunk averages
    over m * B replayed transitions), within 1e-4 relative L2; then both
    train."""
    _batched_vs_full(setup, tmp_path, sampling_length=4, m=2)


def test_batched_gradient_with_a_filled_last_chunk(setup, tmp_path):
    """As above with m not dividing S (5 steps, chunks of 2): the last
    chunk's fill carries no weight, so the last transition counts once."""
    _batched_vs_full(setup, tmp_path, sampling_length=5, m=2)


def test_replay_buffer_training_path(setup, tmp_path):
    """rb_ratio = 1: after the ``it > batch_size`` gate every step is a
    buffer draw, which trains and does not re-enter the buffer."""
    tr = _trainer(setup, tmp_path, lr=1e-2, learning_cutoff=0.0, replay_buffer=True,
                  rb_ratio=1.0, rb_strategy="reward")
    for i in range(3):
        tr.step(i)
    assert len(tr.replay) >= 2
    before, n = _snapshot(tr), len(tr.replay)
    m = tr.step(3)
    assert np.isfinite(m["loss"]) and len(tr.replay) == n and _moved(tr, before)


def test_back_and_forth_langevin_and_host_reward(setup, tmp_path):
    tr = _trainer(setup, tmp_path, sampling_length=4, num_train_timesteps=20, lr=1e-2,
                  learning_cutoff=0.0, back_and_forth=True, bf_freq=2)
    tr.step(0)
    assert tr._last_x is not None
    before, last = _snapshot(tr), tr._last_x
    m = tr.step(1)  # it % bf_freq == bf_freq - 1: the back-and-forth step
    assert np.isfinite(m["loss"]) and _moved(tr, before) and not torch.equal(tr._last_x, last)

    tr = _trainer(setup, tmp_path, langevin=True, lgv_scale=0.05)
    assert tr.sampler.langevin_fn is not None  # the latent-manifold proxy
    assert np.isfinite(tr.step(0)["loss"])

    # a host oracle: the trajectory sampled, scored, then re-run with gradients
    calls = []

    def host(atom14, aatype):
        calls.append(atom14.shape)
        return REWARD(atom14, aatype).numpy()

    tr = RTBTrainer(setup["cfg"], RTBConfig(**SMALL, lr=1e-3), _sim(setup), host,
                    workdir=str(tmp_path), reward_on_device=False)
    before = _snapshot(tr)
    m = tr.step(0)
    assert np.isfinite(m["loss"]) and calls == [(2, 6, 4, 14, 3)] and _moved(tr, before)


def test_conditional_multi_peptide_rtb(setup, tmp_path):
    """One batch mixes two peptides: VarGrad gives one logZ per peptide and
    each element is scored with its own sequence."""
    s = setup
    sim = _sim(s, split=s["split2"], data_dir=os.path.dirname(s["split2"]), batch_size=2,
               distinct_peptides=True)
    tr = _trainer(s, tmp_path, sim=sim, batch_size=4, vargrad=True, learning_cutoff=0.0)
    cond, batch = sim.get_cond_args()
    assert len(set(batch["name"])) == 2
    ids, n = tr._peptide_ids(batch, 4)
    assert n == 2 and ids.tolist() == [0, 0, 1, 1]
    cond = tr._replicate(cond, 4)
    rep = tr._replicate({k: v for k, v in batch.items() if k != "name"}, 4)
    assert cond["start_frames"].rot.shape[0] == 4
    assert not torch.equal(rep["seqres"][0], rep["seqres"][2])
    res = tr.sampler.sample_fwd(torch.Generator().manual_seed(0), tr.posterior_context(), cond, 4)
    logr = tr._decode_reward(rep, res["x"])
    _, aux = tr.objective(res, logr, ids, n)
    lz = aux["logZ_vec"]
    assert lz[0] == lz[1] and lz[2] == lz[3] and lz[0] != lz[2]
    assert torch.isfinite(logr).all() and logr[0] != logr[2]
    before = _snapshot(tr)
    m = tr.step(0)
    assert np.isfinite(m["loss"]) and _moved(tr, before)


def test_diffuser_trainer_loss_falls_and_unet_refused(setup):
    s = setup
    sim = _sim(s, batch_size=2)
    cond, _ = sim.get_cond_args()
    T, L, D = sim.latent_shape

    def source(g):
        return sample_prior_latent(g, 2, T, L, D, uniform=True)

    def held_out():  # the loss on 8 fixed draws of (clean, t, noise)
        g = torch.Generator().manual_seed(99)
        with torch.no_grad():
            return np.mean([float(dt.loss(g, source(g))) for _ in range(8)])

    dt = DiffuserTrainer(s["cfg"], source, cond, lr=1e-3, num_train_timesteps=30, device="cpu")
    params = dt.init_params()
    state = dt.opt.init(params)
    before = held_out()
    params, state, losses = dt.train(params, state, 30, torch.Generator().manual_seed(0))
    assert np.isfinite(losses).all() and held_out() < before

    # the outsourced UNet: distilled by DiffuserTrainer(model=),
    # then the posterior of an RTB step, adapters on its Dense kernels
    torch.manual_seed(0)
    unet = UNet3DSeq(out_dim=D, model_channels=8, channel_mult=(1, 2), num_res_blocks=1,
                     attention_resolutions=(2,), num_head_channels=8)
    dt = DiffuserTrainer(s["cfg"], source, cond, lr=1e-3, num_train_timesteps=30, model=unet,
                         device="cpu")
    params = dt.init_params()
    state = dt.opt.init(params)
    before = held_out()
    params, state, losses = dt.train(params, state, 20, torch.Generator().manual_seed(0))
    assert np.isfinite(losses).all() and held_out() < before
    tr = RTBTrainer(s["cfg"], RTBConfig(**SMALL, lr=1e-3, learning_cutoff=0.0), sim, REWARD,
                    policy=unet, policy_params=params,
                    lora_targets=lambda p: p.endswith("kernel"))
    assert tr.lora and all(p.startswith("UNet2D_0/") and "Conv" not in p for p in tr.lora)
    snap = _snapshot(tr)
    m = tr.step(0)
    assert np.isfinite(m["loss"]) and np.isfinite(m["logr"]) and _moved(tr, snap)
    assert all(torch.equal(v, params[k]) for k, v in tr.model.state_dict().items())


def test_policy_params_replace_the_prior_weights(setup, tmp_path):
    """``policy_params`` with the default policy: a frozen LatentMDGen copy
    at those weights (the simulator's model untouched), b = 0 exact."""
    s = setup
    sim = _sim(s)
    sd2 = randomize_(LatentMDGen(s["cfg"]), torch.Generator().manual_seed(5), scale=0.1)
    sd2 = sd2.state_dict()
    kept = {k: v.clone() for k, v in sim.engine.model.state_dict().items()}
    tr = RTBTrainer(s["cfg"], RTBConfig(**SMALL), sim, REWARD, workdir=str(tmp_path),
                    policy_params=sd2)
    assert tr.model is not sim.engine.model
    assert all(torch.equal(v, sd2[k]) for k, v in tr.model.state_dict().items() if k in sd2)
    assert all(torch.equal(v, kept[k]) for k, v in sim.engine.model.state_dict().items())
    cond, _ = sim.get_cond_args()
    res = tr.sampler.sample_fwd(torch.Generator().manual_seed(0), tr.posterior_context(),
                                tr._replicate(cond, 2), 2)
    assert torch.equal(res["logpf_posterior"], res["logpf_prior"])
    with pytest.raises(KeyError):
        RTBTrainer(s["cfg"], RTBConfig(**SMALL), sim, REWARD, policy_params={"nope": sd2[
            next(iter(sd2))]})


def test_prior_latent_uniform():
    g = torch.Generator().manual_seed(0)
    z = sample_prior_latent(g, 3, 5, 4, 21, uniform=True)
    assert z.shape == (3, 5, 4, 21) and z.min() >= -3 and z.max() <= 3 and z.std() > 1.5
    z = sample_prior_latent(g, 3, 5, 4, 41, design=True, uniform=True)
    cont, simplex = z[..., :21], z[..., 21:]
    assert cont.min() >= -3 and cont.max() <= 3
    torch.testing.assert_close(simplex.sum(-1), torch.ones(3, 5, 4))
    assert (simplex >= 0).all() and torch.equal(simplex, simplex[:, :1].expand_as(simplex))


def _radius_energy(aatype, xyz):
    """A stand-in energy: mean squared distance from the centroid."""
    xyz = np.asarray(xyz)
    return float(np.mean(np.sum((xyz - xyz.mean(0)) ** 2, axis=-1)))


def test_pdb_export_amber_semantics_and_target_cache(setup, tmp_path):
    s = setup
    cfg = s["cfg"].replace(workdir=str(tmp_path))
    sim = MDGenSimulator(cfg, None, s["split"], device="cpu")  # no decode needed
    arr = np.load(sim.dataset._path("AGHK"), mmap_mode="r")
    paths = sim.fix_and_save_pdbs(np.asarray(arr[:3], np.float32), "AGHK")
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
    assert np.load(os.path.join(sim.out_dir, "AGHK_torsions.npy")).shape == (3, 4, 7, 2)
    models = from_pdb_models(os.path.join(sim.out_dir, "AGHK_traj.pdb"))
    assert len(models) == 3 and len(models[0][0]) == 4 and models[0][1].shape[1] == 3

    logs, logrs = Amber14Reward(energy_backend=_radius_energy, energy_temperature=2.0)(
        tmp_dir=sim.out_dir)
    assert logs["AGHK"]["log_r"].shape == (3,) and logs["AGHK"]["torsions"].shape == (3, 4, 7, 2)
    np.testing.assert_allclose(logrs, logs["AGHK"]["log_r"])
    np.testing.assert_allclose(logrs[0], -_radius_energy(*models[0]) / 2.0, rtol=1e-6)
    assert glob.glob(os.path.join(sim.out_dir, "*.pdb")) == []  # cleaned up

    calls = []

    def reward_fn(paths=None, tmp_dir=None):
        calls.append(tmp_dir)
        return Amber14Reward(energy_backend=_radius_energy)(paths=paths, tmp_dir=tmp_dir)

    td = sim.ensure_target_dist(reward_fn, sample_size=5)
    assert td["AGHK"]["log_r"].shape == (5,) and os.path.exists(sim.target_dist_path)
    sim.ensure_target_dist(reward_fn, sample_size=5)
    sim2 = MDGenSimulator(cfg, None, s["split"], device="cpu")
    np.testing.assert_allclose(sim2.target_dist["AGHK"]["log_r"], td["AGHK"]["log_r"])
    sim2.ensure_target_dist(reward_fn, sample_size=5)
    assert len(calls) == 1

    try:
        import openmm  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            get_reward("amber14")
        r = get_reward("auto", temperature=3.0)
        assert isinstance(r, SurrogateReward) and r.temperature == 3.0


def test_cli_train_posterior_conditional_and_prior_on_cpu(setup, tmp_path, capsys):
    s = setup
    cfg = s["cfg"].replace(workdir=str(tmp_path))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(1), scale=0.1)
    ckpt = trainer.save_checkpoint(state, str(tmp_path / "ckpt"))
    common = ["--sim_ckpt", ckpt, "--batch_size", "2", "--sampling_length", "3",
              "--traj_length", "30", "--lora_rank", "4", "--workdir", str(tmp_path / "w"),
              "--print_freq", "1", "--device", "cpu"]
    data = ["--data_dir", s["dir"], "--split", s["split"]]
    train_posterior.main(data + common + [
        "--reward", "auto", "--n_iterations", "2", "--exp_name", "smoke", "--replay_buffer",
        "--rb_sample_strategy", "reward", "--langevin", "--prior_sampling",
        "--prior_sampling_ratio", "0.5"])
    out = capsys.readouterr().out.strip().splitlines()
    chosen = json.loads(out[0])
    assert chosen["device"] == "cpu" and chosen["asked"] == "auto"
    log = (tmp_path / "w" / "smoke" / "log.jsonl").read_text().strip().splitlines()
    assert len(log) == 2 and all(np.isfinite(json.loads(ln)["loss"]) for ln in log)
    assert (tmp_path / "w" / "smoke" / "checkpoint.pt").exists()

    two = os.path.dirname(s["split2"])
    train_conditional_posterior.main(["--data_dir", two, "--split", s["split2"]] + common + [
        "--reward", "surrogate", "--n_iterations", "1", "--exp_name", "cond"])
    m = json.loads((tmp_path / "w" / "cond" / "log.jsonl").read_text().strip().splitlines()[-1])
    assert np.isfinite(m["loss"]) and np.isfinite(m["logZ"])
    capsys.readouterr()

    train_prior.main(data + ["--sim_ckpt", ckpt, "--batch_size", "2", "--n_steps", "4",
                             "--traj_length", "30", "--print_freq", "2", "--workdir",
                             str(tmp_path / "w"), "--device", "cpu"])
    steps = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [m["step"] for m in steps] == [2, 4] and all(np.isfinite(m["loss"]) for m in steps)
    sd = torch.load(tmp_path / "w" / "prior_distill" / "prior_params.pt")
    assert set(sd) == set(LatentMDGen(cfg).state_dict())

    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_posterior.main(data + common[:-2] + ["--n_iterations", "1"])


def test_plots_write_their_files(tmp_path):
    """``rtb/plots.py``: the JS divergence of a sample with itself is ~0 and
    of two disjoint ones ~ln 2; the energy, distance and TICA plots write
    their files."""
    from mdgen_finetune_tpu_torch.rtb import plots

    g = np.random.default_rng(0)
    a = g.normal(size=500)
    assert plots.js_divergence(a, a) < 1e-9
    assert abs(plots.js_divergence(a, a + 100.0) - np.log(2)) < 1e-3
    jsd = plots.plot_energy_distributions(a, a + 0.5, str(tmp_path / "e.png"))
    assert 0 < jsd < np.log(2)
    a14 = g.normal(size=(20, 4, 14, 3)) * 3
    plots.rel_distance_histograms(a14, a14 + 1.0, str(tmp_path / "d.png"))
    feats = np.cumsum(g.normal(size=(400, 3)), axis=0)
    plots.tica_scatter(feats[:200], feats, str(tmp_path / "t.png"), lag=10)
    assert all((tmp_path / f).exists() for f in ("e.png", "d.png", "t.png"))
