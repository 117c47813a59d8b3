"""PyTorch port, RTB fine-tuning held against the JAX package on the CPU.

The tiny config of ``tests/test_rtb_e2e.py`` (1 layer, 32 wide, 4 heads,
IPA 2 x 8, T = 6, L = 4, f32), seeded random weights made in the port and
carried to JAX by ``to_flax``, and JAX's adapters carried to the port by
``lora_from_flax`` with a seeded nonzero b. JAX's draws are rebuilt here from
its keys (``split(key, 3)``, then ``split(k_scan, S)`` and one
``jax.random.normal`` per step) and handed to the port. Both packages read
the port's featurized batch. Tolerances: the scheduler, the surrogate reward
and the losses 1e-5; sampler states and log-probs 1e-4 relative; every
adapter gradient 1e-3 relative L2; one optimizer update 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TrainConfig, TransportConfig)
from mdgen_finetune_tpu.rtb import lora as jlora_mod
from mdgen_finetune_tpu.rtb import trainer as jtrainer_mod
from mdgen_finetune_tpu.rtb import samplers as JS
from mdgen_finetune_tpu.rtb.priors import MDGenSimulator as JSim
from mdgen_finetune_tpu.rtb.replay_buffer import ReplayBuffer as JReplay
from mdgen_finetune_tpu.rtb.rewards import SurrogateReward as JReward
from mdgen_finetune_tpu.rtb.scheduler import DDPMGFNScheduler as JSched
from mdgen_finetune_tpu.rtb.trainer import RTBConfig as JConfig
from mdgen_finetune_tpu.rtb.trainer import RTBTrainer as JTrainer
from mdgen_finetune_tpu.tasks import prep_batch as j_prep
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.rtb import samplers as TS
from mdgen_finetune_tpu_torch.rtb.lora import lora_init, lora_kernels, lora_merge
from mdgen_finetune_tpu_torch.rtb.priors import MDGenSimulator as TSim
from mdgen_finetune_tpu_torch.rtb.replay_buffer import ReplayBuffer as TReplay
from mdgen_finetune_tpu_torch.rtb.rewards import SurrogateReward as TReward
from mdgen_finetune_tpu_torch.rtb.scheduler import DDPMGFNScheduler as TSched
from mdgen_finetune_tpu_torch.rtb.trainer import RTBConfig as TConfig
from mdgen_finetune_tpu_torch.rtb.trainer import RTBTrainer as TTrainer
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep
from mdgen_finetune_tpu_torch.utils.weights import (from_flax, lora_from_flax, lora_to_flax,
                                                    randomize_, to_flax)

B, T, L, S, NT = 2, 6, 4, 3, 30
DIM = (T, L, 21)
RTB = dict(batch_size=B, sampling_length=S, num_train_timesteps=NT, lora_rank=4, lr=1e-3,
           logz_lr=5e-2, learning_cutoff=0.0, detach_freq=0.34)


def jax_normals(key, n, shape):
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(key, n)])


def fwd_draws(key, n_steps, x_start=True):
    """JAX sample_fwd's draws of ``key``: x_start, per-step noise."""
    k_init, _, k_scan = jax.random.split(key, 3)
    out = {"noise": torch.from_numpy(jax_normals(k_scan, n_steps, (B, *DIM)))}
    if x_start:
        out["x_start"] = torch.from_numpy(np.array(jax.random.normal(k_init, (B, *DIM))))
    return out


def close(got, ref, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rtb"))
    split = make_synthetic_dataset(d, ["AGHK"], num_frames=16)
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2, ipa_head_dim=8,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        transport=TransportConfig(sampling_method="euler", inference_steps=3),
        data=DataConfig(data_dir=d, num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        train=TrainConfig(batch_size=B), workdir=d)
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    sd = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(3), scale=0.15).state_dict()
    tree = to_flax(sd, tc)

    jsim = JSim(cfg, tree, split, batch_size=1)
    eager = jtrainer_mod.lora_init  # one compile instead of an eager draw per kernel
    jtrainer_mod.lora_init = jax.jit(eager, static_argnames=("rank", "targets"))
    try:
        jtr = JTrainer(cfg, JConfig(**RTB), jsim, lambda a, s: jnp.zeros(a.shape[0]), workdir=d)
    finally:
        jtrainer_mod.lora_init = eager
    rng = np.random.default_rng(4)
    jtr.lora = {p: {"a": ab["a"], "b": jnp.asarray(0.3 * rng.standard_normal(ab["b"].shape),
                                                   jnp.float32)}
                for p, ab in jtr.lora.items()}
    tsim = TSim(tc, sd, split, device="cpu")
    ttr = TTrainer(tc, TConfig(**RTB), tsim, lambda a, s: torch.zeros(a.shape[0]), workdir=d)
    with torch.no_grad():
        for p, ab in lora_from_flax(jtr.lora).items():
            for k in ("a", "b"):
                ttr.lora[p][k].copy_(ab[k])

    # a batch of two elements, the second with a padded residue
    g = np.random.default_rng(5)
    aatype = g.integers(0, 20, size=(B, L))
    t7 = g.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = g.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    aat = torch.from_numpy(aatype)
    atom14 = TG.frames_torsions_to_atom14(TRigid.from_tensor_7(torch.from_numpy(t7)),
                                          torch.from_numpy(tors), aat[:, None].expand(B, T, L))
    mask = torch.ones(B, L)
    mask[1, -1] = 0
    tbatch = t_featurize(atom14, aat, mask)
    jcond = jax.jit(lambda b: j_prep(cfg, b)["model_kwargs"])(
        {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()})
    tcond = t_prep(tc, tbatch)["model_kwargs"]
    return dict(cfg=cfg, tc=tc, sd=sd, tree=tree, jtr=jtr, ttr=ttr, jcond=jcond, tcond=tcond,
                split=split, dir=d)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["generator", "noise", "scalar", "target", "uniform"])
def test_scheduler_step_matches_jax(mode):
    kw = dict(num_train_timesteps=50, prediction_type="v_prediction", clip_sample=True,
              clip_sample_range=3.0, variance_type="fixed_large")
    js, ts = JSched(**kw), TSched(**kw)
    js.set_timesteps(10)
    ts.set_timesteps(10)
    np.testing.assert_array_equal(js.timesteps, ts.timesteps)
    g = np.random.default_rng(0)
    x, v, noise, target = (g.normal(size=(3, 4, 5)).astype(np.float32) * 2 for _ in range(4))
    for t in (49, 45, 3, 0, np.array([49, 20, 0])):
        jt, tt = jnp.asarray(t), torch.as_tensor(t)
        assert np.array_equal(np.asarray(js.previous_timestep(jt)),
                              np.asarray(ts.previous_timestep(tt)))
        assert np.array_equal(np.asarray(js.next_timestep(jt)), np.asarray(ts.next_timestep(tt)))
        args_j, args_t = (jnp.asarray(v), jt, jnp.asarray(x)), (torch.from_numpy(v), tt,
                                                                 torch.from_numpy(x))
        if mode in ("generator", "uniform"):
            xT = "uniform" if mode == "uniform" else "gaussian"
            ref = js.step(*args_j, key=jax.random.key(1), xT_type=xT)
            got = ts.step(*args_t, generator=torch.Generator().manual_seed(1), xT_type=xT)
            redraw = torch.Generator().manual_seed(1)
            want = (torch.rand(x.shape, generator=redraw) * 6 - 3 if xT == "uniform"
                    else torch.randn(x.shape, generator=redraw))
            assert torch.equal(got["noise"], want)
            if xT == "uniform":
                assert got["noise"].abs().max() <= 3.0
            add = (torch.as_tensor(t) > 0).float()
            add = add.reshape(-1, 1, 1) if add.ndim else add
            close(got["prev_sample"], got["posterior_mean"] + add * got["posterior_std"] * want,
                  1e-6, 1e-6)
        else:
            extra = {"noise": {"noise": noise}, "scalar": {"noise": 0.7},
                     "target": {"target": target}}[mode]
            ref = js.step(*args_j, **{k: a if isinstance(a, float) else jnp.asarray(a)
                                      for k, a in extra.items()})
            got = ts.step(*args_t, **{k: a if isinstance(a, float) else torch.from_numpy(a)
                                      for k, a in extra.items()})
            for k in ref:
                close(got[k], ref[k], 1e-5, 1e-5)
        for k in ("pred_original_sample", "posterior_mean", "posterior_std"):
            close(got[k], ref[k], 1e-5, 1e-5)

    tvec = np.array([0, 17, 49])
    for fn, args in (("add_noise", (x, noise, tvec)), ("get_velocity", (x, noise, tvec))):
        close(getattr(ts, fn)(*map(torch.as_tensor, args)),
              getattr(js, fn)(*map(jnp.asarray, args)), 1e-5, 1e-5)
    ref = js.add_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(tvec), return_std=True)
    got = ts.add_noise(torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(tvec),
                       return_std=True)
    for a, b in zip(got, ref):
        close(a, b, 1e-5, 1e-5)
    for t in (45, 49, 5):
        ref = js.step_noise(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t))
        got = ts.step_noise(torch.from_numpy(x), torch.from_numpy(noise), t)
        for a, b in zip(got, ref):
            close(a, b, 1e-5, 1e-5)


def test_lora_merge_and_carry_across_match_jax(setup):
    s = setup
    jtr, ttr = s["jtr"], s["ttr"]
    # the same adapted kernels, the same shapes; fused kv keeps one pair
    fresh = lora_init(torch.Generator().manual_seed(0), ttr.model, rank=4)
    assert set(fresh) == set(jtr.lora)
    for p, ab in fresh.items():
        assert tuple(ab["a"].shape) == jtr.lora[p]["a"].shape
        assert tuple(ab["b"].shape) == jtr.lora[p]["b"].shape and not ab["b"].any()
    assert "ipa_layers_0/ipa/linear_kv/kernel" in fresh
    assert "ipa_layers_0/ipa/linear_kv_points/kernel" in fresh
    assert abs(fresh["layers_0/fc1/kernel"]["a"].std().item() - 0.5) < 0.1  # N(0, 1/r)

    # JAX's merged tree, carried across, is the port's merge of the carried adapters
    want = from_flax(jlora_mod.lora_merge(s["tree"]["params"], jtr.lora), s["tc"])
    got = lora_merge(ttr.model, lora_from_flax(jtr.lora))
    names = {n for _, _, parts in lora_kernels(ttr.model).values() for n, _ in parts}
    assert set(got) == names
    assert {"ipa_layers.0.ipa.linear_k.weight", "ipa_layers.0.ipa.linear_v_points.weight"} <= names
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-6, atol=1e-6)
    # the untouched weights stay the base weights
    for n, v in want.items():
        if n not in got:
            assert torch.equal(v, s["sd"][n])
    back = lora_to_flax(lora_from_flax(jtr.lora))
    for p, ab in jtr.lora.items():
        for k in ("a", "b"):
            assert np.array_equal(back[p][k], np.asarray(ab[k]))


def test_sample_fwd_matches_jax(setup):
    """The forward trajectory with a Langevin shift, every state kept."""
    s = setup
    jtr, ttr = s["jtr"], s["ttr"]
    key = jax.random.key(11)
    j_s, t_s = jtr.sampler, ttr.sampler
    j_s.langevin_fn = lambda x, t: 0.01 * jnp.clip(-2 * x, -1.0, 1.0)
    t_s.langevin_fn = lambda x, t: 0.01 * (-2 * x).clamp(-1.0, 1.0)
    try:
        ref = jax.jit(lambda k, lo, c: j_s.sample_fwd(k, lo, c, B, save_traj=True))(
            key, jtr.lora, s["jcond"])
        with torch.no_grad():
            got = t_s.sample_fwd(None, ttr.posterior_context(), s["tcond"], B,
                                 detach_flags=np.zeros(S, bool), save_traj=True,
                                 **fwd_draws(key, S))
    finally:
        j_s.langevin_fn = t_s.langevin_fn = None
    for k in ("x", "logpf_posterior", "logpf_prior", "logpb", "traj"):
        close(got[k], ref[k])
    assert not np.allclose(np.asarray(ref["logpf_posterior"]), np.asarray(ref["logpf_prior"]))


def test_rtb_loss_adapter_gradients_match_jax(setup):
    s = setup
    jtr, ttr = s["jtr"], s["ttr"]
    key = jax.random.key(12)
    logr = np.array([-3.0, 5.0], np.float32)
    trainables = {"lora": jtr.lora, "logZ": jnp.asarray(0.4)}
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jtr._loss, has_aux=True), static_argnums=4)(
        trainables, key, s["jcond"], jnp.asarray(logr), B)
    _, k_detach, _ = jax.random.split(key, 3)
    idx = np.asarray(jax.random.choice(k_detach, S, (int(S * RTB["detach_freq"]),),
                                       replace=False))
    flags = np.zeros(S, bool)
    flags[idx] = True
    assert flags.sum() == 1
    with torch.no_grad():
        ttr.logZ.fill_(0.4)
    res = ttr.sampler.sample_fwd(None, ttr.posterior_context(), s["tcond"], B,
                                 detach_flags=flags, **fwd_draws(key, S))
    loss, aux = ttr.objective(res, torch.from_numpy(logr))
    loss.backward()
    close(loss, jloss, 1e-5, 1e-5)
    close(aux["pf_divergence"], jaux["pf_divergence"])
    params = ttr._trainables()
    worst = 0.0
    for p, ab in jg["lora"].items():
        for k in ("a", "b"):
            g = params[f"lora/{p}/{k}"].grad
            ref = np.asarray(ab[k])
            err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref), 1e-12)
            worst = max(worst, err)
            assert err <= 1e-3, (p, k, err)
    close(params["logZ"].grad, jg["logZ"], 1e-5, 1e-5)
    for p in params.values():
        p.grad = None
    with torch.no_grad():
        ttr.logZ.zero_()


def test_replay_and_back_and_forth_match_jax(setup):
    """``replay_logpf``, and ``sample_back_and_forth`` over the whole chain
    (noise level 1: ``sample_bkw`` from the clean sample to x_T, then
    ``sample_fwd`` back)."""
    s = setup
    jtr, ttr = s["jtr"], s["ttr"]
    g = np.random.default_rng(6)
    x0 = g.normal(size=(B, *DIM)).astype(np.float32)
    with torch.no_grad():
        ctx = ttr.posterior_context()
        # replay: m = 2 stored transitions per element, t per element
        xs, tg = (g.normal(size=(2, B, *DIM)).astype(np.float32) for _ in range(2))
        ts = np.array([29, 10])
        ref = jax.jit(jtr.sampler.replay_logpf)(jtr.lora, s["jcond"], jnp.asarray(xs),
                                                jnp.asarray(ts), jnp.asarray(tg))
        got = ttr.sampler.replay_logpf(ctx, s["tcond"], torch.from_numpy(xs), ts,
                                       torch.from_numpy(tg))
        close(got, ref)

        # the backward chain's draws from k_bkw, the forward's from k_fwd
        key = jax.random.key(14)
        ref = jax.jit(lambda k, lo, c, x: jtr.sampler.sample_back_and_forth(
            k, lo, c, x, noise_level=1.0))(key, jtr.lora, s["jcond"], jnp.asarray(x0))
        k_bkw, k_fwd = jax.random.split(key)
        got = ttr.sampler.sample_back_and_forth(
            None, ctx, s["tcond"], torch.from_numpy(x0), noise_level=1.0,
            bkw_noise=torch.from_numpy(jax_normals(jax.random.split(k_bkw)[0], S, x0.shape)),
            fwd_noise=fwd_draws(k_fwd, S, x_start=False)["noise"])
        assert got["t_mid"] == ref["t_mid"]
        for k in ("x_prime", "logpf_posterior_b", "logpf_prior_b", "logpb_b",
                  "logpf_posterior_f", "logpf_prior_f", "logpb_f"):
            close(got[k], ref[k])
        logr_x, logr_xp = np.array([1.0, -2.0]), np.array([0.5, 3.0])
        close(TS.back_and_forth_loss(got, torch.tensor(logr_x), torch.tensor(logr_xp), 0.1),
              JS.back_and_forth_loss(ref, jnp.asarray(logr_x), jnp.asarray(logr_xp), 0.1))
        # the x_T density term of a full backward chain
        bkw = ttr.sampler.sample_bkw(None, ctx, s["tcond"], torch.from_numpy(x0),
                                     noise=torch.zeros(S, B, *DIM), detach_flags=np.zeros(S, bool))
        part = ttr.sampler.sample_bkw(None, ctx, s["tcond"], torch.from_numpy(x0),
                                      noise=torch.zeros(S, B, *DIM),
                                      detach_flags=np.zeros(S, bool), include_xT_logp=False)
        close(bkw["logpf_prior"] - part["logpf_prior"], TS.xT_logprob(bkw["xT"]),
              1e-5, 1e-3)


def test_baseline_sampler_matches_jax(setup):
    """The guided baseline with the FPS-style particle objective."""
    s = setup
    mc = True
    jtr, ttr = s["jtr"], s["ttr"]
    P = 2
    kw = dict(dim=DIM, sampling_length=S, scale=0.05, mc=mc, particles=P)
    jb = JS.PosteriorPriorBaselineSampler(JSched(num_train_timesteps=NT), jtr.sampler.prior_fn,
                                          **kw)

    def t_prior(x, t, c):  # the frozen prior, differentiable in x
        return ttr.model(x, ttr._time(x, t), trunk_pack=ttr.prior_pack, **c)

    tb = TS.PosteriorPriorBaselineSampler(TSched(num_train_timesteps=NT), t_prior, **kw)

    def jreward(x):
        return -jnp.sum(x ** 2, axis=tuple(range(1, x.ndim)))

    def treward(x):
        return -(x ** 2).sum(dim=tuple(range(1, x.ndim)))

    key = jax.random.key(15)
    ref = jb.sample(key, s["jcond"], B, log_reward_fn=jreward)
    k_init, k_scan = jax.random.split(key)
    steps = [jax.random.split(k) for k in jax.random.split(k_scan, S)]
    noise = np.stack([np.asarray(jax.random.normal(k[0], (B, *DIM))) for k in steps])
    pn = np.stack([jax_normals(k[1], P, (B, *DIM)) for k in steps])
    got = tb.sample(None, s["tcond"], B, log_reward_fn=treward,
                    x_start=torch.from_numpy(np.array(jax.random.normal(k_init, (B, *DIM)))),
                    noise=torch.from_numpy(noise), particle_noise=torch.from_numpy(pn))
    for k in ("x", "logpf_posterior", "logpf_prior"):
        close(got[k], ref[k])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_element", [False, True])
def test_surrogate_reward_matches_jax(per_element):
    g = np.random.default_rng(7)
    atom14 = (g.normal(size=(3, 2, 5, 14, 3)) * 3).astype(np.float32)
    atom14[..., 0, :] += np.arange(5)[:, None] * 3.8
    aat = g.integers(0, 20, size=(3, 5) if per_element else (5,))
    ref = jax.jit(JReward(temperature=2.0).__call__)(jnp.asarray(atom14), jnp.asarray(aat))
    got = TReward(temperature=2.0)(torch.from_numpy(atom14), torch.from_numpy(aat))
    assert got.shape == (3,)
    close(got, ref, 1e-5, 1e-5)


def test_losses_vargrad_and_replay_buffer_match_jax(setup):
    g = np.random.default_rng(8)
    a, b, r = (g.normal(size=6).astype(np.float32) * 10 for _ in range(3))
    for cut in (0.0, 50.0):
        close(TS.rtb_loss(*map(torch.from_numpy, (a,)), 0.3, torch.from_numpy(b),
                          torch.from_numpy(r), cut),
              JS.rtb_loss(jnp.asarray(a), 0.3, jnp.asarray(b), jnp.asarray(r), cut), 1e-5, 1e-5)
    close(TS.vargrad_logz(*map(torch.from_numpy, (a, b, r))),
          JS.vargrad_logz(*map(jnp.asarray, (a, b, r))), 1e-5, 1e-5)
    # per-peptide VarGrad logZ: a segment mean gathered back per element
    ids = np.array([0, 0, 1, 1, 2, 2])
    jtr, ttr = setup["jtr"], setup["ttr"]
    kept = jtr.rtb, ttr.rtb
    jtr.rtb, ttr.rtb = JConfig(vargrad=True), TConfig(vargrad=True)
    try:
        ref = jtr._logz_estimate({}, *map(jnp.asarray, (a, b, r, ids)), 3)
        got = ttr._logz_estimate(*map(torch.from_numpy, (a, b, r, ids)), 3)
    finally:
        jtr.rtb, ttr.rtb = kept
    close(got, ref, 1e-5, 1e-5)

    for mode in ("uniform", "reward"):
        jb, tb = JReplay(10, mode=mode, seed=3), TReplay(10, mode=mode, seed=3)
        for i in range(3):
            x, lr_, loss = g.normal(size=(4, 2, 3)), g.normal(size=4), g.normal(size=4)
            jb.add(x, lr_, loss)
            tb.add(x, lr_, loss)
        for _ in range(2):
            (xj, lj), (xt, lt) = jb.sample(8), tb.sample(8)
            assert np.array_equal(xj, xt) and np.array_equal(lj, lt)
        assert len(tb) == 10


def test_optimizer_update_matches_optax(setup):
    """One (two) updates of chain(clip_by_global_norm, multi_transform(adam
    lr, adam logz_lr)) on the same gradients: the clip spans both groups."""
    jtr, ttr = setup["jtr"], setup["ttr"]
    g = np.random.default_rng(9)
    params = {"lora": {p: {k: np.asarray(v) for k, v in ab.items()} for p, ab in
                       jtr.lora.items()}, "logZ": np.float32(0.2)}
    state = jtr.opt.init(jax.tree.map(jnp.asarray, params))
    tparams = {f"lora/{p}/{k}": torch.from_numpy(np.array(v)) for p, ab in params["lora"].items()
               for k, v in ab.items()}
    tparams["logZ"] = torch.tensor(0.2)
    tstate = ttr.opt.init(tparams)
    jp = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def update(grads, state, jp):
        upd, state = jtr.opt.update(grads, state, jp)
        return optax.apply_updates(jp, upd), state

    for scale in (3.0, 0.001):  # clipped, then not
        grads = jax.tree.map(lambda v: jnp.asarray(scale * g.standard_normal(np.shape(v)),
                                                   jnp.float32), params)
        jp, state = update(grads, state, jp)
        tgrads = {f"lora/{p}/{k}": torch.from_numpy(np.array(v))
                  for p, ab in grads["lora"].items() for k, v in ab.items()}
        tgrads["logZ"] = torch.from_numpy(np.array(grads["logZ"]))
        ttr.opt.step(tparams, tgrads, tstate)
        for p, ab in jp["lora"].items():
            for k in ("a", "b"):
                close(tparams[f"lora/{p}/{k}"], ab[k], 1e-6, 1e-6)
        close(tparams["logZ"], jp["logZ"], 1e-6, 1e-6)
