"""PyTorch port, the outsourced RTB policies' schedulers and pipelines held
against the JAX package on the CPU: the extra schedulers
(``rtb/schedulers_extra.py``), the four pipelines (``rtb/pipelines.py``)
and ``utils/logging.MetricLogger``. The UNets are held to flax in
``test_torch_rtb_denoisers.py``, and an RTB loss with a ``UNet3DSeq``
posterior in ``test_torch_rtb_unet_policy.py``.

JAX's draws are rebuilt from its keys and handed to the port. Tolerances:
scheduler steps and pipelines 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.rtb import pipelines as JP
from mdgen_finetune_tpu.rtb import schedulers_extra as JX
from mdgen_finetune_tpu.utils.logging import MetricLogger as JLogger
from mdgen_finetune_tpu_torch.rtb import pipelines as TP
from mdgen_finetune_tpu_torch.rtb import schedulers_extra as TX
from mdgen_finetune_tpu_torch.utils.logging import MetricLogger as TLogger


def close(got, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(ref), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# schedulers
SCHEDULERS = {
    "ddim_eta1": (lambda m: m.DDIMGFNScheduler(num_train_timesteps=20, eta=1.0), 5),
    "ddim_eta07_eps": (lambda m: m.DDIMGFNScheduler(num_train_timesteps=20, eta=0.7,
                                                    prediction_type="epsilon"), 5),
    "ddpm_dp": (lambda m: m.DDPMDPScheduler(num_train_timesteps=50, clip_sample=False), 10),
    "ddpm_dp_trailing_zsnr_v": (lambda m: m.DDPMDPScheduler(
        num_train_timesteps=50, timestep_spacing="trailing", rescale_betas_zero_snr=True,
        prediction_type="v_prediction", beta_schedule="scaled_linear"), 10),
    "ddpm_dp_threshold_sigmoid": (lambda m: m.DDPMDPScheduler(
        num_train_timesteps=50, thresholding=True, prediction_type="sample",
        beta_schedule="sigmoid", sample_max_value=3.0), 10),
    "sde_ve": (lambda m: m.SDEVEGFNScheduler(num_train_timesteps=20), None),
    "edm_euler": (lambda m: m.EDMEulerGFNScheduler(num_inference_steps=10), None),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_extra_scheduler_steps_match_jax(name):
    make, n_inf = SCHEDULERS[name]
    js, ts = make(JX), make(TX)
    if n_inf:
        np.testing.assert_array_equal(js.set_timesteps(n_inf), ts.set_timesteps(n_inf))
    for attr in ("betas", "alphas_cumprod", "sigmas"):
        if hasattr(js, attr):
            close(getattr(ts, attr), getattr(js, attr), 1e-6)
    g = np.random.default_rng(6)
    x, out, noise, target = (g.normal(size=(3, 4, 5)).astype(np.float32) * 4 for _ in range(4))
    steps = [int(v) for v in ts.timesteps[[0, 1, -2, -1]]] + [np.asarray(ts.timesteps[:3])]
    for t in steps:
        jt, tt = jnp.asarray(t), torch.as_tensor(t)
        if n_inf:
            assert np.array_equal(np.asarray(js.previous_timestep(jt)),
                                  np.asarray(ts.previous_timestep(tt)))
        if name in ("sde_ve", "edm_euler") and np.ndim(t):
            continue  # the JAX package's SDE-VE / EDM steps take a scalar t only
        for kw in ({"noise": noise}, {"noise": 0.7}, {"target": target}):
            if name == "edm_euler" and "target" in kw:
                continue
            ref = js.step(jnp.asarray(out), jt, jnp.asarray(x),
                          **{k: v if isinstance(v, float) else jnp.asarray(v)
                             for k, v in kw.items()})
            got = ts.step(torch.from_numpy(out), tt, torch.from_numpy(x),
                          **{k: v if isinstance(v, float) else torch.from_numpy(v)
                             for k, v in kw.items()})
            assert set(got) == set(ref)
            for k in ref:
                close(got[k], np.broadcast_to(ref[k], np.shape(got[k])))
        # drawn noise: the reparametrized identity, and a final step without noise
        got = ts.step(torch.from_numpy(out), tt, torch.from_numpy(x),
                      generator=torch.Generator().manual_seed(0))
        if name != "edm_euler":
            add = torch.as_tensor(np.reshape(np.asarray(t) > 0, (-1, 1, 1) if np.ndim(t) else ()))
            close(got["prev_sample"], got["posterior_mean"]
                  + add * got["posterior_std"] * got["noise"])
    if name == "ddpm_dp_trailing_zsnr_v":
        np.testing.assert_array_equal(TX.DDPMDPScheduler(num_train_timesteps=10,
                                                         timestep_spacing="trailing")
                                      .set_timesteps(5), [9, 7, 5, 3, 1])
        assert abs(np.cumprod(1 - TX.rescale_zero_terminal_snr(np.linspace(1e-4, 0.02,
                                                                            100)))[-1]) < 1e-10
        np.testing.assert_allclose(TX.rescale_zero_terminal_snr(np.linspace(1e-4, 0.02, 100)),
                                   JX.rescale_zero_terminal_snr(np.linspace(1e-4, 0.02, 100)))
    if name == "ddpm_dp":  # the 1000 / T linear rescale, no T-1 quirk
        np.testing.assert_allclose(float(ts.betas[0]), 1000.0 / 50 * 1e-4, rtol=1e-6)
        assert int(ts.previous_timestep(49)) == 49 - 5
    if name == "ddpm_dp_threshold_sigmoid":
        big = torch.from_numpy(g.normal(size=(2, 16)).astype(np.float32) * 10)
        x0 = ts.pred_x0(big, 10, torch.zeros(2, 16))
        close(x0, js.pred_x0(jnp.asarray(big.numpy()), jnp.asarray(10), jnp.zeros((2, 16))))
        assert float(x0.abs().max()) <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# pipelines
def _toy_denoiser(lib):
    def fn(x, t, shift=None):
        tt = t.reshape((-1,) + (1,) * (x.ndim - 1)).astype(x.dtype) if lib is jnp else \
            t.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        out = 0.1 * x * lib.cos(tt / 100.0) - 0.05 * lib.sign(x)
        return out if shift is None else out + shift
    return fn


def _cpu(m):
    return {"device": "cpu"} if m is TP else {}


PIPELINES = {
    "ddpm_gfn": lambda m, f: m.DDPMGFNPipeline(f, num_train_timesteps=50, **_cpu(m)),
    "ddim_gfn": lambda m, f: m.DDIMGFNPipeline(f, eta=0.7, num_train_timesteps=50, **_cpu(m)),
    "ddpm_dp": lambda m, f: m.DDPMDPPipeline(f, num_train_timesteps=50, **_cpu(m)),
    "ldm_gfn": lambda m, f: m.LDMGFNPipeline(
        f, (lambda z: jnp.tanh(z) * 2.0) if m is JP else (lambda z: torch.tanh(z) * 2.0),
        num_train_timesteps=50, **_cpu(m)),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipelines_match_jax(name):
    """JAX's draws rebuilt from its key: split(key) -> (kx, kr); x from kx
    (uniform(-3, 3) for the LDM case), then one split of the carried key a
    step, the step noise a normal of the second half."""
    jp, tp = PIPELINES[name](JP, _toy_denoiser(jnp)), PIPELINES[name](TP, _toy_denoiser(torch))
    key, shape, steps = jax.random.key(3), (2, 3, 4, 4), 6
    noise_type = "uniform" if name == "ldm_gfn" else "gaussian"
    shift = np.full(shape, 0.2, np.float32)
    ref = jp(key, batch_size=2, num_inference_steps=steps, x_shape=shape[1:],
             condition={"shift": jnp.asarray(shift)}, noise_type=noise_type)
    kx, k = jax.random.split(key)
    x_init = (6.0 * jax.random.uniform(kx, shape) - 3.0 if noise_type == "uniform"
              else jax.random.normal(kx, shape))
    noises = []
    for _ in range(steps):
        k, ks = jax.random.split(k)
        noises.append(torch.from_numpy(np.array(jax.random.normal(ks, shape))))
    got = tp(None, batch_size=2, num_inference_steps=steps, x_shape=shape[1:],
             condition={"shift": torch.from_numpy(shift)}, noise_type=noise_type,
             x_init=torch.from_numpy(np.array(x_init)), noises=noises)
    np.testing.assert_array_equal(tp.scheduler.timesteps, jp.scheduler.timesteps)
    assert got.shape == shape and torch.isfinite(got).all()
    close(got, ref)
    # drawn from a generator: deterministic for a seed
    a = tp(torch.Generator().manual_seed(1), batch_size=2, num_inference_steps=steps,
           x_shape=shape[1:])
    b = tp(torch.Generator().manual_seed(1), batch_size=2, num_inference_steps=steps,
           x_shape=shape[1:])
    assert torch.equal(a, b)


def test_pipeline_scheduler_guard_and_passthrough():
    sched = TX.DDPMDPScheduler(num_train_timesteps=40)
    pipe = TP.DDPMGFNPipeline(_toy_denoiser(torch), scheduler=sched)
    out = pipe(torch.Generator().manual_seed(3), batch_size=2, num_inference_steps=5,
               x_shape=(1, 4, 4), noise_type="uniform")
    assert out.shape == (2, 1, 4, 4) and sched.num_inference_steps == 5
    with pytest.raises(TypeError):
        TP.DDPMGFNPipeline(_toy_denoiser(torch), scheduler=TX.SDEVEGFNScheduler())
    if not torch.cuda.is_available():  # the card by default, no quiet fall-back
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.DDIMGFNPipeline(_toy_denoiser(torch))


# ---------------------------------------------------------------------------
def test_metric_logger_line_matches_jax(tmp_path):
    lines = {}
    for name, cls in (("jax", JLogger), ("torch", TLogger)):
        out = tmp_path / name
        log = cls(str(out))
        for v in (1.0, 2.5, float("nan"), 4.0):
            log.add("loss", v)
        log.add("lr", np.float32(3e-4))
        first = log.flush(7, extra={"epoch": 1})
        log.add("loss", 0.5)
        log.flush(8)
        lines[name] = (out / "metrics.jsonl").read_text().splitlines()
        assert first == json.loads(lines[name][0])
    assert lines["torch"] == lines["jax"]
