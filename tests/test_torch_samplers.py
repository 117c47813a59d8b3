"""PyTorch port, the ODE samplers held against the JAX package on the CPU:

- ``ode_euler``, ``ode_heun`` and the adaptive ``ode_dopri5`` against the
  JAX package's ``transport/samplers.py`` on an analytic drift: the same
  final state, and for dopri5 the same accepted and rejected step counts
  (read from the JAX solve's drift-evaluation times);
- ``Transport.drift_fn`` for the score and noise objectives against JAX's;
- the whole slice: ``InferenceEngine.sample_with_zs0`` with Heun (the
  generic ODE path through ``LatentMDGen.forward_inference``) against the
  JAX package's ``InferenceEngine._sample`` with the same weights and the
  same prior latent and the same featurized batch, at T = 264 (above
  MAX_T, so the frame stage runs the tiled core's plain twin). The
  trajectory is built, featurized and initialised by the port (the JAX
  package's eager geometry, featurization and jitted init cost ~13 s on the
  CPU; ``test_torch_geometry.py`` and ``test_torch_weights.py`` hold those
  pieces to JAX).

Sizes: the drift acts on a (2, 5, 3) state; the slice uses 2 layers,
C = 48 with 2 heads (head dim 24), a 2-head IPA encoder, T = 264, L = 4,
B = 1, 2 Heun steps, f32. Tolerances: states rtol 1e-5 / atol 1e-6 (f32, the
same operations in the same order; XLA may fuse into FMAs); atom14 1e-3
Angstrom as in test_torch_sampling.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.transport import samplers as js
from mdgen_finetune_tpu.transport.transport import Transport as JTransport
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen as TModel
from mdgen_finetune_tpu_torch.transport import samplers as ts
from mdgen_finetune_tpu_torch.transport.transport import Transport as TTransport
from mdgen_finetune_tpu_torch.utils.weights import to_flax

RTOL, ATOL = 1e-5, 1e-6


def _jdrift(x, t):
    return -(1.0 + t)[:, None, None] * x + 0.5 * jnp.sin(8.0 * t)[:, None, None]


def _tdrift(x, t):
    return -(1.0 + t)[:, None, None] * x + 0.5 * torch.sin(8.0 * t)[:, None, None]


def _x0():
    return np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_fixed_step_samplers_match_jax(method):
    x0 = _x0()
    ref = getattr(js, f"ode_{method}")(_jdrift, jnp.asarray(x0), 0.0, 1.0, 10)
    out, counts = ts.sample_ode(_tdrift, torch.from_numpy(x0), t0=0.0, t1=1.0, method=method,
                                num_steps=10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert counts == {"accepted": 10, "rejected": 0, "evals": 10 * (1 + (method == "heun"))}


def _jax_dopri5_attempts(x0, t0, t1):
    """JAX's dopri5 and, from the times of its drift evaluations, whether
    each attempt was accepted: stage 1 of an attempt runs at t + h/5 and
    stage 5 at t + h, and an attempt was accepted when the next one starts
    at t + h rather than at t."""
    times = []

    def drift(x, t):
        jax.debug.callback(lambda tt: times.append(float(tt[0])), t, ordered=True)
        return _jdrift(x, t)

    y = jax.jit(lambda x: js.ode_dopri5(drift, x, t0, t1))(jnp.asarray(x0))
    y.block_until_ready()
    att = np.asarray(times[1:], np.float64).reshape(-1, 6)
    h = (att[:, 4] - att[:, 0]) / 0.8
    t = att[:, 4] - h
    accepted = [bool(t[k + 1] > t[k] + 0.5 * h[k]) for k in range(len(t) - 1)] + [True]
    return np.asarray(y), len(times), accepted


def test_dopri5_matches_jax_steps_and_state():
    x0 = _x0()
    ref, evals, accepted = _jax_dopri5_attempts(x0, 0.0, 1.0)
    out, counts = ts.sample_ode(_tdrift, torch.from_numpy(x0), t0=0.0, t1=1.0, method="dopri5")
    assert counts["rejected"] >= 1  # the controller's reject branch ran
    assert counts == {"accepted": sum(accepted), "rejected": len(accepted) - sum(accepted),
                      "evals": evals}
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("prediction", ["score", "noise"])
def test_drift_fn_matches_jax(prediction):
    x = _x0()
    t = np.array([0.3, 0.8], np.float32)
    model_j = lambda x, t: jnp.cos(x) * t[:, None, None]  # noqa: E731
    model_t = lambda x, t: torch.cos(x) * t[:, None, None]  # noqa: E731
    cfg = MDGenConfig(transport=TransportConfig(prediction=prediction))
    ref = JTransport(cfg).drift_fn(model_j)(jnp.asarray(x), jnp.asarray(t))
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    out = TTransport(tc).drift_fn(model_t)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


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


def test_heun_slice_at_long_t_matches_jax_engine():
    B, T, L, STEPS = 1, 264, 4, 2
    cfg = MDGenConfig(
        model=ModelConfig(num_layers=2, embed_dim=48, mha_heads=2, ipa_heads=2, ipa_head_dim=16,
                          ipa_qk=4, ipa_v=4, prepend_ipa=True, abs_pos_emb=True, use_bf16=False),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method="heun", inference_steps=STEPS))
    rng = np.random.default_rng(0)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    atom14 = TG.frames_torsions_to_atom14(
        TRigid.from_tensor_7(torch.from_numpy(t7)), torch.from_numpy(tors),
        torch.from_numpy(np.broadcast_to(aatype[:, None], (B, T, L)).copy()).long())
    mask = np.ones((B, L), np.float32)
    mask[0, -1] = 0.0
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    params = _random_tree(to_flax(TModel(tc).state_dict(), tc), 2)
    zs0 = rng.normal(size=(B, T, L, cfg.latent_dim)).astype(np.float32)
    tbatch = t_featurize(atom14, torch.from_numpy(aatype).long(), torch.from_numpy(mask))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    ref, _ = jax.jit(JEngine(cfg, None)._sample)(params, jbatch, jax.random.key(0),
                                                 jnp.asarray(zs0))

    tengine = TEngine(tc, params, device="cpu")
    out, _ = tengine.sample_with_zs0(tbatch, torch.from_numpy(zs0))
    assert tengine.last_counts == {"accepted": STEPS, "rejected": 0, "evals": 2 * STEPS}
    assert out.shape == (B, T, L, 14, 3) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
