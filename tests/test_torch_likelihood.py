"""PyTorch port, the probability-flow log-likelihood held against the JAX
package on the CPU:

- ``transport.ode_likelihood`` on a linear drift with a diagonal Jacobian,
  where the Hutchinson estimate is the exact divergence: x0 and delta_logp
  against the closed form, and against JAX's ``ode_likelihood``; and on a
  dense linear drift against JAX's with JAX's own Rademacher probes;
- ``InferenceEngine.log_likelihood`` (each step ``LatentMDGen.forward``
  and its VJP in x through ``FusedTrunkFn``) against the JAX engine's
  ``_log_likelihood`` (a VJP of ``forward_inference``) with the same
  weights (``to_flax``) and JAX's probes: ``jax.random.rademacher(k, shape,
  f32)`` over ``jax.random.split(key, num_steps)``;
- ``forward`` and ``forward_inference`` on the same inputs, and the
  gradient of a scalar of ``forward`` in x against JAX's;
- ``Transport.prior_logp`` against the closed form and JAX's;
- the refusal of the design tasks (whose likelihood the JAX package gives
  as NaN, ROADMAP queue 3), and the modular layer's (``hyena``) and
  ``interleave_ipa``'s log-likelihood against JAX's.

Sizes: 2 layers, C = 96, 4 heads, a prepend-IPA encoder, T = 5, L = 4 with
one padded residue, B = 2, 3 likelihood steps, f32. Tolerances: the
log-likelihood 1e-4 x max(1, |ll|) per sample; the linear drifts
rtol 1e-5 / atol 1e-5; velocity rtol 1e-4 / atol 5e-5, as
``tests/test_torch_sampling.py``; the gradient in x max |port - JAX| <=
1e-4 x max |JAX|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import (DataConfig, MDGenConfig, ModelConfig, TaskConfig,
                                       TransportConfig)
from mdgen_finetune_tpu.inference import InferenceEngine as JEngine
from mdgen_finetune_tpu.models import LatentMDGen as JModel
from mdgen_finetune_tpu.tasks import prep_batch as j_prep_batch
from mdgen_finetune_tpu.transport import Transport as JTransport
from mdgen_finetune_tpu.transport.samplers import ode_likelihood as j_ode_likelihood
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.featurize import featurize_atom14_batch as t_featurize
from mdgen_finetune_tpu_torch.geometry import frames as TG
from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid
from mdgen_finetune_tpu_torch.inference import InferenceEngine as TEngine
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.tasks import prep_batch as t_prep_batch
from mdgen_finetune_tpu_torch.transport import Transport as TTransport
from mdgen_finetune_tpu_torch.transport import ode_likelihood as t_ode_likelihood
from mdgen_finetune_tpu_torch.utils.weights import randomize_, to_flax

B, T, L, C, H, NL, STEPS = 2, 5, 4, 96, 4, 2, 3


def jax_probes(key, steps, shape):
    """The probes JAX's likelihood scan draws: one per step from split(key, steps)."""
    return np.stack([np.asarray(jax.random.rademacher(k, shape, jnp.float32))
                     for k in jax.random.split(key, steps)])


def test_ode_likelihood_is_exact_on_a_diagonal_linear_drift():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 4)).astype(np.float32)
    x = rng.normal(size=(2, 3, 4)).astype(np.float32)
    n, t0, t1 = 4, 0.0, 1.0

    def drift(xp):
        return lambda y, t: (1.0 + t[:, None, None]) * xp.asarray(a) * y

    got_x0, got_dl = t_ode_likelihood(drift(torch), torch.from_numpy(x), num_steps=n,
                                      generator=torch.Generator().manual_seed(1))
    dt = (t1 - t0) / n
    want_x, want_dl = x.astype(np.float64), np.zeros(2)
    for i in range(n):
        s = 1.0 + (1.0 - (t0 + dt * i))
        want_dl += s * a.reshape(2, -1).sum(-1) * dt
        want_x = want_x - s * a * want_x * dt
    np.testing.assert_allclose(got_x0.numpy(), want_x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dl.numpy(), want_dl, rtol=1e-5, atol=1e-5)
    ref_x0, ref_dl = j_ode_likelihood(drift(jnp), jnp.asarray(x), jax.random.key(2), num_steps=n)
    np.testing.assert_allclose(got_dl.numpy(), np.asarray(ref_dl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(ref_x0), rtol=1e-5, atol=1e-5)


def test_ode_likelihood_matches_jax_on_a_dense_linear_drift():
    rng = np.random.default_rng(3)
    A = (rng.normal(size=(6, 6)) / 3).astype(np.float32)
    x = rng.normal(size=(2, 5, 6)).astype(np.float32)
    key = jax.random.key(4)

    def drift(xp):
        return lambda y, t: (y @ xp.asarray(A)) * t[:, None, None] + xp.sin(y)

    ref_x0, ref_dl = j_ode_likelihood(drift(jnp), jnp.asarray(x), key, num_steps=5)
    got_x0, got_dl = t_ode_likelihood(drift(torch), torch.from_numpy(x), num_steps=5,
                                      probes=torch.from_numpy(jax_probes(key, 5, x.shape)))
    np.testing.assert_allclose(got_dl.numpy(), np.asarray(ref_dl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(ref_x0), rtol=1e-5, atol=1e-5)


def test_prior_logp_matches_the_closed_form_and_jax():
    z = np.random.default_rng(5).normal(size=(3, 4, 2, 7)).astype(np.float32)
    got = TTransport.prior_logp(torch.from_numpy(z)).numpy()
    n = z[0].size
    want = -n / 2 * np.log(2 * np.pi) - (z.astype(np.float64) ** 2).reshape(3, -1).sum(-1) / 2
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(JTransport(MDGenConfig()).prior_logp(
        jnp.asarray(z))), rtol=1e-6)


def _cfg(**model):
    return MDGenConfig(
        model=ModelConfig(num_layers=NL, embed_dim=C, mha_heads=H, prepend_ipa=True,
                          abs_pos_emb=True, use_bf16=False, **model),
        data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
        transport=TransportConfig(sampling_method="euler", inference_steps=STEPS))


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    model = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(7), scale=0.1)
    tree = to_flax(model.state_dict(), tc)
    rng = np.random.default_rng(8)
    aatype = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t7 = rng.normal(size=(B, T, L, 7)).astype(np.float32)
    t7[..., 4:] *= 4.0
    ang = rng.uniform(-np.pi, np.pi, size=(B, T, L, 7))
    tors = np.stack([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    atom14 = TG.frames_torsions_to_atom14(TRigid.from_tensor_7(torch.from_numpy(t7)),
                                          torch.from_numpy(tors),
                                          torch.from_numpy(aatype).long()[:, None].expand(B, T, L))
    mask = np.ones((B, L), np.float32)
    mask[1, -1] = 0.0
    tbatch = t_featurize(atom14, torch.from_numpy(aatype).long(), torch.from_numpy(mask))
    # both packages read the port's features: the first residue's degenerate
    # pre-omega torsion rounds differently in each featurizer
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tbatch.items()}
    teng = TEngine(tc, model.state_dict(), device="cpu")
    return dict(cfg=cfg, tc=tc, tree=tree, sd=model.state_dict(), jbatch=jbatch,
                tbatch=tbatch, teng=teng, rng=rng)


def test_log_likelihood_matches_jax(setup):
    s = setup
    jeng = JEngine(s["cfg"], s["tree"])
    key = jax.random.key(9)
    ref = np.asarray(jeng.log_likelihood(s["jbatch"], key, num_steps=STEPS))
    probes = jax_probes(key, STEPS, (B, T, L, 21))
    got = s["teng"].log_likelihood(s["tbatch"], num_steps=STEPS,
                                   probes=torch.from_numpy(probes))
    assert got.shape == (B,) and got.dtype == torch.float32 and torch.isfinite(got).all()
    err = np.abs(got.detach().numpy() - ref)
    assert (err <= 1e-4 * np.maximum(1.0, np.abs(ref))).all(), (got, ref)
    # probes drawn from a generator: finite, and another draw gives another estimate
    a = s["teng"].log_likelihood(s["tbatch"], torch.Generator().manual_seed(1), num_steps=2)
    b = s["teng"].log_likelihood(s["tbatch"], torch.Generator().manual_seed(2), num_steps=2)
    assert torch.isfinite(a).all() and not torch.equal(a, b)


def test_forward_matches_forward_inference_and_its_x_gradient_matches_jax(setup):
    s = setup
    model = s["teng"].model
    kw = t_prep_batch(s["tc"], s["tbatch"])["model_kwargs"]
    x = torch.from_numpy(s["rng"].normal(size=(B, T, L, 21)).astype(np.float32))
    t = torch.tensor([0.3, 0.8])
    g = torch.from_numpy(s["rng"].normal(size=(B, T, L, 21)).astype(np.float32))
    args = dict(start_frames=kw["start_frames"], end_frames=kw["end_frames"], x_cond=kw["x_cond"],
                x_cond_mask=kw["x_cond_mask"], aatype=kw["aatype"])
    mask = kw["mask"].float()
    ref = model.forward_inference(x, t, mask, **args)
    xg = x.clone().requires_grad_()
    out = model(xg, t, mask, **args)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-4, atol=5e-5)
    (dx,) = torch.autograd.grad(out, xg, g)
    assert dx.dtype == torch.float32

    jm = JModel(s["cfg"], 21)
    jkw = j_prep_batch(s["cfg"], s["jbatch"])["model_kwargs"]

    @jax.jit
    def out_and_vjp(xx, gg):
        out, vjp = jax.vjp(lambda y: jm.apply(s["tree"], y, jnp.asarray(t.numpy()),
                                              method=jm.forward_inference, **jkw), xx)
        return out, vjp(gg)[0]

    jout, jdx = out_and_vjp(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=5e-5)
    jdx = np.asarray(jdx)
    assert np.abs(dx.numpy() - jdx).max() <= 1e-4 * np.abs(jdx).max()


@pytest.mark.parametrize("change, item", [
    (dict(model=dict(hyena=True)), "item 9"),
    (dict(model=dict(interleave_ipa=True)), "item 9"),
    (dict(task=dict(inpainting=True, design=True)), "NaN at its data endpoint"),
])
def test_log_likelihood_refuses_what_has_no_backward_in_x(setup, change, item):
    """The design tasks (JAX's likelihood is NaN at their data endpoint)
    raise. The modular layer (``hyena``) and ``interleave_ipa``, refused
    until their backward in x was ported (ROADMAP item 9), give the JAX
    engine's log-likelihood with the same seeded random weights and JAX's
    probes (2 steps)."""
    s = setup
    tc = s["tc"]
    if "model" in change:
        tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, **change["model"]))
    else:
        tc = dataclasses.replace(tc, task=tcfg.TaskConfig(**change["task"]))
    model = randomize_(LatentMDGen(tc), torch.Generator().manual_seed(17), scale=0.1)
    eng = TEngine(tc, model.state_dict(), device="cpu")
    if "task" in change:
        with pytest.raises(NotImplementedError, match=item):
            eng.log_likelihood(s["tbatch"], torch.Generator().manual_seed(0), num_steps=2)
        return
    cfg = dataclasses.replace(s["cfg"], model=dataclasses.replace(s["cfg"].model,
                                                                  **change["model"]))
    jeng = JEngine(cfg, to_flax(model.state_dict(), tc))
    key = jax.random.key(19)
    ref = np.asarray(jeng.log_likelihood(s["jbatch"], key, num_steps=2))
    got = eng.log_likelihood(s["tbatch"], num_steps=2,
                             probes=torch.from_numpy(jax_probes(key, 2, (B, T, L, 21))))
    assert got.shape == (B,) and torch.isfinite(got).all()
    err = np.abs(got.detach().numpy() - ref)
    assert (err <= 1e-4 * np.maximum(1.0, np.abs(ref))).all(), (got, ref)
