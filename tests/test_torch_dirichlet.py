"""PyTorch port, the Dirichlet conditional flow of the design task
(``transport/dirichlet.py``) on the CPU against the JAX package's:

- the incomplete-beta derivative table, built once for the module by each
  package at the design preset's grid (``alpha_max`` 8, spacing 0.001);
- ``simplex_proj`` on random rows, rows with ties and rows already on the
  simplex;
- ``c_factor`` on ``bs`` below 0, at 0, inside, at 1, just below 1 (above
  0.9897, (1 - b)**19 underflows, to a subnormal or to 0, and the JAX
  package's arithmetic gives NaN) and above 1, with alpha below 1, at 1,
  inside, at a non-integer and above ``alpha_max - spacing`` (clipped);
  ``interp`` against ``jnp.interp`` outside and inside the grid.

Rule: 1e-5 relative (plus 1e-30 absolute, for exact zeros), NaN exactly
where JAX gives NaN.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.transport.dirichlet import DirichletConditionalFlow as JFlow
from mdgen_finetune_tpu.transport.dirichlet import simplex_proj as j_simplex_proj
from mdgen_finetune_tpu.transport.transport import t_to_alpha as j_t_to_alpha
from mdgen_finetune_tpu_torch.transport.dirichlet import DirichletConditionalFlow, interp, simplex_proj
from mdgen_finetune_tpu_torch.transport.transport import t_to_alpha

RTOL, ATOL = 1e-5, 1e-30


@pytest.fixture(scope="module")
def flows():
    return (JFlow(K=20, alpha_spacing=0.001, alpha_max=8.0),
            DirichletConditionalFlow(K=20, alpha_spacing=0.001, alpha_max=8.0))


def test_table_matches_jax(flows):
    jf, tf = flows
    assert tf.dcdf.shape == jf._dcdf.shape == (7000, 1000)
    assert tf.dcdf.dtype == torch.float32 and tf.dcdf.nbytes == 28_000_000
    np.testing.assert_array_equal(tf.dcdf.numpy(), np.asarray(jf._dcdf))
    np.testing.assert_array_equal(tf.bs.numpy(), np.asarray(jf._bs))
    assert "dcdf" not in tf.state_dict()  # rebuilt, not stored


def _rows():
    rng = np.random.default_rng(0)
    rand = rng.normal(size=(64, 20)).astype(np.float32) * 2
    ties = np.zeros((4, 20), np.float32)
    ties[1] = 0.3
    ties[2, :10] = 0.7
    ties[3, ::2] = -1.0
    ties[3, 1::2] = 1.5
    simplex = rng.dirichlet(np.ones(20), size=8).astype(np.float32)
    return np.concatenate([rand, ties, simplex])


def test_simplex_proj_matches_jax():
    rows = _rows()
    out = simplex_proj(torch.from_numpy(rows)).numpy()
    ref = np.asarray(j_simplex_proj(jnp.asarray(rows)))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    assert (out >= 0).all()
    np.testing.assert_allclose(out[-8:], rows[-8:], atol=1e-6)  # on the simplex: unmoved
    np.testing.assert_allclose(out[64], 1 / 20, atol=1e-6)  # a tie over all 20


BS = np.array([-0.5, -1e-3, 0.0, 1e-6, 0.01, 0.05, 0.2, 0.5, 0.77, 0.95, 0.999, 0.9999999,
               1.0, 1.0 + 1e-6, 1.5], np.float32)


@pytest.mark.parametrize("alpha", [0.5, 1.0, 1.0004, 2.0, 3.3, 5.5, 7.9995, 7.999, 8.0, 12.0])
def test_c_factor_matches_jax(flows, alpha):
    jf, tf = flows
    bs = np.concatenate([BS, np.random.default_rng(1).uniform(-0.2, 1.2, 64).astype(np.float32)])
    ref = np.asarray(jf.c_factor(jnp.asarray(bs), jnp.float32(alpha)))
    out = tf.c_factor(torch.from_numpy(bs), torch.tensor(alpha)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL, equal_nan=True)
    # the beta term is 0 at and above b = 1, and below 0 (NaN power) or at 0
    # unless alpha clips to 1 (power 1)
    outside = (bs >= 1) | ((bs <= 0) & (max(alpha, 1.0) > 1.0))
    assert (out[outside] == 0).all()
    if alpha <= 1.0:  # clipped to alpha = 1: bs ** 0 = 1; (1 - b)**19 normal below 0.9897
        assert np.isfinite(out[bs < 0.98]).all() and (out[(bs > 0) & (bs < 0.5)] != 0).all()


def test_c_factor_nan_where_jax_is_nan(flows):
    """Just below b = 1, (1 - b)**19 underflows, the beta term is inf and the
    table's last column 0: NaN in both packages (JAX's forward_inference
    zeroes it only under ``allow_nan_cfactor``)."""
    jf, tf = flows
    bs = np.array([0.9999999, 0.99999994], np.float32)
    ref = np.asarray(jf.c_factor(jnp.asarray(bs), jnp.float32(3.0)))
    out = tf.c_factor(torch.from_numpy(bs), 3.0).numpy()
    assert np.isnan(ref).all() and np.isnan(out).all()


def test_interp_matches_jnp_interp(flows):
    _, tf = flows
    row = tf.dcdf[1234]
    x = torch.tensor([-1.0, -1e-9, 0.0, 1e-4, 0.123456, 0.5, 0.999, 1.0, 1.0 + 1e-6, 3.0])
    ref = np.asarray(jnp.interp(jnp.asarray(x.numpy()), jnp.asarray(tf.bs.numpy()),
                                jnp.asarray(row.numpy())))
    np.testing.assert_allclose(interp(x, tf.bs, row).numpy(), ref, rtol=RTOL, atol=ATOL)


def test_t_to_alpha_matches_jax():
    t = np.array([0.0, 0.25, 0.999, 1.0], np.float32)
    a, da = t_to_alpha(torch.from_numpy(t), 8.0)
    ja, jda = j_t_to_alpha(jnp.asarray(t), 8.0)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=0)
    assert da == jda == 7.0
