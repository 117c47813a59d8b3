"""PyTorch port, ``ops/fused_attention.py`` held against the JAX package's
``ops/fused_attention.py`` on the CPU:

- the plain forward (``fused_attention_fwd_plain``: ``attention_core`` and
  the row statistic) against the TPU kernel ``_fwd_tpu`` in interpret mode,
  in both softmaxes;
- the CPU backward of ``FusedAttentionFn`` (P recomputed from the saved
  statistic) against ``_bwd_tpu`` in interpret mode (dq, dk, dv) and
  against torch autograd through the plain forward.

Sizes: B = 2, H = 2 (R = 4 rows), N = 264 queries, M = 265 keys, D = 24;
element 0 has masked keys, element 1 only its last key (the bias key's
place) valid. Inputs are seeded numpy, f32 on both sides. Tolerances: the
output rtol 1e-5 / atol 1e-6 against JAX (exp2 against exp and sums in
other orders); the gradients 1e-5 of each tensor's max magnitude against
JAX and against autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops.fused_attention import _bwd_tpu, _fwd_tpu
from mdgen_finetune_tpu_torch.ops.fused_attention import (
    LOG2E, FusedAttentionFn, fused_attention, fused_attention_fwd_plain, fused_attention_plain)

B, H, N, M, D = 2, 2, 264, 265, 24


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(B, H, N, D)) * D ** -0.5).astype(np.float32)
    k, v, do = (rng.normal(size=s).astype(np.float32)
                for s in ((B, H, M, D), (B, H, M, D), (B, H, N, D)))
    kv = np.ones((B, M), np.float32)
    kv[0, 40:100] = 0.0
    kv[0, 200:N] = 0.0
    kv[1, :-1] = 0.0
    return q, k, v, do, kv


def _jax_rows(a):
    return jnp.asarray(a.reshape(B * H, *a.shape[2:]))


def _scaled(q, base2):
    return q * LOG2E if base2 else q


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("base2", [True, False])
def test_plain_forward_matches_jax_kernel(inputs, base2):
    q, k, v, _, kv = inputs
    q = _scaled(q, base2)
    ref = _fwd_tpu(_jax_rows(q), _jax_rows(k), _jax_rows(v),
                   jnp.asarray(np.repeat(kv, H, axis=0)), interpret=True, base2=base2)
    o, stat = fused_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v, kv)),
                                        base2=base2)
    np.testing.assert_allclose(o.numpy().reshape(B * H, N, D), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    # the statistic is log2 of the softmax denominator in base-2 units
    t = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * (1.0 if base2 else LOG2E)
    t = np.where(kv[:, None, None, :] > 0, t, -1e9)
    m = t.max(-1, keepdims=True)
    want = (m + np.log2(np.exp2(t - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(stat.numpy(), want, rtol=0, atol=1e-4)
    # the differentiable op runs the same plain forward on CPU tensors
    again = fused_attention(*(torch.from_numpy(a) for a in (q, k, v, kv)), base2=base2)
    np.testing.assert_array_equal(again.numpy(), o.numpy())


@pytest.mark.parametrize("base2", [True, False])
def test_cpu_backward_matches_jax_kernel_and_autograd(inputs, base2):
    q, k, v, do, kv = inputs
    q = _scaled(q, base2)
    rows = [_jax_rows(a) for a in (q, k, v)]
    kvr = jnp.asarray(np.repeat(kv, H, axis=0))
    o = _fwd_tpu(*rows, kvr, interpret=True, base2=base2)
    want = jax.jit(lambda *a: _bwd_tpu(*a, interpret=True, base2=base2))(
        *rows, kvr, o, _jax_rows(do))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FusedAttentionFn.apply(*leaves, torch.from_numpy(kv), base2)
    out.backward(torch.from_numpy(do))
    got = [t.grad.numpy() for t in leaves]

    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    fused_attention_plain(*ref, torch.from_numpy(kv), base2=base2).backward(torch.from_numpy(do))
    for g, w, r in zip(got, want, ref):
        _close(g.reshape(B * H, *g.shape[2:]), np.asarray(w))
        _close(g, r.grad.numpy())
