"""PyTorch port, the trunk's stage ops at long T held against the JAX
package's XLA twins on the CPU:

- ``time_attention_block`` (above MAX_T its core is ``tiled_attention``)
  against ``time_attention._block_xla_tl``;
- ``residue_block`` against ``residue_block._s1_xla``;
- ``adaln_mlp`` against ``adaln_mlp._xla_impl``;
- ``tiled_attention_plain`` against ``time_attention._xla_impl(base2=True)``;
- ``tiled_attention``'s natural softmax (it took only the base-2 one before
  the modular layer) against ``_xla_impl(base2=False)``, and
  ``rope_attention``'s shared-memory limit on N;
- the training path's backwards: ``time_attention_block_bwd`` against
  ``jax.vjp`` of ``_block_xla_tl``, ``adaln_mlp_bwd_plain`` against the TPU
  kernel ``_pallas_bwd`` in interpret mode (as ``tests/test_adaln_mlp.py``
  holds it to the XLA VJP: B = 2, N = 37 rows, C = 128, row blocks of 32),
  and the whole ``fused_layer_bwd`` (frame stage above
  ``rope_attention_bwd.MAX_N``) against ``jax.vjp`` of ``_layer_xla``.

Sizes: T = 264 (above MAX_T = 256, not a multiple of 8), L = 3, C = 48 with
2 heads (head dim 24, as the flagship), B = 2; frames 200.. of element 0 and
the last residue of element 1 are masked. Inputs are seeded numpy, f32 on
both sides. Tolerance: rtol 1e-4 / atol 5e-5 on outputs of unit scale
(different summation orders; exp2 in the port's kernels' contract, exp of
ln2-scaled logits in both twins). Gradients: each tensor within 1e-4 of its
max magnitude (at least 1e-6 absolute); ``adaln_mlp_bwd_plain`` within
1e-5 of it, the rule of ``tests/test_adaln_mlp.py`` (5e-6) with room for
the other op order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import adaln_mlp as jmlp
from mdgen_finetune_tpu.ops.fused_layer import _layer_xla
from mdgen_finetune_tpu.ops import residue_block as jrb
from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu_torch.ops import rope_attention as tra
from mdgen_finetune_tpu_torch.ops.adaln_mlp import adaln_mlp, adaln_mlp_bwd_plain
from mdgen_finetune_tpu_torch.ops.fused_layer import LAYER_KEYS, trunk_layer
from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import fused_layer_bwd
from mdgen_finetune_tpu_torch.ops.residue_block import residue_block
from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention, tiled_attention_plain
from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import MAX_N
from mdgen_finetune_tpu_torch.ops.time_attention import (MAX_T, time_attention_block,
                                                         time_attention_block_bwd)

RTOL, ATOL = 1e-4, 5e-5
B, T, L, C, H = 2, 264, 3, 48, 2


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def r(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    mask = np.ones((B, T, L), np.float32)
    mask[0, 200:] = 0.0
    mask[1, :, -1] = 0.0
    return dict(
        x=r(B, T * L, C), sh=r(B, C, sc=0.3), sc=r(B, C, sc=0.3), g=r(B, C, sc=0.5),
        wqkv=r(C, 3 * C, sc=C ** -0.5), bqkv=r(3 * C, sc=0.1), wout=r(C, C, sc=C ** -0.5),
        bout=r(C, sc=0.1), bk=r(C), bv=r(C), w1=r(C, 4 * C, sc=C ** -0.5), b1=r(4 * C, sc=0.1),
        w2=r(4 * C, C, sc=(4 * C) ** -0.5), b2=r(C, sc=0.1), mask=mask)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_args(i):
    return [i[k] for k in ("x", "sh", "sc", "g", "wqkv", "bqkv", "wout", "bout", "bk", "bv")]


@pytest.mark.parametrize("stage", ["time_attention_block", "residue_block"])
def test_attention_stage_matches_jax_twin(inputs, stage):
    i = inputs
    args = _attn_args(i)
    if stage == "time_attention_block":
        assert T > MAX_T  # the tiled core is the one on this path
        ref = jta._block_xla_tl(*map(jnp.asarray, args), jnp.asarray(i["mask"].transpose(0, 2, 1)),
                                H, T, L, None)
        op = time_attention_block
    else:
        ref = jrb._s1_xla(*map(jnp.asarray, args), jnp.asarray(i["mask"]), H, T, L)
        op = residue_block
    targs = [_t(a) for a in args]
    targs[0] = targs[0].reshape(B * T * L, C)
    out = op(*targs, _t(i["mask"]), B=B, T=T, L=L, num_heads=H)
    np.testing.assert_allclose(out.reshape(B, T * L, C).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_adaln_mlp_matches_jax_twin(inputs):
    i = inputs
    args = [i[k] for k in ("x", "sh", "sc", "g", "w1", "b1", "w2", "b2")]
    ref = jmlp._xla_impl(*map(jnp.asarray, args))
    targs = [_t(a) for a in args]
    out = adaln_mlp(targs[0].reshape(-1, C), *targs[1:])
    np.testing.assert_allclose(out.reshape(B, T * L, C).numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_tiled_attention_plain_matches_jax_core(inputs):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(B, T, L, C)).astype(np.float32) for _ in range(3))
    i = inputs
    ref = jta._xla_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(i["bk"]),
                        jnp.asarray(i["bv"]), jnp.asarray(i["mask"].transpose(0, 2, 1)), H,
                        base2=True)
    qkv = _t(np.concatenate([q, k, v], -1))
    out = tiled_attention_plain(qkv, _t(i["bk"]), _t(i["bv"]), _t(i["mask"]), num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper is the plain version
    again = tiled_attention(qkv, _t(i["bk"]), _t(i["bv"]), _t(i["mask"]), num_heads=H)
    np.testing.assert_array_equal(again.numpy(), out.numpy())


@pytest.mark.parametrize("fn", [tiled_attention, tiled_attention_plain])
def test_tiled_attention_natural_matches_jax_core(inputs, fn):
    """The natural softmax of ``tiled_attention`` (TPU row 11b): on CPU
    tensors the wrapper and its plain version give the natural softmax of
    the JAX package's ``time_attention._xla_impl(base2=False)`` at T = 264,
    with q carrying head_dim**-0.5 only."""
    i = inputs
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(B, T, L, C)).astype(np.float32) * 0.5 for _ in range(3))
    ref = jta._xla_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(i["bk"]),
                        jnp.asarray(i["bv"]), jnp.asarray(i["mask"].transpose(0, 2, 1)), H,
                        base2=False)
    out = fn(_t(np.concatenate([q, k, v], -1)), _t(i["bk"]), _t(i["bv"]), _t(i["mask"]),
             num_heads=H, base2=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_rope_attention_shared_memory_limit():
    """The long rope_attention kernel stages the N+1 keys and N queries of
    a head in shared memory (K and Q in fp16, V in bf16, rows padded to
    16): N <= 943 at D = 24 and N <= 527 at D = 64; the wrapper raises a
    ValueError naming the limit instead of failing at launch."""
    assert tra.max_keys(24) == 943 and tra.max_keys(64) == 527
    for D in (16, 24, 32, 64):
        n = tra.max_keys(D)
        assert tra._head_bytes(n, D) <= tra.SMEM_BYTES < tra._head_bytes(n + 1, D)


def _close(got, ref, rel=1e-4, floor=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + floor, (err, np.abs(ref).max())


def test_time_attention_block_bwd_matches_jax_vjp(inputs):
    i = inputs
    assert T > MAX_N  # the fused_attention route, not rope_attention_bwd
    args = _attn_args(i)
    rng = np.random.default_rng(2)
    dout = rng.normal(size=(B, T * L, C)).astype(np.float32)

    @jax.jit
    def grads(args, g):
        f = lambda *a: jta._block_xla_tl(*a, jnp.asarray(i["mask"].transpose(0, 2, 1)),  # noqa: E731
                                         H, T, L, None)
        return jax.vjp(f, *args)[1](g)

    want = grads(tuple(map(jnp.asarray, args)), jnp.asarray(dout))
    targs = [_t(a) for a in args]
    targs[0] = targs[0].reshape(B * T * L, C)
    got = time_attention_block_bwd(*targs, _t(i["mask"]), _t(dout.reshape(-1, C)),
                                   B=B, T=T, L=L, num_heads=H)
    for g, w in zip(got, want):
        _close(g.numpy().reshape(w.shape), np.asarray(w))


def test_adaln_mlp_bwd_plain_matches_jax_kernel():
    rng = np.random.default_rng(3)
    Bm, Nm, Cm = 2, 37, 128
    x = rng.normal(size=(Bm, Nm, Cm)).astype(np.float32)
    sh, sc, g = ((rng.normal(size=(Bm, Cm)) * s).astype(np.float32) for s in (0.3, 0.3, 0.5))
    w1 = (rng.normal(size=(Cm, 4 * Cm)) * Cm ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(4 * Cm,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * Cm, Cm)) * Cm ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(Cm,)) * 0.1).astype(np.float32)
    grad = rng.normal(size=(Bm, Nm, Cm)).astype(np.float32)
    args = (x, sh, sc, g, w1, b1, w2, b2)
    want = jax.jit(lambda *a: jmlp._pallas_bwd(*a, interpret=True, block_rows=32))(
        *map(jnp.asarray, args), jnp.asarray(grad))
    targs = [_t(a) for a in args]
    got = adaln_mlp_bwd_plain(targs[0].reshape(-1, Cm), *targs[1:], _t(grad.reshape(-1, Cm)))
    for gg, w in zip(got, want):
        _close(gg.numpy().reshape(w.shape), np.asarray(w), rel=1e-5, floor=0.0)


LAYER_NAMES = ["x", "mod", *LAYER_KEYS]


def test_fused_layer_bwd_matches_jax_vjp(inputs):
    rng = np.random.default_rng(4)
    i = inputs
    vals = dict(x=i["x"], mod=(rng.normal(size=(B, 9 * C)) * 0.4).astype(np.float32),
                wqkv_l=i["wqkv"], bqkv_l=i["bqkv"], wout_l=i["wout"], bout_l=i["bout"],
                wqkv_t=(rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(np.float32),
                bqkv_t=i["bqkv"][::-1].copy(), wout_t=i["wout"].T.copy(), bout_t=i["bout"],
                w1=i["w1"], b1=i["b1"], w2=i["w2"], b2=i["b2"], bkl=i["bk"], bvl=i["bv"],
                bkt=i["bv"], bvt=i["bk"])
    vs = [vals[k] for k in LAYER_NAMES]  # _layer_xla's argument order
    dout = rng.normal(size=(B, T * L, C)).astype(np.float32)

    @jax.jit
    def grads(vs, g):
        f = lambda *a: _layer_xla(*a, jnp.asarray(i["mask"]), H, T, L)  # noqa: E731
        return jax.vjp(f, *vs)[1](g)

    want = dict(zip(LAYER_NAMES, grads(tuple(map(jnp.asarray, vs)), jnp.asarray(dout))))
    x = _t(vals["x"]).reshape(-1, C)
    mod = _t(vals["mod"])
    w = {k: _t(vals[k]) for k in LAYER_KEYS}
    mk = _t(i["mask"])
    x1, x2, _ = trunk_layer(x, mod, w, mk, B=B, T=T, L=L, num_heads=H)
    dx, dmod, dw = fused_layer_bwd(x, x1, x2, _t(dout.reshape(-1, C)), mod, w, mk, H)
    got = dict(x=dx, mod=dmod, **dw)
    for k in LAYER_NAMES:
        _close(got[k].numpy().reshape(want[k].shape), np.asarray(want[k]))
