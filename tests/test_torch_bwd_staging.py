"""PyTorch port, the rounding points and reduction orders of the training
backward's two largest kernels, emulated in plain PyTorch and held against
the JAX package on the CPU.

- ``blocked_attention_bwd`` (csrc/blocked_attention_bwd.cu): the RoPE'd q
  and k staged in fp16, each times a power of two when the head's largest
  value leaves [2^-6, 2^15); dO, v and pn in bf16; ds in fp16 as
  ds * ln2 / max|dO| of its 16-query tile; f32 logits, sums and products;
  the no-max softmax exp2(min(l, 100)) / (sum + 1e-30) with the bias key
  at position N and masked keys at -1e9. Held against ``jax.vjp`` of
  ``time_attention._xla_impl(base2=True)``, the twin that
  ``tests/test_torch_atlas.py`` holds the plain version to, at ordinary
  scales, beyond fp16's range (q ~ 2e5, k ~ 1e-5) and at dO ~ 1e-6, where
  the emulation without the scales is measurably off.
- ``linear_bwd`` (csrc/linear_bwd.cu): P(A) and P(dY) rounded to bf16, f32
  products over each split of the M rows, the splits' partials added in
  colsum.cuh's fixed order (8 lanes of every 8th split, then the lanes in
  order). Run as the products of the MLP stage's backward (the port's
  composition ``adaln_mlp._mlp_bwd`` with the emulation in place of the
  kernel) and held against ``jax.vjp`` of ``adaln_mlp._xla_impl``, the
  MLP stage of the fused layer's XLA twin ``_layer_xla``.
- The host-side schedule: the wgrad split rule, the scratch sizes, the
  blocked kernel's shared memory and routing limits.

Inputs are seeded numpy; C = 48 with 2 heads (head dim 24, as the
flagship). Tolerance: 1e-2 x max(1, max |reference|), the card's kernel
rule (to each gradient's own scale where it is far below 1).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import adaln_mlp as jmlp
from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu_torch.models.rope import rope_tables, rotate_half
from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as tba
from mdgen_finetune_tpu_torch.ops import linear_bwd as tlb
from mdgen_finetune_tpu_torch.ops.adaln_linear import _rows, adaln_linear_plain
from mdgen_finetune_tpu_torch.ops.adaln_mlp import _mlp_bwd
from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd_plain
from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import _rotate_half_t
from mdgen_finetune_tpu_torch.models.layers import gelu_fast_with_grad, layer_norm

C, H = 48, 2
D = C // H
TOL = 1e-2
LN2 = math.log(2.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _bf(x):
    return x.to(torch.bfloat16).float()


def _fp16(x):
    return x.to(torch.float16).float()


def _scale_exponent(m):
    """rope_tile.cuh's scale_exponent: 0 inside [2^-6, 2^15), else s with
    m * 2^s in [2^14, 2^15)."""
    if m <= 0.0:
        return 0
    e = math.frexp(m)[1]  # m in [2^(e-1), 2^e)
    return 15 - e if (e > 15 or e < -5) else 0


def blocked_bwd_emulated(qkv, dout, bk, bv, key_valid, scaled=True):
    """The kernel's rounding points over (G, N, I, 3C) inputs, per (sequence,
    head); ``scaled=False`` drops the powers of two of q, k and ds."""
    G, N, I, _ = qkv.shape
    S = G * I
    x = _bf(qkv).permute(0, 2, 1, 3).reshape(S, N, 3 * C)
    do = _bf(dout).permute(0, 2, 1, 3).reshape(S, N, C)
    valid = key_valid.permute(0, 2, 1).reshape(S, N)
    cos, sin = rope_tables(N + 1, D)
    dqkv = torch.zeros(S, N, 3 * C)
    dbk, dbv = torch.zeros(C), torch.zeros(C)
    for s in range(S):
        for h in range(H):
            lanes = slice(h * D, (h + 1) * D)
            q = x[s, :, lanes]
            k = torch.cat([x[s, :, C:][:, lanes], _bf(bk)[lanes][None]], 0)
            v = torch.cat([x[s, :, 2 * C:][:, lanes], _bf(bv)[lanes][None]], 0)
            g = do[s, :, lanes]
            qr = q * cos[:N] + rotate_half(q) * sin[:N]
            kr = k * cos + rotate_half(k) * sin
            sq = _scale_exponent(qr.abs().max().item()) if scaled else 0
            sk = _scale_exponent(kr.abs().max().item()) if scaled else 0
            qh, kh = _fp16(qr * 2.0 ** sq), _fp16(kr * 2.0 ** sk)
            kb = torch.cat([torch.where(valid[s] > 0, 0.0, -1e9), torch.zeros(1)])
            p = torch.exp2(torch.clamp((qh @ kh.T) * 2.0 ** -(sq + sk) + kb, max=100.0))
            dp = g @ v.T
            inv = 1.0 / (p.sum(1) + 1e-30)
            delta = (p * dp).sum(1) * inv
            pn = _bf(p * inv[:, None])
            dq, dk = torch.zeros(N, D), torch.zeros(N + 1, D)
            for q0 in range(0, N, 16):  # ds in fp16 per 16-query tile
                rows = slice(q0, q0 + 16)
                gm = g[rows].abs().max().item()
                to_f16, from_f16 = (LN2 / gm, gm) if (scaled and gm > 0) else (LN2, 1.0)
                ds = _fp16(pn[rows] * (dp[rows] - delta[rows, None]) * to_f16)
                dq[rows] = (ds @ kh) * (from_f16 * 2.0 ** -sk)
                dk += (ds.T @ qh[rows]) * (from_f16 * 2.0 ** -sq)
            dv = pn.T @ g
            dq = dq * cos[:N] + _rotate_half_t(dq * sin[:N])
            dk = dk * cos + _rotate_half_t(dk * sin)
            dqkv[s, :, lanes] = dq
            dqkv[s, :, C:][:, lanes] = dk[:N]
            dqkv[s, :, 2 * C:][:, lanes] = dv[:N]
            dbk[lanes] += dk[N]
            dbv[lanes] += dv[N]
    dqkv = _bf(dqkv.reshape(G, I, N, 3 * C).permute(0, 2, 1, 3))
    return dqkv, dbk, dbv


def _attention_case(N, q_scale=1.0, k_scale=1.0, dout_scale=1.0, seed=1):
    G, I = 1, 2
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(G, N, I, C)) * D ** -0.5 * 1.4426950408889634 * q_scale
    k = rng.normal(size=(G, N, I, C)) * k_scale
    v = rng.normal(size=(G, N, I, C))
    bk, bv = rng.normal(size=C) * k_scale, rng.normal(size=C)
    dout = rng.normal(size=(G, N, I, C)) * dout_scale
    mask = np.ones((G, N, I), np.float32)
    mask[0, N // 2:, 0] = 0.0
    q, k, v, bk, bv, dout = (_bf(_t(a)).numpy() for a in (q, k, v, bk, bv, dout))

    def f(q, k, v, bk, bv):
        return jta._xla_impl(q, k, v, bk, bv, jnp.asarray(mask.transpose(0, 2, 1)), H,
                             base2=True)

    dq, dk, dv, dbk, dbv = jax.jit(lambda a, g: jax.vjp(f, *a)[1](g))(
        tuple(map(jnp.asarray, (q, k, v, bk, bv))), jnp.asarray(dout))
    want = [np.concatenate([np.asarray(dq), np.asarray(dk), np.asarray(dv)], -1),
            np.asarray(dbk), np.asarray(dbv)]
    args = (_t(np.concatenate([q, k, v], -1)), _t(dout), _t(bk), _t(bv), _t(mask))
    return args, want


def _err(got, want, own=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() if own else max(1.0, np.abs(want).max())
    return np.abs(got - want).max() / scale


@pytest.mark.parametrize("N", [40, 129])
def test_blocked_bwd_rounding_matches_jax_vjp(N):
    args, want = _attention_case(N)
    got = blocked_bwd_emulated(*args)
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL, _err(g, w)


def test_blocked_bwd_scales_keep_fp16_in_range():
    """q ~ 2e5 (beyond fp16's 65,504) and k ~ 1e-5 (below its normal range):
    the power-of-two scales keep every gradient within 1e-2 of its own
    scale; without them q overflows fp16."""
    args, want = _attention_case(48, q_scale=2e5 * D ** 0.5, k_scale=1e-5 * D ** -0.5, seed=2)
    got = blocked_bwd_emulated(*args)
    for j in range(3):
        part = slice(j * C, (j + 1) * C)
        assert _err(got[0][..., part], want[0][..., part], own=True) <= TOL, j
    plain = blocked_bwd_emulated(*args, scaled=False)
    assert not torch.isfinite(plain[0]).all()


def test_blocked_bwd_ds_scale_keeps_small_gradients():
    """dO ~ 1e-6, a real step's size: ds / max|dO| stays in fp16's normal
    range; unscaled, ds ~ 1e-7 falls among fp16's subnormals."""
    args, want = _attention_case(48, dout_scale=1e-6, seed=3)
    got = blocked_bwd_emulated(*args)
    errs = [_err(g, w, own=True) for g, w in zip(got, want)]
    assert max(errs) <= TOL, errs
    plain = blocked_bwd_emulated(*args, scaled=False)
    assert _err(plain[0], want[0], own=True) > 4 * errs[0]


def linear_bwd_emulated(mode, dy, x, *, gate=None, act=None, ln=False, shift=None, scale=None,
                        out_dtype=None):
    """linear_bwd's rounding points and split order (its arguments)."""
    M = dy.shape[0]
    g = _bf(dy.float() * _rows(gate, M).float() if gate is not None else dy.float())
    if mode == "dgrad":
        dx = g @ _bf(x).T
        if act is not None:
            dx = dx * gelu_fast_with_grad(act.float())[1]
        return dx.to(out_dtype or torch.float32)
    a = _bf(layer_norm(x.float()) * (1 + _rows(scale, M).float()) + _rows(shift, M).float()) \
        if ln else _bf(x)
    K, N = a.shape[1], g.shape[1]
    splits = tlb._splits(M, K, N)
    per = -(-M // splits)
    parts = [(a[s * per:(s + 1) * per].T @ g[s * per:(s + 1) * per],
              g[s * per:(s + 1) * per].sum(0)) for s in range(splits)]

    def colsum(ts):  # colsum.cuh: lane ty adds parts ty, ty + 8, ...; then the lanes in order
        lanes = []
        for ty in range(8):
            acc = torch.zeros_like(ts[0])
            for t in ts[ty::8]:
                acc = acc + t
            lanes.append(acc)
        total = torch.zeros_like(ts[0])
        for lane in lanes:
            total = total + lane
        return total

    return colsum([p for p, _ in parts]), colsum([q for _, q in parts])


def test_linear_bwd_rounding_matches_jax_mlp_stage():
    """The MLP stage's backward (dW2, db2 from a gated f32 dY; the GELU'
    dgrad; dW1, db1 with the LN prologue; the dgrad into the stage) with
    the emulation as its products, against jax.vjp of the XLA twin."""
    rng = np.random.default_rng(4)
    Bm, R, Cm = 2, 600, C  # M = 1,200 rows: 4 splits of 300 (not a multiple of 32)
    x = rng.normal(size=(Bm, R, Cm)).astype(np.float32)
    sh, sc, g = ((rng.normal(size=(Bm, Cm)) * s).astype(np.float32) for s in (0.3, 0.3, 0.5))
    w1 = (rng.normal(size=(Cm, 4 * Cm)) * Cm ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(4 * Cm,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(4 * Cm, Cm)) * (4 * Cm) ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(Cm,)) * 0.1).astype(np.float32)
    grad = rng.normal(size=(Bm, R, Cm)).astype(np.float32)
    args = (x, sh, sc, g, w1, b1, w2, b2)
    _, vjp = jax.vjp(jmlp._xla_impl, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(grad))  # dx, dsh, dsc, dg, dw1, db1, dw2, db2
    assert tlb._splits(Bm * R, Cm, 4 * Cm) > 1
    targs = [_t(a) for a in args]
    got = _mlp_bwd(adaln_linear_plain, linear_bwd_emulated, modln_bwd_plain,
                   targs[0].reshape(-1, Cm), *targs[1:], _t(grad.reshape(-1, Cm)), None)
    names = ["dx", "dsh", "dsc", "dg", "dw1", "db1", "dw2", "db2"]
    for name, gg, w in zip(names, got, want):
        err = _err(gg.numpy().reshape(np.shape(w)), np.asarray(w))
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("M,K,N", [(12_800, 384, 1536), (12_800, 1536, 384),
                                   (12_800, 384, 1152), (12_800, 384, 384),
                                   (64_000, 384, 1536), (1_200, 48, 192), (100, 8, 8)])
def test_wgrad_split_schedule(M, K, N):
    """One wave of 128 x 128 blocks on an H100's 264 resident slots, each
    split at least 256 rows (one split below that)."""
    s = tlb._splits(M, K, N)
    tiles = -(-K // tlb.TILE) * -(-N // tlb.TILE)
    assert s >= 1 and (s == 1 or s * tiles <= tlb.SLOTS)
    assert s == 1 or -(-M // s) >= 256
    if M >= 256 * tlb.SLOTS:
        assert (s + 1) * tiles > tlb.SLOTS  # no slot left for another split


def test_linear_bwd_scratch_sizes():
    M, K, N = 1_201, 48, 192
    s = tlb._splits(M, K, N)
    assert tlb.scratch_floats(M, K, N) == s * (K * N + N) + 2404
    assert tlb.scratch_floats(M, K, N, "dgrad") == 0
    assert tlb.scratch_floats(M, K, N, "dgrad", pre_dy=True) == M * N // 2
    assert tlb.scratch_floats(M, K, N, "wgrad", True, True) == \
        s * (K * N + N) + 2404 + M * N // 2 + M * K // 2


def test_blocked_bwd_shared_memory_and_limits():
    """The routing limits stay (319 / 511 / 255 / 127 keys at D = 24 / 16 /
    32 / 64); the block's shared memory fits 3 blocks per SM at N = 256,
    D = 24 (60,352 bytes), and every limit fits one block."""
    assert [tba.max_keys(d) for d in (24, 16, 32, 64)] == [319, 511, 255, 127]
    assert tba.smem_bytes(256, 24) == 60_352
    assert 3 * (tba.smem_bytes(256, 24) + 1024) <= 228 * 1024
    for d in (16, 24, 32, 64):
        assert tba.smem_bytes(tba.max_keys(d), d) <= tba.SMEM_BYTES
