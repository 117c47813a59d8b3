"""PyTorch port, the rounding points and reduction orders of the long-key
attention kernels, emulated in plain PyTorch and held against the JAX
package on the CPU.

- ``tiled_attention`` (csrc/tiled_attention.cu): RoPE in f32, the RoPE'd q
  and k rounded to bf16; f32 logits; the bias key at position N and masked
  keys at -1e9; the keys walked in steps of 32 (16 at the tail, to the 16-key
  tiles' padding); p rounded to bf16 before p.v, f32 row sums. Base 2:
  exp2(min(l, 100)) / (sum + 1e-30). Natural: a running max per query row
  over the steps, the output and row sums rescaled by exp2(old - new) only
  where the max rose (exp2(0) = 1 elsewhere). Held against the JAX
  package's ``time_attention._xla_impl`` (both ``base2``), and the natural
  mode at logits ~1e3, where exp without the max overflows.
- ``fused_attention_bwd`` (csrc/fused_attention_bwd.cu): the dq pass forms
  delta = rowsum(dout * o) in f32 and walks the keys in steps of 32 (masked
  keys' k as zeros), ds = p (dp - delta) rounded to bf16, dq summed over the
  steps in key order in f32 and times ln 2 (base 2) after the sum; the
  dK / dV pass walks the queries in steps of 16, p and ds rounded to bf16,
  dk of a masked key zero. Held against ``jax.vjp`` of the JAX package's
  ``fused_attention._attention_xla``.
- ``fused_attention``'s forward (csrc/fused_attention.cu), both forms: f32
  logits; a masked key's logit q.k * km - 1e9 with km the row's scale where
  any key is attendable and 0 where none is (then every logit is -1e9, JAX's
  replacement); p rounded to bf16 before p.v, f32 row sums. The long form
  walks the keys in steps of 32 (16 at the tail) with the natural mode's
  running max (rescaled only where it rose); the short form (at most 16
  queries and 32 keys) takes the exact row max. The row statistic is
  log2(sum + 1e-30) in base 2 and max + log2(sum) in the natural mode.
  Held against the JAX package's ``_fwd_tpu`` in interpret mode, and the
  statistic against log2 of the denominator recomputed from JAX's logits.
- The host-side schedule (``ops/long_attention.py``): windows, chunks,
  blocks and shared-memory bytes at the paths' shapes, and the forward's
  form.

Inputs are seeded numpy; C = 48 with 2 heads (head dim 24, as the
flagship). Tolerance: 1e-2 x max(1, max |reference|), the card's kernel
rule.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu.ops.fused_attention import _attention_xla, _fwd_tpu
from mdgen_finetune_tpu_torch.models.rope import rope_tables, rotate_half
from mdgen_finetune_tpu_torch.ops import long_attention as LA
from mdgen_finetune_tpu_torch.ops.fused_attention import fused_attention_fwd_plain

C, H = 48, 2
D = C // H
TOL = 1e-2
LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
STEP = 32  # the kernels' full key step at D <= 32 (16 at the tail)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _bf(x):
    return x.to(torch.bfloat16).float()


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(1.0, np.abs(ref).max())
    err = np.abs(got - ref).max()
    assert err <= TOL * scale, (err, scale)


def _steps(n):
    """The kernels' key (or query) steps over n rows padded to 16: 32 while
    a full step fits, then 16."""
    n16 = -(-n // 16) * 16
    k0, out = 0, []
    while k0 + STEP <= n16:
        out.append((k0, k0 + STEP))
        k0 += STEP
    while k0 < n16:
        out.append((k0, k0 + 16))
        k0 += 16
    return out


def tiled_emulated(qkv, bk, bv, mask, base2):
    """tiled_attention's arithmetic over (G, N, I, 3C) inputs, per (sequence,
    head)."""
    G, N, I, _ = qkv.shape
    S = G * I
    x = _bf(qkv).permute(0, 2, 1, 3).reshape(S, N, 3 * C)
    valid = mask.permute(0, 2, 1).reshape(S, N)
    cos, sin = rope_tables(N + 1, D)
    nkp = -(-(N + 1) // 16) * 16
    out = torch.zeros(S, N, C)
    for s in range(S):
        for h in range(H):
            lanes = slice(h * D, (h + 1) * D)
            q = x[s, :, lanes]
            k = torch.cat([x[s, :, C:][:, lanes], _bf(bk)[lanes][None]], 0)
            v = torch.cat([x[s, :, 2 * C:][:, lanes], _bf(bv)[lanes][None]], 0)
            qr = _bf(q * cos[:N] + rotate_half(q) * sin[:N])
            kr = _bf(k * cos + rotate_half(k) * sin)
            pad = nkp - (N + 1)
            kr = torch.cat([kr, torch.zeros(pad, D)])
            v = torch.cat([v, torch.zeros(pad, D)])
            kb = torch.cat([torch.where(valid[s] > 0, 0.0, -1e9), torch.zeros(1),
                            torch.full((pad,), -1e9)])
            o, l = torch.zeros(N, D), torch.zeros(N)
            m = torch.full((N,), -math.inf)
            for k0, k1 in _steps(N + 1):
                lg = qr @ kr[k0:k1].T
                if base2:
                    p = torch.exp2(torch.clamp(lg + kb[k0:k1], max=100.0))
                else:
                    t = lg * LOG2E + kb[k0:k1]
                    new = torch.maximum(m, t.max(1).values)
                    rose = new > m
                    a = torch.where(rose, torch.exp2(m - new), torch.ones(()))
                    o, l, m = o * a[:, None], l * a, new
                    p = torch.exp2(t - m[:, None])
                l = l + p.sum(1)
                o = o + _bf(p) @ v[k0:k1]
            out[s, :, lanes] = o / (l + (1e-30 if base2 else 0.0))[:, None]
    return _bf(out.reshape(G, I, N, C).permute(0, 2, 1, 3))


def _jax_core(qkv, bk, bv, mask, base2):
    q, k, v = (jnp.asarray(qkv[..., i * C:(i + 1) * C].numpy()) for i in range(3))
    return np.asarray(jta._xla_impl(q, k, v, jnp.asarray(bk.numpy()), jnp.asarray(bv.numpy()),
                                    jnp.asarray(mask.numpy().transpose(0, 2, 1)), H,
                                    base2=base2))


def _fwd_inputs(seed, G, N, I, q_scale=1.0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(G, N, I, 3 * C)).astype(np.float32)
    qkv[..., :C] *= 0.5 * D ** -0.5 * q_scale
    bk, bv = rng.normal(size=(2, C)).astype(np.float32)
    mask = np.ones((G, N, I), np.float32)
    mask[0, N // 2:, -1] = 0  # masked frames
    mask[1, :, 0] = 0         # only the bias key is valid
    mask[0, 32:64, 0] = 0     # a whole key step
    return _bf(_t(qkv)), _bf(_t(bk)), _bf(_t(bv)), _t(mask)


@pytest.mark.parametrize("base2", [True, False])
def test_tiled_attention_emulation_matches_jax(base2):
    """Both softmaxes at N = 70 (71 keys: two steps of 32 and a tail of 16
    with 9 padding keys), with a masked key step, masked frames and a
    sequence whose only valid key is the bias key."""
    qkv, bk, bv, mask = _fwd_inputs(1, 2, 70, 3, LOG2E if base2 else 1.0)
    got = tiled_emulated(qkv, bk, bv, mask, base2)
    _close(got.numpy(), _jax_core(qkv, bk, bv, mask, base2))


def test_tiled_attention_natural_emulation_at_large_logits():
    """The natural mode at logits ~1e3 (q 400x), where exp without the max
    overflows f32: the running max keeps every exp2 finite, the rescale is
    skipped where no max rose, and the result agrees with TPU row 11b, the
    JAX package's ``_pallas_fwd_blocked`` in interpret mode on the same bf16
    inputs. At these logits the bf16 rounding of the RoPE'd q and k moves a
    logit by ~2, so the reference is the JAX kernel that rounds where the
    port's does (``_xla_impl`` keeps them in f32)."""
    qkv, bk, bv, mask = _fwd_inputs(2, 2, 45, 2, 400.0)
    got = tiled_emulated(qkv, bk, bv, mask, False)
    assert torch.isfinite(got).all()
    bf = jnp.bfloat16
    q, k, v = (jnp.asarray(qkv[..., i * C:(i + 1) * C].numpy(), bf) for i in range(3))
    ref = jta._pallas_fwd_blocked(q, k, v, jnp.asarray(bk.numpy(), bf), jnp.asarray(bv.numpy(), bf),
                                  jnp.asarray(mask.numpy().transpose(0, 2, 1)), H,
                                  interpret=True, base2=False)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.isfinite(ref).all()
    _close(got.numpy(), ref)


def fused_bwd_emulated(q, k, v, kv, o, stat, dout, base2):
    """fused_attention_bwd's two passes over (B, H, N, D) / (B, H, M, D)
    inputs (f32 holding bf16 values)."""
    Bc, Hc, N, Dd = q.shape
    M = k.shape[2]
    scale = 1.0 if base2 else LOG2E
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for b in range(Bc):
        valid = kv[b] > 0
        kb = torch.where(valid, 0.0, -1e9)
        for h in range(Hc):
            qq, kk, vv, g, st = q[b, h], k[b, h], v[b, h], dout[b, h], stat[b, h]
            delta = (g * o[b, h]).sum(1)
            kz = torch.where(valid[:, None], kk, 0.0)  # the dq pass stages masked keys' k as 0

            def p_of(lg, kbias, rows_stat):
                t = lg * scale + kbias
                if base2:
                    t = torch.clamp(t, max=100.0)
                return torch.exp2(t - rows_stat)

            acc = torch.zeros(N, Dd)
            for k0, k1 in _steps(M):  # dq: key steps in order
                k1 = min(k1, M)
                p = p_of(qq @ kz[k0:k1].T, kb[k0:k1], st[:, None])
                ds = _bf(p * (g @ vv[k0:k1].T - delta[:, None]))
                acc = acc + ds @ kz[k0:k1]
            dq[b, h] = acc * (LN2 if base2 else 1.0)
            ksc = torch.where(valid, scale, 0.0)  # a masked key's t is its -1e9 exactly
            dka, dva = torch.zeros(M, Dd), torch.zeros(M, Dd)
            for q0 in range(0, N, 16):  # dK / dV: query steps in order
                q1 = min(q0 + 16, N)
                lg = kk @ qq[q0:q1].T
                t = lg * ksc[:, None] + kb[:, None]
                if base2:
                    t = torch.clamp(t, max=100.0)
                pt = torch.exp2(t - st[None, q0:q1])
                dst = pt * (vv @ g[q0:q1].T - delta[None, q0:q1])
                dva = dva + _bf(pt) @ g[q0:q1]
                dka = dka + _bf(dst) @ qq[q0:q1]
            dk[b, h] = dka * torch.where(valid, LN2 if base2 else 1.0, 0.0)[:, None]
            dv[b, h] = dva
    return _bf(dq), _bf(dk), _bf(dv)


@pytest.mark.parametrize("base2", [True, False])
def test_fused_attention_bwd_emulation_matches_jax_vjp(base2):
    """Both softmaxes at N = 70 queries over M = 71 keys (two key steps of
    32 and a tail of 16; query steps of 16 and a tail of 6), with a masked
    key step and masked keys, against jax.vjp of _attention_xla; the
    forward's o (bf16) and stat are the port's plain forward's."""
    rng = np.random.default_rng(5)
    Bc, N, M = 2, 70, 71
    qs = 0.5 * D ** -0.5 * (LOG2E if base2 else 1.0)
    q = _bf(_t(rng.normal(size=(Bc, H, N, D)) * qs))
    k, v = (_bf(_t(rng.normal(size=(Bc, H, M, D)))) for _ in range(2))
    dout = _bf(_t(rng.normal(size=(Bc, H, N, D))))
    kv = torch.ones(Bc, M)
    kv[0, 32:64] = 0
    kv[1, 10:20] = 0
    o, stat = fused_attention_fwd_plain(q, k, v, kv, base2=base2)
    got = fused_bwd_emulated(q, k, v, kv, _bf(o), stat, dout, base2)

    def f(q_, k_, v_):
        return _attention_xla(q_, k_, v_, jnp.asarray(kv.numpy()), base2=base2)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(dout.numpy()))):
        _close(a.numpy(), np.asarray(b))


def fused_fwd_emulated(q, k, v, kv, base2):
    """fused_attention's forward over (B, H, N, D) / (B, H, M, D) inputs (f32
    holding bf16 values), in the form its plan picks: (o, stat)."""
    Bc, Hc, N, Dd = q.shape
    M = k.shape[2]
    short = LA.fused_plan(Bc * Hc, N, M, Dd).form == 1
    o, stat = torch.zeros(Bc, Hc, N, Dd), torch.zeros(Bc, Hc, N)
    for b in range(Bc):
        valid = kv[b] > 0
        km = (1.0 if base2 else LOG2E) if bool(valid.any()) else 0.0
        kb = torch.where(valid, 0.0, -1e9)
        for h in range(Hc):
            t = q[b, h] @ k[b, h].T * km + kb
            if base2:
                t = torch.clamp(t, max=100.0)
            if short:  # the exact row max, the keys in order
                m = t.max(1).values if not base2 else torch.zeros(N)
                p = torch.exp2(t - m[:, None])
                acc, l = _bf(p) @ v[b, h], p.sum(1)
            else:  # the long form's key steps, the running max rescaled where it rose
                acc, l = torch.zeros(N, Dd), torch.zeros(N)
                m = torch.full((N,), -math.inf) if not base2 else torch.zeros(N)
                for k0, k1 in _steps(M):
                    k1 = min(k1, M)
                    ts = t[:, k0:k1]
                    if not base2:
                        new = torch.maximum(m, ts.max(1).values)
                        a = torch.where(new > m, torch.exp2(m - new), torch.ones(()))
                        acc, l, m = acc * a[:, None], l * a, new
                    p = torch.exp2(ts - m[:, None])
                    l = l + p.sum(1)
                    acc = acc + _bf(p) @ v[b, h, k0:k1]
            sum_ = l + 1e-30 if base2 else l
            o[b, h] = acc / sum_[:, None]
            stat[b, h] = torch.log2(sum_) + (0.0 if base2 else m)
    return _bf(o), stat


@pytest.mark.parametrize("N", [4, 40])
@pytest.mark.parametrize("base2", [True, False])
def test_fused_attention_fwd_emulation_matches_jax(base2, N):
    """Both softmaxes in both forms (N = 4 queries over 5 keys: the short
    form; N = 40 over 41: the long one, a key step of 32 and a tail of 9),
    with masked keys and a batch element whose every key is masked (uniform
    over them in the natural mode, zero in base 2: the TPU kernel's p =
    exp2(min(-1e9, 100)) = 0 over a sum of 1e-30), against the JAX package's
    ``_fwd_tpu`` in interpret mode on the same bf16 inputs. The statistic is
    held to log2 of the softmax denominator recomputed from JAX's logits in
    base-2 units with a masked logit at -1e9, to 1e-3 of its scale (f32
    sums in another order)."""
    rng = np.random.default_rng(7 + N)
    Bc, M = 3, N + 1
    qs = D ** -0.5 * (LOG2E if base2 else 1.0)
    q = _bf(_t(rng.normal(size=(Bc, H, N, D)) * qs))
    k, v = (_bf(_t(rng.normal(size=(Bc, H, M, D)))) for _ in range(2))
    kv = torch.ones(Bc, M)
    kv[0, 1:3] = 0
    kv[1] = 0  # every key masked
    kv[2, -1] = 0
    o, stat = fused_fwd_emulated(q, k, v, kv, base2)
    bf = jnp.bfloat16
    R = Bc * H
    jq, jk, jv = (jnp.asarray(t.reshape(R, -1, D).numpy(), bf) for t in (q, k, v))
    jkv = jnp.asarray(kv.repeat_interleave(H, 0).numpy())
    ref = _fwd_tpu(jq, jk, jv, jkv, interpret=True, base2=base2)
    _close(o.reshape(R, N, D).numpy(), np.asarray(ref.astype(jnp.float32)))
    assert float(o[1].abs().max()) == 0.0 if base2 else float(o[1].abs().max()) > 0.0
    lg = np.asarray(jax.lax.dot_general(jq, jk, (((2,), (2,)), ((0,), (0,))),
                                        preferred_element_type=jnp.float32), np.float64)
    t = lg * (1.0 if base2 else LOG2E)
    t = np.where(np.asarray(jkv)[:, None, :] > 0, t, -1e9)
    if base2:
        want = np.log2(np.exp2(np.minimum(t, 100.0)).sum(-1) + 1e-30)
    else:
        mx = t.max(-1)
        want = mx + np.log2(np.exp2(t - mx[..., None]).sum(-1))
    got = stat.reshape(R, N).numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())


def test_long_attention_schedule():
    """The host-side schedule at the paths' shapes: every resident row in
    one window where it fits two blocks per SM; one block per row at
    T = 1000 (512 rows, ~1.9 waves of 264) and in the ATLAS views; a row
    split in chunks of at least two tiles per warp where the rows fill less
    than a wave; windows in multiples of 64 beyond, with one round of tiles
    per warp; every block within the SM's shared memory at two per SM."""
    rs = LA.row_stride
    assert [rs(d) for d in (16, 24, 32, 64)] == [24, 24, 40, 72]
    t1000 = LA.forward_plan(8 * 4 * 16, 1000, 24)
    assert (t1000.chunk, t1000.win, t1000.chunks, t1000.blocks, t1000.windows) == \
        (63, 1008, 1, 512, 1)
    few = LA.forward_plan(64, 1000, 24)  # 64 rows: 4 chunks of 16 tiles, two per warp
    assert (few.chunks, few.chunk, few.blocks) == (4, 16, 256)
    assert t1000.smem == 1008 * 100 + 8 * 2 * 16 * 24 * 2 == 113_088
    for view in ((250 * 16, 256), (256 * 16, 250)):  # ATLAS residue and frame views
        p = LA.forward_plan(*view, 24)
        assert (p.chunks, p.windows, p.chunk) == (1, 1, 16) and p.blocks == view[0]
    dq, dkdv = LA.dq_plan(512, 1000, 1001, 24), LA.dkdv_plan(512, 1000, 1001, 24)
    assert (dq.win, dq.chunk, dq.blocks, dq.smem) == (1008, 63, 512, 1008 * 100)
    assert (dkdv.win, dkdv.chunk, dkdv.blocks, dkdv.smem) == (1008, 63, 512, 1008 * 104)
    long = LA.forward_plan(8, 4096, 24)
    assert long.win % 64 == 0 and long.windows == -(-4112 // long.win) > 1
    assert long.chunk == 16 and long.chunks == 256 // 16
    # fused_attention's forward: the long form at T = 1000 (row g's schedule
    # without the appended key) and the no_rope frame view, the short form
    # at the residue view (64 rows of 4 queries a block of 256 threads)
    fa = LA.fused_plan(512, 1000, 1001, 24)
    assert (fa.form, fa.chunk, fa.win, fa.blocks, fa.smem) == (0, 63, 1008, 512, 113_088)
    frame = LA.fused_plan(256 * 16, 100, 101, 24)
    assert (frame.form, frame.chunks, frame.chunk, frame.windows) == (0, 1, 7, 1)
    res = LA.fused_plan(6400 * 16, 4, 5, 24)
    assert (res.form, res.rows, res.blocks, res.smem) == (1, 64, 1600, 64 * 5 * 24 * 4)
    assert LA.fused_plan(16, 17, 18, 24).form == 0 and LA.fused_plan(16, 16, 33, 24).form == 0
    assert LA.fused_plan(16, 16, 17, 64).form == 1
    for d in (16, 24, 32, 64):
        for n in (1, 4, 16, 17):
            p = LA.fused_plan(8, n, n + 1, d)
            assert p.smem <= LA.BUDGET and (p.form == 0 or p.rows * n <= LA.SHORT_THREADS)
        for n in (63, 64, 65, 255, 256, 257, 1000, 1001, 4096):
            for p in (LA.forward_plan(8, n, d), LA.dq_plan(8, n, n + 1, d),
                      LA.dkdv_plan(8, n, n + 1, d), LA.fused_plan(8, n, n + 1, d)):
                assert p.smem <= LA.BUDGET and 2 * (p.smem + 1024) <= LA.SMEM_PER_SM
                assert p.win % 16 == 0 and p.chunks * p.chunk >= -(-n // 16)
