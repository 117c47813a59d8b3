"""PyTorch port, the trunk layer's backward held against the JAX package on
the CPU:

- ``rope_attention_bwd``'s plain twin against ``jax.vjp`` of the JAX
  package's ``dense_attn`` (base 2 is natural exp of ln2 * q, RoPE being
  linear) on both trunk axes, with a padded residue and a frame whose only
  valid key is the bias token; masked keys get exactly zero dk and dv;
- ``linear_bwd``'s and ``modln_bwd``'s plain twins against torch autograd
  through the forward math they invert;
- ``fused_layer_bwd`` (the three stage backwards composed) against
  ``jax.vjp`` of ``_layer_xla`` and against torch autograd through the
  port's plain ``trunk_layer``, f32, at C = 96, 4 heads (head dim 24),
  B = 2, T = 6, L = 4, one padded residue;
- in bf16, the port's backward and the JAX package's Pallas backward
  (``fused_layer(..., force_pallas=True)``, interpret mode) held to the f32
  truth at B = 2, T = 12, L = 4, C = 192, 8 heads, under the rule of
  ``tests/test_fused_layer_bwd.py``: error <= 2 x the XLA-bf16 error + 0.01.

The CUDA kernels against these twins on a card: test_torch_kernels_cuda.py.
Tolerances (f32): 1e-4 of each tensor's max magnitude, at least 1e-6
absolute (sums in other orders; exp2 against exp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.models.attention import dense_attn as j_dense_attn
from mdgen_finetune_tpu.ops.fused_layer import _layer_xla, fused_layer
from mdgen_finetune_tpu_torch.models.attention import LN2
from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear_math
from mdgen_finetune_tpu_torch.ops.fused_layer import LAYER_KEYS, trunk_layer
from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import fused_layer_bwd
from mdgen_finetune_tpu_torch.ops.linear_bwd import linear_bwd
from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd
from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import rope_attention_bwd

NAMES = ["x", "mod", "wqkv_l", "bqkv_l", "wout_l", "bout_l", "wqkv_t", "bqkv_t",
         "wout_t", "bout_t", "w1", "b1", "w2", "b2", "bkl", "bvl", "bkt", "bvt"]


def _close(got, ref, rel=1e-4, floor=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + floor, (err, np.abs(ref).max())


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("stage", ["residues", "frames", "residues_n1"])
def test_rope_attention_bwd_matches_jax_vjp(stage):
    """residues: N = L = 4 with a padded residue and a frame whose only
    valid key is the bias key; frames: N = T = 6, I = 4; residues_n1: N = 1
    (one residue: the padded frames see only the bias key)."""
    rng = np.random.default_rng(1)
    B, T, L, C, H = 2, 6, (1 if stage == "residues_n1" else 4), 96, 4
    qkv = rng.normal(size=(B, T, L, 3 * C)).astype(np.float32) * 0.7
    bk, bv = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, T, L), np.float32)
    mask[1, :, -1] = 0.0   # a padded residue
    mask[0, 2, :] = 0.0    # residue attention: a frame whose only valid key is the bias
    view = (B, T, L) if stage == "frames" else (B * T, L, 1)
    G, N, I = view
    dout = rng.normal(size=(G, N, I, C)).astype(np.float32)
    q4 = qkv.reshape(*view, 3 * C)
    dqkv, dbk, dbv = rope_attention_bwd(_t(q4), _t(dout), _t(bk), _t(bv),
                                        _t(mask.reshape(view)), num_heads=H)

    def seqs(a):  # (G, N, I, X) -> (G*I, N, X)
        return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(G * I, N, -1))

    qs = seqs(q4)
    ms = mask.reshape(view).transpose(0, 2, 1).reshape(G * I, N)

    def f(q, k, v, b_k, b_v):
        return j_dense_attn(q * LN2, k, v, jnp.asarray(ms), b_k, b_v, H)

    @jax.jit  # op by op, the vjp costs ~5 s on the CPU
    def grads(args, g):
        return jax.vjp(f, *args)[1](g)

    dq, dk, dv, rbk, rbv = (np.asarray(g) for g in grads(
        tuple(jnp.asarray(a) for a in (qs[..., :C], qs[..., C:2 * C], qs[..., 2 * C:],
                                       bk.reshape(1, 1, C), bv.reshape(1, 1, C))),
        jnp.asarray(seqs(dout))))
    got = seqs(dqkv.numpy())
    _close(got[..., :C], dq)
    _close(got[..., C:2 * C], dk)
    _close(got[..., 2 * C:], dv)
    _close(dbk.numpy(), rbk.reshape(C))
    _close(dbv.numpy(), rbv.reshape(C))
    assert not got[..., C:][ms == 0].any()  # masked keys: exactly zero dk, dv


def test_linear_bwd_and_modln_bwd_match_autograd():
    rng = np.random.default_rng(2)
    nb, R, C, F = 2, 12, 32, 64
    M = nb * R
    x, dy = _t(rng.normal(size=(M, C))), _t(rng.normal(size=(M, F)))
    w, b = _t(rng.normal(size=(C, F)) * 0.2), _t(rng.normal(size=(F,)) * 0.1)
    sh, sc, g = (_t(rng.normal(size=(nb, C)) * 0.3) for _ in range(3))
    gate = _t(rng.normal(size=(nb, F)) * 0.3)

    # wgrad (LN + modulate prologue, gated dy) and dgrad against autograd
    # of (g_rows * (modulate(LN(x)) @ w + b)) . dy
    leaves = [t.clone().requires_grad_() for t in (x, w, b, sh, sc)]
    y = adaln_linear_math(leaves[0], leaves[1], leaves[2], ln="plain", shift=leaves[3],
                          scale=leaves[4])
    (y * gate.repeat_interleave(R, 0) * dy).sum().backward()
    dw, db = linear_bwd("wgrad", dy, x, gate=gate, ln=True, shift=sh, scale=sc)
    _close(dw, leaves[1].grad)
    _close(db, leaves[2].grad)
    # dgrad with the GELU epilogue: d/dh of gelu_fast(h @ w2.T-shaped product)
    a = _t(rng.normal(size=(M, C)) * 2)
    w2 = _t(rng.normal(size=(C, F)) * 0.2)
    ha = a.clone().requires_grad_()
    hid = adaln_linear_math(ha, torch.eye(C), epilogue="gelu")
    (hid @ w2 * dy).sum().backward()
    _close(linear_bwd("dgrad", dy, w2, act=a), ha.grad)

    # modln_bwd: L = dh . modulate(LN(x)) + dout . (x + g * y)
    dh, dout, yy = _t(rng.normal(size=(M, C))), _t(rng.normal(size=(M, C))), _t(rng.normal(size=(M, C)))
    xs, shs, scs, gs = (t.clone().requires_grad_() for t in (x, sh, sc, g))
    h = adaln_linear_math(xs, torch.eye(C), ln="plain", shift=shs, scale=scs)
    ((h * dh).sum() + (dout * (xs + gs.repeat_interleave(R, 0) * yy)).sum()).backward()
    dmod = torch.zeros(nb, 5 * C)
    dx, _ = modln_bwd(x, dh, dout, yy, sc, dmod[:, C:4 * C])
    _close(dx, xs.grad)
    _close(dmod[:, C:2 * C], shs.grad)
    _close(dmod[:, 2 * C:3 * C], scs.grad)
    _close(dmod[:, 3 * C:4 * C], gs.grad)
    assert not dmod[:, :C].any() and not dmod[:, 4 * C:].any()


def _make(B, T, L, C, seed):
    rng = np.random.default_rng(seed)
    shapes = dict(x=(B, T * L, C), mod=(B, 9 * C), wqkv_l=(C, 3 * C), bqkv_l=(3 * C,),
                  wout_l=(C, C), bout_l=(C,), wqkv_t=(C, 3 * C), bqkv_t=(3 * C,),
                  wout_t=(C, C), bout_t=(C,), w1=(C, 4 * C), b1=(4 * C,),
                  w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,), bkt=(C,), bvt=(C,))
    vals = {k: (rng.normal(size=shapes[k]) * (C ** -0.5 if k.startswith("w") else 0.4))
            .astype(np.float32) for k in NAMES}
    mask = np.ones((B, T, L), np.float32)
    mask[1, :, -1] = 0.0
    w_out = rng.normal(size=(B, T * L, C)).astype(np.float32)
    return vals, mask, w_out


def _jax_grads(vals, mask, w_out, H, T, L, dtype, which):
    vs = [jnp.asarray(vals[k], dtype) for k in NAMES]

    def loss(*vv):
        if which == "pallas":
            out = fused_layer(*vv, jnp.asarray(mask), num_heads=H, tl=(T, L), force_pallas=True)
        else:
            out = _layer_xla(*vv, jnp.asarray(mask), H, T, L)
        return jnp.sum(out.astype(jnp.float32) * w_out)

    return dict(zip(NAMES, jax.jit(jax.grad(loss, argnums=tuple(range(18))))(*vs)))


def _port_grads(vals, mask, w_out, H, T, L, dtype):
    B, _, C = vals["x"].shape
    x = _t(vals["x"].reshape(-1, C), dtype)
    mod = _t(vals["mod"], dtype)
    w = {k: _t(vals[k], dtype) for k in LAYER_KEYS}
    mk = _t(mask)
    x1, x2, _ = trunk_layer(x, mod, w, mk, B=B, T=T, L=L, num_heads=H)
    dx, dmod, dw = fused_layer_bwd(x, x1, x2, _t(w_out.reshape(-1, C)), mod, w, mk, H)
    return dict(x=dx.reshape(B, T * L, C), mod=dmod, **dw)


def test_layer_bwd_matches_jax_vjp_and_autograd():
    B, T, L, C, H = 2, 6, 4, 96, 4
    vals, mask, w_out = _make(B, T, L, C, seed=4)
    ref = _jax_grads(vals, mask, w_out, H, T, L, jnp.float32, "xla")
    got = _port_grads(vals, mask, w_out, H, T, L, torch.float32)
    leaves = {k: _t(vals[k]).requires_grad_() for k in NAMES}
    _, _, y = trunk_layer(leaves["x"].reshape(-1, C), leaves["mod"],
                          {k: leaves[k] for k in LAYER_KEYS}, _t(mask), B=B, T=T, L=L,
                          num_heads=H)
    (y * _t(w_out.reshape(-1, C))).sum().backward()
    for k in NAMES:
        _close(got[k].numpy(), np.asarray(ref[k]))
        _close(got[k].numpy(), leaves[k].grad.numpy())


def test_layer_bwd_bf16_held_to_f32_truth():
    B, T, L, C, H = 2, 12, 4, 192, 8
    vals, mask, w_out = _make(B, T, L, C, seed=0)
    truth = _jax_grads(vals, mask, w_out, H, T, L, jnp.float32, "xla")
    xla = _jax_grads(vals, mask, w_out, H, T, L, jnp.bfloat16, "xla")
    pallas = _jax_grads(vals, mask, w_out, H, T, L, jnp.bfloat16, "pallas")
    port = _port_grads(vals, mask, w_out, H, T, L, torch.bfloat16)
    for k in NAMES:
        gt = np.asarray(truth[k], np.float64)
        denom = max(np.abs(gt).max(), 1e-6)

        def err(g):
            return np.abs(np.asarray(g, np.float64) - gt).max() / denom

        e_xla = err(np.asarray(xla[k], np.float32))
        e_port = err(port[k].float().numpy())
        e_pal = err(np.asarray(pallas[k], np.float32))
        assert e_port <= 2.0 * e_xla + 0.01, (k, e_port, e_xla)
        assert e_pal <= 2.0 * e_xla + 0.01, (k, e_pal, e_xla)
