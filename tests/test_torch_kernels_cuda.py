"""PyTorch port, the CUDA kernels against their plain twins on a card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry
the ``cuda`` marker and skip without a card. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX). ``chip_smoke.py``
makes the same comparisons at the full shapes of each path (sampling at
T = 100 and T = 1000, training, the modular layer's natural-softmax cores).
"""
import pytest
import torch

from mdgen_finetune_tpu_torch.geometry.rigid import Rigid as TRigid


def _close(got, ref, rel=1e-2):
    """Kernel (bf16 out) against the plain twin run in f32 on the same
    inputs: within ``rel`` of the output's scale (bf16 keeps 8 bits)."""
    scale = max(1.0, ref.float().abs().max().item())
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * scale, (err, scale)


def _f32(kw):
    return {k: (v.float() if torch.is_tensor(v) and v.dtype == torch.bfloat16 else v)
            for k, v in kw.items()}


@pytest.mark.cuda
def test_trunk_kernels_match_plain_on_card():
    """On the card: adaln_linear (both tilings, every prologue/epilogue of
    the trunk and the encoder) and rope_attention (both axes, both softmax
    modes) against their plain twins, at the flagship head dim 24."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, adaln_linear_plain
    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention, rope_attention_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    Bc, Tc, Lc, Cc, Hc = 2, 20, 4, 96, 4
    M = Bc * Tc * Lc

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)

    x, w, b = r(M, Cc), r(Cc, 3 * Cc, sc=Cc ** -0.5), r(3 * Cc, sc=0.1)
    sh, scl, gate = r(Bc, Cc, sc=0.3), r(Bc, Cc, sc=0.3), r(Bc, 3 * Cc, sc=0.3)
    cases = [
        (x, w, b, dict(ln="plain", shift=sh, scale=scl)),
        (x, w, b, dict(ln="plain", shift=sh, scale=scl, epilogue="gelu")),
        (x, w, b, dict(epilogue="gate_res", res=r(M, 3 * Cc), gate=gate)),
        (x, w, b, dict(ln="affine", ln_weight=1 + r(Cc, sc=0.1, dtype=f32),
                       ln_bias=r(Cc, sc=0.1, dtype=f32), out_dtype=f32)),
        # the 64-tile path: N = 21 head with the Euler update, f32 embed input
        (x, w[:, :21].contiguous(), b[:21].contiguous(),
         dict(ln="plain", shift=sh[:1], scale=scl[:1], epilogue="euler", res=r(M, 21, dtype=f32), dt=0.1)),
        (r(M, 21, dtype=f32), r(21, Cc, sc=0.2), None,
         dict(epilogue="add", add1=r(M, Cc), add2=r(Bc * Lc, Cc), add2_map=(Tc * Lc, Lc, Lc))),
    ]
    for a_, w_, b_, kw in cases:
        _close(adaln_linear(a_, w_, b_, **kw),
               adaln_linear_plain(a_.float(), w_.float(), None if b_ is None else b_.float(), **_f32(kw)))
    mask = torch.ones(Bc, Tc, Lc, device="cuda")
    mask[1, :, -1] = 0
    qkv = r(Bc, Tc, Lc, 3 * Cc)
    bk, bv = r(Cc), r(Cc)
    for view, mk in (((Bc * Tc, Lc, 1, 3 * Cc), (Bc * Tc, Lc, 1)), ((Bc, Tc, Lc, 3 * Cc), (Bc, Tc, Lc))):
        q = qkv.view(view)
        for base2 in (True, False):
            _close(rope_attention(q, bk, bv, mask.view(mk), num_heads=Hc, base2=base2),
                   rope_attention_plain(q.float(), bk.float(), bv.float(), mask.view(mk),
                                        num_heads=Hc, base2=base2))


@pytest.mark.cuda
def test_ipa_attention_matches_plain_on_card():
    """On the card: the IPA core kernel against its plain twin (f32 point
    math in both; the kernel writes bf16 features)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.ipa_attention import (
        ipa_attention, ipa_attention_plain, proj_width)

    g = torch.Generator(device="cuda").manual_seed(0)
    Bc = 16
    proj = torch.randn(Bc, 4, proj_width(4, 32, 8, 8), generator=g, device="cuda")
    t7 = torch.randn(Bc, 4, 7, generator=g, device="cuda")
    fr = TRigid.from_tensor_7(t7)
    mask = torch.ones(Bc, 4, device="cuda")
    mask[0, -1] = 0
    hw = torch.randn(4, generator=g, device="cuda")
    a = ipa_attention(proj, fr.rot.contiguous(), fr.trans.contiguous(), mask, hw,
                      H=4, Ch=32, Pq=8, Pv=8)
    p = ipa_attention_plain(proj, fr.rot, fr.trans, mask, hw, H=4, Ch=32, Pq=8, Pv=8)
    _close(a, p)


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """On the card: linear_bwd (dgrad with gate and GELU' epilogue, wgrad
    with the LN prologue), modln_bwd and rope_attention_bwd (both trunk
    axes, a padded residue) against their plain twins on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.linear_bwd import linear_bwd, linear_bwd_plain
    from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd, modln_bwd_plain
    from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import (
        rope_attention_bwd, rope_attention_bwd_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16
    Bc, Tc, Lc, Cc, Hc = 2, 20, 4, 96, 4
    M = Bc * Tc * Lc

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)

    x, dout = r(M, Cc), r(M, Cc, dtype=torch.float32)
    sh, scl, gate = r(Bc, Cc, sc=0.3), r(Bc, Cc, sc=0.3), r(Bc, Cc, sc=0.3)
    w1, w2 = r(Cc, 4 * Cc, sc=Cc ** -0.5), r(4 * Cc, Cc, sc=0.05)
    act, da = r(M, 4 * Cc, sc=2.0, dtype=torch.float32), r(M, 4 * Cc)
    cases = [
        ("dgrad", dout, w2, dict(gate=gate, act=act, out_dtype=bf)),
        ("dgrad", da, w1, dict()),
        ("wgrad", da, x, dict(ln=True, shift=sh, scale=scl)),
        ("wgrad", dout, r(M, 4 * Cc), dict(gate=gate)),
    ]
    for mode, dy, xx, kw in cases:
        got, ref = linear_bwd(mode, dy, xx, **kw), linear_bwd_plain(mode, dy, xx, **kw)
        for a, b in zip(got if mode == "wgrad" else (got,), ref if mode == "wgrad" else (ref,)):
            _close(a, b)
    dh, y = r(M, Cc, dtype=torch.float32), r(M, Cc, dtype=torch.float32)
    dx, dmod = modln_bwd(x, dh, dout, y, scl)
    rdx, rdmod = modln_bwd_plain(x, dh, dout, y, scl)
    _close(dx, rdx, 1e-3)
    _close(dmod, rdmod, 1e-3)
    mask = torch.ones(Bc, Tc, Lc, device="cuda")
    mask[1, :, -1] = 0
    qkv = r(Bc, Tc, Lc, 3 * Cc)
    bk, bv = r(Cc), r(Cc)
    for view in ((Bc * Tc, Lc, 1), (Bc, Tc, Lc)):
        q, do, mk = qkv.view(*view, 3 * Cc), r(*view, Cc), mask.view(view)
        for a, b in zip(rope_attention_bwd(q, do, bk, bv, mk, num_heads=Hc),
                        rope_attention_bwd_plain(q, do, bk, bv, mk, num_heads=Hc)):
            _close(a, b)


MODLN_SHAPES = {"flagship": (32 * 100 * 4, 32), "train_1000": (8 * 1000 * 4, 8),
                "train_atlas": (250 * 256, 1)}  # (rows, elements) at C = 384


def _modln_inputs(M, nb, C=384, seed=3, pad=0, x_dtype=torch.bfloat16):
    """Seeded modln_bwd inputs on the card; ``pad`` > 0 gives x as a row
    view of a (M, C + pad) buffer (pad 1: rows off 16-byte boundaries)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xb = (torch.randn(M, C + pad, generator=g, device="cuda") * 1.5 + 0.3).to(x_dtype)
    dh, dout, y = (torch.randn(M, C, generator=g, device="cuda") for _ in range(3))
    scale = (0.3 * torch.randn(nb, C, generator=g, device="cuda")).bfloat16()
    return xb[:, :C], dh, dout, y, scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(MODLN_SHAPES))
def test_modln_bwd_at_the_training_shapes_on_card(shape):
    """On the card: modln_bwd (row e) against its plain version (f32, the
    same inputs) within 1e-3 of each output's scale at the flagship, T = 1000
    and ATLAS training shapes (32, 8 and 1 elements): x in bf16 and in f32,
    x as a row view whose rows start on 16-byte boundaries and one whose rows
    do not (the kernel's plain-copy path), dmod as a row view of a wider
    buffer; two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd, modln_bwd_plain

    M, nb = MODLN_SHAPES[shape]
    C = 384
    for kw in (dict(), dict(x_dtype=torch.float32), dict(pad=8), dict(pad=1)):
        x, dh, dout, y, scale = _modln_inputs(M, nb, **kw)
        n0 = modln_bwd.launches
        view = torch.full((nb, 4 * C), 7.0, device="cuda")[:, C:]
        dx, dmod = modln_bwd(x, dh, dout, y, scale, dmod=view)
        assert dmod.data_ptr() == view.data_ptr() and modln_bwd.launches == n0 + 1
        rdx, rdmod = modln_bwd_plain(x.float(), dh, dout, y, scale.float())
        _close(dx, rdx, 1e-3)
        _close(dmod, rdmod, 1e-3)
        again = modln_bwd(x, dh, dout, y, scale)
        torch.cuda.synchronize()
        assert torch.equal(again[0], dx) and torch.equal(again[1], dmod), kw


MODLN_WIDTHS = {200: (2400, 3), 448: (3200, 4)}  # C: (rows, elements)


@pytest.mark.cuda
@pytest.mark.parametrize("C", sorted(MODLN_WIDTHS))
def test_modln_bwd_at_other_widths_on_card(C):
    """On the card: modln_bwd at widths off the training path's 384 (C =
    200, J = 8; 448, J = 16: both routes run the staged body up to 512)
    against its plain version within 1e-3 of each output's scale, x in bf16
    and in f32, rows on and off 16-byte boundaries; each instance builds
    without spills; rows wider than the kernel's MAX_C raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import modln_bwd as MB

    M, nb = MODLN_WIDTHS[C]
    for kw in (dict(), dict(x_dtype=torch.float32), dict(pad=1)):
        x, dh, dout, y, scale = _modln_inputs(M, nb, C=C, **kw)
        dx, dmod = MB.modln_bwd(x, dh, dout, y, scale)
        rdx, rdmod = MB.modln_bwd_plain(x.float(), dh, dout, y, scale.float())
        _close(dx, rdx, 1e-3)
        _close(dmod, rdmod, 1e-3)
    for x_f32 in (False, True):
        res = MB.resources(C, x_f32)
        assert res["local_bytes"] == 0 and res["blocks_per_sm"] >= 1, (C, x_f32, res)
    wide = MB.MAX_C + 8
    with pytest.raises(ValueError, match="not taken"):
        MB.modln_bwd(*_modln_inputs(16, 2, C=wide))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,nb", [(1203, 200, 72, 3), (40, 8, 136, 2), (2400, 384, 1152, 4)])
def test_linear_bwd_tiling_edges_on_card(M, K, N, nb):
    """On the card: linear_bwd against its plain twin (f32 on the same
    inputs, 1e-2 x max(1, max |twin|)) at the edges of its 128 x 128
    tiles and 32-row chunks: M not a multiple of either (one split at
    M = 40), K and N multiples of 8 but not of 64, per-element rows that
    end inside a tile; every mode of the training path: dgrad with f32 or
    bf16 dY, with and without the gate, the GELU' epilogue and a bf16
    output; wgrad with the gate (f32 and bf16 dY) or the LN prologue.
    Two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.linear_bwd import linear_bwd, linear_bwd_plain

    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    bf, f32 = torch.bfloat16, torch.float32

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)

    gate, sh, scl = r(nb, N, sc=0.3), r(nb, K, sc=0.3), r(nb, K, sc=0.3)
    w, act = r(K, N, sc=N ** -0.5), r(M, K, sc=2.0, dtype=f32)
    cases = [
        ("dgrad", r(M, N, dtype=f32), w, dict(gate=gate, act=act, out_dtype=bf)),
        ("dgrad", r(M, N, dtype=f32), w, dict()),
        ("dgrad", r(M, N), w, dict(gate=gate)),
        ("dgrad", r(M, N), w, dict(act=act)),
        ("wgrad", r(M, N), r(M, K), dict(ln=True, shift=sh, scale=scl)),
        ("wgrad", r(M, N, dtype=f32), r(M, K), dict(gate=gate)),
        ("wgrad", r(M, N), r(M, K), dict(gate=gate)),
        ("wgrad", r(M, N, dtype=f32), r(M, K), dict(ln=True, shift=sh, scale=scl)),
    ]
    for mode, dy, xx, kw in cases:
        got = linear_bwd(mode, dy, xx, **kw)
        again = linear_bwd(mode, dy, xx, **kw)
        ref = linear_bwd_plain(mode, dy.float(), xx.float(), **_f32(kw))
        got, again, ref = ((t,) if mode == "dgrad" else t for t in (got, again, ref))
        for a, b, c in zip(got, again, ref):
            assert torch.equal(a, b), (mode, sorted(kw))
            _close(a, c)


# sequence lengths at and around the long-key kernels' tile (16), step (64)
# and window boundaries, the ATLAS lengths and T = 1000
LONG_N = (63, 64, 65, 255, 256, 257, 1000, 1001, 4096)


def _long_mask(G, N, I, win):
    """The key mask of the long-key kernel tests over (G, N, I): a 64-key
    step of masked keys, a whole window of them where N spans more than
    one window, masked frames, and sequence (1, 0) whose only valid key is
    the bias key."""
    mask = torch.ones(G, N, I, device="cuda")
    mask[0, 64:128] = 0
    if N > win:
        mask[0, win:2 * win, 0] = 0
    mask[0, N // 2:, -1] = 0
    mask[1, :, 0] = 0
    return mask


@pytest.mark.cuda
def test_tiled_attention_matches_plain_on_card():
    """On the card: the long-key frame-attention core (base 2) against its
    plain twin at every supported head dim, at N around every tile, step
    and window boundary (``LONG_N``, to 4,096, the JAX package's
    fused_attention ceiling) and in both ATLAS views ((1, 250, 256) frames,
    (250, 256, 1) residues), with the masks of ``_long_mask``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.long_attention import forward_plan
    from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention, tiled_attention_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    Hc = 2
    for D in (16, 24, 32, 64):
        C = Hc * D
        views = [(2, N, 2) for N in LONG_N] + [(2, 250, 256), (250, 256, 1)]
        for Gc, N, Ic in views:
            qkv = torch.randn(Gc, N, Ic, 3 * C, generator=g, device="cuda").to(torch.bfloat16)
            qkv[..., :C] *= 0.5 * D ** -0.5
            bk = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
            bv = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
            mask = _long_mask(Gc, N, Ic, forward_plan(Gc * Ic * Hc, N, D).win)
            got = tiled_attention(qkv, bk, bv, mask, num_heads=Hc)
            ref = tiled_attention_plain(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc)
            torch.cuda.synchronize()
            _close(got, ref)


@pytest.mark.cuda
def test_tiled_attention_natural_matches_plain_on_card():
    """On the card: the long-key core's natural mode (``base2=False``, a
    running max per query row across the key steps, the rescale skipped
    where no row's max rose) against its plain twin at every supported
    head dim, at ``LONG_N`` and in both ATLAS views with the masks of
    ``_long_mask``, over residues at L = 9 (the view (B*T, L, 1)); and with
    q scaled so that the logits reach ~1e3, where exp without the max
    overflows f32: the max must be subtracted. There a logit moves by ~2
    when the kernel rounds the RoPE'd q and k to bf16 (as the JAX kernel
    does), so the reference is the plain math with that rounding
    (``rope_attention_math(stage=bf16)``), with q and k nonzero in the
    first half of each head's lanes only: RoPE is one product per lane
    there, so that kernel and reference round the same f32 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.long_attention import forward_plan
    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention_math
    from mdgen_finetune_tpu_torch.ops.tiled_attention import tiled_attention, tiled_attention_plain

    g = torch.Generator(device="cuda").manual_seed(8)
    Hc = 2
    for D in (16, 24, 32, 64):
        C = Hc * D
        views = ([((2, N, 2), 1.0) for N in LONG_N]
                 + [((2, 250, 256), 1.0), ((250, 256, 1), 1.0), ((6, 9, 1), 1.0),
                    ((2, 300, 2), 400.0), ((2, 1001, 2), 400.0)])
        for (Gc, N, Ic), qs in views:
            qkv = torch.randn(Gc, N, Ic, 3 * C, generator=g, device="cuda")
            qkv[..., :C] *= 0.5 * D ** -0.5 * qs
            bk = torch.randn(C, generator=g, device="cuda")
            if qs != 1.0:
                qkv.view(Gc, N, Ic, 3, Hc, 2, D // 2)[..., :2, :, 1, :] = 0
                bk.view(Hc, 2, D // 2)[:, 1] = 0
            qkv, bk = qkv.to(torch.bfloat16), bk.to(torch.bfloat16)
            bv = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
            mask = _long_mask(Gc, N, Ic, forward_plan(Gc * Ic * Hc, N, D).win)
            got = tiled_attention(qkv, bk, bv, mask, num_heads=Hc, base2=False)
            if qs == 1.0:
                ref = tiled_attention_plain(qkv.float(), bk.float(), bv.float(), mask,
                                            num_heads=Hc, base2=False)
            else:
                ref = rope_attention_math(qkv.float(), bk.float(), bv.float(), mask,
                                          num_heads=Hc, base2=False, stage=torch.bfloat16)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), (D, Gc, N, Ic, qs)
            scale = max(1.0, ref.abs().max().item())
            err = (got.float() - ref).abs().max().item()
            assert err <= 1e-2 * scale, (D, Gc, N, Ic, qs, err, scale)


@pytest.mark.cuda
def test_rope_attention_natural_at_the_modular_shapes_on_card():
    """On the card: ``rope_attention(base2=False)`` (the modular layer's
    residue core, row 12, and its frame core at T <= 256, row 11a) against
    its plain twin at head dim 24: the (B*T, L, 1) view at L = 4 and 8, and
    the (B, T, L) view at T = 100 and 256, with masked residues and frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention, rope_attention_plain

    g = torch.Generator(device="cuda").manual_seed(9)
    Hc, D = 4, 24
    C = Hc * D
    for view in ((200, 4, 1), (200, 8, 1), (4, 100, 4), (2, 256, 3)):
        qkv = torch.randn(*view, 3 * C, generator=g, device="cuda")
        qkv[..., :C] *= D ** -0.5
        qkv = qkv.to(torch.bfloat16)
        bk = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
        bv = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
        mask = torch.ones(*view, device="cuda")
        mask[0, -1] = 0
        mask[1] = 0
        got = rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=False)
        ref = rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc,
                                   base2=False)
        torch.cuda.synchronize()
        _close(got, ref)


def _rope_case(g, Gc, N, Ic, Hc, D, q_scale=1.0, k_scale=1.0, half_lanes=False):
    """Seeded bf16 qkv (G, N, I, 3C), bias key / value and a mask with
    masked keys, a sequence whose only valid key is the bias token (g = 1)
    and, at g = 2, keys masked at random. ``half_lanes``: q and k nonzero
    in the first half of each head's lanes only, where RoPE is one product
    per lane, so that kernel and reference round the same f32 values."""
    C = Hc * D
    qkv = torch.randn(Gc, N, Ic, 3 * C, generator=g, device="cuda")
    qkv[..., :C] *= q_scale
    qkv[..., C:2 * C] *= k_scale
    bk = torch.randn(C, generator=g, device="cuda") * k_scale
    if half_lanes:
        qkv.view(Gc, N, Ic, 3, Hc, 2, D // 2)[..., :2, :, 1, :] = 0
        bk.view(Hc, 2, D // 2)[:, 1] = 0
    bv = torch.randn(C, generator=g, device="cuda")
    mask = torch.ones(Gc, N, Ic, device="cuda")
    mask[0, N // 2:, -1] = 0
    mask[1] = 0
    mask[2] = (torch.rand(N, Ic, generator=g, device="cuda") > 0.3).float()
    return qkv.to(torch.bfloat16), bk.to(torch.bfloat16), bv.to(torch.bfloat16), mask


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_rope_attention_long_body_on_card(D):
    """On the card: the long-sequence body of rope_attention (tensor-core
    products, RoPE'd q and k staged in fp16) in both softmax modes against
    its f32 plain twin at N = 17, 64, 100, 128, 200 and 256 (q unscaled:
    logits of several units, where the staging precision shows), with
    masked keys, a sequence whose only valid key is the bias token and keys
    masked at random; and the natural mode with q scaled 400x (logits
    ~1e3, where exp without the max overflows f32 and a logit moves by
    ~0.5 with the fp16 rounding of q and k), against the plain math with
    that rounding (``rope_attention_math(stage=float16)``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.rope_attention import (rope_attention, rope_attention_math,
                                                             rope_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(20 + D)
    Hc = 2
    for N in (17, 64, 100, 128, 200, 256):
        qkv, bk, bv, mask = _rope_case(g, 3, N, 2, Hc, D)
        for base2 in (True, False):
            got = rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=base2)
            ref = rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc,
                                       base2=base2)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), (N, base2)
            _close(got, ref)
    for N in (100, 256):
        qkv, bk, bv, mask = _rope_case(g, 3, N, 2, Hc, D, q_scale=400.0 * D ** -0.5,
                                       half_lanes=True)
        got = rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=False)
        ref = rope_attention_math(qkv.float(), bk.float(), bv.float(), mask, num_heads=Hc,
                                  base2=False, stage=torch.float16)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all(), N
        _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_rope_attention_short_body_on_card(D):
    """On the card: the streaming short body of ``rope_attention`` (N <= 16)
    against its f32 plain twin (1e-2 x max(1, max |twin|)) at N = 1, 4, 5,
    9, 16, I = 1 and 3, both softmax modes: G = 1201 sequences per I (not a
    multiple of the plan's sequences per unit), masked keys, a sequence
    whose only valid key is the bias token (g = 1; its output is the bias
    value) and keys masked at random (g = 2); at D = 64 with 8 heads the
    plan splits a sequence's heads into groups (the last one short). Also
    the flagship's stage-1 view (6400, 4, 1) at D = 24, 16 heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import rope_attention as RA

    g = torch.Generator(device="cuda").manual_seed(19 + D)
    Hc = 8 if D == 64 else 16
    cases = [(1201, N, Ic) for N in (1, 4, 5, 9, 16) for Ic in (1, 3)]
    if D == 24:
        cases.append((6400, 4, 1))
    uneven = split = 0
    for Gc, N, Ic in cases:
        p = RA.short_plan(Gc, N, Ic, Hc, D)
        uneven += (Gc * Ic) % p.spb != 0
        split += p.hg < Hc and Hc % p.hg != 0
        qkv, bk, bv, mask = _rope_case(g, Gc, N, Ic, Hc, D, q_scale=D ** -0.5)
        for base2 in (True, False):
            got = RA.rope_attention(qkv, bk, bv, mask, num_heads=Hc, base2=base2)
            ref = RA.rope_attention_plain(qkv.float(), bk.float(), bv.float(), mask,
                                          num_heads=Hc, base2=base2)
            torch.cuda.synchronize()
            _close(got, ref)
            # g = 1 sees only the bias key: every output row is bias_v
            assert torch.equal(got[1], bv.view(1, 1, -1).expand_as(got[1])), (N, Ic, base2)
    assert uneven and (D != 64 or split), (uneven, split)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_rope_attention_bwd_short_body_on_card(D):
    """On the card: the streaming short body of ``rope_attention_bwd``
    (N <= 16) against its f32 plain twin (1e-2 x max(1, max |twin|), each of
    dqkv, dbk, dbv) at N = 1, 4, 5, 9, 16, I = 1 and 3: G = 1201 sequences
    per I (not a multiple of the plan's sequences per unit), masked keys, a
    sequence whose only valid key is the bias token (g = 1: its keys' dk and
    dv exactly zero) and keys masked at random (g = 2); at D = 64 with 8
    heads the plan splits a sequence's heads into groups. Also the training
    path's stage 1, (3200, 4, 1) at D = 24 with 16 heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    g = torch.Generator(device="cuda").manual_seed(29 + D)
    Hc = 8 if D == 64 else 16
    cases = [(1201, N, Ic) for N in (1, 4, 5, 9, 16) for Ic in (1, 3)]
    if D == 24:
        cases.append((3200, 4, 1))
    uneven = split = 0
    for Gc, N, Ic in cases:
        p = RB.short_plan(Gc, N, Ic, Hc, D)
        uneven += (Gc * Ic) % p.spb != 0
        split += p.hg < Hc
        qkv, bk, bv, mask = _rope_case(g, Gc, N, Ic, Hc, D, q_scale=D ** -0.5)
        do = (0.1 * torch.randn(Gc, N, Ic, Hc * D, generator=g, device="cuda")).bfloat16()
        got = RB.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
        ref = RB.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                          num_heads=Hc)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a.float()).all(), (N, Ic)
            _close(a, b)
        assert not got[0][1, ..., Hc * D:].any(), (N, Ic)  # g = 1: masked keys, zero dk and dv
    assert uneven and (D != 64 or split), (uneven, split)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_rope_attention_bwd_natural_short_body_on_card(D):
    """On the card: the natural-softmax mode of ``rope_attention_bwd``'s
    short body (the modular layer's residue attention: the row's maximum
    before the exponent, no ln 2) against its f32 plain twin at N = 1, 4,
    5, 9, 16 and I = 1, 3 over 1201 sequences, masked keys as
    ``_rope_case``, at unit logits and with q scaled 400x (logits ~1e3,
    where an exponent without the maximum would overflow); the modular
    layer's residue shape (3200, 4, 1) at D = 24; and at N = 20, 33 the
    natural route through ``fused_attention`` (``natural_long_bwd``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

    g = torch.Generator(device="cuda").manual_seed(41 + D)
    Hc = 8 if D == 64 else 16
    cases = [(1201, N, Ic, qs) for N in (1, 4, 5, 9, 16) for Ic in (1, 3) for qs in (1.0, 400.0)]
    cases += [(301, N, 1, 1.0) for N in (20, 33)]
    if D == 24:
        cases += [(3200, 4, 1, 1.0), (3200, 4, 1, 400.0)]
    before = RB.rope_attention_bwd.bodies[2]
    for Gc, N, Ic, qs in cases:
        qkv, bk, bv, mask = _rope_case(g, Gc, N, Ic, Hc, D, q_scale=D ** -0.5 * qs)
        do = (0.1 * torch.randn(Gc, N, Ic, Hc * D, generator=g, device="cuda")).bfloat16()
        got = RB.rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc, base2=False)
        ref = RB.rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                          num_heads=Hc, base2=False)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a.float()).all(), (N, Ic, qs)
            _close(a, b)
        assert not got[0][1, ..., Hc * D:].any(), (N, Ic)  # g = 1: masked keys, zero dk and dv
    assert RB.rope_attention_bwd.bodies[2] - before == sum(c[1] <= 16 for c in cases)


@pytest.mark.cuda
def test_ipa_attention_streaming_form_on_card():
    """On the card: the streaming form of the IPA core (L <= 16 at the
    model's widths) against its plain twin at every L from 1 to 16 over
    B = 1201 elements (not a multiple of the plan's elements per unit), and
    at the encoder's (6401, 4), with a padded residue in every 7th element
    and an element whose residues are all masked but one; the same bits from
    a proj that starts 4 bytes past a 16-byte boundary (the 4-byte copy
    path) and from the build that copies 4 bytes at a time everywhere
    (``-DMDGEN_IPA_GENERAL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import ipa_attention as IA

    g = torch.Generator(device="cuda").manual_seed(13)
    kw = dict(H=4, Ch=32, Pq=8, Pv=8)
    general = _cuda.variant_library("ipa_attention", "MDGEN_IPA_GENERAL")
    own = _cuda.library("ipa_attention", IA._ARGTYPES)
    general.ipa_attention.argtypes = own.ipa_attention.argtypes
    general.ipa_attention.restype = own.ipa_attention.restype
    uneven = 0
    for Bc, Lc in [(1201, L) for L in range(1, 17)] + [(6401, 4)]:
        assert IA._form(Bc, Lc, 4, 32, 8, 8) == 0
        uneven += Bc % IA.ipa_plan(Bc, Lc, 4, 32, 8, 8).spb != 0
        W = IA.proj_width(4, 32, 8, 8)
        proj = torch.randn(Bc, Lc, W, generator=g, device="cuda")
        t7 = torch.randn(Bc, Lc, 7, generator=g, device="cuda")
        t7[..., 4:] *= 5
        fr = TRigid.from_tensor_7(t7)
        rot, trans = fr.rot.contiguous(), fr.trans.contiguous()
        mask = torch.ones(Bc, Lc, device="cuda")
        mask[::7, -1] = 0
        mask[1, 1:] = 0
        hw = torch.randn(4, generator=g, device="cuda")
        got = IA.ipa_attention(proj, rot, trans, mask, hw, **kw)
        ref = IA.ipa_attention_plain(proj, rot, trans, mask, hw, **kw)
        torch.cuda.synchronize()
        _close(got, ref)
        shifted = torch.empty(Bc * Lc * W + 1, device="cuda")[1:].view(Bc, Lc, W)
        shifted.copy_(proj)
        assert shifted.data_ptr() % 16 == 4
        assert torch.equal(IA.ipa_attention(shifted, rot, trans, mask, hw, **kw), got), Lc
        kept = _cuda._LIBS["ipa_attention"]
        _cuda._LIBS["ipa_attention"] = general
        try:
            assert torch.equal(IA.ipa_attention(proj, rot, trans, mask, hw, **kw), got), Lc
        finally:
            _cuda._LIBS["ipa_attention"] = kept
    assert uneven


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_rope_attention_bwd_long_body_on_card(D):
    """On the card: the long-sequence body of rope_attention_bwd (all six
    products on the tensor cores; q and k in fp16 scaled by powers of two,
    ds in fp16 scaled by 1 / max|dO|) against its f32 plain twin at N = 17,
    100 and 128 with the masks of the forward test (a sequence whose only
    valid key is the bias token among them); at N = 100 also with dO ~ 1e-6
    (ds would underflow fp16 unscaled) and with RoPE'd q ~ 2e5 and k ~ 1e-5
    (beyond fp16's range both ways, logits O(1)), where each of dq, dk and
    dv is also held within 0.01 of its own largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import (rope_attention_bwd,
                                                                 rope_attention_bwd_plain)

    g = torch.Generator(device="cuda").manual_seed(40 + D)
    Hc = 2
    C = Hc * D
    cases = [(N, 1.0, 1.0, 1.0) for N in (17, 100, 128)]
    cases += [(100, 1.0, 1.0, 1e-6), (100, 2e5, 1e-5 * D ** -0.5, 1.0)]
    for N, qs, ks, gs in cases:
        qkv, bk, bv, mask = _rope_case(g, 3, N, 2, Hc, D, q_scale=qs, k_scale=ks)
        do = (torch.randn(3, N, 2, C, generator=g, device="cuda") * gs).to(torch.bfloat16)
        got = rope_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
        ref = rope_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(), mask,
                                       num_heads=Hc)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a.float()).all(), (N, qs, ks, gs)
            _close(a, b)
        if (qs, ks, gs) != (1.0, 1.0, 1.0):
            for j in range(3):
                a, b = got[0][..., j * C:(j + 1) * C].float(), ref[0][..., j * C:(j + 1) * C]
                scale = b.abs().max().item()
                assert 0 < scale and (a - b).abs().max().item() <= 1e-2 * scale, (N, qs, gs, j)


def _fused_case(g, Bc, Hc, N, D, win):
    """q, k, v, dout and the key mask (Bc, N + 1) of the fused_attention
    tests: a 64-key step of masked keys, a whole dq-pass window of them
    where the keys span more than one window, masked keys, and row 1 whose
    only valid key is the last."""
    M = N + 1

    def r(*s, sc=1.0):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(torch.bfloat16)

    q, k, v, do = r(Bc, Hc, N, D, sc=0.5 * D ** -0.5), r(Bc, Hc, M, D), r(Bc, Hc, M, D), \
        r(Bc, Hc, N, D)
    kv = torch.ones(Bc, M, device="cuda")
    kv[0, 64:128] = 0
    if M > win:
        kv[0, win:2 * win] = 0
    kv[0, N // 2:N] = 0
    kv[1, :-1] = 0
    return q, k, v, do, kv


@pytest.mark.cuda
def test_fused_attention_matches_plain_on_card():
    """On the card: the fused_attention forward (output and row statistic)
    and backward kernels against their plain twins in f32 on the same
    inputs, at every supported head dim, N in ``LONG_N`` queries (N + 1
    keys), both softmaxes, with the masks of ``_fused_case``. The
    statistic (a log2) is held to 1e-2 absolute."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.fused_attention import (
        fused_attention_bwd, fused_attention_bwd_plain, fused_attention_fwd,
        fused_attention_fwd_plain)
    from mdgen_finetune_tpu_torch.ops.long_attention import dq_plan

    g = torch.Generator(device="cuda").manual_seed(3)
    Bc, Hc = 2, 2
    for D in (16, 24, 32, 64):
        for N in LONG_N:
            q, k, v, do, kv = _fused_case(g, Bc, Hc, N, D, dq_plan(Bc * Hc, N, N + 1, D).win)
            for base2 in (True, False):
                o, stat = fused_attention_fwd(q, k, v, kv, base2=base2)
                ro, rstat = fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv,
                                                      base2=base2)
                torch.cuda.synchronize()
                _close(o, ro)
                assert (stat - rstat).abs().max().item() <= 1e-2
                got = fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)
                ref = fused_attention_bwd_plain(q.float(), k.float(), v.float(), kv, o.float(),
                                                stat, do.float(), base2=base2)
                torch.cuda.synchronize()
                for a, b in zip(got, ref):
                    _close(a, b)


@pytest.mark.cuda
def test_fused_attention_bwd_is_deterministic_on_card():
    """On the card: two fused_attention_bwd calls on the same inputs give
    the same bits (dq sums over the keys in one warp's registers in key
    order; no atomics), at the T = 1000 path's head dim and at N = 4096,
    where the keys come in windows, in both softmaxes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.fused_attention import fused_attention_bwd, fused_attention_fwd
    from mdgen_finetune_tpu_torch.ops.long_attention import dq_plan

    g = torch.Generator(device="cuda").manual_seed(13)
    for Bc, Hc, N, D in ((4, 16, 1000, 24), (2, 2, 4096, 24), (2, 2, 1001, 64)):
        q, k, v, do, kv = _fused_case(g, Bc, Hc, N, D, dq_plan(Bc * Hc, N, N + 1, D).win)
        for base2 in (True, False):
            o, stat = fused_attention_fwd(q, k, v, kv, base2=base2)
            one = fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)
            two = fused_attention_bwd(q, k, v, kv, o, stat, do, base2=base2)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(one, two)), (N, D, base2)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12)).item()


@pytest.mark.cuda
def test_long_t_stage_backwards_match_plain_on_card():
    """On the card: ``adaln_linear``'s GELU epilogue with its f32
    pre-activation output, and the two stage backwards of the T > 128
    training path, ``adaln_mlp_bwd`` and ``time_attention_block_bwd``
    (B = 1 and 2, T = 300, head dim 24, masked frames and a padded
    residue), against
    their plain compositions in f32, under the composition rule: each
    output's relative L2 error at most twice that of the plain twins run in
    bf16, plus 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, adaln_linear_plain
    from mdgen_finetune_tpu_torch.ops.adaln_mlp import adaln_mlp_bwd, adaln_mlp_bwd_plain
    from mdgen_finetune_tpu_torch.ops.time_attention import (
        time_attention_block_bwd, time_attention_block_bwd_plain)

    g = torch.Generator(device="cuda").manual_seed(4)
    bf = torch.bfloat16
    Bc, Tc, Lc, Cc, Hc = 2, 300, 3, 96, 4
    M = Bc * Tc * Lc

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)

    x, w1, b1 = r(M, Cc), r(Cc, 4 * Cc, sc=Cc ** -0.5), r(4 * Cc, sc=0.1)
    sh, scl = r(Bc, Cc, sc=0.3), r(Bc, Cc, sc=0.3)
    pre, rpre = (torch.empty(M, 4 * Cc, device="cuda") for _ in range(2))
    ge = adaln_linear(x, w1, b1, ln="plain", shift=sh, scale=scl, epilogue="gelu", pre=pre)
    rge = adaln_linear_plain(x.float(), w1.float(), b1.float(), ln="plain", shift=sh.float(),
                             scale=scl.float(), epilogue="gelu", pre=rpre)
    _close(ge, rge)
    _close(pre, rpre)

    def held(name, op, plain, args, kw):
        got = op(*args, **kw)
        truth = plain(*[a.float() if a.dtype == bf else a for a in args], **kw)
        twin = plain(*args, **kw)
        torch.cuda.synchronize()
        for i, (a, b, t) in enumerate(zip(got, twin, truth)):
            assert _rel(a, t) <= 2 * _rel(b, t) + 0.01, (name, i, _rel(a, t), _rel(b, t))

    dout = r(M, Cc, dtype=torch.float32)
    mlp = [x, sh, scl, r(Bc, Cc, sc=0.5), w1, b1, r(4 * Cc, Cc, sc=(4 * Cc) ** -0.5),
           r(Cc, sc=0.1), dout]
    held("adaln_mlp_bwd", adaln_mlp_bwd, adaln_mlp_bwd_plain, mlp, {})
    mask = torch.ones(Bc, Tc, Lc, device="cuda")
    mask[0, 200:] = 0
    mask[1, :, -1] = 0
    att = [x, sh, scl, r(Bc, Cc, sc=0.5), r(Cc, 3 * Cc, sc=Cc ** -0.5), r(3 * Cc, sc=0.1),
           r(Cc, Cc, sc=Cc ** -0.5), r(Cc, sc=0.1), r(Cc), r(Cc), mask, dout]
    held("time_attention_block_bwd", time_attention_block_bwd, time_attention_block_bwd_plain,
         att, dict(B=Bc, T=Tc, L=Lc, num_heads=Hc))
    # B = 1: the layout views of the frame rows need no copy there
    one = [a[:M // Bc] if a.shape[0] == M else a[:1] if a.shape[0] == Bc else a for a in att]
    held("time_attention_block_bwd[B=1]", time_attention_block_bwd,
         time_attention_block_bwd_plain, one, dict(B=1, T=Tc, L=Lc, num_heads=Hc))


@pytest.mark.cuda
def test_blocked_attention_bwd_matches_plain_on_card():
    """On the card: the one-block-per-(sequence, head) attention backward
    against its plain twin in f32 on the same inputs, at head dims 16, 24
    and 32, at N = 129, 250, 256 and each head dim's limit (``max_keys``),
    in the frame view (G = 1, I = 3) and the residue view (G = 3, I = 1),
    with masked keys, a 64-key tile of masked keys only, and one sequence
    whose only valid key is the bias key; two calls give the same bits;
    the kernel's shared-memory size equals the wrapper's formula, and one
    token past the limit raises.
    q is drawn at the trunk's logit scale (0.5 x head_dim^-0.5 x log2 e, the
    fold the q columns carry; the fused_attention test's 0.5 x
    head_dim^-0.5). And the residue view at N = 256 with dO ~ 1e-6, the size
    of a real step's attention gradient, held within 1e-2 of its own scale:
    the kernel's gradients must not underflow."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    import ctypes

    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as BA

    g = torch.Generator(device="cuda").manual_seed(5)
    lib = _cuda.library("blocked_attention_bwd", BA._ARGTYPES)
    smem = lib.blocked_attention_bwd_smem
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    Hc = 2
    for D in (16, 24, 32):
        C = Hc * D
        for N in sorted({n for n in (129, 250, 256, BA.max_keys(D)) if n <= BA.max_keys(D)}):
            assert smem(N, D) == BA.smem_bytes(N, D)
            for view in ((1, N, 3), (3, N, 1)):
                qkv = torch.randn(*view, 3 * C, generator=g, device="cuda").to(torch.bfloat16)
                qkv[..., :C] *= 0.5 * D ** -0.5 * 1.4426950408889634
                do = torch.randn(*view, C, generator=g, device="cuda").to(torch.bfloat16)
                bk = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
                bv = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
                seq = torch.ones(3, N, device="cuda")  # sequence s = g * I + i
                seq[0, 64:128] = 0  # a whole key tile
                seq[2, N // 2:] = 0  # masked keys
                seq[1] = 0  # only the bias key is valid
                mask = seq.view(view[0], view[2], N).permute(0, 2, 1).contiguous()
                got = BA.blocked_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
                again = BA.blocked_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
                ref = BA.blocked_attention_bwd_plain(qkv.float(), do.float(), bk.float(),
                                                     bv.float(), mask, num_heads=Hc)
                torch.cuda.synchronize()
                for a, b, c in zip(got, ref, again):
                    _close(a, b)
                    assert torch.equal(a, c)  # two calls, the same bits
        if D == 24:
            view = (3, 256, 1)
            qkv = torch.randn(*view, 3 * C, generator=g, device="cuda").to(torch.bfloat16)
            qkv[..., :C] *= 0.5 * D ** -0.5 * 1.4426950408889634
            do = (torch.randn(*view, C, generator=g, device="cuda") * 1e-6).to(torch.bfloat16)
            mask = torch.ones(*view, device="cuda")
            got = BA.blocked_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
            ref = BA.blocked_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(),
                                                 mask, num_heads=Hc)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                scale = b.float().abs().max().item()
                assert 0 < scale and (a.float() - b.float()).abs().max().item() <= 1e-2 * scale
        n = BA.max_keys(D) + 1
        with pytest.raises(ValueError, match="shared memory"):
            BA.blocked_attention_bwd(torch.zeros(1, n, 1, 3 * C, device="cuda", dtype=torch.bfloat16),
                                     torch.zeros(1, n, 1, C, device="cuda", dtype=torch.bfloat16),
                                     bk, bv, torch.ones(1, n, 1, device="cuda"), num_heads=Hc)


@pytest.mark.cuda
def test_blocked_attention_bwd_beyond_the_fp16_range_on_card():
    """On the card: the attention backward with RoPE'd q of ~2e5 (beyond
    fp16's 65,504) and k of ~1e-5 (below fp16's normal range), so that the
    logits stay O(1): the kernel scales q per query tile and k per head by
    powers of two into fp16's range, and must be finite and within
    0.01 x max(1, max |twin|) of its f32 twin (PERF.md's kernel rule), in
    the residue view at N = 256 and the frame view at N = 250. dq (~1e-5)
    and dk (~1e5) differ by ten orders of magnitude, so each of dq, dk and
    dv is also held within 0.01 of its own largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as BA

    g = torch.Generator(device="cuda").manual_seed(10)
    Hc, D = 2, 24
    C = Hc * D
    for view in ((3, 256, 1), (1, 250, 3)):
        qkv = torch.randn(*view, 3 * C, generator=g, device="cuda")
        qkv[..., :C] *= 2e5
        qkv[..., C:2 * C] *= 1e-5 * D ** -0.5
        qkv = qkv.to(torch.bfloat16)
        do = torch.randn(*view, C, generator=g, device="cuda").to(torch.bfloat16)
        bk = (torch.randn(C, generator=g, device="cuda") * 1e-5).to(torch.bfloat16)
        bv = torch.randn(C, generator=g, device="cuda").to(torch.bfloat16)
        mask = torch.ones(*view, device="cuda")
        mask[0, view[1] // 2:] = 0
        got = BA.blocked_attention_bwd(qkv, do, bk, bv, mask, num_heads=Hc)
        ref = BA.blocked_attention_bwd_plain(qkv.float(), do.float(), bk.float(), bv.float(),
                                             mask, num_heads=Hc)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.isfinite(a.float()).all()
            _close(a, b)
        for j in range(3):
            a, b = got[0][..., j * C:(j + 1) * C].float(), ref[0][..., j * C:(j + 1) * C]
            scale = b.abs().max().item()
            assert 0 < scale and (a - b).abs().max().item() <= 1e-2 * scale, (j, scale)


@pytest.mark.cuda
def test_ipa_attention_tiled_matches_plain_on_card():
    """On the card: the IPA core above ``RESIDENT_MAX_L`` (the tensor-core
    kernel) against its plain twin at L = 65, 200 and 256 (ATLAS), with
    padded residues and one element whose frames are all masked but one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.ipa_attention import (
        RESIDENT_MAX_L, ipa_attention, ipa_attention_plain, proj_width)

    g = torch.Generator(device="cuda").manual_seed(6)
    Bc = 3
    for Lc in (65, 200, 256):
        assert Lc > RESIDENT_MAX_L
        proj = torch.randn(Bc, Lc, proj_width(4, 32, 8, 8), generator=g, device="cuda")
        t7 = torch.randn(Bc, Lc, 7, generator=g, device="cuda")
        t7[..., 4:] *= 5
        fr = TRigid.from_tensor_7(t7)
        mask = torch.ones(Bc, Lc, device="cuda")
        mask[0, Lc // 2:] = 0
        mask[2, 1:] = 0
        hw = torch.randn(4, generator=g, device="cuda")
        a = ipa_attention(proj, fr.rot.contiguous(), fr.trans.contiguous(), mask, hw,
                          H=4, Ch=32, Pq=8, Pv=8)
        p = ipa_attention_plain(proj, fr.rot, fr.trans, mask, hw, H=4, Ch=32, Pq=8, Pv=8)
        torch.cuda.synchronize()
        _close(a, p)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(32, 8, 8), (16, 4, 6)])
def test_ipa_attention_tensor_core_form_on_card(widths):
    """On the card: the tensor-core form of the IPA core (L > RESIDENT_MAX_L
    at both of its widths) against its plain twin in f32 at L = 65, 100, 256
    and 300 over B = 1 and 100 elements, with translations across +-40 A (a
    256-residue crop's extent) and a masked tail of 56 residues in every
    element (queries with m_q = 0 attend over every key), within
    1e-2 x max(1, max |twin|); the same bits again, and from a proj that
    starts 4 bytes past a 16-byte boundary (the 4-byte copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import ipa_attention as IA

    Ch, Pq, Pv = widths
    kw = dict(H=4, Ch=Ch, Pq=Pq, Pv=Pv)
    W = IA.proj_width(4, Ch, Pq, Pv)
    g = torch.Generator(device="cuda").manual_seed(17)
    for Bc in (1, 100):
        for Lc in (65, 100, 256, 300):
            assert IA._form(Bc, Lc, 4, Ch, Pq, Pv) == 3
            proj = torch.randn(Bc, Lc, W, generator=g, device="cuda")
            fr = TRigid.from_tensor_7(torch.randn(Bc, Lc, 7, generator=g, device="cuda"))
            rot = fr.rot.contiguous()
            trans = (torch.rand(Bc, Lc, 3, generator=g, device="cuda") * 2 - 1) * 40
            mask = torch.ones(Bc, Lc, device="cuda")
            mask[:, Lc - 56:] = 0
            hw = torch.randn(4, generator=g, device="cuda")
            n0 = IA.ipa_attention.forms[3]
            got = IA.ipa_attention(proj, rot, trans, mask, hw, **kw)
            assert IA.ipa_attention.forms[3] == n0 + 1
            ref = IA.ipa_attention_plain(proj, rot, trans, mask, hw, **kw)
            torch.cuda.synchronize()
            _close(got, ref)
            assert torch.equal(IA.ipa_attention(proj, rot, trans, mask, hw, **kw), got), Lc
            shifted = torch.empty(Bc * Lc * W + 1, device="cuda")[1:].view(Bc, Lc, W)
            shifted.copy_(proj)
            assert shifted.data_ptr() % 16 == 4
            assert torch.equal(IA.ipa_attention(shifted, rot, trans, mask, hw, **kw), got), Lc


# ---------------------------------------------------------------------------
# adaln_linear's wgmma core and fused_attention's two forms (slice 11)
# ---------------------------------------------------------------------------

def _adaln_uses(g, M, nb):
    """Every product of the trunk and the encoder at the flagship's widths
    (C = 384): (name, x, w, b, kwargs, route) with the route its plan must
    take (0 resident, 1 pipelined, 2 tiled64)."""
    from mdgen_finetune_tpu_torch.ops.ipa_attention import feat_width, proj_width

    C, F = 384, 1536
    bf, f32 = torch.bfloat16, torch.float32

    def r(*s, sc=1.0, dtype=bf):
        return (torch.randn(*s, generator=g, device="cuda") * sc).to(dtype)

    mod = r(nb, 9 * C, sc=0.3)

    def m(j):
        return mod[:, j * C:(j + 1) * C]

    x, res = r(M, C), r(M, C)
    pw, fw = proj_width(4, 32, 8, 8), feat_width(4, 32, 8)
    return [
        ("qkv", x, r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), dict(ln="plain", shift=m(0), scale=m(1)), 0),
        ("out_gate", x, r(C, C, sc=C ** -0.5), r(C, sc=0.1), dict(epilogue="gate_res", res=res, gate=m(2)), 0),
        ("fc1_gelu", x, r(C, F, sc=C ** -0.5), r(F, sc=0.1),
         dict(ln="plain", shift=m(6), scale=m(7), epilogue="gelu"), 0),
        ("fc1_pre", x, r(C, F, sc=C ** -0.5), r(F, sc=0.1),
         dict(ln="plain", shift=m(6), scale=m(7), epilogue="gelu", pre=torch.empty(M, F, device="cuda")), 0),
        ("fc2_gate", r(M, F), r(F, C, sc=F ** -0.5), r(C, sc=0.1), dict(epilogue="gate_res", res=res, gate=m(8)), 1),
        ("fc2_f32", r(M, F), r(F, C, sc=F ** -0.5), r(C, sc=0.1), dict(out_dtype=f32), 1),
        ("ipa_proj", x, r(C, pw, sc=C ** -0.5), r(pw, sc=0.1),
         dict(ln="affine", ln_weight=1 + r(C, sc=0.1, dtype=f32), ln_bias=r(C, sc=0.1, dtype=f32),
              out_dtype=f32), 0),
        ("ipa_out", r(M, fw), r(fw, C, sc=0.06), r(C, sc=0.1), dict(epilogue="gate_res", res=res), 0),
        ("head_euler", x, r(C, 21, sc=C ** -0.5), r(21, sc=0.1),
         dict(ln="plain", shift=m(0), scale=m(1), epilogue="euler", res=r(M, 21, dtype=f32), dt=0.01), 2),
        ("embed_add", r(M, 21, dtype=f32), r(21, C, sc=0.2), None,
         dict(epilogue="add", add1=r(M, C), add2=r(nb, C), add2_map=(M // nb, 1, 1)), 2),
    ]


def _adaln_ref(a, w, b, kw):
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear_plain

    kwf = _f32(kw)
    if kw.get("pre") is not None:
        kwf["pre"] = torch.empty_like(kw["pre"])
    return adaln_linear_plain(a.float(), w.float(), None if b is None else b.float(), **kwf), kwf


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 63, 65, 12801])
def test_adaln_linear_every_use_on_card(M):
    """On the card: every product of the trunk and the encoder (each N and K
    of the main path, every prologue and epilogue, the f32 outputs and the
    GELU's f32 pre-activation) against the plain version in f32 on the same
    inputs, each on the route its plan takes, at row counts around a tile
    (1, 63, 65) and over many blocks (12,801: the LayerNorm prologue's
    shared-memory writes must be fenced for the tensor cores in every
    block). Tolerance: 1e-2 x max(1, max |twin|) (bf16 outputs keep 8
    bits); the pre-activation likewise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, plan

    g = torch.Generator(device="cuda").manual_seed(M)
    nb = next(n for n in (7, 5, 3, 1) if M % n == 0)  # AdaLN rows dividing the rows
    for name, a, w, b, kw, route in _adaln_uses(g, M, nb):
        assert plan(a, w, b, **kw).route == route, name
        n0 = adaln_linear.routes[route]
        got = adaln_linear(a, w, b, **kw)
        ref, kwf = _adaln_ref(a, w, b, kw)
        torch.cuda.synchronize()
        assert adaln_linear.routes[route] == n0 + 1, name
        _close(got, ref)
        if kw.get("pre") is not None:
            _close(kw["pre"], kwf["pre"])


@pytest.mark.cuda
def test_adaln_linear_views_aliasing_and_determinism_on_card():
    """On the card: row views with lda != K (the k columns of a qkv, with
    and without the LayerNorm prologue), out aliasing res (the trunk's
    in-place gated residual, on both wgmma routes), and two calls on the
    same inputs giving the same bits (every sum in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.adaln_linear import adaln_linear, plan

    g = torch.Generator(device="cuda").manual_seed(21)
    M, C = 5000, 384
    qkv = torch.randn(M, 3 * C, generator=g, device="cuda").bfloat16()
    w = (torch.randn(C, C, generator=g, device="cuda") * C ** -0.5).bfloat16()
    sh, sc = (0.3 * torch.randn(2, 2, C, generator=g, device="cuda")).bfloat16()
    xv = qkv[:, C:2 * C]
    for kw in ({}, dict(ln="plain", shift=sh, scale=sc)):
        assert plan(xv, w, None, **kw).route == 0
        ref, _ = _adaln_ref(xv, w, None, kw)
        _close(adaln_linear(xv, w, None, **kw), ref)
    for K, route in ((C, 0), (4 * C, 1)):
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        wk = (torch.randn(K, C, generator=g, device="cuda") * K ** -0.5).bfloat16()
        res = torch.randn(M, C, generator=g, device="cuda").bfloat16()
        gate = (0.3 * torch.randn(2, C, generator=g, device="cuda")).bfloat16()
        kw = dict(epilogue="gate_res", res=res, gate=gate)
        ref, _ = _adaln_ref(x, wk, None, kw)
        assert plan(x, wk, None, out=res, **kw).route == route
        out = adaln_linear(x, wk, None, out=res, **kw)
        torch.cuda.synchronize()
        assert out.data_ptr() == res.data_ptr()
        _close(res, ref)
    x = torch.randn(M, C, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(C, 4 * C, generator=g, device="cuda") * C ** -0.5).bfloat16()
    kw = dict(ln="plain", shift=sh, scale=sc, epilogue="gelu")
    one, two = adaln_linear(x, w1, None, **kw), adaln_linear(x, w1, None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 24, 32, 64])
def test_fused_attention_forms_on_card(D):
    """On the card: fused_attention's forward, output and statistic, against
    its plain version in f32 at N = 1 .. 17 queries (the short form to 16,
    the long one at 17) and N = 64 .. 2,048 (the long form; windows at
    D = 64 from N = 1,000), N + 1 keys, both softmaxes, with masked keys.
    Tolerance: the output 1e-2 x max(1, max |twin|) (bf16), the statistic
    (a log2 of f32 sums in another order) 1e-3 x max(1, max |twin|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.fused_attention import fused_attention_fwd, fused_attention_fwd_plain
    from mdgen_finetune_tpu_torch.ops.long_attention import fused_plan

    g = torch.Generator(device="cuda").manual_seed(D)
    Bc, Hc = 3, 2
    for N in list(range(1, 18)) + [64, 100, 257, 1000, 2048]:
        M = N + 1
        q = (torch.randn(Bc, Hc, N, D, generator=g, device="cuda") * D ** -0.5).bfloat16()
        k, v = (torch.randn(Bc, Hc, M, D, generator=g, device="cuda").bfloat16() for _ in range(2))
        kv = (torch.rand(Bc, M, generator=g, device="cuda") > 0.25).float()
        kv[:, -1] = 1
        assert fused_plan(Bc * Hc, N, M, D).form == (1 if N <= 16 else 0)
        for base2 in (True, False):
            o, stat = fused_attention_fwd(q, k, v, kv, base2=base2)
            ro, rstat = fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv, base2=base2)
            torch.cuda.synchronize()
            _close(o, ro)
            _close(stat, rstat, rel=1e-3)


@pytest.mark.cuda
def test_fused_attention_edge_rows_on_card():
    """On the card, both forms: natural logits ~1e3 (exp without the max
    would overflow f32), and a batch element whose every key is masked:
    uniform over its keys in the natural softmax (the plain version's), all
    zero in base 2, as the TPU kernel gives it (p = exp2(min(-1e9, 100)) = 0
    over a sum of 1e-30), with the statistic log2(1e-30) there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    import math

    from mdgen_finetune_tpu_torch.ops.fused_attention import fused_attention_fwd, fused_attention_fwd_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    Bc, Hc, D = 3, 2, 24
    for N in (4, 300):
        M = N + 1
        k, v = (torch.randn(Bc, Hc, M, D, generator=g, device="cuda").bfloat16() for _ in range(2))
        kv = torch.ones(Bc, M, device="cuda")
        kv[0, : M // 2] = 0
        kv[1] = 0
        for qs, base2 in ((300.0, False), (1.0, False), (1.0, True)):
            q = (torch.randn(Bc, Hc, N, D, generator=g, device="cuda") * qs * D ** -0.5).bfloat16()
            o, stat = fused_attention_fwd(q, k, v, kv, base2=base2)
            ro, rstat = fused_attention_fwd_plain(q.float(), k.float(), v.float(), kv, base2=base2)
            torch.cuda.synchronize()
            assert torch.isfinite(o).all() and torch.isfinite(stat).all()
            if base2:
                assert o[1].abs().max().item() == 0.0
                assert (stat[1] - math.log2(1e-30)).abs().max().item() <= 1e-3 * 100
                _close(o[::2], ro[::2])
            else:
                _close(o, ro)
            _close(stat, rstat, rel=1e-3)


# ---------------------------------------------------------------------------
# the merged layer backward (MDGEN_FUSED_BWD=merged), the probe, IPA widths
# ---------------------------------------------------------------------------



def _layer_case(Bc, Tc, Lc, Cc, seed):
    """Seeded f32 inputs of one trunk layer on the card (a padded residue and
    a frame whose residue attention sees only the bias key)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=g, device="cuda") * sc

    shapes = dict(wqkv_l=(Cc, 3 * Cc), bqkv_l=(3 * Cc,), wout_l=(Cc, Cc), bout_l=(Cc,),
                  wqkv_t=(Cc, 3 * Cc), bqkv_t=(3 * Cc,), wout_t=(Cc, Cc), bout_t=(Cc,),
                  w1=(Cc, 4 * Cc), b1=(4 * Cc,), w2=(4 * Cc, Cc), b2=(Cc,), bkl=(Cc,),
                  bvl=(Cc,), bkt=(Cc,), bvt=(Cc,))
    w = {k: r(*s, sc=(s[0] ** -0.5 if k[0] == "w" else 0.4)) for k, s in shapes.items()}
    M = Bc * Tc * Lc
    mask = torch.ones(Bc, Tc, Lc, device="cuda")
    mask[0, :, -1] = 0  # a padded residue
    mask[-1, 2, :] = 0  # a frame whose only valid residue key is the bias token
    return r(M, Cc), r(Bc, 9 * Cc, sc=0.3), w, mask, r(M, Cc)


def _layer_plain(x, mod, w, mask, Bc, Tc, Lc, Hc):
    """The forward's X1, X2 through the plain twins (any dtype)."""
    from mdgen_finetune_tpu_torch.ops.residue_block import residue_block_plain
    from mdgen_finetune_tpu_torch.ops.time_attention import time_attention_block_plain

    Cc = x.shape[1]

    def m(j):
        return mod[:, j * Cc:(j + 1) * Cc]

    dims = dict(B=Bc, T=Tc, L=Lc, num_heads=Hc)
    x1 = residue_block_plain(x, m(0), m(1), m(2), w["wqkv_l"], w["bqkv_l"], w["wout_l"],
                             w["bout_l"], w["bkl"], w["bvl"], mask, **dims)
    x2 = time_attention_block_plain(x1, m(3), m(4), m(5), w["wqkv_t"], w["bqkv_t"], w["wout_t"],
                                    w["bout_t"], w["bkt"], w["bvt"], mask, **dims)
    return x1, x2


def _flat(out):
    dx, dmod, dw = out
    return [("dx", dx), ("dmod", dmod)] + [(k, dw[k]) for k in sorted(dw)]


def _rel(a, b):
    return ((a.float() - b.float()).norm() / max(b.float().norm().item(), 1e-12)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("Bc,Tc", [(2, 100), (32, 100), (4, 200)])
def test_merged_layer_bwd_matches_split_and_plain_on_card(Bc, Tc):
    """On the card: the merged layer backward (one cooperative launch)
    against the split route on the same bf16 inputs, bit for bit, and
    against the f32 plain version under the composition rule (relative L2
    at most 2 x that of the plain version in bf16, + 0.01) at the
    flagship's width (L = 4, C = 384, 16 heads), with a padded residue and
    a frame whose only valid residue key is the bias token; T = 200 takes
    the blocked frame core."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd_merged as FM
    from mdgen_finetune_tpu_torch.ops.fused_layer import trunk_layer
    from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import layer_bwd_split
    from mdgen_finetune_tpu_torch.ops.linear_bwd import linear_bwd

    Lc, Cc, Hc = 4, 384, 16
    x, mod, w, mask, dout = _layer_case(Bc, Tc, Lc, Cc, seed=Tc + Bc)
    bf = torch.bfloat16
    xb, modb, wb = x.to(bf), mod.to(bf), {k: v.to(bf) for k, v in w.items()}
    x1, x2, _ = trunk_layer(xb, modb, wb, mask, B=Bc, T=Tc, L=Lc, num_heads=Hc)
    split = _flat(layer_bwd_split(xb, x1, x2, dout, modb, wb, mask, Hc))
    n0, s0 = FM.fused_layer_bwd_merged.launches, linear_bwd.launches
    merged = _flat(FM.fused_layer_bwd_merged(xb, x1, x2, dout, modb, wb, mask, Hc))
    torch.cuda.synchronize()
    assert FM.fused_layer_bwd_merged.launches == n0 + 1 and linear_bwd.launches == s0
    differ = [k for (k, a), (_, b) in zip(merged, split) if not torch.equal(a, b)]
    assert not differ, differ
    plain_bf = _flat(FM.fused_layer_bwd_merged_plain(xb, x1, x2, dout, modb, wb, mask, Hc))
    p1, p2 = _layer_plain(x, mod, w, mask, Bc, Tc, Lc, Hc)
    truth = _flat(FM.fused_layer_bwd_merged_plain(x, p1, p2, dout, mod, w, mask, Hc))
    for (k, a), (_, p), (_, t) in zip(merged, plain_bf, truth):
        assert torch.isfinite(a).all(), k
        assert _rel(a, t) <= 2 * _rel(p, t) + 0.01, (k, _rel(a, t), _rel(p, t))


@pytest.mark.cuda
def test_merged_layer_bwd_at_the_route_limits_on_card():
    """On the card: the merged layer backward at the short route's limits
    (L = 8, T = 256, B = 1: the blocked frame core at its longest, the
    residue stage on the short body at N = 8) against the split route on
    the same bf16 inputs, bit for bit, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd_merged as FM
    from mdgen_finetune_tpu_torch.ops.fused_layer import trunk_layer
    from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import layer_bwd_split

    Bc, Tc, Lc, Cc, Hc = 1, 256, 8, 384, 16
    x, mod, w, mask, dout = _layer_case(Bc, Tc, Lc, Cc, seed=7)
    bf = torch.bfloat16
    xb, modb, wb = x.to(bf), mod.to(bf), {k: v.to(bf) for k, v in w.items()}
    x1, x2, _ = trunk_layer(xb, modb, wb, mask, B=Bc, T=Tc, L=Lc, num_heads=Hc)
    split = _flat(layer_bwd_split(xb, x1, x2, dout, modb, wb, mask, Hc))
    n0 = FM.fused_layer_bwd_merged.launches
    merged = _flat(FM.fused_layer_bwd_merged(xb, x1, x2, dout, modb, wb, mask, Hc))
    torch.cuda.synchronize()
    assert FM.fused_layer_bwd_merged.launches == n0 + 1
    differ = [k for (k, a), (_, b) in zip(merged, split) if not torch.equal(a, b)]
    assert not differ, differ
    assert all(torch.isfinite(a).all() for _, a in merged)


@pytest.mark.cuda
def test_moved_split_kernels_match_the_parent_sources_on_card(tmp_path):
    """On the card: the split kernels whose bodies live in the shared
    headers (modln_bwd) give the outputs of another checkout's sources of
    the same kernels bit for bit, at the merged path's shapes (T = 100 and
    200): a change to a shared header must not move the split route's
    numbers. modln_bwd (redesigned as a staged kernel, each output's
    arithmetic pinned to the first version's rounding) is also held alone
    at the three training shapes (flagship, T = 1000, ATLAS) and at C =
    200 and 448 (where the other sources may run a body of their own for
    rows wider than 384), bf16 and f32 x. adaln_linear is not
    swapped: its products moved to wgmma (a new order of the sums), and it
    is held to its plain version by the
    kernel tests and, through the layer, the split route to the merged
    route bit for bit. rope_attention
    and rope_attention_bwd are held to the other sources only at N = 4
    (stage 1, the encoder and the modular residue attention), where their
    short bodies run: their long-sequence bodies were redesigned for the
    tensor cores, which moves those bits (the short bodies were redesigned
    too, as streaming kernels, with each output's arithmetic unchanged, so
    they keep their bits); so is ipa_attention, at L = 4 (its streaming
    form, redesigned the same way; at L = 256 its tensor-core form moved
    the bits by design and is held to its plain version by the kernel
    tests). linear_bwd and
    blocked_attention_bwd are not swapped: they were redesigned too (new
    tilings and reduction orders), and are held to their plain versions by
    the kernel tests and, through the layer, the split route to the merged
    route bit for bit. The other sources come from MDGEN_PARENT_CSRC (a
    csrc directory, for example ``git archive`` of an earlier commit);
    without it the test skips."""
    import ctypes
    import os
    import subprocess

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    parent = os.environ.get("MDGEN_PARENT_CSRC")
    if not parent:
        pytest.skip("needs MDGEN_PARENT_CSRC, the csrc directory of the sources before the move")
    from mdgen_finetune_tpu_torch.ops import _cuda
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd as FB
    from mdgen_finetune_tpu_torch.ops.fused_layer import trunk_layer

    names = ("modln_bwd",)
    short = ("rope_attention", "rope_attention_bwd", "ipa_attention")
    procs = [(n, subprocess.Popen([_cuda.nvcc(), *_cuda.FLAGS, "-o", str(tmp_path / f"{n}.so"),
                                   os.path.join(parent, f"{n}.cu")], stdout=subprocess.DEVNULL,
                                  stderr=subprocess.STDOUT)) for n in names + short]
    assert all(p.wait() == 0 for _, p in procs), "the parent's sources did not build"

    def swapped(ns, run):
        """run() with the other sources' libraries of kernels ``ns``."""
        kept = {}
        for n in ns:
            lib = _cuda._LIBS.get(n)
            if lib is None:  # not on this shape's path
                continue
            old = ctypes.CDLL(str(tmp_path / f"{n}.so"))
            getattr(old, n).argtypes = getattr(lib, n).argtypes
            getattr(old, n).restype = getattr(lib, n).restype
            kept[n] = lib
            _cuda._LIBS[n] = old
        try:
            return run()
        finally:
            _cuda._LIBS.update(kept)

    Bc, Lc, Cc, Hc = 2, 4, 384, 16
    outs = {}
    for Tc in (100, 200):
        x, mod, w, mask, dout = _layer_case(Bc, Tc, Lc, Cc, seed=5)
        bf = torch.bfloat16
        xb, modb, wb = x.to(bf), mod.to(bf), {k: v.to(bf) for k, v in w.items()}

        def run():
            x1, x2, y = trunk_layer(xb, modb, wb, mask, B=Bc, T=Tc, L=Lc, num_heads=Hc)
            return [x1, x2, y] + [t for _, t in _flat(FB.layer_bwd_split(xb, x1, x2, dout, modb,
                                                                          wb, mask, Hc))]

        outs[Tc] = run()
        before = swapped(names, run)
        torch.cuda.synchronize()
        differ = [i for i, (a, b) in enumerate(zip(outs[Tc], before)) if not torch.equal(a, b)]
        assert not differ, (Tc, differ)

    from mdgen_finetune_tpu_torch.ops.modln_bwd import modln_bwd

    cases = [(shape, M, nb, 384) for shape, (M, nb) in sorted(MODLN_SHAPES.items())]
    cases += [(f"C = {C}", M, nb, C) for C, (M, nb) in sorted(MODLN_WIDTHS.items())]
    for shape, M, nb, C in cases:
        for dt in (torch.bfloat16, torch.float32):
            args = _modln_inputs(M, nb, C=C, x_dtype=dt)
            now = modln_bwd(*args)
            before = swapped(names, lambda: modln_bwd(*args))
            torch.cuda.synchronize()
            differ = [i for i, (a, b) in enumerate(zip(now, before)) if not torch.equal(a, b)]
            assert not differ, (shape, dt, differ)
            del args, now, before

    from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention
    from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import rope_attention_bwd

    g = torch.Generator(device="cuda").manual_seed(11)
    G4, C4, H4 = 200, 384, 16  # stage 1 of the T = 100 layer at B = 2: (B * T, L, 1, 3C)
    qkv, dout = (torch.randn(G4, 4, 1, w * C4, generator=g, device="cuda").bfloat16()
                 for w in (3, 1))
    bk, bv = (0.4 * torch.randn(C4, generator=g, device="cuda")).bfloat16(), \
        (0.4 * torch.randn(C4, generator=g, device="cuda")).bfloat16()
    valid = torch.ones(G4, 4, 1, device="cuda")
    valid[0, -1] = 0  # a padded residue
    valid[1] = 0  # a frame whose only valid key is the bias token

    from mdgen_finetune_tpu_torch.ops.ipa_attention import ipa_attention, proj_width

    ipa_in = []
    for Bi, Li in ((400, 4),):  # the streaming form
        t7 = torch.randn(Bi, Li, 7, generator=g, device="cuda")
        fr = TRigid.from_tensor_7(t7)
        m = torch.ones(Bi, Li, device="cuda")
        m[0, -1] = 0
        ipa_in.append((torch.randn(Bi, Li, proj_width(4, 32, 8, 8), generator=g, device="cuda"),
                       fr.rot.contiguous(), fr.trans.contiguous(), m,
                       torch.randn(4, generator=g, device="cuda")))

    def run_short():
        return [rope_attention(qkv, bk, bv, valid, num_heads=H4, base2=b) for b in (True, False)] \
            + list(rope_attention_bwd(qkv, dout, bk, bv, valid, num_heads=H4)) \
            + [ipa_attention(*a, H=4, Ch=32, Pq=8, Pv=8) for a in ipa_in]

    now = run_short()
    before = swapped(short, run_short)
    torch.cuda.synchronize()
    differ = [i for i, (a, b) in enumerate(zip(now, before)) if not torch.equal(a, b)]
    assert not differ, ("N = 4", differ)


@pytest.mark.cuda
def test_micro_ops_probe_matches_plain_on_card():
    """On the card: every op of the micro-op probe (csrc/micro_ops.cu)
    against its plain version, the K = 2 plain and position-weighted sums
    of 4 programs, each within ``REL`` of its terms' magnitudes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.tools import micro_ops as P

    x, y = P.inputs("cuda", seed=1, programs=4)
    for name in P.NAMES:
        P.check(x, y, name)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(16, 4, 6), (8, 6, 2)])
def test_ipa_attention_tiled_other_widths_on_card(widths):
    """On the card: the key-tiled IPA core at (Ch, Pq, Pv) other than the
    model's, at L = 72 and 200, against its plain twin, with padded residues
    and one element whose frames are all masked but one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    from mdgen_finetune_tpu_torch.ops.ipa_attention import (
        RESIDENT_MAX_L, ipa_attention, ipa_attention_plain, proj_width)

    Ch, Pq, Pv = widths
    g = torch.Generator(device="cuda").manual_seed(7)
    Bc, Hi = 3, 4
    for Lc in (72, 200):
        assert Lc > RESIDENT_MAX_L
        proj = torch.randn(Bc, Lc, proj_width(Hi, Ch, Pq, Pv), generator=g, device="cuda")
        t7 = torch.randn(Bc, Lc, 7, generator=g, device="cuda")
        t7[..., 4:] *= 5
        fr = TRigid.from_tensor_7(t7)
        mask = torch.ones(Bc, Lc, device="cuda")
        mask[0, Lc // 2:] = 0
        mask[2, 1:] = 0
        hw = torch.randn(Hi, generator=g, device="cuda")
        a = ipa_attention(proj, fr.rot.contiguous(), fr.trans.contiguous(), mask, hw,
                          H=Hi, Ch=Ch, Pq=Pq, Pv=Pv)
        p = ipa_attention_plain(proj, fr.rot, fr.trans, mask, hw, H=Hi, Ch=Ch, Pq=Pq, Pv=Pv)
        torch.cuda.synchronize()
        _close(a, p)
