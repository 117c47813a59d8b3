"""PyTorch port, the host-side plan of ``adaln_linear`` (``ops/adaln_linear.py::plan``)
at the shapes of every path, on the CPU.

``plan`` decides, from the operands' shapes, dtypes, base addresses and row
strides, which route a call takes (the wgmma + TMA core: resident or
pipelined; or the scalar ``tiled64``), the grid, the TMA ring's depth and the
shared memory that the launcher is given. These tests build each call's
operands as the ops build them (AdaLN rows as column blocks of the
modulation matrix, the encoder's per-layer blocks, the attention output
viewed as rows, the in-place residual) at the full width (C = 384, 16
heads, the IPA encoder's widths) and the row counts of the flagship
(B = 64, T = 100, L = 4: M = 25,600), its training (B = 32: 12,800), the
4AA preset at T = 1000 (B = 8: 32,000) and ATLAS (L = 256, T = 250:
64,000), and check that

- no full-width projection (qkv, out, fc1, fc2, the IPA projection and its
  out-projection, the modular layer's) falls to ``tiled64``: only the
  output head (N = 21) and the embed (an f32 input) do;
- every block fits the SM's shared memory (227 KB), and the merged layer
  backward's six products (its plans: one warpgroup, a ring of 3) keep its
  two blocks per SM;
- the grid covers every row and column chunk, with the rows' chunks split
  only as far as about four waves of blocks need.
"""
import pytest
import torch

from mdgen_finetune_tpu_torch.ops import adaln_linear as AL
from mdgen_finetune_tpu_torch.ops.ipa_attention import feat_width, proj_width

C, H, NL = 384, 16, 5
F = 4 * C
BF, F32 = torch.bfloat16, torch.float32
SHAPES = {  # (B, T, L): the row count is B * T * L
    "flagship": (64, 100, 4),
    "train_t100": (32, 100, 4),
    "train_t1000": (8, 1000, 4),
    "atlas": (1, 250, 256),
}


def _e(*shape, dtype=BF):
    return torch.empty(*shape, dtype=dtype)


def trunk_uses(B, T, L, training=False):
    """The trunk layer's products (ops/residue_block, ops/time_attention,
    ops/adaln_mlp, ops/fused_layer), with the training backward's
    recomputes, as (name, x, w, b, kwargs, full-width?)."""
    M = B * T * L
    mod = _e(B, 9 * C)

    def m(j):
        return mod[:, j * C:(j + 1) * C]

    x, att, hid = _e(M, C), _e(M, C), _e(M, F)
    wq, wo, w1, w2 = _e(C, 3 * C), _e(C, C), _e(C, F), _e(F, C)
    bq, bo, b1, b2 = _e(3 * C), _e(C), _e(F), _e(C)
    uses = [
        ("qkv", x, wq, bq, dict(ln="plain", shift=m(0), scale=m(1)), True),
        ("out_gate", att, wo, bo, dict(epilogue="gate_res", res=x, gate=m(2), out=x), True),
        ("fc1_gelu", x, w1, b1, dict(ln="plain", shift=m(6), scale=m(7), epilogue="gelu"), True),
        ("fc2_gate", hid, w2, b2, dict(epilogue="gate_res", res=x, gate=m(8), out=x), True),
        ("head_euler", x, _e(C, 21), _e(21),
         dict(ln="plain", shift=mod[:, :C], scale=mod[:, C:2 * C], epilogue="euler",
              res=_e(M, 21, dtype=F32), dt=0.01), False),
        ("embed_add", _e(M, 21, dtype=F32), _e(21, C), None,
         dict(epilogue="add", add1=_e(M, C), add2=_e(B * L, C), add2_map=(T * L, L, L)), False),
    ]
    if training:
        uses += [
            ("fc1_pre", x, w1, b1, dict(ln="plain", shift=m(6), scale=m(7), epilogue="gelu",
                                        pre=_e(M, F, dtype=F32)), True),
            ("fc2_f32", hid, w2, b2, dict(out_dtype=F32), True),
            ("out_f32", att, wo, bo, dict(out_dtype=F32), True),
        ]
    return uses


def encoder_uses(Bn, L):
    """The IPA encoder's products per layer (ops/ipa_encoder._stack)."""
    M = Bn * L
    mods = _e(Bn, 6 * C * NL)
    mod = mods[:, 6 * C:12 * C]  # the second layer's block

    def m(j):
        return mod[:, j * C:(j + 1) * C]

    h, pw, fw = _e(M, C), proj_width(4, 32, 8, 8), feat_width(4, 32, 8)
    return [
        ("ipa_proj", h, _e(C, pw), _e(pw), dict(ln="affine", ln_weight=_e(C, dtype=F32),
                                                 ln_bias=_e(C, dtype=F32), out_dtype=F32), True),
        ("ipa_out", _e(Bn, L, fw).view(M, fw), _e(fw, C), _e(C), dict(epilogue="gate_res", res=h),
         True),
        ("qkv_m", h, _e(C, 3 * C), _e(3 * C), dict(ln="plain", shift=m(0), scale=m(1)), True),
        ("out_m", _e(M, C), _e(C, C), _e(C), dict(epilogue="gate_res", res=h, gate=m(2)), True),
        ("fc1_m", h, _e(C, F), _e(F), dict(ln="plain", shift=m(3), scale=m(4), epilogue="gelu"),
         True),
        ("fc2_m", _e(M, F), _e(F, C), _e(C), dict(epilogue="gate_res", res=h, gate=m(5)), True),
    ]


def modular_uses(M, nb):
    """The modular layer's MultiheadAttention products (models/attention.py)
    and its row views: qkv of the AdaLN rows, the out-projection with and
    without the gated residual."""
    mod = _e(nb, 6 * C)
    rows = _e(M, C)
    return [
        ("mha_qkv", rows, _e(C, 3 * C), _e(3 * C),
         dict(ln="plain", shift=mod[:, :C], scale=mod[:, C:2 * C]), True),
        ("mha_qkv_noln", rows, _e(C, 3 * C), _e(3 * C), {}, True),
        ("mha_out", _e(M, C), _e(C, C), _e(C), {}, True),
        ("mha_out_gate", _e(M, C), _e(C, C), _e(C),
         dict(epilogue="gate_res", res=rows, gate=mod[:, 2 * C:3 * C]), True),
        # a row view of qkv's k columns (lda = 3C), as the q/k/v slices are
        ("k_cols", _e(M, 3 * C)[:, C:2 * C], _e(C, C), None, {}, True),
    ]


def _check(p, M, N, K):
    assert p.smem <= AL.SMEM_PER_BLOCK
    if p.route == 2:
        return
    assert p.tma and p.tile_n == 128 and p.tile_m in (64, 128)
    assert p.row_blocks * p.tile_m >= M > (p.row_blocks - 1) * p.tile_m
    chunks = -(-N // 128)
    assert p.per * p.splits >= chunks > p.per * (p.splits - 1)
    assert p.smem == AL.smem_bytes(p.route, K, p.stages, p.warpgroups)
    assert AL.MIN_STAGES <= p.stages <= AL.MAX_STAGES
    if p.route == 0:  # resident: about four waves of blocks, no more splits than that takes
        slots = AL.SMS * AL.blocks_per_sm(p.smem)
        assert p.splits == 1 or (p.splits - 1) * p.row_blocks < AL.WAVES * slots + p.row_blocks


@pytest.mark.parametrize("cell", list(SHAPES))
def test_trunk_and_encoder_routes(cell):
    """Every full-width product of the trunk (and, at the flagship, of the
    encoder and the modular layer) takes a wgmma route; the head and the
    embed take tiled64; every plan fits and covers its grid."""
    B, T, L = SHAPES[cell]
    M = B * T * L
    uses = trunk_uses(B, T, L, training=cell.startswith("train") or cell == "atlas")
    if cell == "flagship":
        uses += encoder_uses(B * T, L) + modular_uses(M, B)
    for name, x, w, b, kw, wide in uses:
        p = AL.plan(x, w, b, **kw)
        assert (p.route < 2) == wide, (cell, name, p)
        _check(p, x.shape[0], w.shape[1], w.shape[0])
        if wide:  # the two-warpgroup tile and its deep ring at these row counts
            assert p.tile_m == 128 and p.stages >= 6, (cell, name, p)
    prologue = {n: AL.plan(x, w, b, **kw).route for n, x, w, b, kw, _ in uses}
    assert prologue["fc2_gate"] == 1 and prologue["fc1_gelu"] == 0 and prologue["qkv"] == 0


@pytest.mark.parametrize("B,T", [(32, 100), (4, 200), (2, 100)])
def test_merged_backward_plans(B, T):
    """The merged layer backward's six recomputed products (fc1 with its
    pre-activation, fc2, qkv and the out-projection of both stages), planned
    with ``merged=True``: one warpgroup a block, a ring of 3, two blocks per
    SM (the merged kernel's occupancy); the same route as the split route's
    plan of the same call."""
    L = 4
    M = B * T * L
    uses = [u for u in trunk_uses(B, T, L, training=True)
            if u[0] in ("qkv", "fc1_pre", "fc2_f32", "out_f32")]
    for name, x, w, b, kw, _ in uses:
        p = AL.plan(x, w, b, merged=True, **kw)
        split = AL.plan(x, w, b, **kw)
        assert p.route == split.route < 2, (name, p)
        assert p.tile_m == 64 and p.stages == AL.MERGED_STAGES
        assert AL.blocks_per_sm(p.smem) == 2, (name, p.smem)
        _check(p, M, w.shape[1], w.shape[0])


def test_small_and_unaligned_calls():
    """Rows fewer than a tile take one warpgroup; an operand off the 16-byte
    rule (a row stride of an odd number of bf16 pairs, an odd base, N not a
    multiple of 8, an f32 x) goes to tiled64, where the launcher counts it,
    rather than to a TMA box it cannot take."""
    w, b = _e(C, C), _e(C)
    for M in (1, 63, 64):
        p = AL.plan(_e(M, C), w, b)
        assert p.route == 0 and p.tile_m == 64 and p.row_blocks == 1
    assert AL.plan(_e(65, C), w, b).tile_m == 128
    x = _e(100, C + 4)[:, :C]  # rows 776 bytes apart
    assert AL.plan(x, w, b).route == 2
    x = _e(100 * C + 1).narrow(0, 1, 100 * C).view(100, C)  # base 2 bytes off
    assert AL.plan(x, w, b).route == 2
    assert AL.plan(_e(100, C), _e(C, 100), None).route == 2
    assert AL.plan(_e(100, C, dtype=F32), w, b).route == 2
    # no prologue and K past the resident route's 512: pipelined
    assert AL.plan(_e(100, 1024), _e(1024, C), b).route == 1
    assert AL.plan(_e(100, 1024), _e(1024, C), b, ln="plain").route == 2
