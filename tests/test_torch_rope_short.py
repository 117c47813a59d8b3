"""PyTorch port: the short body of ``rope_attention`` (N <= 16) on the CPU.

- ``short_plan`` (``ops/rope_attention.py``), the unit that the streaming
  kernel and the merged layer backward take (SPB sequences x HG heads, one
  or two raw buffers), at every use: trunk stage 1 of the flagship and of
  its training, the encoder's residue MHA, the modular layer's residue
  attention, stage 2 at T <= 16 (the I > 1 form), every N from 1 to 16 at
  head dims 16-64; its shared memory against the layout written out by
  hand; the merged launch's integer slots carrying the two stages' plans.
- ``rope_attention_bwd.short_plan``, the short backward's unit, at its
  three uses (the training path's stage 1, the T = 1000 training's, the
  merged route's residue stage at B = 4, T = 200) and at every N from 1 to
  16; its shared memory against the layout by hand; the merged launch's
  integer slots carrying the backward's plans beside the forward's.
- The plain math that the short body is held to on the card
  (``rope_attention_plain``) against the JAX package's XLA twins
  (``residue_attention._xla_impl`` over the residue view and
  ``time_attention._xla_impl`` over the (G, N, I) view) at N = 1 and 16, in
  both softmax modes, with a padded residue and a frame whose only valid
  key is the bias token. f32 on both sides: within 2e-5 of the outputs'
  scale (the two differ only in the order of f32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import residue_attention as jra
from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu_torch.ops import rope_attention as RA
from mdgen_finetune_tpu_torch.ops import rope_attention_bwd as RB

jax.config.update("jax_platforms", "cpu")

USES = {  # (G, N, I, H, D)
    "stage1_flagship": (6400, 4, 1, 16, 24),
    "stage1_training": (3200, 4, 1, 16, 24),
    "encoder_mha": (64, 4, 1, 16, 24),
    "stage2_t8": (2, 8, 4, 16, 24),
    "stage2_t16_d64": (3, 16, 3, 8, 64),
}


BWD_USES = {  # (G, N, I, H, D)
    "stage1_training": (3200, 4, 1, 16, 24),
    "stage1_t1000": (8000, 4, 1, 16, 24),
    "merged_residue_b4_t200": (800, 4, 1, 16, 24),
}


def _check_plan(p, G, N, I, H, D, merged, M=RA):
    S = G * I
    groups = -(-H // p.hg)
    assert 1 <= p.hg <= H and 1 <= p.spb <= max(1, S)
    assert p.hg == -(-H // groups), "head groups as even as they go"
    assert p.nbuf == (1 if merged else 2)
    assert p.smem == M.short_bytes(p.spb, p.hg, N, D, p.nbuf, H) <= M.SHORT_BUDGET
    assert p.units == -(-S // p.spb) * groups, "every sequence and head in exactly one unit"
    # a thread per query (the forward) or per key, the bias key with them (the backward)
    per = N + 1 if M is RB else N
    assert p.spb * p.hg * per <= max(M.SHORT_THREADS, p.hg * per), "about a thread per query or key"


@pytest.mark.parametrize("use", sorted(USES))
def test_short_plan_at_every_use(use):
    G, N, I, H, D = USES[use]
    for merged in (False, True):
        p = RA.short_plan(G, N, I, H, D, merged=merged)
        _check_plan(p, G, N, I, H, D, merged)
        if use == "stage1_flagship":
            # two whole sequences (8 rows of 1,152 bf16) per unit, four
            # blocks per SM in the streaming kernel
            assert (p.spb, p.hg, p.units) == (2, 16, 3200)
            assert 4 * (p.smem + 1024) <= 233_472
        if use == "encoder_mha":
            assert p.spb == 1 and p.units == 64, "a small call spreads over the SMs"


def test_short_plan_every_n_and_head_dim():
    """N = 1..16 at D = 16, 24, 32, 64 (8 or 16 heads), G not a multiple of
    any SPB; the layout by hand at the flagship; N outside 1..16 refused."""
    for D, H in ((16, 16), (24, 16), (32, 16), (64, 8)):
        for N in range(1, 17):
            for I in (1, 3):
                for merged in (False, True):
                    _check_plan(RA.short_plan(397, N, I, H, D, merged=merged), 397, N, I, H, D,
                                merged)
    # 2 raw buffers of 2 x 4 x 1,152 bf16 and 2 x 4 key_valid floats, K of
    # 2 x 16 heads at 4 x 24 + 4 floats, 2 x 4 key biases, the bias key and
    # value of 16 heads of 24
    assert RA.short_bytes(2, 16, 4, 24, 2, 16) == \
        2 * (18_432 + 32) + 2 * 16 * 100 * 4 + 32 + 3_072
    assert RA.short_plan(6400, 4, 1, 16, 24, merged=True).smem == 18_464 + 12_800 + 32 + 3_072
    for N in (0, 17):
        with pytest.raises(ValueError):
            RA.short_plan(10, N, 1, 16, 24)


@pytest.mark.parametrize("use", sorted(BWD_USES))
def test_short_bwd_plan_at_every_use(use):
    G, N, I, H, D = BWD_USES[use]
    for merged in (False, True):
        p = RB.short_plan(G, N, I, H, D, merged=merged)
        _check_plan(p, G, N, I, H, D, merged, M=RB)
        # one whole sequence (4 rows of 1,152 bf16 and 4 of 384) per unit:
        # its 80 keys (16 heads x 4 + the bias key) in one pass of the 128
        # threads; four blocks per SM in the streaming kernel
        assert (p.spb, p.hg, p.units) == (1, 16, G)
        if not merged:
            assert 4 * (p.smem + 1024) <= 233_472


def test_short_bwd_plan_every_n_and_head_dim():
    """N = 1..16 at D = 16, 24, 32, 64 (8 or 16 heads), G not a multiple of
    any SPB; the layout by hand at stage 1; N outside 1..16 refused."""
    for D, H in ((16, 16), (24, 16), (32, 16), (64, 8)):
        for N in range(1, 17):
            for I in (1, 3):
                for merged in (False, True):
                    _check_plan(RB.short_plan(397, N, I, H, D, merged=merged), 397, N, I, H, D,
                                merged, M=RB)
    # 2 raw buffers of 2 x 4 x (1,152 + 384) bf16 and 2 x 4 key_valid
    # floats; q and k of 2 x 16 heads at 4 x 24 + 4 floats; 2 x 4 key
    # biases; p and dl of 2 x 16 x 4 x 5; the bias key and value
    assert RB.short_bytes(2, 16, 4, 24, 2, 16) == \
        2 * (24_576 + 32) + 2 * 2 * 16 * 100 * 4 + 32 + 2 * 2_560 + 3_072
    for N in (0, 17):
        with pytest.raises(ValueError):
            RB.short_plan(10, N, 1, 16, 24)


def test_merged_slots_carry_the_short_plans():
    """The merged layer backward's launch slots (CPU tensors; the slots are
    built the same way): the short plans of the frame stage (B, T, L) where
    T <= 16 and of the residue stage (B * T, L, 1), each with one raw
    buffer, rope_attention's and then rope_attention_bwd's; a long frame
    stage gets none."""
    from mdgen_finetune_tpu_torch.ops import fused_layer_bwd_merged as FM

    C, H, L = 96, 4, 4
    g = torch.Generator().manual_seed(0)
    keys = dict(wqkv_l=(C, 3 * C), bqkv_l=(3 * C,), wout_l=(C, C), bout_l=(C,),
                wqkv_t=(C, 3 * C), bqkv_t=(3 * C,), wout_t=(C, C), bout_t=(C,),
                w1=(C, 4 * C), b1=(4 * C,), w2=(4 * C, C), b2=(C,), bkl=(C,), bvl=(C,),
                bkt=(C,), bvt=(C,))
    w = {k: torch.randn(*s, generator=g).bfloat16() for k, s in keys.items()}
    for B, T in ((2, 12), (2, 20)):
        M = B * T * L
        x = torch.randn(M, C, generator=g).bfloat16()
        mod = torch.randn(B, 9 * C, generator=g).bfloat16()
        _, ints, _ = FM.launch_slots(x, x, x, x.float(), mod, w, torch.ones(B, T, L), H)
        assert len(ints) == FM.N_INT
        for got, M in ((ints[-8:-4], RA), (ints[-4:], RB)):
            frame = M.short_plan(B, T, L, H, C // H, merged=True) if T <= 16 else None
            resid = M.short_plan(B * T, L, 1, H, C // H, merged=True)
            assert got == ([frame.spb, frame.hg] if frame else [0, 0]) + [resid.spb, resid.hg]


def _qkv(rng, G, N, I, H, D, base2):
    C = H * D
    q, k, v = (rng.normal(size=(G, N, I, C)).astype(np.float32) for _ in range(3))
    q *= D ** -0.5 * (np.log2(np.e) if base2 else 1.0)  # the fold contract of the trunk
    bk, bv = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    mask = (rng.random((G, N, I)) > 0.3).astype(np.float32)
    mask[0] = 0.0  # only the bias key is valid
    mask[1, -1] = 0.0  # a padded residue
    mask[2] = 1.0
    return q, k, v, bk, bv, mask


def _plain(q, k, v, bk, bv, mask, H, base2):
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    return RA.rope_attention_plain(qkv, torch.from_numpy(bk), torch.from_numpy(bv),
                                   torch.from_numpy(mask), num_heads=H, base2=base2).numpy()


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= 2e-5 * scale, np.abs(got - want).max()


@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("base2", [True, False])
def test_short_plain_math_matches_jax_residue_view(N, base2):
    """The residue view (B*T, L, 1) at L = N against
    ``residue_attention._xla_impl`` over (B, T, L): B = 2, T = 3, 2 heads
    of D = 24. The frame whose only valid key is the bias token gives the
    bias value."""
    rng = np.random.default_rng(N + 2 * base2)
    Bc, Tc, H, D = 2, 3, 2, 24
    q, k, v, bk, bv, mask = _qkv(rng, Bc * Tc, N, 1, H, D, base2)
    got = _plain(q, k, v, bk, bv, mask, H, base2)

    def btl(x):
        return jnp.asarray(x.reshape(Bc, Tc, N, -1))

    want = np.asarray(jra._xla_impl(btl(q), btl(k), btl(v), jnp.asarray(bk), jnp.asarray(bv),
                                    jnp.asarray(mask.reshape(Bc, Tc, N)), H, base2=base2))
    _close(got.reshape(Bc, Tc, N, -1), want)
    np.testing.assert_allclose(got[0], np.broadcast_to(bv, got[0].shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("N", [1, 16])
@pytest.mark.parametrize("base2", [True, False])
def test_short_plain_math_matches_jax_time_view(N, base2):
    """The (G, N, I) view at I = 3 (stage 2 at T = N) against
    ``time_attention._xla_impl`` over (B, T, L) = (G, N, I), key_valid
    (B, L, T)."""
    rng = np.random.default_rng(10 + N + 2 * base2)
    G, I, H, D = 3, 3, 2, 16
    q, k, v, bk, bv, mask = _qkv(rng, G, N, I, H, D, base2)
    got = _plain(q, k, v, bk, bv, mask, H, base2)
    want = np.asarray(jta._xla_impl(*map(jnp.asarray, (q, k, v, bk, bv)),
                                    jnp.asarray(mask.transpose(0, 2, 1)), H, base2=base2))
    _close(got, want)
