"""PyTorch port: the streaming form of ``ipa_attention`` (L <= 16) on the CPU.

- ``ipa_plan`` (``ops/ipa_attention.py``), the unit of whole elements that
  the streaming kernel walks: at the flagship's encoder ((B, L) = (6400, 4),
  4 heads of 32 with 8 / 8 points), at every L from 1 to 16, and at a B
  that the plan's elements per unit do not divide: every element in exactly
  one unit, four threads per query, shared memory within the budget (two
  blocks per SM) and the layout written out by hand; L > 16 and other
  widths refused by the plan, and the form each shape takes.
- The plain IPA core that the kernel is held to on the card
  (``ipa_attention_plain``) against the JAX package's XLA twin
  (``ops/ipa_encoder.py::_ipa_fwd_split``) at L = 1 and at L = 4 with a
  masked residue. The twin's projections are identity column blocks with
  zero biases, so both sides take the same proj; f32 on both sides: rtol
  1e-4 / atol 5e-5 (the two differ in the order of f32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.ops.ipa_encoder import _ipa_fwd_split
from mdgen_finetune_tpu_torch.ops import ipa_attention as IA
from mdgen_finetune_tpu_torch.ops._cuda import SMS
from mdgen_finetune_tpu_torch.ops.rope_attention import SMEM_BYTES

jax.config.update("jax_platforms", "cpu")

WIDTHS = (32, 8, 8)  # (Ch, Pq, Pv): the model's


def _check_plan(p, B, L, H):
    assert 1 <= p.spb <= max(1, B)
    assert p.units == -(-B // p.spb), "every element in exactly one unit"
    assert (p.units - 1) * p.spb < B <= p.units * p.spb
    assert p.smem == IA.ipa_bytes(p.spb, L, H) <= SMEM_BYTES
    assert p.spb == 1 or p.smem <= IA.SHORT_BUDGET
    assert p.spb * L * H * IA.QUERY_THREADS <= max(IA.SHORT_THREADS, IA.QUERY_THREADS * L * H), \
        "about QUERY_THREADS threads per query"
    assert p.spb == 1 or B // p.spb >= 3 * SMS, "no fewer than 3 units per SM"


def test_ipa_plan_at_the_flagship():
    """Four elements (16 rows of 2,688 B) per unit, two blocks per SM; the
    layout by hand: two raw buffers of 16 rows of 672 floats padded by 4
    after every 32 and the rows' 9 + 3 + 1 frame floats, then 16 feature
    rows of 256 bf16."""
    p = IA.ipa_plan(6400, 4, 4, *WIDTHS)
    _check_plan(p, 6400, 4, 4)
    assert (p.spb, p.units) == (4, 1600)
    assert p.smem == 2 * (16 * 756 * 4 + 16 * 36 + 16 * 12 + 16 * 4) + 16 * 256 * 2 == 106_624
    assert 2 * (p.smem + 1024) <= 233_472


@pytest.mark.parametrize("H", [4, 8])
def test_ipa_plan_every_l(H):
    """L = 1..16 at B = 6400, at B = 6401 and 1601 (not a multiple of the
    plan's elements per unit) and at small B, where a unit is one element;
    the streaming form takes every B."""
    uneven = 0
    for L in range(1, IA.SHORT_L + 1):
        for B in (1, 7, 397, 1601, 6400, 6401):
            p = IA.ipa_plan(B, L, H, *WIDTHS)
            _check_plan(p, B, L, H)
            uneven += B % p.spb != 0
        assert IA._form(1, L, H, *WIDTHS) == IA._form(6400, L, H, *WIDTHS) == 0
    assert uneven


def test_ipa_plan_refuses_and_the_forms():
    """L outside 1..16, widths other than the model's and H not a multiple
    of 4 are not the streaming form's; they take the resident form at L = 4
    and, at the model's widths, the tensor-core form from ``TC_MIN_L``."""
    for L in (0, 17, 64, 256):
        with pytest.raises(ValueError):
            IA.ipa_plan(6400, L, 4, *WIDTHS)
    for H, widths in ((2, WIDTHS), (6, WIDTHS), (4, (16, 4, 6)), (4, (32, 8, 4))):
        with pytest.raises(ValueError):
            IA.ipa_plan(6400, 4, H, *widths)
        assert IA._form(6400, 4, H, *widths) == 1
    assert [IA._form(6400, L, 4, *WIDTHS) for L in (16, 17, 64, 65, 256)] == [0, 3, 3, 3, 3]


def _case(rng, B, L, H):
    Ch, Pq, Pv = WIDTHS
    proj = rng.normal(size=(B, L, IA.proj_width(H, Ch, Pq, Pv))).astype(np.float32)
    t7 = rng.normal(size=(B, L, 7)).astype(np.float32)
    t7[..., 4:] *= 3.0
    mask = np.ones((B, L), np.float32)
    hw = rng.normal(size=(H,)).astype(np.float32)
    return proj, t7, mask, hw


@pytest.mark.parametrize("L", [1, 4])
def test_plain_core_matches_jax_split_twin(L):
    """The plain core against ``_ipa_fwd_split`` on the same proj (identity
    projections): L = 1, and L = 4 with a masked residue in one element and
    an element whose residues are all masked but one."""
    rng = np.random.default_rng(30 + L)
    B, H = 3, 4
    Ch, Pq, Pv = WIDTHS
    proj, t7, mask, hw = _case(rng, B, L, H)
    if L == 4:
        mask[0, -1] = 0.0
        mask[2, 1:] = 0.0
    jf = JRigid.from_tensor_7(jnp.asarray(t7))
    rot, trans = np.array(jf.rot), np.array(jf.trans)
    got = IA.ipa_attention(torch.from_numpy(proj), torch.from_numpy(rot), torch.from_numpy(trans),
                           torch.from_numpy(mask), torch.from_numpy(hw), H=H, Ch=Ch, Pq=Pq,
                           Pv=Pv).numpy()

    W, F = IA.proj_width(H, Ch, Pq, Pv), IA.feat_width(H, Ch, Pv)
    eye = np.eye(W, dtype=np.float32)
    cuts = np.cumsum([0, H * Ch, H * Ch, H * Ch, 3 * H * Pq, 3 * H * Pq, 3 * H * Pv])
    ws = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        ws += [jnp.asarray(eye[:, a:b]), jnp.zeros((b - a,), jnp.float32)]
    ws += [jnp.asarray(hw), jnp.eye(F, dtype=jnp.float32), jnp.zeros((F,), jnp.float32)]
    want = np.asarray(_ipa_fwd_split(jnp.asarray(proj), jf, jnp.asarray(mask), tuple(ws), H, Ch,
                                     Pq, Pv, jnp.float32))
    assert got.shape == want.shape == (B, L, F)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
