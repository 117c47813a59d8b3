"""PyTorch port: the tensor-core form of ``ipa_attention`` (L > 64) on the CPU.

- ``ipa_attention_tc_math`` (``ops/ipa_attention.py``), the kernel's
  arithmetic in plain PyTorch: the logits as one product of augmented rows
  [q | q_pts] . [c k | w k_pts] plus a per-key bias, the masked queries'
  bias, the scalar columns rounded to TF32 and the point columns of both
  products in 3xTF32, the values as one product of the unnormalised weights
  with [v | v_pts]. Held against the JAX package's ``models/ipa.py::
  ipa_forward`` (f32, on the CPU) at L = 256, B = 2, H = 4 and both of the
  form's widths, with translations across +-40 A (a 256-residue crop's
  extent) and a masked tail of 56 residues. The JAX side takes the same
  proj through identity projections. Tolerance: 4e-3 x max(1, max |ref|),
  under half the card's rule for the kernel against its twin. Most of what
  it measures (1.2-2.1e-3 of that scale) is the f32 reference's own: the
  expanded squared distance at 40 A rounds in f32 (the port's f32 plain
  version, which agrees with JAX's to 1e-5, is 1.4e-3 of the scale from an
  f64 evaluation, the emulation 3e-4). Single TF32 on the point columns
  measures above the card's rule, which is why the kernel splits them.
- ``tc_plan``: the blocks each (B, L, widths) takes, every query tile in
  exactly one block; the form each shape takes; ``tc_bytes`` written out.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.geometry.rigid import Rigid as JRigid
from mdgen_finetune_tpu.models.ipa import ipa_forward
from mdgen_finetune_tpu_torch.ops import ipa_attention as IA

jax.config.update("jax_platforms", "cpu")

H = 4


def _case(widths, B=2, L=256, seed=0):
    Ch, Pq, Pv = widths
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(B, L, IA.proj_width(H, Ch, Pq, Pv))).astype(np.float32)
    t7 = rng.normal(size=(B, L, 7)).astype(np.float32)
    t7[..., 4:] = rng.uniform(-40.0, 40.0, size=(B, L, 3))
    mask = np.ones((B, L), np.float32)
    mask[:, L - 56:] = 0.0
    hw = rng.normal(size=(H,)).astype(np.float32)
    return proj, t7, mask, hw


def _jax_ref(proj, jf, mask, hw, widths):
    """``ipa_forward`` on s = proj, its projections picking proj's column
    blocks (its kv rows are [k_h | v_h] per head, its kv points [k | v] per
    head inside each coordinate), its output projection the identity."""
    Ch, Pq, Pv = widths
    W, F = IA.proj_width(H, Ch, Pq, Pv), IA.feat_width(H, Ch, Pv)
    HCh, HPq, HPv = H * Ch, H * Pq, H * Pv
    eye = np.eye(W, dtype=np.float32)
    kv = np.concatenate([np.r_[HCh + h * Ch:HCh + (h + 1) * Ch, 2 * HCh + h * Ch:2 * HCh + (h + 1) * Ch]
                         for h in range(H)])
    kp, vp = 3 * HCh + 3 * HPq, 3 * HCh + 6 * HPq
    kvp = np.concatenate([np.r_[kp + x * HPq + h * Pq:kp + x * HPq + (h + 1) * Pq,
                                vp + x * HPv + h * Pv:vp + x * HPv + (h + 1) * Pv]
                          for x in range(3) for h in range(H)])

    def dense(cols):
        return jnp.asarray(eye[:, cols]), jnp.zeros((len(cols),), jnp.float32)

    ws = (*dense(np.arange(HCh)), *dense(kv), *dense(np.arange(3 * HCh, 3 * HCh + 3 * HPq)),
          *dense(kvp), jnp.asarray(hw), jnp.eye(F, dtype=jnp.float32), jnp.zeros((F,), jnp.float32))
    return np.asarray(ipa_forward(jnp.asarray(proj), jf, jnp.asarray(mask), ws, H, Ch, Pq, Pv,
                                  jnp.float32))


@pytest.mark.parametrize("widths", IA.TC_WIDTHS)
def test_tc_math_matches_jax_ipa_forward(widths):
    """The emulation within 4e-3 x max(1, max |ref|) of JAX's ipa_forward;
    with single TF32 on the point columns above the card's 1e-2 rule."""
    proj, t7, mask, hw = _case(widths)
    jf = JRigid.from_tensor_7(jnp.asarray(t7))
    ref = _jax_ref(proj, jf, mask, hw, widths)
    Ch, Pq, Pv = widths
    args = [torch.from_numpy(np.array(a)) for a in (proj, jf.rot, jf.trans, mask, hw)]
    kw = dict(H=H, Ch=Ch, Pq=Pq, Pv=Pv)
    got = IA.ipa_attention_tc_math(*args, **kw).numpy()
    assert got.shape == ref.shape == (2, 256, IA.feat_width(H, Ch, Pv))
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 4e-3 * scale, np.abs(got - ref).max() / scale
    # the masked tail (m_q = 0: every key) and the live rows both within it
    assert np.abs(got[:, -56:] - ref[:, -56:]).max() <= 4e-3 * scale
    single = IA.ipa_attention_tc_math(*args, **kw, split=False).numpy()
    assert np.abs(single - ref).max() > 1e-2 * scale


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -(1.0 + 2 ** -11), 3.0e-3, 0.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 0.0, 0.0])
    got = IA.tf32(x)
    assert torch.equal(got[[0, 1, 2, 3, 5]], want[[0, 1, 2, 3, 5]])
    assert abs(got[4].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    cut = IA.tf32(x, truncate=True)
    assert torch.equal(cut[[0, 1, 2, 5]], torch.tensor([1.0, 1.0, 1.0, 0.0]))
    assert cut[3].item() == -1.0 and 0 <= 3.0e-3 - cut[4].item() <= 3.0e-3 * 2 ** -10


def test_tc_plan():
    """The blocks of every (B, L) at both widths: at most TC_MAX_WARPS warps,
    every 16-query tile in exactly one block, the fewest blocks, the warps
    spread evenly over them (at most one apart); the ATLAS shapes written
    out."""
    assert IA.tc_plan(100, 256, H, 32, 8, 8) == IA.TcPlan(8, 2, 800, 97_792)
    assert IA.tc_plan(1, 256, H, 32, 8, 8) == IA.TcPlan(8, 2, 8, 97_792)
    assert IA.tc_plan(100, 256, H, 16, 4, 6) == IA.TcPlan(8, 2, 800, 73_216)
    assert IA.tc_plan(100, 300, H, 32, 8, 8) == IA.TcPlan(7, 3, 1200, 97_792)
    assert IA.tc_plan(100, 65, H, 32, 8, 8) == IA.TcPlan(5, 1, 400, 97_792)
    for widths in IA.TC_WIDTHS:
        for B in (1, 2, 3, 10, 33, 100, 400):
            for L in (17, 64, 65, 100, 255, 256, 300, 1000):
                p = IA.tc_plan(B, L, H, *widths)
                tiles = -(-L // 16)
                assert 1 <= p.warps <= IA.TC_MAX_WARPS
                assert (p.qgroups - 1) * p.warps < tiles <= p.qgroups * p.warps
                assert p.qgroups == -(-tiles // IA.TC_MAX_WARPS)
                assert p.qgroups * p.warps - tiles < p.qgroups, "the last block's warps within one"
                assert p.blocks == B * H * p.qgroups
                assert p.smem == IA.tc_bytes(*widths) and 2 * (p.smem + 1024) <= 233_472
    for bad in ((8, 6, 2), (32, 8, 4), (16, 6, 6)):
        with pytest.raises(ValueError):
            IA.tc_plan(100, 256, H, *bad)


def test_tc_bytes_and_forms():
    """The ring written out: per key at (32, 8, 8) K rows of 56 + 4 floats,
    the point lows 24 + 4, V 56 + 4 and 24 + 4, 15 frame, mask and bias
    floats; at (16, 4, 6) 32 + 4, 16 + 4, 40 + 4, 24 + 4, 15. The form of
    each shape: streaming to L = 16 at the model's widths, tensor-core from
    TC_MIN_L = 17 at its widths (resident below); at other widths resident to
    RESIDENT_MAX_L, key-tiled above."""
    assert IA.tc_bytes(32, 8, 8) == 2 * 64 * (60 + 28 + 60 + 28 + 15) * 4
    assert IA.tc_bytes(16, 4, 6) == 2 * 64 * (36 + 20 + 44 + 28 + 15) * 4
    top = IA.RESIDENT_MAX_L
    assert IA.TC_MIN_L == IA.SHORT_L + 1
    for B in (1, 100):
        assert [IA._form(B, L, H, 32, 8, 8) for L in (16, 17, top, top + 1, 256)] == [0, 3, 3, 3, 3]
        assert [IA._form(B, L, 2, 32, 8, 8) for L in (16, 17)] == [1, 3]
        assert [IA._form(B, L, H, 16, 4, 6) for L in (16, 17, top + 1, 256)] == [1, 3, 3, 3]
        assert [IA._form(B, L, H, 8, 6, 2) for L in (17, top, top + 1, 256)] == [1, 1, 2, 2]
