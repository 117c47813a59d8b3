"""PyTorch port: row e, ``modln_bwd`` (the LN-modulate adjoint of a trunk
stage, with its residual add and its AdaLN-row sums), on the CPU.

- ``modln_bwd_plain``, which the kernel is held to on the card, against the
  JAX package's ``_modln_fwd`` / ``_modln_bwd`` (``ops/fused_layer_bwd.py``)
  plus the stage's gate sum ``dg = sum(dOUT * y)`` and residual add
  ``dOUT + dx_ln``, per batch element, on numpy-seeded f32 inputs at narrow
  widths, one element and several. f32 on both sides: within 2e-5 of each
  output's scale (JAX takes the variance as E[x^2] - mean^2, the port as
  E[(x - mean)^2]; the sums run in other orders).
- The kernel's block plan (``plan``, and the walk of ``csrc/modln_bwd.cu``
  written out in ``_row_order``): over the (element, run) blocks, each
  warp's rows, in the order it sums them, cover every row of the element
  exactly once, at the three training shapes (flagship,
  T = 1000, ATLAS) and the merged route's shapes; that order is the tree
  the bits rest on (virtual warp w of run s sums rows r_lo + w, r_lo + w +
  8, ... ascending); runs past the element's rows (B = 4, T = 200) are
  empty and add zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import fused_layer_bwd as jfb
from mdgen_finetune_tpu_torch.ops import modln_bwd as MB

jax.config.update("jax_platforms", "cpu")


def _jax_stage(x, dh, dout, y, scale):
    """The JAX stage kernels' pieces per batch element: (dx, dmod rows)."""
    nb, C = scale.shape
    R = x.shape[0] // nb
    dxs, rows = [], []
    for b in range(nb):
        sl = slice(b * R, (b + 1) * R)
        mod = np.zeros((1, 2, C), np.float32)
        mod[0, 1] = scale[b]  # row 0: the shift (not in the adjoint), row 1: the scale
        _, hh, rstd, sc = jfb._modln_fwd(jnp.asarray(x[sl]), jnp.asarray(mod), 0, jnp.float32)
        dx_ln, dsh, dsc = jfb._modln_bwd(jnp.asarray(dh[sl]), hh, rstd, sc)
        dg = jnp.sum(jnp.asarray(dout[sl]) * jnp.asarray(y[sl]), axis=0, keepdims=True)
        dxs.append(np.asarray(jnp.asarray(dout[sl]) + dx_ln))
        rows.append(np.concatenate([np.asarray(dsh), np.asarray(dsc), np.asarray(dg)], axis=1))
    return np.concatenate(dxs), np.concatenate(rows)


@pytest.mark.parametrize("M,C,nb", [(24, 48, 1), (40, 64, 5), (96, 96, 3)])
def test_modln_bwd_plain_matches_jax(M, C, nb):
    rng = np.random.default_rng(M + C + nb)
    x = (rng.standard_normal((M, C)) * 1.5 + 0.3).astype(np.float32)
    dh, dout, y = (rng.standard_normal((M, C)).astype(np.float32) for _ in range(3))
    scale = (0.3 * rng.standard_normal((nb, C))).astype(np.float32)
    want_dx, want_dmod = _jax_stage(x, dh, dout, y, scale)
    t = [torch.from_numpy(a) for a in (x, dh, dout, y, scale)]
    dx, dmod = MB.modln_bwd_plain(*t)
    given = torch.full((nb, 4 * C), 7.0)[:, C:]  # a row view of a wider buffer
    dx2, dmod2 = MB.modln_bwd(*t, dmod=given)  # CPU tensors: the plain version
    assert dmod2.data_ptr() == given.data_ptr() and torch.equal(dmod2, dmod)
    assert torch.equal(dx2, dx)
    for got, want in ((dx.numpy(), want_dx), (dmod.numpy(), want_dmod)):
        tol = 2e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


WARPS = 8  # a block's warps: virtual warp w of the tree each


def _row_order(M, nb, s):
    """The kernel's walk of run ``s`` of an element (the same for every
    element): for each warp w, the rows it sums, in order (for k < n:
    rows r_lo + w + 8 k below r_hi)."""
    _, per = MB.plan(M, nb)
    r_lo, r_hi = s * per, min(M // nb, (s + 1) * per)
    return [[r_lo + w + WARPS * k for k in range(max(0, -(-(r_hi - r_lo - w) // WARPS)))]
            for w in range(WARPS)]


SHAPES = {  # (M rows, nb elements) at C = 384
    "flagship_train_path": (32 * 100 * 4, 32),
    "train_1000": (8 * 1000 * 4, 8),
    "train_atlas": (1 * 250 * 256, 1),
    "merged_b2_t100": (2 * 100 * 4, 2),
    "merged_b4_t200": (4 * 200 * 4, 4),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_block_plan_covers_every_row_once_in_tree_order(name):
    M, nb = SHAPES[name]
    rows = M // nb
    splits, per = MB.plan(M, nb)
    assert splits == MB._splits(rows, nb) and per == -(-rows // splits)
    assert rows <= splits * per, "no row beyond the last run"
    seen = []
    for s in range(splits):
        order = _row_order(M, nb, s)
        lo = s * per
        for w, rs in enumerate(order):
            assert rs == list(range(lo + w, min(rows, lo + per), WARPS)), (s, w)
        seen += [r for rs in order for r in rs]
    assert sorted(seen) == list(range(rows)), "every row exactly once"
