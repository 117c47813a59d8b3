"""PyTorch port, the ATLAS crop-256 path (large L) held against the JAX
package on the CPU:

- ``residue_rows_block_plain`` (the residue stage at L > MAX_L, core
  ``tiled_attention``) against the TPU rows kernel
  ``_block_pallas_fwd_blocked_rows`` in interpret mode and its XLA twin
  ``_res_rows_xla``, with one frame all masked (the shapes of
  ``tests/test_time_attention.py``'s rows test at head dim 24);
- ``blocked_attention_bwd_plain`` against ``jax.vjp`` of
  ``time_attention._xla_impl(base2=True)``, and the routing of the
  attention backward by N (``fused_layer_bwd.bwd_core``);
- the stage backwards (``fused_layer_bwd.attention_stage_bwd``) in the
  residue view and the frame view against ``jax.vjp`` through
  ``_res_rows_block_pallas`` / ``_time_block_pallas_blocked`` in interpret
  mode, whose backwards are the TPU's row 8 (``rows_block_bwd`` /
  ``time_block_bwd``);
- ``trunk_layer`` and ``fused_layer_bwd`` at L = 12 and L = 136 against
  ``_layer_xla`` and its ``jax.vjp``;
- the ATLAS branch of ``MDGenDataset`` (replica choice, crop, zero padding
  with mask 0) against the JAX package's from one rng;
- ``cli.train`` then ``cli.sim_inference`` with ``--atlas --crop 12`` on
  the CPU.

Inputs are seeded numpy, f32 on both sides; C = 48 with 2 heads (head dim
24, as ATLAS). Tolerances: forward outputs rtol 1e-4 / atol 5e-5 (other
summation orders; exp2 in the port, exp of ln2-scaled logits in JAX);
gradients each within 1e-4 of the tensor's max magnitude (at least 1e-6
absolute), as ``tests/test_torch_long_t.py``; the dataset's arrays exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu import config as jcfg
from mdgen_finetune_tpu.data.dataset import MDGenDataset as JDataset
from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu.ops.fused_layer import _layer_xla
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import sim_inference, train
from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models, from_pdb_string
from mdgen_finetune_tpu_torch.ops import blocked_attention_bwd as tba
from mdgen_finetune_tpu_torch.ops.fused_layer import LAYER_KEYS, trunk_layer
from mdgen_finetune_tpu_torch.ops.fused_layer_bwd import (attention_stage_bwd, bwd_core,
                                                          fused_layer_bwd)
from mdgen_finetune_tpu_torch.ops.rope_attention_bwd import rope_attention_bwd
from mdgen_finetune_tpu_torch.ops.time_attention import (MAX_L, residue_rows_block,
                                                         residue_rows_block_plain)

RTOL, ATOL = 1e-4, 5e-5
C, H = 48, 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rel=1e-4, floor=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max() + floor, (err, np.abs(ref).max())


def _stage_inputs(seed, B, T, L):
    rng = np.random.default_rng(seed)

    def r(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    mask = rng.integers(0, 2, size=(B, T, L)).astype(np.float32)
    mask[:, :, 0] = 1.0
    mask[:, min(2, T - 1)] = 0.0  # one frame all masked: only the bias key is left
    args = [r(B, T * L, C, sc=0.5), r(B, C, sc=0.3), r(B, C, sc=0.3), r(B, C, sc=0.5),
            r(C, 3 * C, sc=C ** -0.5), r(3 * C, sc=0.1), r(C, C, sc=C ** -0.5), r(C, sc=0.1),
            r(C), r(C)]
    return args, mask, r(B, T * L, C)


def test_residue_rows_block_matches_jax_rows_kernel():
    B, T, L = 2, 5, 12
    assert L > MAX_L  # the rows route of _layer_kernels
    args, mask, _ = _stage_inputs(0, B, T, L)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(mask)]
    twin = jax.jit(lambda *a: jta._res_rows_xla(*a, H, T, L))(*jargs)
    kern = jta._block_pallas_fwd_blocked_rows(*jargs, H, T, L, interpret=True)
    targs = [_t(a) for a in args]
    targs[0] = targs[0].reshape(B * T * L, C)
    got = residue_rows_block_plain(*targs, _t(mask), B=B, T=T, L=L, num_heads=H)
    assert torch.isfinite(got).all()
    for ref in (twin, kern):
        np.testing.assert_allclose(got.reshape(B, T * L, C).numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper composition is the plain one
    again = residue_rows_block(*targs, _t(mask), B=B, T=T, L=L, num_heads=H)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_blocked_attention_bwd_plain_matches_jax_vjp():
    """G = 2, N = 136 tokens (above rope_attention_bwd's 128), I = 2, some
    keys masked and one sequence with only the bias key left."""
    G, N, I = 2, 136, 2
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(G, N, I, C)).astype(np.float32) for _ in range(3))
    bk, bv = (rng.normal(size=(C,)).astype(np.float32) for _ in range(2))
    dout = rng.normal(size=(G, N, I, C)).astype(np.float32)
    mask = np.ones((G, N, I), np.float32)
    mask[0, 90:, 0] = 0.0
    mask[1, :, 1] = 0.0

    def f(q, k, v, bk, bv):
        return jta._xla_impl(q, k, v, bk, bv, jnp.asarray(mask.transpose(0, 2, 1)), H,
                             base2=True)

    dq, dk, dv, dbk, dbv = jax.jit(lambda a, g: jax.vjp(f, *a)[1](g))(
        tuple(map(jnp.asarray, (q, k, v, bk, bv))), jnp.asarray(dout))
    assert bwd_core(N, C // H) is tba.blocked_attention_bwd
    qkv = _t(np.concatenate([q, k, v], -1))
    got = tba.blocked_attention_bwd(qkv, _t(dout), _t(bk), _t(bv), _t(mask), num_heads=H)
    want = (np.concatenate([np.asarray(dq), np.asarray(dk), np.asarray(dv)], -1), dbk, dbv)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    plain = tba.blocked_attention_bwd_plain(qkv, _t(dout), _t(bk), _t(bv), _t(mask), num_heads=H)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g.numpy(), p.numpy())


def test_attention_backward_routing_by_length():
    """rope_attention_bwd to 128 tokens, the blocked kernel to its limit
    (319 at D = 24: ATLAS's L = 256 and T = 250), fused_attention above; the
    limits are the ones the first design's shared memory set, kept, and a
    block fits the card at each (60,352 bytes at N = 256, D = 24, as
    csrc/blocked_attention_bwd.cu states)."""
    assert tba.max_keys(24) == 319 and tba.max_keys(16) == 511 and tba.max_keys(32) == 255
    assert tba.smem_bytes(256, 24) == 60_352
    for D in (16, 24, 32, 64):
        n = tba.max_keys(D)
        assert tba.smem_bytes(n, D) <= tba.SMEM_BYTES
    assert bwd_core(128, 24) is rope_attention_bwd
    for N in (129, 250, 256, 319):
        assert bwd_core(N, 24) is tba.blocked_attention_bwd
    assert bwd_core(320, 24) is None and bwd_core(1000, 24) is None


def _stage_case(view):
    if view == "rows_L12":
        return 2, 5, 12
    if view == "rows_L136":
        return 1, 2, 136
    return 1, 136, 2  # frame view, T = 136


@pytest.mark.parametrize("view", ["rows_L12", "rows_L136", "frame_T136"])
def test_stage_backward_matches_jax_row8(view):
    B, T, L = _stage_case(view)
    args, mask, dout = _stage_inputs(2, B, T, L)
    jargs = tuple(jnp.asarray(a) for a in args)
    if view.startswith("rows"):
        def f(*a):
            return jta._res_rows_block_pallas(*a, jnp.asarray(mask), H, T, L, True)

        j, tview, short, N = 0, (B * T, L, 1), L <= MAX_L, L
    else:
        def f(*a):
            return jta._time_block_pallas_blocked(*a, jnp.asarray(mask.transpose(0, 2, 1)), H, T,
                                                  L, True)

        j, tview, short, N = 3, (B, T, L), False, T
    want = jax.vjp(f, *jargs)[1](jnp.asarray(dout))
    core = bwd_core(N, C // H)
    assert core is (rope_attention_bwd if N <= 128 else tba.blocked_attention_bwd)
    targs = [_t(a) for a in args]
    mod = torch.zeros(B, 9 * C)
    for i in range(3):
        mod[:, (j + i) * C:(j + i + 1) * C] = targs[1 + i]
    dmod = torch.zeros(B, 9 * C)
    dx, grads = attention_stage_bwd(targs[0].reshape(-1, C), _t(dout).reshape(-1, C), mod, j,
                                    targs[4:], _t(mask), tview, H, dmod, short=short)
    got = [dx, dmod[:, j * C:(j + 1) * C], dmod[:, (j + 1) * C:(j + 2) * C],
           dmod[:, (j + 2) * C:(j + 3) * C], *grads]
    for g, w in zip(got, want):
        _close(g.numpy().reshape(w.shape), np.asarray(w))


LAYER_NAMES = ["x", "mod", *LAYER_KEYS]


@pytest.mark.parametrize("B,T,L", [(2, 5, 12), (1, 2, 136)])
def test_trunk_layer_and_backward_match_jax(B, T, L):
    """The whole layer at large L: the forward against ``_layer_xla`` and
    ``fused_layer_bwd`` against its ``jax.vjp``; at L = 136 the residue
    stage's backward takes the blocked kernel's route."""
    rng = np.random.default_rng(3)

    def r(*s, sc=1.0):
        return (rng.normal(size=s) * sc).astype(np.float32)

    vals = dict(x=r(B, T * L, C, sc=0.5), mod=r(B, 9 * C, sc=0.4))
    for stage in ("l", "t"):
        vals.update({f"wqkv_{stage}": r(C, 3 * C, sc=C ** -0.5), f"bqkv_{stage}": r(3 * C, sc=0.1),
                     f"wout_{stage}": r(C, C, sc=C ** -0.5), f"bout_{stage}": r(C, sc=0.1),
                     f"bk{stage}": r(C), f"bv{stage}": r(C)})
    vals.update(w1=r(C, 4 * C, sc=C ** -0.5), b1=r(4 * C, sc=0.1),
                w2=r(4 * C, C, sc=(4 * C) ** -0.5), b2=r(C, sc=0.1))
    mask = np.ones((B, T, L), np.float32)
    mask[:, :, L - 3:] = 0.0  # padded residues, as ATLAS pads a short protein
    vs = [vals[k] for k in LAYER_NAMES]
    dout = r(B, T * L, C)

    @jax.jit
    def fwd_bwd(vs, g):
        out, vjp = jax.vjp(lambda *a: _layer_xla(*a, jnp.asarray(mask), H, T, L), *vs)
        return out, vjp(g)

    ref, grads = fwd_bwd(tuple(map(jnp.asarray, vs)), jnp.asarray(dout))
    want = dict(zip(LAYER_NAMES, grads))
    x = _t(vals["x"]).reshape(-1, C)
    mod = _t(vals["mod"])
    w = {k: _t(vals[k]) for k in LAYER_KEYS}
    mk = _t(mask)
    x1, x2, y = trunk_layer(x, mod, w, mk, B=B, T=T, L=L, num_heads=H)
    np.testing.assert_allclose(y.reshape(B, T * L, C).numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    dx, dmod, dw = fused_layer_bwd(x, x1, x2, _t(dout.reshape(-1, C)), mod, w, mk, H)
    got = dict(x=dx, mod=dmod, **dw)
    for k in LAYER_NAMES:
        _close(got[k].numpy().reshape(want[k].shape), np.asarray(want[k]))


PROTEINS = [("prot_long", "MKTAYIAKQRQISFVK"), ("prot_short", "GSHMAV")]


@pytest.fixture(scope="module")
def atlas_data(tmp_path_factory):
    """Two proteins in the ATLAS layout (``{name}_R{1,2,3}_i40.npy``): one
    longer than the crop of 12, one shorter; the short one lacks replica 2,
    so the replica draw must retry."""
    root = tmp_path_factory.mktemp("atlas")
    split = make_synthetic_dataset(str(root / "data"), PROTEINS, num_frames=12, suffix="_i40",
                                   replicas=(1, 2, 3))
    (root / "data" / "prot_short_R2_i40.npy").unlink()
    return root, split


def test_atlas_dataset_matches_jax(atlas_data):
    root, split = atlas_data
    kw = dict(data_dir=str(root / "data"), num_frames=6, crop=12, atlas=True, suffix="_i40")
    jds = JDataset(jcfg.MDGenConfig(data=jcfg.DataConfig(**kw)), split)
    tds = MDGenDataset(tcfg.MDGenConfig(data=tcfg.DataConfig(**kw)), split)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    seen = set()
    for _ in range(6):
        jb, tb = jds.batch(jrng, 3), tds.batch(trng, 3)
        assert jb["name"] == tb["name"]
        for k in ("atom14", "seqres", "mask"):
            np.testing.assert_array_equal(tb[k], jb[k])
        assert tb["atom14"].shape == (3, 6, 12, 14, 3)
        for name, m, a in zip(tb["name"], tb["mask"], tb["atom14"]):
            seen.add(name)
            if name.startswith("prot_short"):  # padded: mask 0 and zero coordinates
                assert m.tolist() == [1.0] * 6 + [0.0] * 6 and not a[:, 6:].any()
            else:  # cropped: every residue real
                assert m.all()
    assert "prot_short_R2" not in seen and {"prot_long_R1", "prot_short_R1"} <= seen


def test_atlas_train_then_sim_inference_cli(atlas_data, capsys):
    root, split = atlas_data
    argv = ["--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--atlas", "--crop", "12",
            "--num_frames", "6", "--num_layers", "1", "--embed_dim", "48", "--mha_heads", "2",
            "--ipa_heads", "2", "--ipa_head_dim", "16", "--ipa_qk", "4", "--ipa_v", "4",
            "--suffix", "_i40", "--precision", "32-true", "--batch_size", "1",
            "--sampling_method", "heun", "--inference_steps", "2", "--data_dir",
            str(root / "data"), "--train_split", split, "--val_split", split, "--workdir",
            str(root / "work"), "--run_name", "atlas", "--epochs", "1", "--steps_per_epoch",
            "2", "--val_batches", "1", "--device", "cpu"]
    state = train.main(argv)
    assert state.step == 2
    ckpt = root / "work" / "atlas" / "ckpt_2"
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(root / "data"), "--split",
                        split, "--out_dir", str(root / "out"), "--num_frames", "6",
                        "--num_rollouts", "1", "--suffix", "_i40", "--device", "cpu"])
    meta = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{\"name\"")]
    assert '"frames": 6' in meta[-1]
    models = from_pdb_models(str(root / "out" / "prot_long.pdb"))
    assert len(models) == 6 and {len(a) for a, _ in models} == {12}
    pdb = (root / "out" / "prot_long.pdb").read_text()
    pos = np.stack([from_pdb_string(c).atom_positions for c in pdb.split("ENDMDL") if "ATOM" in c])
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2
