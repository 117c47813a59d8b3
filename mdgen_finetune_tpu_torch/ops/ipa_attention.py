"""ipa_attention: the Invariant Point Attention core (c_z = 0) from the
scalar/point projections to the output features.

Kernel: ``csrc/ipa_attention.cu``; it replaces the IPA part of the JAX
package's ``ops/ipa_encoder.py::_encoder_call`` kernel. Two forms: at
L <= ``RESIDENT_MAX_L`` one block per (element, head) holds the L x L
logits in shared memory (the 4AA peptides); above it one block per
(element, head, 64-query tile) streams the keys through shared memory with
a running-max softmax, so no buffer grows with L (ATLAS, L = 256). The
tiled form keeps a query's state in registers at the model's widths
(Ch = 32, Pq = Pv = 8) and in shared memory at any other widths
(``tiled_bytes``); the wrapper raises ``ValueError`` for widths whose state
or resident logits would not fit one block's shared memory. ``ipa_attention_plain`` is
the same function in plain PyTorch, in the op order of the JAX package's
``models/ipa.py::ipa_forward``; it runs for CPU tensors. For CUDA tensors the
wrapper launches the kernel or raises.

``proj`` (B, L, 3*H*Ch + 6*H*Pq + 3*H*Pv): scalar q | k | v, then q / k / v
points, each point block coordinate-major (x | y | z)
and head-major inside; ``rot`` (B, L, 3, 3), ``trans`` (B, L, 3) f32;
``mask`` (B, L); ``head_weights`` (H,) raw. Returns (B, L, H*Ch + 4*H*Pv):
scalars | x | y | z | norms (reference src/mdgen/model/ipa.py:250-253).
"""
from __future__ import annotations

import math

import torch

from . import _cuda
from .rope_attention import SMEM_BYTES

_INF = 1e5
_ARGTYPES = [_cuda.P, _cuda.I64, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.P]
RESIDENT_MAX_L = 64  # the resident form up to here, the key-tiled form above
REGISTER_WIDTHS = (32, 8, 8)  # (Ch, Pq, Pv) the tiled form keeps in registers


def resident_bytes(L: int, Ch: int, Pq: int, Pv: int) -> int:
    """Shared memory of the resident form: frames, mask, scalars, lifted
    points and the L x L logits of one (element, head), f32."""
    return 4 * (13 * L + 3 * L * Ch + 3 * L * (2 * Pq + Pv) + L * L)


def tiled_bytes(Ch: int, Pq: int, Pv: int) -> int:
    """Shared memory of the tiled form at widths other than
    ``REGISTER_WIDTHS`` (csrc/ipa_attention.cu ``tiled_any_floats``): a
    64-key tile, the 64 x 65 logits and 64 queries' state, f32."""
    keys = 64 * (2 * Ch + 3 * Pq + 3 * Pv + 1)
    return 4 * (keys + 64 * 65 + 64 * (2 * Ch + 3 * Pq + 3 * Pv))


def proj_width(H: int, Ch: int, Pq: int, Pv: int) -> int:
    return 3 * H * Ch + 6 * H * Pq + 3 * H * Pv


def feat_width(H: int, Ch: int, Pv: int) -> int:
    return H * Ch + 4 * H * Pv


def ipa_attention_math(proj, rot, trans, mask, head_weights, *, H: int, Ch: int,
                       Pq: int, Pv: int, out_dtype=None):
    """The plain PyTorch math of ``ipa_attention`` (same arguments), counted
    nowhere; the scalar path runs in proj's dtype, the point path in f32."""
    B, L, _ = proj.shape
    HCh, HPq, HPv = H * Ch, H * Pq, H * Pv
    q = proj[..., :HCh].reshape(B, L, H, Ch)
    k = proj[..., HCh:2 * HCh].reshape(B, L, H, Ch)
    v = proj[..., 2 * HCh:3 * HCh].reshape(B, L, H, Ch)
    o0 = 3 * HCh

    def points(lo, HP, P):
        t = proj[..., lo:lo + 3 * HP].float().reshape(B, L, 3, HP).transpose(-1, -2)
        # lift to the global frame: R p + t, per residue
        g = (rot[:, :, None] * t[..., None, :]).sum(-1) + trans[:, :, None]
        return g.reshape(B, L, H, P, 3)

    q_pts = points(o0, HPq, Pq)
    k_pts = points(o0 + 3 * HPq, HPq, Pq)
    v_pts = points(o0 + 6 * HPq, HPv, Pv)

    a = torch.einsum("bqhc,bkhc->bhqk", q, k) * math.sqrt(1.0 / (3 * Ch))
    hw = torch.nn.functional.softplus(head_weights.float()) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
    sum_sq = (q_pts ** 2).sum(-1).sum(-1)  # (B, L, H)
    sum_sk = (k_pts ** 2).sum(-1).sum(-1)
    cross = torch.einsum("bqhpx,bkhpx->bhqk", q_pts, k_pts)
    pt_att = sum_sq.transpose(-1, -2)[..., :, None] + sum_sk.transpose(-1, -2)[..., None, :] - 2 * cross
    a = a + pt_att * hw[:, None, None] * (-0.5)
    square = mask[:, :, None] * mask[:, None, :]
    a = a + (_INF * (square - 1))[:, None]
    a = torch.softmax(a.float(), dim=-1)

    o = torch.einsum("bhqk,bkhc->bqhc", a.to(v.dtype), v).reshape(B, L, HCh)
    o_pt = torch.einsum("bhqk,bkhpx->bqhpx", a, v_pts).reshape(B, L, HPv, 3)
    o_pt = ((o_pt - trans[:, :, None])[..., :, None] * rot[:, :, None]).sum(-2)  # R^T (g - t)
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + 1e-8)
    dt = out_dtype or proj.dtype
    return torch.cat([o.to(dt), o_pt[..., 0].to(dt), o_pt[..., 1].to(dt), o_pt[..., 2].to(dt),
                      o_pt_norm.to(dt)], dim=-1)


def ipa_attention_plain(proj, rot, trans, mask, head_weights, **kw):
    """Plain PyTorch version of ``ipa_attention`` (same arguments); counts
    its calls on CUDA tensors in ``cuda_calls``."""
    if proj.is_cuda:
        ipa_attention_plain.cuda_calls += 1
    return ipa_attention_math(proj, rot, trans, mask, head_weights, **kw)


ipa_attention_plain.cuda_calls = 0


def ipa_attention(proj, rot, trans, mask, head_weights, *, H: int, Ch: int, Pq: int,
                  Pv: int, out_dtype=None):
    """The IPA core: the kernel on CUDA tensors, the plain version on CPU
    tensors (see the module docstring). The kernel writes bf16 features."""
    if not proj.is_cuda:
        return ipa_attention_plain(proj, rot, trans, mask, head_weights, H=H, Ch=Ch,
                                   Pq=Pq, Pv=Pv, out_dtype=out_dtype)
    B, L, W = proj.shape
    if W != proj_width(H, Ch, Pq, Pv) or proj.dtype != torch.float32 or not proj.is_contiguous():
        raise ValueError("ipa_attention: proj must be a contiguous f32 (B, L, proj_width) tensor")
    for name, t, shape in (("rot", rot, (B, L, 3, 3)), ("trans", trans, (B, L, 3)),
                           ("mask", mask, (B, L)), ("head_weights", head_weights, (H,))):
        if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"ipa_attention: {name} must be a contiguous f32 {shape} tensor")
    if out_dtype not in (None, torch.bfloat16):
        raise ValueError("ipa_attention: the kernel writes bf16 features")
    tiled = L > RESIDENT_MAX_L
    if tiled and (Ch, Pq, Pv) != REGISTER_WIDTHS and tiled_bytes(Ch, Pq, Pv) > SMEM_BYTES:
        raise ValueError(f"ipa_attention: the key-tiled kernel needs "
                         f"{tiled_bytes(Ch, Pq, Pv):,} bytes of shared memory at (Ch, Pq, Pv) = "
                         f"{(Ch, Pq, Pv)}, more than the {SMEM_BYTES:,} a block may use")
    if not tiled and resident_bytes(L, Ch, Pq, Pv) > SMEM_BYTES:
        raise ValueError(f"ipa_attention: the resident kernel needs "
                         f"{resident_bytes(L, Ch, Pq, Pv):,} bytes of shared memory at L = {L}, "
                         f"more than the {SMEM_BYTES:,} a block may use")
    F = feat_width(H, Ch, Pv)
    out = torch.empty(B, L, F, dtype=torch.bfloat16, device=proj.device)
    lib = _cuda.library("ipa_attention", _ARGTYPES)
    code = lib.ipa_attention(proj.data_ptr(), W, rot.data_ptr(), trans.data_ptr(),
                             mask.data_ptr(), head_weights.data_ptr(), out.data_ptr(), F,
                             B, L, H, Ch, Pq, Pv, int(tiled), _cuda.stream_ptr(proj))
    _cuda.check(code, "ipa_attention")
    ipa_attention.launches += 1
    return out


ipa_attention.launches = 0
