"""The prepend-IPA conditioning encoder: NL IPALayers over (B, L) tokens.

Counterpart of the JAX package's ``ops/ipa_encoder.py::ipa_encoder``
(reference src/mdgen/model/latent_model.py:179-214, 341-394). The TPU ran
the whole stack as one streaming kernel; here each layer is a sequence of
the hand-written kernels:

    proj  = adaln_linear(affine LN eps 1e-5)     scalar + point projections
    feats = ipa_attention(proj, frames, mask)    IPA core
    x    += feats @ linear_out                   (adaln_linear, gate_res)
    qkv   = adaln_linear(LN + modulate)          residue MHA
    att   = rope_attention(B, L, 1), natural-exp softmax
    x    += g_l * (att @ out_m)
    hid   = adaln_linear(LN + modulate, GELU)    MLP
    x    += g_m * (hid @ w2)

On CPU tensors every op runs its plain PyTorch version, so the same code is
the plain twin of the JAX package's ``encoder_xla``.
"""
from __future__ import annotations

import torch

from ..geometry.rigid import Rigid
from .adaln_linear import adaln_linear
from .ipa_attention import ipa_attention
from .rope_attention import rope_attention

# per-layer weight names (LatentMDGen.make_encoder_pack)
ENC_KEYS = ("ln_w", "ln_b", "wproj", "bproj", "head_weights", "wo_i", "bo_i",
            "wqkv_m", "bqkv_m", "wo_m", "bo_m", "bkm", "bvm", "w1", "b1", "w2", "b2")


def ipa_encoder(x, mods, ws, frames: Rigid, mask, *, num_heads_mha: int, Hi: int,
                Ch: int, Pq: int, Pv: int):
    """x (Bn, L, C) tokens; mods (nb, NL*6*C) AdaLN rows, nb dividing Bn
    (consecutive elements share a row); ``ws`` a list of per-layer dicts
    (``ENC_KEYS``); frames Rigid (Bn, L); mask (Bn, L). Returns (Bn, L, C)."""
    Bn, L, C = x.shape
    h = x.reshape(Bn * L, C).clone()
    rot = frames.rot.to(torch.float32).contiguous()
    trans = frames.trans.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    for i, w in enumerate(ws):
        mod = mods[:, i * 6 * C:(i + 1) * 6 * C]

        def m(j, mod=mod):
            return mod[:, j * C:(j + 1) * C]

        proj = adaln_linear(h, w["wproj"], w["bproj"], ln="affine", ln_weight=w["ln_w"],
                            ln_bias=w["ln_b"], out_dtype=torch.float32)
        feats = ipa_attention(proj.view(Bn, L, -1), rot, trans, mask, w["head_weights"],
                              H=Hi, Ch=Ch, Pq=Pq, Pv=Pv, out_dtype=h.dtype)
        adaln_linear(feats.view(Bn * L, -1), w["wo_i"], w["bo_i"], epilogue="gate_res",
                     res=h, out=h)
        qkv = adaln_linear(h, w["wqkv_m"], w["bqkv_m"], ln="plain", shift=m(0), scale=m(1))
        att = rope_attention(qkv.view(Bn, L, 1, 3 * C), w["bkm"], w["bvm"],
                             mask.view(Bn, L, 1), num_heads=num_heads_mha, base2=False)
        adaln_linear(att.view(-1, C), w["wo_m"], w["bo_m"], epilogue="gate_res", res=h,
                     gate=m(2), out=h)
        hid = adaln_linear(h, w["w1"], w["b1"], ln="plain", shift=m(3), scale=m(4),
                           epilogue="gelu")
        adaln_linear(hid, w["w2"], w["b2"], epilogue="gate_res", res=h, gate=m(5), out=h)
    return h.view(Bn, L, C)
