"""The "outsourced" denoiser policies of the RTB chain.

Counterpart of the JAX package's ``rtb/denoisers.py`` (reference
src/rtb_utils/denoisers.py: a guided-diffusion UNet at :13-503 and
``UNet3DSeqModel`` at :504-636, which folds (B, T, L, D) into per-frame
images). The MDGen fine-tune path conditions the ``LatentMDGen`` denoiser;
these are the alternative DDPM policies:

- ``UNetSeqDenoiser``: a light per-frame conv UNet along the residue axis;
- ``UNet2D`` / ``UNet3DSeq``: the guided-diffusion UNet (per-level residual
  stacks with channel multipliers, self-attention at the configured
  downsample rates, FiLM / scale-shift timestep conditioning, learned up-
  and downsampling, optional class labels, a zero-initialised output conv)
  and its per-frame fold.

Their convolutions, GroupNorms and attention are plain PyTorch ops, as they
are plain XLA ops in the JAX package: no TPU kernel lies under them. The
layout is PyTorch's channels-first (``UNet2D`` takes (N, C, H, W), the JAX
package's (N, H, W, C)); the values are the same: flax's "SAME" padding
(the stride-2 conv pads (0, 1) on an even side), its GroupNorm eps 1e-6 and
its group counts, the attention's f32 softmax over 1/sqrt(head dim) logits.

Every submodule carries flax's auto-name (``Conv_0``, ``Dense_1``,
``ResBlock2D_3``, ``qkv``, ``proj_out``), given in flax's creation order, so
a Linear's path (``UNet2D_0/ResBlock2D_3/Dense_0/kernel``) is the path of
its kernel in the JAX package's tree: ``utils.weights.unet_from_flax``
carries the weights across leaf by leaf, and ``rtb.lora`` keys adapters by
the strings JAX's ``lora_targets`` sees. The initializers are flax's: Conv
lecun-normal, Dense xavier-uniform, biases 0, GroupNorm 1 / 0, the final
conv, each ResBlock's second conv and ``proj_out`` zero. The modules
compute in their parameters' dtype (f32, or after ``.to(torch.bfloat16)``)
and return f32, as the JAX package's ``dtype`` field does; the port takes
the input's width (``in_channels``, ``in_dim``), which flax infers.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import timestep_embedding

_EPS = 1e-6  # flax GroupNorm


def _lecun_(w: torch.Tensor) -> torch.Tensor:
    """flax's lecun_normal: truncated normal (+-2 sd) of variance 1 / fan_in."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _conv(dims: int, cin: int, cout: int, k: int, zero: bool = False, stride: int = 1):
    cls = nn.Conv1d if dims == 1 else nn.Conv2d
    conv = cls(cin, cout, k, stride=stride, padding=k // 2 if stride == 1 else 0)
    nn.init.zeros_(conv.bias)
    nn.init.zeros_(conv.weight) if zero else _lecun_(conv.weight)
    return conv


def _dense(cin: int, cout: int, zero: bool = False) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    nn.init.zeros_(lin.bias)
    nn.init.zeros_(lin.weight) if zero else nn.init.xavier_uniform_(lin.weight)
    return lin


def _group_norm(channels: int) -> nn.GroupNorm:
    """guided-diffusion's normalization: 32 groups, halved until they
    divide the channels."""
    g = 32
    while channels % g:
        g //= 2
    return nn.GroupNorm(max(g, 1), channels, eps=_EPS)


class _Flax(nn.Module):
    """A module whose submodules are registered under flax's auto-names,
    ``<Kind>_<n>`` counted per kind in creation order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def _add(self, kind: str, module: nn.Module) -> nn.Module:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        self.add_module(f"{kind}_{n}", module)
        return module


class ResBlock1D(nn.Module):
    """GN-SiLU-conv, the timestep embedding added, GN-SiLU-conv, a 1-wide
    conv on the skip when the widths differ; (N, C, L)."""

    def __init__(self, in_channels: int, channels: int, emb_channels: int):
        super().__init__()
        groups = min(8, channels)
        self.GroupNorm_0 = nn.GroupNorm(groups, in_channels, eps=_EPS)
        self.Conv_0 = _conv(1, in_channels, channels, 3)
        self.Dense_0 = _dense(emb_channels, channels)
        self.GroupNorm_1 = nn.GroupNorm(groups, channels, eps=_EPS)
        self.Conv_1 = _conv(1, channels, channels, 3)
        if in_channels != channels:  # the skip's projection
            self.Conv_2 = _conv(1, in_channels, channels, 1)

    def forward(self, x, t_emb):
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        h = h + self.Dense_0(F.silu(t_emb))[:, :, None]
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
        return (self.Conv_2(x) if hasattr(self, "Conv_2") else x) + h


class UNetSeqDenoiser(nn.Module):
    """Per-frame residue-axis UNet: (B, T, L, D) folded to (B T) sequences
    of L residues with D channels. The frames share the timestep embedding
    and do not mix (as ``UNet3DSeqModel``'s per-frame fold,
    denoisers.py:560-610); the output head starts at zero."""

    def __init__(self, out_dim: int, widths: Sequence[int] = (64, 128),
                 in_dim: Optional[int] = None):
        super().__init__()
        self.out_dim, self.widths = out_dim, tuple(widths)
        w0 = self.widths[0]
        self.Conv_0 = _conv(1, out_dim if in_dim is None else in_dim, w0, 3)  # the stem
        self.Dense_0 = _dense(128, w0)
        ch, n = w0, len(self.widths)
        for i, w in enumerate(self.widths):
            setattr(self, f"ResBlock1D_{i}", ResBlock1D(ch, w, w0))
            ch = w
        setattr(self, f"ResBlock1D_{n}", ResBlock1D(ch, ch, w0))  # the middle
        for i, w in enumerate(reversed(self.widths)):
            setattr(self, f"ResBlock1D_{n + 1 + i}", ResBlock1D(ch + w, w, w0))
            ch = w
        self.Conv_1 = _conv(1, ch, out_dim, 3, zero=True)  # the head

    def forward(self, x, t, mask=None, **_):
        B, T, L, D = x.shape
        dtype = self.Conv_0.weight.dtype  # the module's, after .to(dtype)
        h = x.reshape(B * T, L, D).transpose(1, 2).to(dtype)
        tt = (torch.as_tensor(t, dtype=torch.float32, device=x.device)
              * torch.ones(B, device=x.device)).repeat_interleave(T)
        t_emb = self.Dense_0(timestep_embedding(tt, 128).to(dtype))
        h = self.Conv_0(h)
        n = len(self.widths)
        skips = []
        for i in range(n):
            h = getattr(self, f"ResBlock1D_{i}")(h, t_emb)
            skips.append(h)
        h = getattr(self, f"ResBlock1D_{n}")(h, t_emb)
        for i, s in enumerate(reversed(skips)):
            h = getattr(self, f"ResBlock1D_{n + 1 + i}")(torch.cat([h, s], dim=1), t_emb)
        out = self.Conv_1(h)
        return out.transpose(1, 2).reshape(B, T, L, self.out_dim).float()


# ---------------------------------------------------------------------------
# The guided-diffusion UNet (src/rtb_utils/denoisers.py:13-278)
# ---------------------------------------------------------------------------
def _upsample_nearest(x):
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _avg_pool(x):
    return F.avg_pool2d(x, 2, 2)


class ResBlock2D(nn.Module):
    """Guided-diffusion ResBlock: GN-SiLU (up / down sampled), conv, the
    timestep FiLM (``use_scale_shift_norm``) or an added embedding, GN-SiLU,
    dropout, a zero-initialised conv; a 1x1 conv on the skip when the widths
    differ."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 dropout: float = 0.0, use_scale_shift_norm: bool = True, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.dropout, self.use_scale_shift_norm = dropout, use_scale_shift_norm
        self.up, self.down = up, down
        self.GroupNorm_0 = _group_norm(in_channels)
        self.Conv_0 = _conv(2, in_channels, out_channels, 3)
        self.Dense_0 = _dense(emb_channels,
                              2 * out_channels if use_scale_shift_norm else out_channels)
        self.GroupNorm_1 = _group_norm(out_channels)
        self.Conv_1 = _conv(2, out_channels, out_channels, 3, zero=True)
        if in_channels != out_channels:  # the skip's projection
            self.Conv_2 = _conv(2, in_channels, out_channels, 1)

    def forward(self, x, emb, deterministic: bool = True):
        h = F.silu(self.GroupNorm_0(x))
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = _avg_pool(h), _avg_pool(x)
        h = self.Conv_0(h)
        emb_out = self.Dense_0(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = self.GroupNorm_1(h) * (1 + scale) + shift
        else:
            h = self.GroupNorm_1(h + emb_out)
        h = F.dropout(F.silu(h), self.dropout, training=not deterministic)
        h = self.Conv_1(h)
        return (self.Conv_2(x) if hasattr(self, "Conv_2") else x) + h


class AttentionBlock2D(nn.Module):
    """Self-attention over the H W positions: GroupNorm, one ``qkv`` Dense
    split into heads, the softmax in f32 over logits scaled by 1/sqrt(head
    dim), a zero-initialised ``proj_out``, the residual."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1):
        super().__init__()
        self.heads = channels // num_head_channels if num_head_channels > 0 else num_heads
        self.GroupNorm_0 = _group_norm(channels)
        self.qkv = _dense(channels, 3 * channels)
        self.proj_out = _dense(channels, channels, zero=True)

    def forward(self, x):
        N, C, H, W = x.shape
        hd = C // self.heads
        h = self.GroupNorm_0(x).flatten(2).transpose(1, 2)  # (N, HW, C)
        q, k, v = self.qkv(h).reshape(N, H * W, 3, self.heads, hd).unbind(2)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(N, H * W, C)
        return x + self.proj_out(out).transpose(1, 2).reshape(N, C, H, W)


class Downsample2D(nn.Module):
    """The stride-2 3x3 conv with flax's "SAME" padding, or a 2x2 average."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.Conv_0 = _conv(2, channels, channels, 3, stride=2)

    def forward(self, x):
        if not hasattr(self, "Conv_0"):
            return _avg_pool(x)
        pads = []
        for n in (x.shape[-1], x.shape[-2]):  # F.pad's order: the last axis first
            total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        return self.Conv_0(F.pad(x, pads))


class Upsample2D(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.Conv_0 = _conv(2, channels, channels, 3)

    def forward(self, x):
        x = _upsample_nearest(x)
        return self.Conv_0(x) if hasattr(self, "Conv_0") else x


class UNet2D(_Flax):
    """The guided-diffusion UNet over (N, ``in_channels``, H, W): a conv
    stem; per level ``num_res_blocks`` ResBlocks at ``mult`` x
    ``model_channels`` with attention where the downsample rate is in
    ``attention_resolutions``; a middle Res-Attn-Res; a decoder over the
    concatenated skips; GN-SiLU-zero-conv head (src/rtb_utils/
    denoisers.py:43-278). ``in_channels`` is the input's width, which flax
    infers."""

    def __init__(self, in_channels: int = 1, model_channels: int = 32, out_channels: int = 1,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (2,),
                 dropout: float = 0.0, channel_mult: Sequence[int] = (1, 2),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = True, resblock_updown: bool = False):
        super().__init__()
        mc, emb_ch = model_channels, 4 * model_channels
        self.model_channels, self.num_classes = mc, num_classes
        self.Dense_0 = _dense(mc, emb_ch)
        self.Dense_1 = _dense(emb_ch, emb_ch)
        if num_classes is not None:
            self.Embed_0 = nn.Embedding(num_classes, emb_ch)
            nn.init.normal_(self.Embed_0.weight, std=1.0 / math.sqrt(num_classes))

        def res(cin, cout, **kw):
            return self._add("ResBlock2D", ResBlock2D(
                cin, cout, emb_ch, dropout=dropout, use_scale_shift_norm=use_scale_shift_norm,
                **kw))

        def attn(ch):
            return self._add("AttentionBlock2D",
                             AttentionBlock2D(ch, num_heads, num_head_channels))

        # the forward's plan: ("res" | "attn" | "push" | "pop+res" | "resample", module)
        ch = channel_mult[0] * mc
        self.Conv_0 = _conv(2, in_channels, ch, 3)  # the stem
        plan, skips, ds = [("push", None)], [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                plan.append(("res", res(ch, mult * mc)))
                ch = mult * mc
                if ds in attention_resolutions:
                    plan.append(("attn", attn(ch)))
                plan.append(("push", None))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                plan.append(("res", res(ch, ch, down=True)) if resblock_updown else
                            ("resample", self._add("Downsample2D",
                                                   Downsample2D(ch, conv_resample))))
                plan.append(("push", None))
                skips.append(ch)
                ds *= 2
        plan += [("res", res(ch, ch)), ("attn", attn(ch)), ("res", res(ch, ch))]
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                plan.append(("pop+res", res(ch + skips.pop(), mult * mc)))
                ch = mult * mc
                if ds in attention_resolutions:
                    plan.append(("attn", attn(ch)))
                if level and i == num_res_blocks:
                    plan.append(("res", res(ch, ch, up=True)) if resblock_updown else
                                ("resample", self._add("Upsample2D",
                                                       Upsample2D(ch, conv_resample))))
                    ds //= 2
        self.plan = plan
        self.GroupNorm_0 = _group_norm(ch)
        self.Conv_1 = _conv(2, ch, out_channels, 3, zero=True)  # the head

    def forward(self, x, timesteps, y=None, deterministic: bool = True):
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("pass y exactly when the UNet has num_classes")
        dtype = self.Conv_0.weight.dtype  # the module's, after .to(dtype)
        temb = timestep_embedding(torch.as_tensor(timesteps, device=x.device).reshape(-1),
                                  self.model_channels).to(dtype)
        emb = self.Dense_1(F.silu(self.Dense_0(temb)))
        if y is not None:
            emb = emb + self.Embed_0(y)
        h = self.Conv_0(x.to(dtype))
        hs = []
        for kind, mod in self.plan:
            if kind == "push":
                hs.append(h)
            elif kind == "res":
                h = mod(h, emb, deterministic)
            elif kind == "pop+res":
                h = mod(torch.cat([h, hs.pop()], dim=1), emb, deterministic)
            else:  # attn, resample
                h = mod(h)
        return self.Conv_1(F.silu(self.GroupNorm_0(h))).float()


class UNet3DSeq(nn.Module):
    """``UNet3DSeqModel`` (src/rtb_utils/denoisers.py:504-561): the frames
    folded into the batch, (B, T, L, D) -> (B T, 1, L, D), one ``UNet2D``
    image per frame with the frame's timestep embedding, then unfolded. The
    (L, D) plane is padded up to a multiple of 2^(levels - 1) (D = 21 ->
    22) and cropped back; a scalar or (B,) t is repeated over the frames; a
    final Dense maps D to ``out_dim`` when they differ. Called as the RTB
    policies are, (x, t, **condition), surplus condition keys ignored."""

    def __init__(self, out_dim: int, model_channels: int = 32, num_res_blocks: int = 2,
                 channel_mult: Sequence[int] = (1, 2), attention_resolutions: Sequence[int] = (2,),
                 num_head_channels: int = 16, dropout: float = 0.0,
                 num_classes: Optional[int] = None, in_dim: Optional[int] = None):
        super().__init__()
        self.out_dim, self.levels = out_dim, len(channel_mult)
        self.UNet2D_0 = UNet2D(
            in_channels=1, model_channels=model_channels, out_channels=1,
            num_res_blocks=num_res_blocks, attention_resolutions=tuple(attention_resolutions),
            dropout=dropout, channel_mult=tuple(channel_mult), num_classes=num_classes,
            num_head_channels=num_head_channels)
        self.in_dim = out_dim if in_dim is None else in_dim
        if self.in_dim != out_dim:
            self.Dense_0 = _dense(self.in_dim, out_dim)

    def forward(self, x, t, y=None, mask=None, deterministic: bool = True, **_):
        B, T, L, D = x.shape
        h = x.reshape(B * T, 1, L, D)
        m = 1 << (self.levels - 1)
        Lp, Dp = -(-L // m) * m, -(-D // m) * m
        if (Lp, Dp) != (L, D):
            h = F.pad(h, (0, Dp - D, 0, Lp - L))
        tt = torch.as_tensor(t, dtype=torch.float32, device=x.device) * torch.ones(
            B, device=x.device)
        yy = y.repeat_interleave(T) if y is not None else None
        out = self.UNet2D_0(h, tt.repeat_interleave(T), y=yy, deterministic=deterministic)
        out = out[:, 0, :L, :D].reshape(B, T, L, D)
        if not hasattr(self, "Dense_0"):
            return out
        return self.Dense_0(out.to(self.Dense_0.weight.dtype)).float()
