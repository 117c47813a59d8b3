"""SiT-style latent denoiser with factorized frame x residue attention.

Counterpart of the JAX package's ``models/denoiser.py::LatentMDGen``
(reference src/mdgen/model/latent_model.py:43-326) for every frames task:
forward simulation, upsampling, transition paths, inpainting / design and
(dynamic) mpnn, with or without the prepend-IPA encoder and the absolute
position/time tables. With the doubled offsets (``tps_condition``,
``inpainting``, ``dynamic_mpnn``) the encoder runs on two token sets, the end
frames seen from the start frames and the reverse, and sums the two passes
(``run_ipa``). With ``design`` the latent carries 20 simplex channels: the
encoder's tokens gain ``x_d_to_emb`` of their mean over frames at every
evaluation, the trunk runs without the folded head, and the design head
(``fc1``, ``fc2``, a mean over frames, ``fc3``, ``emb_to_logits``) adds
sequence logits to the head's last 20 channels; ``forward_inference`` turns
them into the Dirichlet conditional flow. ``mpnn`` / ``dynamic_mpnn`` keep
frame 0 (and T-1) and return the logits alone. Parameters are named after
the flax tree (``layers_3/mha_t/q_proj/kernel`` ->
``layers.3.mha_t.q_proj.weight``); ``utils.weights.from_flax`` converts a
JAX checkpoint.

The trunk takes one of JAX's branches of ``LatentMDGenLayer`` (:246-330):
- the fused branch (the default configs, and ``dropout > 0`` at inference,
  where JAX's ``train`` is False): ``ops/fused_layer.py``, every attention
  with the base-2 softmax fold; with ``interleave_ipa`` each layer runs its
  IPA first (``models/ipa.ipa_block``), then the fused layer (JAX
  :259-285: its gate at :270 keeps ``interleave_ipa`` alone on
  ``fused_layer``), in sampling and in training (``FusedLayerFn``);
- the modular branch (``hyena``, ``no_rope``, and every configuration in
  training with ``dropout > 0``): ``LatentMDGenLayer.forward``, a per-layer
  IPA with ``interleave_ipa``, then ``MultiheadAttention`` over residues
  and over frames (or Hyena, or dense attention without RoPE) with the
  natural softmax, each an ``ops/modular_stage.adaln_stage``, then
  ``adaln_mlp``. With dropout the attention runs on dense probabilities
  with the keep masks of ``models.layers.Dropout`` (JAX :270, flax's
  ``rngs={"dropout": ...}``), and the prepend encoder takes the plain
  ``IPALayer`` path (JAX :361) with its IPA and MHA masks.

Three ways to run it, as in the JAX package:
- ``forward(x, t, mask, ...)``: the plain call (``__call__``, :608-740),
  differentiable on every branch, in the parameters (the training path)
  and in x (the log-likelihood's VJP; ``refuse_input_grad`` refuses only
  the design tasks);
- ``forward_inference(x, t, mask, ...)``: the same velocity without
  gradients, for the generic ODE samplers (heun, dopri5; every sampler of
  the modular branch and of ``interleave_ipa``);
- the flat sampling path of the fused branch: ``make_trunk_pack`` (weights
  folded and stacked once per sample), ``make_scan_consts``
  (per-step-constant embed terms), ``embed_times`` / ``embed_mods`` /
  ``encode_steps`` (the whole t grid's t-embeddings, AdaLN rows and
  encoder outputs at once), then one ``flat_call`` per Euler step, which
  updates the f32 latent carry (B, T, L, lat) in place.

``self.dtype`` is the compute dtype (bf16 on the card, f32 in the CPU
tests); parameters stay f32 and packs are cast once.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..config import MDGenConfig
from ..geometry.rigid import Rigid
from ..ops.adaln_linear import adaln_linear
from ..ops.adaln_mlp import adaln_mlp_train
from ..ops.fused_layer import (FinalLayerFn, fused_layer_train, fused_trunk, fused_trunk_train,
                               trunk_layer)
from ..ops.ipa_encoder import ipa_encoder
from ..ops.modular_stage import adaln_stage
from ..transport.dirichlet import DirichletConditionalFlow, simplex_proj
from ..transport.transport import t_to_alpha
from .attention import MHAParams, MultiheadAttention
from .attention_core import LOG2E
from .hyena import HyenaOperator
from .ipa import IPAParams, ipa_block
from .layers import TimestepEmbedder, gelu_erf, sincos_pos_embed


class IPALayer(nn.Module):
    """Conditioning-encoder block parameters: IPA + residue MHA + MLP with
    6-way AdaLN (src/mdgen/model/latent_model.py:341-394)."""

    def __init__(self, cfg: MDGenConfig):
        super().__init__()
        m = cfg.model
        C = m.embed_dim
        self.adaLN = nn.Linear(C, 6 * C)
        self.ipa_norm = nn.LayerNorm(C, eps=1e-5)
        self.ipa = IPAParams(C, m.ipa_heads, m.ipa_head_dim, m.ipa_qk, m.ipa_v)
        self.mha_l = MHAParams(C)
        self.fc1 = nn.Linear(C, 4 * C)
        self.fc2 = nn.Linear(4 * C, C)


def modular(cfg: MDGenConfig) -> bool:
    """True when the trunk's layers take the modular branch of
    LatentMDGenLayer whatever the call: ``hyena`` or ``no_rope`` (JAX :270;
    ``interleave_ipa`` alone runs its IPA and then the fused layer, and
    ``dropout > 0`` takes the modular branch only in training)."""
    m = cfg.model
    return bool(m.hyena or m.no_rope)


def _ipa_weights(ln: nn.LayerNorm, ipa: IPAParams, dt) -> dict:
    """An IPA block's weights for ops/adaln_linear and ops/ipa_attention: the
    affine LayerNorm (f32), the six projections as one (C, proj) weight, the
    head weights (f32) and linear_out (the JAX package's
    ``fold_encoder_ws`` split)."""
    wproj, bproj = ipa.projections()
    return dict(ln_w=ln.weight.float().contiguous(), ln_b=ln.bias.float().contiguous(),
                wproj=wproj.to(dt).contiguous(), bproj=bproj.to(dt),
                head_weights=ipa.head_weights.float().contiguous(),
                wo_i=_t(ipa.linear_out, dt), bo_i=ipa.linear_out.bias.to(dt))


class LatentMDGenLayer(nn.Module):
    """One trunk layer (src/mdgen/model/latent_model.py:397-493): 9-way
    AdaLN, residue and frame attention, MLP; with ``interleave_ipa`` an
    affine LayerNorm and IPA first, with ``hyena`` a Hyena operator as the
    frame stage (``mha_t``).

    ``forward`` runs one layer on the pack ``make_trunk_pack`` made for
    the call's branch. With ``interleave_ipa`` it first adds the IPA of an
    affine LayerNorm (``ipa_block``: frame 0's rigids for every frame,
    frame_mask = mask). A fused pack (``ops/fused_layer.LAYER_KEYS``) then
    runs ``trunk_layer`` (``fused_layer_train`` with gradients). A modular
    pack runs the JAX package's modular branch (:288-330), in its order:

        h += g_l * mha_l(modulate(LN(h)))      over residues
        h += g_t * mha_t(modulate(LN(h)))      over frames: attention, Hyena,
                                                 or dense attention (no_rope)
        h  = adaln_mlp(h)

    Each attention or Hyena stage is an ``ops/modular_stage.adaln_stage``:
    the LayerNorm + modulate inside its first product and the gate and
    residual inside its last (``ops/adaln_linear``'s prologue and
    ``gate_res`` epilogue), with a backward on ``linear_bwd`` /
    ``modln_bwd``; the MLP is ``AdaLNMLPFn``. The cores are
    ``ops/residue_attention`` / ``ops/time_attention`` (natural softmax),
    ``ops/fused_attention`` (``no_rope``), Hyena's FFT convolution, and
    with dropout the dense probabilities of ``dense_attn_dropout``."""

    def __init__(self, cfg: MDGenConfig):
        super().__init__()
        m = cfg.model
        C, H = m.embed_dim, m.mha_heads
        self.adaLN = nn.Linear(C, 9 * C)
        if m.interleave_ipa:
            self.ipa_norm = nn.LayerNorm(C, eps=1e-5)
            self.ipa = IPAParams(C, m.ipa_heads, m.ipa_head_dim, m.ipa_qk, m.ipa_v)
        self.mha_l = MultiheadAttention(C, H, use_rope=not m.no_rope)
        self.mha_t = (HyenaOperator(C, l_max=cfg.data.num_frames, order=2,
                                    filter_order=m.hyena_filter_order) if m.hyena
                      else MultiheadAttention(C, H, use_rope=not m.no_rope))
        self.fc1 = nn.Linear(C, 4 * C)
        self.fc2 = nn.Linear(4 * C, C)

    def fold(self, dt) -> dict:
        """The modular branch's weights in the products' layout and dtype
        ``dt``, made once per sample (``make_trunk_pack``)."""
        w = dict(l=self.mha_l.fold(dt), w1=_t(self.fc1, dt), b1=self.fc1.bias.to(dt),
                 w2=_t(self.fc2, dt), b2=self.fc2.bias.to(dt))
        if isinstance(self.mha_t, HyenaOperator):
            w["t"] = dict(w_in=_t(self.mha_t.in_proj, dt), b_in=self.mha_t.in_proj.bias.to(dt),
                          wout=_t(self.mha_t.out_proj, dt), bout=self.mha_t.out_proj.bias.to(dt))
        else:
            w["t"] = self.mha_t.fold(dt)
        if hasattr(self, "ipa"):
            w["ipa"] = _ipa_weights(self.ipa_norm, self.ipa, dt)
        return w

    def hyena_core(self, B: int, T: int, L: int):
        """Hyena between its two products as ``core(u (M, 3C), *params) ->
        (M, C)`` for ``adaln_stage``, with the operator's other parameters
        (``params``: those that are not ``in_proj`` / ``out_proj``)."""
        hy = self.mha_t
        C = hy.d_model
        params = [p for n, p in hy.named_parameters() if not n.startswith(("in_proj", "out_proj"))]

        def core(u, *_params):
            y = hy.mix(u.view(B, T, L, 3 * C).permute(0, 2, 3, 1).reshape(B * L, 3 * C, T))
            return y.view(B, L, C, T).permute(0, 3, 1, 2).reshape(B * T * L, C)
        return core, params

    def forward(self, h, mod, mask, w, frames=None, *, dropout=None, path: str = "",
                remat: bool = False):
        """h (M, C) with M = B*T*L rows (b, t, l); mod (nb, 9C) this layer's
        AdaLN rows; mask (B, T, L) f32; ``w`` this layer's entry of the
        pack; ``frames`` = (rot (B*T, L, 3, 3), trans (B*T, L, 3)) f32,
        frame 0's rigids for every frame (``interleave_ipa``); ``dropout``
        (``models.layers.Dropout``) with this layer's flax ``path``
        (``layers_3``); ``remat``: ``grad_checkpointing`` for the fused
        layer. Differentiable when grad mode is on. Returns the new h
        (M, C)."""
        B, T, L = mask.shape
        M, C = h.shape

        def m(j):
            return mod[:, j * C:(j + 1) * C]

        def drop(name):
            return None if dropout is None else functools.partial(dropout, f"{path}/{name}")

        if "ipa" in w:
            ipa = self.ipa
            h = ipa_block(h, w["ipa"], frames[0], frames[1], mask.view(B * T, L), H=ipa.H,
                          Ch=ipa.Ch, Pq=ipa.Pq, Pv=ipa.Pv, dropout=drop("ipa"))
        if "wqkv_l" in w:  # the fused layer
            if torch.is_grad_enabled():
                return fused_layer_train(h, mod, w, mask, num_heads=self.mha_l.num_heads,
                                         remat=remat)
            trunk_layer(h, mod, w, mask, B=B, T=T, L=L, num_heads=self.mha_l.num_heads, out=h)
            return h

        ada_l = dict(shift=m(0), scale=m(1), gate=m(2), dropout=drop("mha_l"))
        if self.mha_l.use_rope:
            h = self.mha_l(h.view(B, T * L, C), mask, axis="residue", tl=(T, L), w=w["l"],
                           **ada_l)
        else:
            h = self.mha_l(h.view(B * T, L, C), mask.view(B * T, L), w=w["l"], **ada_l)
        h = h.reshape(M, C)

        ada_t = dict(shift=m(3), scale=m(4), gate=m(5), dropout=drop("mha_t"))
        if isinstance(self.mha_t, HyenaOperator):
            wt = w["t"]
            core, params = self.hyena_core(B, T, L)
            h = adaln_stage(h, m(3), m(4), m(5), wt["w_in"], wt["b_in"], wt["wout"], wt["bout"],
                            core, *params)
        elif self.mha_t.use_rope:
            h = self.mha_t(h.view(B, T * L, C), mask, axis="time", tl=(T, L), w=w["t"],
                           **ada_t).reshape(M, C)
        else:
            xt = h.view(B, T, L, C).transpose(1, 2).reshape(B * L, T, C)
            mt = mask.transpose(1, 2).reshape(B * L, T)
            y = self.mha_t(xt, mt, w=w["t"], **ada_t)
            h = y.view(B, L, T, C).transpose(1, 2).reshape(M, C)
        return adaln_mlp_train(h, m(6), m(7), m(8), w["w1"], w["b1"], w["w2"], w["b2"])


class FinalLayer(nn.Module):
    """AdaLN output head parameters (src/mdgen/model/layers.py:58-75)."""

    def __init__(self, C: int, out_channels: int):
        super().__init__()
        self.adaLN = nn.Linear(C, 2 * C)
        self.linear = nn.Linear(C, out_channels)


def refuse_rtb_unported(cfg: MDGenConfig) -> None:
    """Raise ``NotImplementedError`` for the branches whose RTB posterior
    fine-tuning is not ported: the modular layer and dropout (ROADMAP.md
    queue 3). Every model and task branch samples and trains."""
    m = cfg.model
    for name in ("hyena", "no_rope", "interleave_ipa"):
        if getattr(m, name):
            raise NotImplementedError(
                f"RTB fine-tuning with model.{name} is not ported (ROADMAP.md queue 3)")
    if m.dropout > 0.0:
        raise NotImplementedError(
            "RTB fine-tuning with model.dropout is not ported (ROADMAP.md queue 3)")


def refuse_input_grad(cfg: MDGenConfig) -> None:
    """Raise ``NotImplementedError`` where the log-likelihood is not ported:
    the design tasks, whose likelihood the JAX package gives as NaN (ROADMAP
    queue 3): a port would port the NaN."""
    t = cfg.task
    for name in ("design", "mpnn", "dynamic_mpnn"):
        if getattr(t, name):
            raise NotImplementedError(
                f"the log-likelihood of task.{name} is not ported: the JAX package's is NaN "
                "at its data endpoint (ROADMAP.md queue 3, the design log-likelihood)")


def _detached(tree):
    """A pack's tensors as plain tensors (``.to`` may hand back the
    parameter itself)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree.detach() if torch.is_tensor(tree) else tree


def _t(lin: nn.Linear, dt) -> torch.Tensor:
    """nn.Linear weight in the kernels' (in, out) layout."""
    return lin.weight.t().to(dt).contiguous()


class LatentMDGen(nn.Module):
    """Top-level denoiser: forward(x, t, mask, ...) -> velocity latents."""

    def __init__(self, cfg: MDGenConfig, latent_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        task = cfg.task
        if (task.mpnn or task.dynamic_mpnn) and not task.design:
            raise ValueError("task.mpnn / dynamic_mpnn predict the sequence: they need task.design")
        if task.no_frames and cfg.model.prepend_ipa:
            raise ValueError("task.no_frames has no rigids for the prepend-IPA encoder "
                             "(model.prepend_ipa): the JAX package cannot run it either")
        self.cfg = cfg
        m = cfg.model
        C = m.embed_dim
        self.latent_dim = latent_dim or cfg.latent_dim
        self.dtype = dtype
        self.latent_to_emb = nn.Linear(self.latent_dim, C)
        if cfg.doubled_offsets:  # the encoder's two token sets (tps_condition)
            self.latent_to_emb_f = nn.Linear(7, C)
            self.latent_to_emb_r = nn.Linear(7, C)
        # x_cond holds the task's latents without the simplex channels
        self.cond_to_emb = nn.Linear(self.latent_dim - (20 if task.design else 0), C)
        self.mask_to_emb = nn.Embedding(2, C)
        if task.design:
            self.x_d_to_emb = nn.Linear(20, C)
        if m.prepend_ipa:
            if not m.no_aa_emb:
                self.aatype_to_emb = nn.Embedding(21, C)
            self.ipa_layers = nn.ModuleList([IPALayer(cfg) for _ in range(m.num_layers)])
        self.modular = modular(cfg)
        self.layer_ipa = bool(m.interleave_ipa)
        self.layers = nn.ModuleList([LatentMDGenLayer(cfg) for _ in range(m.num_layers)])
        if not (task.mpnn or task.dynamic_mpnn):
            self.emb_to_latent = FinalLayer(C, self.latent_dim)
        if task.design:  # the design head (reference latent_model.py:120-125)
            self.fc1 = nn.Linear(C, C)
            self.fc2 = nn.Linear(C, C)
            self.fc3 = nn.Linear(C, C)
            self.emb_to_logits = nn.Linear(C, 20)
            self.condflow = DirichletConditionalFlow(K=20, alpha_spacing=0.001,
                                                     alpha_max=cfg.transport.alpha_max)
        self.t_embedder = TimestepEmbedder(C)
        if m.abs_pos_emb:
            self.register_buffer("pos_embed", torch.from_numpy(
                sincos_pos_embed(C, cfg.data.crop)), persistent=False)
        if m.abs_time_emb:
            self.register_buffer("time_embed", torch.from_numpy(
                sincos_pos_embed(C, cfg.data.num_frames)), persistent=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        """The JAX package's init (reference latent_model.py:134-142):
        xavier-uniform Linear weights (IPA's k/v and k/v-point projections
        with the fan of their fused flax kernels) and zero biases (the design
        head's and ``x_d_to_emb`` among them); the AdaLN
        projections, the FinalLayer's linear and IPA's linear_out zero; the
        t-embedder N(0, 0.02); embeddings N(0, 1); the bias-KV tokens
        N(0, 2 / (1 + C)); Hyena's other parameters as
        ``HyenaOperator.reset_parameters``. Draws from torch's global
        generator."""
        C = self.cfg.model.embed_dim
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                nn.init.xavier_uniform_(mod.weight)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight)
            elif isinstance(mod, MHAParams):
                nn.init.normal_(mod.bias_k, std=(2.0 / (1 + C)) ** 0.5)
                nn.init.normal_(mod.bias_v, std=(2.0 / (1 + C)) ** 0.5)
            elif isinstance(mod, HyenaOperator):
                mod.reset_parameters()
        for lin in (self.t_embedder.mlp0, self.t_embedder.mlp2):
            nn.init.normal_(lin.weight, std=0.02)
        zero = [lay.adaLN for lay in self.layers]
        if hasattr(self, "emb_to_latent"):
            zero += [self.emb_to_latent.adaLN, self.emb_to_latent.linear]
        zero += [lay.adaLN for lay in getattr(self, "ipa_layers", ())]
        for lay in list(getattr(self, "ipa_layers", ())) + [
                lay for lay in self.layers if hasattr(lay, "ipa")]:
            zero.append(lay.ipa.linear_out)
            for a, b in ((lay.ipa.linear_k, lay.ipa.linear_v),
                         (lay.ipa.linear_k_points, lay.ipa.linear_v_points)):
                bound = (6.0 / (C + a.out_features + b.out_features)) ** 0.5
                nn.init.uniform_(a.weight, -bound, bound)
                nn.init.uniform_(b.weight, -bound, bound)
        for lin in zero:
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    # ------------------------------------------------------------------
    def make_encoder_pack(self, dt=None):
        """Encoder weights for ops.ipa_encoder: the layers' AdaLN projections
        concatenated (one product for every layer's 6-way rows) and one dict
        per layer (the JAX package's ``fold_encoder_ws``: kv split, MHA q
        scale folded). Built in the caller's grad mode (see
        ``make_trunk_pack``)."""
        pack = self._encoder_pack(dt or self.dtype)
        return pack if torch.is_grad_enabled() else _detached(pack)

    def _encoder_pack(self, dt):
        C, Hm = self.cfg.model.embed_dim, self.cfg.model.mha_heads
        scale = (C // Hm) ** -0.5
        layers = []
        for lay in self.ipa_layers:
            mha = lay.mha_l
            layers.append(dict(
                **_ipa_weights(lay.ipa_norm, lay.ipa, dt),
                wqkv_m=torch.cat([mha.q_proj.weight.t() * scale, mha.k_proj.weight.t(),
                                  mha.v_proj.weight.t()], dim=1).to(dt).contiguous(),
                bqkv_m=torch.cat([mha.q_proj.bias * scale, mha.k_proj.bias,
                                  mha.v_proj.bias]).to(dt),
                wo_m=_t(mha.out_proj, dt), bo_m=mha.out_proj.bias.to(dt),
                bkm=mha.bias_k.to(dt).contiguous(), bvm=mha.bias_v.to(dt).contiguous(),
                w1=_t(lay.fc1, dt), b1=lay.fc1.bias.to(dt),
                w2=_t(lay.fc2, dt), b2=lay.fc2.bias.to(dt)))
        wmods = torch.cat([lay.adaLN.weight.t() for lay in self.ipa_layers], 1).to(dt)
        bmods = torch.cat([lay.adaLN.bias for lay in self.ipa_layers]).to(dt)
        return {"wmods": wmods, "bmods": bmods, "layers": layers}

    def make_trunk_pack(self, dt=None, modular_branch: Optional[bool] = None):
        """The trunk weights folded once per sample (the JAX package's
        ``make_trunk_pack`` with ``_fold_fused_args``): on the fused branch
        both attention q columns carry head_dim**-0.5 * log2(e) (the base-2
        softmax fold), qkv concatenated, (in, out) layout in the compute
        dtype (with ``interleave_ipa`` each layer's IPA weights under
        "ipa"); on the modular branch (``modular_branch``, by default the
        model's: ``modular``; training with dropout asks for it) each
        layer's ``LatentMDGenLayer.fold`` (q scaled by head_dim**-0.5 only:
        the natural softmax); every
        layer's AdaLN projection and the FinalLayer's in one (C, NL*9C+2C)
        weight (``mpnn`` / ``dynamic_mpnn`` have no FinalLayer: (C, NL*9C),
        ``fin`` None); the encoder pack. With grad mode on, the fold, the
        concatenation and the cast run inside autograd, so that gradients of
        the pack reach the f32 parameters (JAX traces ``make_trunk_pack``
        inside ``__call__``); under ``torch.no_grad`` the pack is detached."""
        mb = self.modular if modular_branch is None else modular_branch
        pack = self._trunk_pack(dt or self.dtype, mb)
        return pack if torch.is_grad_enabled() else _detached(pack)

    def _trunk_pack(self, dt, modular_branch: bool):
        C, H = self.cfg.model.embed_dim, self.cfg.model.mha_heads
        scale_t = (C // H) ** -0.5 * LOG2E

        def qkv(mha):
            return (torch.cat([mha.q_proj.weight.t() * scale_t, mha.k_proj.weight.t(),
                               mha.v_proj.weight.t()], dim=1).to(dt).contiguous(),
                    torch.cat([mha.q_proj.bias * scale_t, mha.k_proj.bias,
                               mha.v_proj.bias]).to(dt))

        def fused(lay):
            wl, bl = qkv(lay.mha_l)
            wt, bt = qkv(lay.mha_t)
            ipa = {"ipa": _ipa_weights(lay.ipa_norm, lay.ipa, dt)} if hasattr(lay, "ipa") else {}
            return dict(**ipa,
                wqkv_l=wl, bqkv_l=bl, wout_l=_t(lay.mha_l.out_proj, dt),
                bout_l=lay.mha_l.out_proj.bias.to(dt),
                wqkv_t=wt, bqkv_t=bt, wout_t=_t(lay.mha_t.out_proj, dt),
                bout_t=lay.mha_t.out_proj.bias.to(dt),
                w1=_t(lay.fc1, dt), b1=lay.fc1.bias.to(dt),
                w2=_t(lay.fc2, dt), b2=lay.fc2.bias.to(dt),
                bkl=lay.mha_l.bias_k.to(dt).contiguous(), bvl=lay.mha_l.bias_v.to(dt).contiguous(),
                bkt=lay.mha_t.bias_k.to(dt).contiguous(), bvt=lay.mha_t.bias_v.to(dt).contiguous())

        layers = [lay.fold(dt) if modular_branch else fused(lay) for lay in self.layers]
        fin = getattr(self, "emb_to_latent", None)
        heads = [] if fin is None else [fin.adaLN]
        wmods = torch.cat([lay.adaLN.weight.t() for lay in self.layers]
                          + [a.weight.t() for a in heads], 1).to(dt)
        bmods = torch.cat([lay.adaLN.bias for lay in self.layers] + [a.bias for a in heads]).to(dt)
        enc = self._encoder_pack(dt) if self.cfg.model.prepend_ipa else None
        return {"wmods": wmods, "bmods": bmods, "layers": layers,
                "fin": None if fin is None else (_t(fin.linear, dt), fin.linear.bias.to(dt)),
                "enc": enc}

    # ------------------------------------------------------------------
    def _lin(self, lin: nn.Linear, x):
        dt = self.dtype
        return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))

    def make_encoder_tokens(self, mask_l, aatype, start_frames: Optional[Rigid] = None,
                            end_frames: Optional[Rigid] = None) -> tuple:
        """The encoder's input tokens, a 1-tuple or a 2-tuple of (B, L, C) as
        the JAX package's (:457-479; reference latent_model.py:179-214):
        zeros plus the aatype embedding; with the doubled offsets and none
        of the one-token tasks (``tps_condition``, ``inpainting``,
        ``dynamic_mpnn``), the pair ``x_f = latent_to_emb_f((start^-1 o end)
        as 7-tensors)`` and ``x_r = latent_to_emb_r((end^-1 o start))``, each
        plus the aatype embedding. With ``design`` the JAX package adds
        ``x_d_to_emb(x_d)`` last; it depends on the carry, so
        ``denoise`` adds it at each evaluation."""
        t = self.cfg.task
        aa = None
        if aatype is not None and not self.cfg.model.no_aa_emb:
            aa = F.embedding(aatype.long(), self.aatype_to_emb.weight.to(self.dtype))
        if not self.cfg.doubled_offsets or t.sim_condition or t.mpnn or t.cond_interval:
            B, L = mask_l.shape
            x = torch.zeros(B, L, self.cfg.model.embed_dim, dtype=self.dtype,
                            device=mask_l.device)
            return (x if aa is None else x + aa,)
        fwd = start_frames.invert().compose(end_frames).to_tensor_7()
        rev = end_frames.invert().compose(start_frames).to_tensor_7()
        x_f, x_r = self._lin(self.latent_to_emb_f, fwd), self._lin(self.latent_to_emb_r, rev)
        return (x_f, x_r) if aa is None else (x_f + aa, x_r + aa)

    def run_ipa(self, t_emb, mask_l, start_frames: Rigid, end_frames: Optional[Rigid], tokens,
                pack, dropout=None):
        """The conditioning encoder (reference latent_model.py:179-214):
        ``tokens`` from ``make_encoder_tokens``, each (Bn, L, C); t_emb
        (nb, C) with nb dividing Bn. One token set is encoded over the start
        frames. A pair (x_f, x_r) keeps the JAX package's pairing
        (:490-494): x_r over the start frames, x_f over the end frames, the
        result x_r + x_f; both passes run as one ``ipa_encoder`` call over
        2 Bn elements, interleaved (element 2i is x_r's i, 2i + 1 x_f's), so
        that consecutive elements still share their AdaLN row. With
        ``dropout`` (``models.layers.Dropout``) the encoder takes the plain
        IPALayer path (``ops/ipa_encoder``) and a pair runs as JAX runs it,
        x_r's pass first, then x_f's."""
        m = self.cfg.model
        enc = pack["enc"]
        mods = F.silu(t_emb).to(self.dtype) @ enc["wmods"] + enc["bmods"]
        dims = dict(num_heads_mha=m.mha_heads, Hi=m.ipa_heads, Ch=m.ipa_head_dim, Pq=m.ipa_qk,
                    Pv=m.ipa_v, use_rope=not m.no_rope)
        if dropout is not None:
            if len(tokens) == 1:
                return ipa_encoder(tokens[0], mods, enc["layers"], start_frames, mask_l,
                                   dropout=dropout, **dims)
            x_f, x_r = tokens
            return (ipa_encoder(x_r, mods, enc["layers"], start_frames, mask_l, dropout=dropout,
                                **dims)
                    + ipa_encoder(x_f, mods, enc["layers"], end_frames, mask_l, dropout=dropout,
                                  **dims))
        frames, x = start_frames, tokens[0]
        if len(tokens) == 2:
            x_f, x_r = tokens
            Bn, L, C = x_r.shape

            def pair(a, b):
                return torch.stack([a, b], 1).reshape(2 * Bn, *a.shape[1:])

            x = pair(x_r, x_f)
            frames = Rigid(pair(start_frames.rot, end_frames.rot),
                           pair(start_frames.trans, end_frames.trans))
            mask_l = pair(mask_l, mask_l)
        out = ipa_encoder(x, mods, enc["layers"], frames, mask_l, **dims)
        if len(tokens) == 2:
            out = out.view(Bn, 2, L, C)
            out = out[:, 0] + out[:, 1]
        return out

    def _check_len(self, L: int):
        if self.cfg.model.abs_pos_emb and L > self.pos_embed.shape[0]:
            raise ValueError(f"peptide length {L} exceeds the absolute position table "
                             f"(cfg.data.crop = {self.pos_embed.shape[0]})")

    def _const_terms(self, h, x_cond, x_cond_mask):
        """Add the position/time tables and the conditioning embeddings to
        h (B, T, L, C), in the JAX package's order."""
        B, T, L, C = h.shape
        m = self.cfg.model
        if m.abs_pos_emb:
            self._check_len(L)
            h = h + self.pos_embed[:L].to(self.dtype)
        if m.abs_time_emb:
            h = h + self.time_embed[:T, None].to(self.dtype)
        if x_cond is not None:
            h = (h + self._lin(self.cond_to_emb, x_cond)
                 + F.embedding(x_cond_mask.long(), self.mask_to_emb.weight.to(self.dtype)))
        return h

    def forward(self, x, t, mask, start_frames: Optional[Rigid] = None,
                end_frames: Optional[Rigid] = None, x_cond=None, x_cond_mask=None,
                aatype=None, trunk_pack=None, dropout=None):
        """x (B, T, L, lat), t (B,), mask (B, T, L) -> velocity (B, T, L, lat)
        f32, differentiable in the parameters and in x when grad mode is on:
        the JAX package's ``__call__`` (:608-740), the same function as
        ``forward_inference`` without its design flow. The trunk takes
        ``FusedTrunkFn`` on the fused branch (``grad_checkpointing`` saves
        only each layer's input), and otherwise the layers one by one
        (``LatentMDGenLayer.forward``: ``interleave_ipa``'s IPA and
        ``FusedLayerFn``, or the modular stages) and the FinalLayer as its
        own product (``FinalLayerFn``: JAX's ``FinalLayer`` off the parent
        trunk); the encoder through its recompute, which also returns its
        tokens' gradient. ``dropout`` (``models.layers.Dropout``, training
        with ``model.dropout > 0``, JAX's ``train=True``): every layer on the
        modular branch with its masks, the encoder on its plain path.

        With ``design`` the result is ``denoise``'s, built with gradients:
        the encoder's tokens plus ``x_d_to_emb`` of x's simplex channels
        averaged over frames, the trunk without its head, the FinalLayer
        (``FinalLayerFn``) and the design head's logits added to its last 20
        channels in the compute dtype; ``mpnn`` / ``dynamic_mpnn`` keep frame
        0 (and T-1) and return the logits (B, 1, L, 20) f32. ``trunk_pack``
        must be made for the call's branch (``make_trunk_pack``)."""
        cfg, task = self.cfg, self.cfg.task
        if task.mpnn or task.dynamic_mpnn:
            sel = [0] if task.mpnn else [0, x.shape[1] - 1]
            x, x_cond, x_cond_mask, mask = (a[:, sel] for a in (x, x_cond, x_cond_mask, mask))
        B, T, L = mask.shape
        NL, C = len(self.layers), cfg.model.embed_dim
        mask = mask.float().contiguous()
        modular_branch = self.modular or dropout is not None
        pack = (trunk_pack if trunk_pack is not None
                else self.make_trunk_pack(modular_branch=modular_branch))
        h = self._lin(self.latent_to_emb, x)
        h = self._const_terms(h, x_cond, x_cond_mask)
        t_emb = self.t_embedder(t * cfg.model.time_multiplier, self.dtype)
        if cfg.model.prepend_ipa:
            tokens = self.make_encoder_tokens(mask[:, 0], aatype, start_frames, end_frames)
            if task.design:
                xd = self._lin(self.x_d_to_emb, x[..., -20:].float().mean(dim=1))
                tokens = tuple(tk + xd for tk in tokens)
            enc = self.run_ipa(t_emb, mask[:, 0], start_frames, end_frames, tokens, pack,
                               dropout=dropout)
            h = h + enc[:, None]
        mods_all = F.silu(t_emb).to(self.dtype) @ pack["wmods"] + pack["bmods"]
        mods, modf = mods_all[:, :NL * 9 * C], mods_all[:, NL * 9 * C:]
        remat = cfg.model.grad_checkpointing
        if not (modular_branch or self.layer_ipa):
            trunk = dict(num_heads=cfg.model.mha_heads, remat=remat)
            if not task.design:
                return fused_trunk_train(h, mods, pack["layers"], mask,
                                         final=(modf, *pack["fin"]), **trunk)
            h = fused_trunk_train(h, mods, pack["layers"], mask, **trunk).reshape(B * T * L, C)
        else:
            frames = self._layer_frames(start_frames, B, T) if self.layer_ipa else None
            h = h.reshape(B * T * L, C).contiguous()
            for i, lay in enumerate(self.layers):
                h = lay(h, mods[:, i * 9 * C:(i + 1) * 9 * C], mask, pack["layers"][i], frames,
                        dropout=dropout, path=f"layers_{i}", remat=remat)
            if not task.design:
                return FinalLayerFn.apply(h, modf, *pack["fin"]).view(B, T, L, -1).float()
        logits = self.design_logits(h, B, T, L)
        if task.mpnn or task.dynamic_mpnn:
            return logits[:, None].float()
        latent = FinalLayerFn.apply(h, modf, *pack["fin"]).view(B, T, L, -1)
        return torch.cat([latent[..., :-20], latent[..., -20:] + logits[:, None]], -1).float()

    @staticmethod
    def _layer_frames(start_frames: Rigid, B: int, T: int):
        """Frame 0's rigids for every frame, (rot (B*T, L, 3, 3), trans
        (B*T, L, 3)) f32: the interleaved IPA's frames (JAX :259-265)."""
        return tuple(a.float()[:, None].expand(B, T, *a.shape[1:]).reshape(B * T, *a.shape[1:])
                     .contiguous() for a in (start_frames.rot, start_frames.trans))

    def design_logits(self, h, B: int, T: int, L: int):
        """The design head on the trunk's output h (B*T*L, C) in the compute
        dtype: ``emb_to_logits(gelu_erf(fc3(mean over frames of
        fc2(gelu_erf(fc1(h))))))`` -> (B, L, 20), plain dense layers (JAX
        :734-736 computes them outside its kernels)."""
        C = h.shape[1]
        x_l = self._lin(self.fc2, gelu_erf(self._lin(self.fc1, h))).view(B, T, L, C).mean(dim=1)
        return self._lin(self.emb_to_logits, gelu_erf(self._lin(self.fc3, x_l)))

    # ------------------------------------------------------------------
    # flat sampling path
    @torch.no_grad()
    def make_scan_consts(self, x_cond, x_cond_mask, mask, aatype=None,
                         start_frames: Optional[Rigid] = None,
                         end_frames: Optional[Rigid] = None):
        """Per-step-constant terms of the Euler chain, once per sample:
        ``wlat`` (lat, C) the latent projection; ``cadd`` (B, T, L, C) its
        bias + position/time tables + conditioning embeddings; ``tokens``
        the encoder's input tokens (``make_encoder_tokens``: the token pair
        needs the start and end frames)."""
        B, T, L = mask.shape
        C = self.cfg.model.embed_dim
        add = self.latent_to_emb.bias.to(self.dtype).expand(B, T, L, C)
        add = self._const_terms(add, x_cond, x_cond_mask).contiguous()
        tokens = (self.make_encoder_tokens(mask[:, 0], aatype, start_frames, end_frames)
                  if self.cfg.model.prepend_ipa else None)
        return _detached({"wlat": _t(self.latent_to_emb, self.dtype), "cadd": add,
                          "tokens": tokens})

    @torch.no_grad()
    def embed_times(self, ts):
        """ts (S,) -> t-embeddings (S, C) in one batched call."""
        return self.t_embedder(ts * self.cfg.model.time_multiplier, self.dtype)

    @torch.no_grad()
    def embed_mods(self, t_embs, pack):
        """t_embs (S, C) -> every step's trunk + FinalLayer AdaLN rows
        (S, NL*9*C + 2C). One row per step: the t grid is shared by the
        batch, so the kernels broadcast it over the batch."""
        return F.silu(t_embs).to(self.dtype) @ pack["wmods"] + pack["bmods"]

    @torch.no_grad()
    def encode_steps(self, ts, mask, consts, pack, start_frames: Rigid,
                     end_frames: Optional[Rigid] = None):
        """The prepend-IPA encoder for the whole t grid in one pass:
        ts (S,) -> enc (S, B, L, C). The conditioning is step-invariant;
        only the AdaLN rows vary with t (one row per step, shared by B,
        and with the token pair by both passes of each element)."""
        if not self.cfg.model.prepend_ipa:
            return None
        B, T, L = mask.shape
        S = ts.shape[0]

        def tile(a):
            return a.unsqueeze(0).expand(S, *a.shape).reshape(S * a.shape[0], *a.shape[1:])

        def tile_frames(f):
            return None if f is None else Rigid(tile(f.rot), tile(f.trans))

        enc = self.run_ipa(self.embed_times(ts), tile(mask[:, 0]), tile_frames(start_frames),
                           tile_frames(end_frames), tuple(tile(x) for x in consts["tokens"]),
                           pack)
        return enc.view(S, B, L, -1)

    @torch.no_grad()
    def forward_inference(self, x, t, mask, start_frames: Optional[Rigid] = None,
                          end_frames: Optional[Rigid] = None, x_cond=None, x_cond_mask=None,
                          aatype=None, trunk_pack=None, scan_consts=None):
        """The velocity at any (x, t), for the ODE samplers: x (B, T, L, lat),
        t (B,), mask (B, T, L) -> (B, T, L, lat) f32. The JAX package's
        ``forward_inference`` (:952-978), computed as its ``__call__`` with
        ``trunk_pack`` (:608-740; here ``denoise``): per call the
        t-embeddings (``embed_times``), the AdaLN rows (``embed_mods``) and
        the encoder (one row per element), then ``fused_trunk`` with the
        embed folded in and, but under ``design``, the output head too; its
        layers on the model's branch (the modular one: ``LatentMDGenLayer``
        with frame 0's rigids for every frame, JAX :724-733). ``scan_consts``
        (``make_scan_consts``) and ``trunk_pack`` are made once per sample
        by the caller, or here when absent.

        With ``design`` the last 20 channels of the result are the Dirichlet
        conditional flow of the simplex channels x_d: softmax(logits /
        ``dirichlet_flow_temp``) projected onto the simplex, then
        sum_j p_j (delta_ij - x_i) c_j(x) * dalpha/dt at alpha = ``t_to_alpha``
        of t[0] (clipped), c from ``condflow.c_factor`` (``nan_to_num`` under
        ``allow_nan_cfactor``). ``mpnn`` / ``dynamic_mpnn`` keep frame 0
        (and T-1) of x, x_cond, x_cond_mask and mask (``scan_consts`` must
        be made from the kept frames) and return the logits,
        (B, 1, L, 20) f32."""
        task, tr = self.cfg.task, self.cfg.transport
        if task.mpnn or task.dynamic_mpnn:
            sel = [0] if task.mpnn else [0, x.shape[1] - 1]
            x, x_cond, x_cond_mask, mask = (a[:, sel] for a in (x, x_cond, x_cond_mask, mask))
        kw = dict(start_frames=start_frames, end_frames=end_frames, x_cond=x_cond,
                  x_cond_mask=x_cond_mask, aatype=aatype, trunk_pack=trunk_pack,
                  scan_consts=scan_consts)
        if not task.design or task.mpnn or task.dynamic_mpnn:
            return self.denoise(x, t, mask, **kw)
        x_d = x[..., -20:].float()
        latent = self.denoise(x, t, mask, **kw)
        probs = simplex_proj(torch.softmax(latent[..., -20:] / tr.dirichlet_flow_temp, dim=-1))
        alpha, dalpha_dt = t_to_alpha(t[0].float(), tr.alpha_max)
        alpha = alpha.clamp(1.0, tr.alpha_max - self.condflow.alpha_spacing)
        c = self.condflow.c_factor(x_d, alpha)
        if tr.allow_nan_cfactor:
            c = torch.nan_to_num(c)
        eye = torch.eye(20, dtype=x_d.dtype, device=x_d.device)
        cond_flows = (eye - x_d[..., None]) * c[..., None, :]
        flow = (probs[..., None, :] * cond_flows).sum(-1) * dalpha_dt
        return torch.cat([latent[..., :-20], flow], dim=-1)

    @torch.no_grad()
    def denoise(self, x, t, mask, start_frames: Optional[Rigid] = None,
                    end_frames: Optional[Rigid] = None, x_cond=None, x_cond_mask=None,
                    aatype=None, trunk_pack=None, scan_consts=None):
        """The denoiser's output at (x, t) without the design flow: the JAX
        package's ``__call__`` with ``trunk_pack`` (:608-740) on the frames
        it is given. Without ``design`` the velocity, the head folded into
        ``fused_trunk``. With ``design``: the encoder's tokens plus
        ``x_d_to_emb`` of x's simplex channels averaged over frames (JAX
        :468-478); the trunk's output h; the FinalLayer as its own row-a
        product (``_final_xla``, :185-191) in the compute dtype; the design
        head ``emb_to_logits(gelu_erf(fc3(mean over frames of
        fc2(gelu_erf(fc1(h))))))`` (plain dense layers, as JAX computes them
        outside its kernels) added to the head's last 20 channels in the
        compute dtype (JAX :734-740), then f32. ``mpnn`` / ``dynamic_mpnn``:
        the logits (B, 1, L, 20) f32."""
        task = self.cfg.task
        NL, C = len(self.layers), self.cfg.model.embed_dim
        mask = mask.float().contiguous()
        pack = trunk_pack if trunk_pack is not None else self.make_trunk_pack()
        consts = scan_consts if scan_consts is not None else self.make_scan_consts(
            x_cond, x_cond_mask, mask, aatype=aatype, start_frames=start_frames,
            end_frames=end_frames)
        t_emb = self.embed_times(t)
        mods = self.embed_mods(t_emb, pack)
        enc = None
        if self.cfg.model.prepend_ipa:
            tokens = consts["tokens"]
            if task.design:
                xd = self._lin(self.x_d_to_emb, x[..., -20:].float().mean(dim=1))
                tokens = tuple(tk + xd for tk in tokens)
            enc = self.run_ipa(t_emb, mask[:, 0], start_frames, end_frames, tokens, pack)
        layer = None
        if self.modular or self.layer_ipa:
            B, T = mask.shape[:2]
            frames = self._layer_frames(start_frames, B, T) if self.layer_ipa else None

            def layer(i, h, mod, w):
                return self.layers[i](h, mod, mask, w, frames)
        trunk = dict(num_heads=self.cfg.model.mha_heads, layer=layer,
                     embed=(consts["wlat"], consts["cadd"], enc))
        x = x.float().contiguous()
        if not task.design:
            return fused_trunk(x, mods[:, :NL * 9 * C], pack["layers"], mask,
                               final=(mods[:, NL * 9 * C:], *pack["fin"]), **trunk)
        h = fused_trunk(x, mods[:, :NL * 9 * C], pack["layers"], mask, **trunk)
        B, T, L, _ = h.shape
        h = h.reshape(B * T * L, C)
        logits = self.design_logits(h, B, T, L)
        if task.mpnn or task.dynamic_mpnn:
            return logits[:, None].float()
        modf = mods[:, NL * 9 * C:]
        wfin, bfin = pack["fin"]
        latent = adaln_linear(h, wfin, bfin, ln="plain", shift=modf[:, :C],
                              scale=modf[:, C:]).view(B, T, L, -1)
        latent = torch.cat([latent[..., :-20], latent[..., -20:] + logits[:, None]], dim=-1)
        return latent.float()

    @torch.no_grad()
    def flat_call(self, xc, mask, consts, pack, step_dt: float, enc=None, mods=None):
        """One Euler step on the f32 carry xc (B, T, L, lat), updated IN
        PLACE: embed (+ constants + encoder rows) -> trunk -> head ->
        xc + dt * v. ``mods`` (nb, NL*9*C + 2C), one step's AdaLN rows;
        ``enc`` (B, L, C) that step's encoder output."""
        NL, C = len(self.layers), self.cfg.model.embed_dim
        return fused_trunk(xc, mods[:, :NL * 9 * C], pack["layers"], mask,
                           num_heads=self.cfg.model.mha_heads,
                           final=(mods[:, NL * 9 * C:], *pack["fin"]),
                           embed=(consts["wlat"], consts["cadd"], enc), step_dt=step_dt)
