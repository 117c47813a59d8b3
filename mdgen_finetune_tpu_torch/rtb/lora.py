"""LoRA adapters as parameter additions over the denoiser's Linear weights.

Counterpart of the JAX package's ``rtb/lora.py`` (:22-62), which replaces
the reference's peft wrapping of the posterior policy
(src/rtb_utils/gfn_diffusion.py:58-83): low-rank factors (a, b) are attached
to the targeted kernels and merged functionally, W_eff = W + scale * a @ b in
the flax (in, out) layout, before the policy runs; the base weights stay
frozen and only the adapters receive gradients.

An adapter dict is keyed by the flax path of its kernel
(``layers_0/mha_l/q_proj/kernel``, as the JAX package's; the outsourced
UNets' submodules carry their flax names, ``UNet2D_0/ResBlock2D_0/Dense_0/
kernel``), with ``a`` (in, r)
and ``b`` (r, out) as JAX holds them, so a JAX adapter dict carries across
unchanged (``utils.weights.lora_from_flax``). The port's weights are
(out, in), so the merged weight is ``W + scale * (a @ b).T``. IPA's fused
kernels ``linear_kv`` and ``linear_kv_points`` keep JAX's single (a, b) pair:
the port holds those weights split (``linear_k`` / ``linear_v``,
``linear_k_points`` / ``linear_v_points``, ``utils.weights.from_flax``), so
``lora_merge`` splits b's columns the way ``from_flax`` splits the fused
weight and adds ``a @ b_part`` to each part. Two independent rank-r adapters
there would be a different, rank-2r model.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models.ipa import IPAParams

# reference target modules (gfn_diffusion.py:59-76): MHA + IPA projections,
# MLP fc1/fc2, the output head linear, and the timestep embedder MLP
_DEFAULT_PATTERNS = [
    r".*(q_proj|k_proj|v_proj|out_proj)/kernel$",
    r".*linear_(q|kv|q_points|kv_points|out)/kernel$",
    r".*fc1/kernel$",
    r".*fc2/kernel$",
    r".*emb_to_latent/linear/kernel$",
    r".*t_embedder/mlp[02]/kernel$",
]

# IPA's fused flax kernels -> the port's split Linear modules
_FUSED = {"linear_kv": ("linear_k", "linear_v"),
          "linear_kv_points": ("linear_k_points", "linear_v_points")}


def lora_targets_default(path: str) -> bool:
    return any(re.match(p, path) for p in _DEFAULT_PATTERNS)


def _flax_path(module_name: str) -> str:
    """``layers.0.mha_l.q_proj`` -> ``layers_0/mha_l/q_proj/kernel``."""
    name = re.sub(r"(^|\.)(ipa_layers|layers)\.(\d+)", r"\1\2_\3", module_name)
    return name.replace(".", "/") + "/kernel"


def _split(ipa: IPAParams, fused: str, part: int, cols: torch.Tensor) -> torch.Tensor:
    """The columns of a fused flax kernel's (.., out) tensor that belong to
    part 0 (k) or 1 (v), as ``utils.weights.from_flax`` splits the weight:
    ``linear_kv`` per head [k | v], ``linear_kv_points`` per (coordinate,
    head) [k points | v points]."""
    lead = cols.shape[:-1]
    if fused == "linear_kv":
        parts = cols.reshape(*lead, ipa.H, 2, ipa.Ch)[..., part, :]
    else:
        parts = cols.reshape(*lead, 3, ipa.H, ipa.Pq + ipa.Pv)
        parts = parts[..., :ipa.Pq] if part == 0 else parts[..., ipa.Pq:]
    return parts.reshape(*lead, -1)


def lora_kernels(model: nn.Module, targets: Callable[[str], bool] = lora_targets_default
                 ) -> Dict[str, Tuple[int, int, List[Tuple[str, Optional[Tuple]]]]]:
    """{flax path: (fan_in, fan_out, [(weight name, split)])} of every
    targeted Linear kernel of ``model``; ``split`` is None, or (the IPA
    module, the fused kernel's name, part) for a fused kernel's halves."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, IPAParams):
            for fused, (k, v) in _FUSED.items():
                path = _flax_path(f"{name}.{fused}")
                if targets(path):
                    wk, wv = getattr(mod, k).weight, getattr(mod, v).weight
                    out[path] = (wk.shape[1], wk.shape[0] + wv.shape[0],
                                 [(f"{name}.{k}.weight", (mod, fused, 0)),
                                  (f"{name}.{v}.weight", (mod, fused, 1))])
        elif isinstance(mod, nn.Linear) and not any(
                name.endswith(f".{p}") for parts in _FUSED.values() for p in parts):
            path = _flax_path(name)
            if targets(path):
                out[path] = (mod.in_features, mod.out_features, [(f"{name}.weight", None)])
    return out


def lora_init(generator: torch.Generator, model: nn.Module, rank: int = 32,
              targets: Callable[[str], bool] = lora_targets_default, device=None) -> dict:
    """{flax path: {"a": (in, r), "b": (r, out)}} f32 for each targeted
    kernel: a ~ N(0, 1/r), b = 0 (so the adapter starts as the identity),
    as peft initializes; a drawn from ``generator`` in path order."""
    out = {}
    for path, (fan_in, fan_out, _) in sorted(lora_kernels(model, targets).items()):
        a = torch.randn(fan_in, rank, generator=generator, device=generator.device) / rank ** 0.5
        out[path] = {"a": a.to(device), "b": torch.zeros(rank, fan_out, device=device)}
    return out


def lora_merge(model: nn.Module, lora: dict, scale: float = 1.0,
               kernels: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The adapted weights of ``model``, {weight name: W + scale * (a @
    b).T} (for ``torch.func.functional_call``); a fused kernel's b split by
    columns into its two halves. ``kernels``: ``lora_kernels(model)``,
    computed here when absent."""
    kernels = kernels if kernels is not None else lora_kernels(model, lambda p: p in lora)
    params = dict(model.named_parameters())
    merged = {}
    for path, ab in lora.items():
        for name, split in kernels[path][2]:
            b = ab["b"] if split is None else _split(split[0], split[1], split[2], ab["b"])
            merged[name] = params[name] + scale * (ab["a"] @ b).t()
    return merged
