"""Weights: the JAX package's flax parameter tree <-> the port's state_dict.

``from_flax(tree, cfg)`` takes the tree as nested dicts of numpy arrays (as
``jax.tree_util.tree_map(np.asarray, params)`` gives them; the top-level
``"params"`` key is optional) and returns a state_dict for
``models.denoiser.LatentMDGen``. It needs no JAX:

- module ``ipa_layers_3`` / ``layers_3`` -> ``ipa_layers.3`` / ``layers.3``;
- Dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` -> ``bias``;
- LayerNorm ``scale`` and Embed ``embedding`` -> ``weight``;
- ``bias_k`` / ``bias_v`` (1, 1, C) -> (C,);
- IPA's fused ``linear_kv`` (per head [k | v]) and ``linear_kv_points``
  (coordinate, head, [k points | v points]) are split by columns, as the
  JAX package's ``fold_encoder_ws`` splits them.

``to_flax`` is the exact inverse. ``lora_from_flax`` / ``lora_to_flax``
carry the JAX package's RTB adapter dict across (``rtb/lora.py``);
``unet_from_flax`` / ``unet_to_flax`` the weights of the outsourced UNet
policies (``rtb/denoisers.py``), whose submodules carry the flax names.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from ..config import MDGenConfig


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _module_name(name: str) -> str:
    return re.sub(r"^(ipa_layers|layers)_(\d+)$", r"\1.\2", name)


def from_flax(tree: dict, cfg: MDGenConfig) -> dict:
    """Flax parameter tree (numpy leaves) -> the port's state_dict (f32)."""
    tree = tree.get("params", tree)
    m = cfg.model
    H, Ch, Pq, Pv = m.ipa_heads, m.ipa_head_dim, m.ipa_qk, m.ipa_v
    sd = {}
    for path, v in _flatten(tree):
        mods = [_module_name(p) for p in path[:-1]]
        leaf = path[-1]
        v = np.asarray(v, np.float32)
        if mods and mods[-1] in ("linear_kv", "linear_kv_points"):
            base = ".".join(mods[:-1])
            if mods[-1] == "linear_kv":
                parts = v.reshape(-1, H, 2, Ch)
                k, val = parts[..., 0, :], parts[..., 1, :]
                names = ("linear_k", "linear_v")
            else:
                parts = v.reshape(-1, 3, H, Pq + Pv)
                k, val = parts[..., :Pq], parts[..., Pq:]
                names = ("linear_k_points", "linear_v_points")
            for name, a in zip(names, (k, val)):
                if leaf == "kernel":
                    sd[f"{base}.{name}.weight"] = a.reshape(a.shape[0], -1).T
                else:
                    sd[f"{base}.{name}.bias"] = a.reshape(-1)
            continue
        def key(name):
            return ".".join(mods + [name])

        if leaf == "kernel":
            sd[key("weight")] = v.T
        elif leaf in ("scale", "embedding"):
            sd[key("weight")] = v
        elif leaf in ("bias_k", "bias_v"):
            sd[key(leaf)] = v.reshape(-1)
        else:
            sd[key(leaf)] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def to_flax(state_dict: dict, cfg: MDGenConfig) -> dict:
    """The port's state_dict -> the flax parameter tree {"params": ...}
    (numpy leaves); the inverse of ``from_flax``."""
    m = cfg.model
    H, Ch, Pq, Pv = m.ipa_heads, m.ipa_head_dim, m.ipa_qk, m.ipa_v
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()}
    out: dict = {}

    def put(path, value):
        d = out
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = value

    def flax_path(key):
        parts = key.split(".")
        mods, leaf = parts[:-1], parts[-1]
        if len(mods) >= 2 and mods[0] in ("ipa_layers", "layers") and mods[1].isdigit():
            mods = [f"{mods[0]}_{mods[1]}"] + mods[2:]
        return mods, leaf

    done = set()
    for key, v in sd.items():
        mods, leaf = flax_path(key)
        last = mods[-1] if mods else ""
        if last in ("linear_k", "linear_v", "linear_k_points", "linear_v_points"):
            fused = "linear_kv" if last in ("linear_k", "linear_v") else "linear_kv_points"
            base = key.rsplit(".", 2)[0]
            if (base, fused, leaf) in done:
                continue
            done.add((base, fused, leaf))
            if fused == "linear_kv":
                k = sd[f"{base}.linear_k.{leaf}"]
                val = sd[f"{base}.linear_v.{leaf}"]
                if leaf == "weight":
                    a = np.stack([k.T.reshape(-1, H, Ch), val.T.reshape(-1, H, Ch)], axis=2)
                    put(mods[:-1] + ["linear_kv", "kernel"], a.reshape(a.shape[0], -1))
                else:
                    a = np.stack([k.reshape(H, Ch), val.reshape(H, Ch)], axis=1)
                    put(mods[:-1] + ["linear_kv", "bias"], a.reshape(-1))
            else:
                k = sd[f"{base}.linear_k_points.{leaf}"]
                val = sd[f"{base}.linear_v_points.{leaf}"]
                if leaf == "weight":
                    a = np.concatenate([k.T.reshape(-1, 3, H, Pq), val.T.reshape(-1, 3, H, Pv)], -1)
                    put(mods[:-1] + ["linear_kv_points", "kernel"], a.reshape(a.shape[0], -1))
                else:
                    a = np.concatenate([k.reshape(3, H, Pq), val.reshape(3, H, Pv)], -1)
                    put(mods[:-1] + ["linear_kv_points", "bias"], a.reshape(-1))
            continue
        if leaf == "weight":
            if last in ("mask_to_emb", "aatype_to_emb"):
                put(mods + ["embedding"], v)
            elif last == "ipa_norm":
                put(mods + ["scale"], v)
            else:
                put(mods + ["kernel"], v.T)
        elif leaf in ("bias_k", "bias_v"):
            put(mods + [leaf], v.reshape(1, 1, -1))
        else:
            put(mods + [leaf], v)
    return {"params": out}


def lora_from_flax(lora: dict, device=None) -> dict:
    """The JAX package's adapter dict {flax kernel path: {"a": (in, r), "b":
    (r, out)}} (numpy leaves) -> the port's (``rtb/lora.py``), f32 tensors.
    The port keys its adapters by the same flax paths and holds a and b in
    the same layout; b of a fused IPA kernel (``linear_kv``,
    ``linear_kv_points``) keeps its fused flax columns, which ``lora_merge``
    splits as ``from_flax`` splits the weight, so that the merged weights
    are ``from_flax`` of the JAX package's merged tree."""
    return {path: {k: torch.tensor(np.asarray(ab[k], np.float32), device=device)
                   for k in ("a", "b")} for path, ab in lora.items()}


def lora_to_flax(lora: dict) -> dict:
    """The port's adapter dict -> the JAX package's (numpy f32 leaves); the
    inverse of ``lora_from_flax``."""
    return {path: {k: ab[k].detach().cpu().float().numpy() for k in ("a", "b")}
            for path, ab in lora.items()}


# flax leaf -> the port's parameter, by the kind of module that holds it
_UNET_LEAF = {(torch.nn.Conv1d, "kernel"): "weight", (torch.nn.Conv2d, "kernel"): "weight",
              (torch.nn.Linear, "kernel"): "weight", (torch.nn.GroupNorm, "scale"): "weight",
              (torch.nn.Embedding, "embedding"): "weight"}


def _unet_layout(kind, leaf: str, v: np.ndarray, to_torch: bool) -> np.ndarray:
    """A kernel between flax's layout and the port's: Conv (kh, [kw,] in,
    out) <-> (out, in, kh[, kw]), Dense (in, out) <-> (out, in)."""
    if leaf != "kernel":
        return v
    if kind is torch.nn.Linear:
        return v.T
    n = v.ndim
    perm = (n - 1, n - 2, *range(n - 2)) if to_torch else (*range(2, n), 1, 0)
    return np.transpose(v, perm)


def unet_from_flax(tree: dict, module: torch.nn.Module) -> dict:
    """A flax parameter tree (numpy leaves; the ``"params"`` key optional)
    of one of the JAX package's ``rtb/denoisers.py`` modules -> the
    state_dict of the port's counterpart ``module`` (f32). The port's
    submodules carry the flax names, so a path maps leaf by leaf; every
    parameter of ``module`` must be given, at its shape."""
    tree = tree.get("params", tree)
    kinds = {name: type(m) for name, m in module.named_modules()}
    want = module.state_dict()
    sd = {}
    for path, v in _flatten(tree):
        mod, leaf = ".".join(path[:-1]), path[-1]
        kind = kinds.get(mod)
        name = f"{mod}.{_UNET_LEAF.get((kind, leaf), leaf)}"
        if name not in want:
            raise KeyError(f"{'/'.join(path)}: no parameter {name} in {type(module).__name__}")
        val = _unet_layout(kind, leaf, np.asarray(v, np.float32), True)
        if tuple(val.shape) != tuple(want[name].shape):
            raise ValueError(f"{'/'.join(path)}: shape {val.shape}, the port's "
                             f"{tuple(want[name].shape)}")
        sd[name] = torch.tensor(val)
    missing = set(want) - set(sd)
    if missing:
        raise KeyError(f"parameters not in the tree: {sorted(missing)}")
    return sd


def unet_to_flax(state_dict: dict, module: torch.nn.Module) -> dict:
    """The inverse of ``unet_from_flax``: {"params": nested dicts of numpy
    f32 leaves}."""
    kinds = {name: type(m) for name, m in module.named_modules()}
    back = {(k, t): leaf for (k, leaf), t in _UNET_LEAF.items()}
    out = {}
    for name, v in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        kind = kinds[mod]
        leaf = back.get((kind, leaf), leaf)
        node = out
        for p in mod.split("."):
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(
            _unet_layout(kind, leaf, v.detach().cpu().float().numpy(), False))
    return {"params": out}


@torch.no_grad()
def randomize_(model: torch.nn.Module, generator: torch.Generator, scale: float = 0.05):
    """Overwrite every parameter with seeded N(0, scale^2) values (LayerNorm
    weights 1 + noise). The JAX package zero-initialises the AdaLN and output
    projections, which makes the model the identity; random weights make a
    comparison of two implementations meaningful."""
    for name, p in model.named_parameters():
        r = torch.randn(p.shape, generator=generator, device=generator.device,
                        dtype=torch.float32).to(p.device) * scale
        p.copy_(r + 1.0 if name.endswith("ipa_norm.weight") else r)
    return model
