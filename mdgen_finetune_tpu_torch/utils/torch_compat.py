"""Released MDGen checkpoints: the reference's PyTorch Lightning ``.ckpt``
<-> the port's state_dict.

Counterpart of the JAX package's ``utils/torch_compat.py``. A state_dict of
the reference ``LatentMDGenModel`` (src/mdgen/model/latent_model.py:43;
the released files, reference README.md:71-75) maps name for name onto the
flax parameter tree that both packages share, and ``weights.from_flax``
takes that tree to the port's state_dict:

- torch ``Linear.weight`` (out, in) -> flax ``kernel`` (in, out);
- ``Embedding.weight`` -> ``embedding``; ``LayerNorm.weight`` -> ``scale``;
- ``Conv1d.weight`` (out, in/groups, k) -> ``kernel`` (k, in/groups, out);
- fairseq MHA's ``bias_k`` / ``bias_v`` (1, 1, C) are kept as they are;
- the reference's module paths: ``adaLN_modulation.1`` -> ``adaLN``,
  ``mha_l.attn`` -> ``mha_l``, ``t_embedder.mlp.0`` -> ``t_embedder/mlp0``,
  Hyena's ``filter_fn.implicit_filter.{0..6}`` -> ``mlp_in``, ``sin_i``,
  ``mlp_i``, ``mlp_out``.

``to_reference_state_dict`` / ``write_reference_checkpoint`` are the exact
inverse, so a reference-format file can be made from any of the port's
models (the tests and ``chip_smoke.py`` do so with random weights).

Only the CLIs' loading uses this module; it reads a file the user names
(``torch.load(weights_only=False)``: a Lightning file holds plain Python
objects beside its tensors).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import MDGenConfig
from .weights import from_flax, to_flax

_HYENA_MLPS = (("mlp_in", 0), ("mlp_0", 2), ("mlp_1", 4), ("mlp_out", 6))
_HYENA_SINS = (("sin_0", 1), ("sin_1", 3), ("sin_2", 5))


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _np(w) -> np.ndarray:
    return np.asarray(w)


def torch_mha_to_flax(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    out = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out[name] = {"kernel": _t(sd[f"{prefix}.{name}.weight"]),
                     "bias": _np(sd[f"{prefix}.{name}.bias"])}
    out["bias_k"] = _np(sd[f"{prefix}.bias_k"])
    out["bias_v"] = _np(sd[f"{prefix}.bias_v"])
    return out


def torch_ipa_to_flax(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    out = {}
    for name in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points", "linear_out"):
        out[name] = {"kernel": _t(sd[f"{prefix}.{name}.weight"]),
                     "bias": _np(sd[f"{prefix}.{name}.bias"])}
    out["head_weights"] = _np(sd[f"{prefix}.head_weights"])
    return out


def _linear(sd, name) -> dict:
    entry = {"kernel": _t(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        entry["bias"] = _np(sd[f"{name}.bias"])
    return entry


def _layernorm(sd, name) -> dict:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _ipa_layer(sd, p) -> dict:
    return {"adaLN": _linear(sd, f"{p}.adaLN_modulation.1"),
            "ipa_norm": _layernorm(sd, f"{p}.ipa_norm"),
            "ipa": torch_ipa_to_flax(sd, f"{p}.ipa"),
            "mha_l": torch_mha_to_flax(sd, f"{p}.mha_l.attn"),
            "fc1": _linear(sd, f"{p}.fc1"), "fc2": _linear(sd, f"{p}.fc2")}


def _hyena_to_flax(sd, p) -> dict:
    z = _np(sd[f"{p}.filter_fn.pos_emb.z"])
    filt = {"pos_z": z.reshape(-1, z.shape[-1]), "bias": _np(sd[f"{p}.filter_fn.bias"])}
    for name, i in _HYENA_MLPS:
        filt[name] = _linear(sd, f"{p}.filter_fn.implicit_filter.{i}")
    for name, i in _HYENA_SINS:
        filt[name] = {"freq": _np(sd[f"{p}.filter_fn.implicit_filter.{i}.freq"])}
    conv_w = _np(sd[f"{p}.short_filter.weight"])  # (out, in/groups, k)
    return {"in_proj": _linear(sd, f"{p}.in_proj"), "out_proj": _linear(sd, f"{p}.out_proj"),
            "short_filter": {"kernel": np.ascontiguousarray(conv_w.transpose(2, 1, 0)),
                             "bias": _np(sd[f"{p}.short_filter.bias"])},
            "filter_fn": filt}


def _main_layer(sd, p, hyena: bool) -> dict:
    out = {"adaLN": _linear(sd, f"{p}.adaLN_modulation.1"),
           "mha_l": torch_mha_to_flax(sd, f"{p}.mha_l.attn"),
           "fc1": _linear(sd, f"{p}.fc1"), "fc2": _linear(sd, f"{p}.fc2"),
           "mha_t": (_hyena_to_flax(sd, f"{p}.mha_t") if hyena
                     else torch_mha_to_flax(sd, f"{p}.mha_t.attn"))}
    if f"{p}.ipa_norm.weight" in sd:
        out["ipa_norm"] = _layernorm(sd, f"{p}.ipa_norm")
        out["ipa"] = torch_ipa_to_flax(sd, f"{p}.ipa")
    return out


def convert_state_dict(sd: Dict[str, np.ndarray]) -> dict:
    """Reference ``LatentMDGenModel`` state_dict -> the flax parameter tree
    ``{"params": ...}`` (numpy leaves), as the JAX package converts it."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: dict = {"latent_to_emb": _linear(sd, "latent_to_emb")}
    for name in ("latent_to_emb_f", "latent_to_emb_r", "cond_to_emb", "x_d_to_emb", "fc1", "fc2",
                 "fc3", "emb_to_logits"):
        if f"{name}.weight" in sd:
            params[name] = _linear(sd, name)
    for name in ("mask_to_emb", "aatype_to_emb"):
        if f"{name}.weight" in sd:
            params[name] = {"embedding": _np(sd[f"{name}.weight"])}
    params["t_embedder"] = {"mlp0": _linear(sd, "t_embedder.mlp.0"),
                            "mlp2": _linear(sd, "t_embedder.mlp.2")}
    if "emb_to_latent.linear.weight" in sd:
        params["emb_to_latent"] = {"adaLN": _linear(sd, "emb_to_latent.adaLN_modulation.1"),
                                   "linear": _linear(sd, "emb_to_latent.linear")}
    hyena = any(".mha_t.in_proj.weight" in k for k in sd)
    i = 0
    while f"layers.{i}.adaLN_modulation.1.weight" in sd:
        params[f"layers_{i}"] = _main_layer(sd, f"layers.{i}", hyena)
        i += 1
    i = 0
    while f"ipa_layers.{i}.adaLN_modulation.1.weight" in sd:
        params[f"ipa_layers_{i}"] = _ipa_layer(sd, f"ipa_layers.{i}")
        i += 1
    return {"params": params}


def load_reference_checkpoint(path: str, cfg: MDGenConfig):
    """A reference ``.ckpt`` (Lightning: ``state_dict`` under ``model.``,
    the EMA's under ``ema.params``) -> (state_dict, EMA state_dict or None,
    hyper_parameters), the state_dicts the port's (``weights.from_flax``
    under ``cfg``), as ``training.read_checkpoint`` gives them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    model_sd = {k[len("model."):]: v.float().numpy() for k, v in ckpt["state_dict"].items()
                if k.startswith("model.")}
    params = from_flax(convert_state_dict(model_sd), cfg)
    ema = None
    if "ema" in ckpt:
        ema_sd = {k: v.float().numpy() for k, v in ckpt["ema"]["params"].items()}
        ema = from_flax(convert_state_dict(ema_sd), cfg)
    return params, ema, ckpt.get("hyper_parameters", {})


# ---------------------------------------------------------------------------
# the inverse: the port's weights in the reference's names
# ---------------------------------------------------------------------------

def _put_linear(out, name, entry):
    out[f"{name}.weight"] = _t(entry["kernel"])
    if "bias" in entry:
        out[f"{name}.bias"] = _np(entry["bias"])


def _put_mha(out, prefix, tree):
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _put_linear(out, f"{prefix}.{name}", tree[name])
    out[f"{prefix}.bias_k"] = _np(tree["bias_k"])
    out[f"{prefix}.bias_v"] = _np(tree["bias_v"])


def _put_ipa(out, prefix, tree):
    for name in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points", "linear_out"):
        _put_linear(out, f"{prefix}.{name}", tree[name])
    out[f"{prefix}.head_weights"] = _np(tree["head_weights"])


def _put_hyena(out, p, tree):
    filt = tree["filter_fn"]
    out[f"{p}.filter_fn.pos_emb.z"] = _np(filt["pos_z"])[None]
    out[f"{p}.filter_fn.bias"] = _np(filt["bias"])
    for name, i in _HYENA_MLPS:
        _put_linear(out, f"{p}.filter_fn.implicit_filter.{i}", filt[name])
    for name, i in _HYENA_SINS:
        out[f"{p}.filter_fn.implicit_filter.{i}.freq"] = _np(filt[name]["freq"])
    _put_linear(out, f"{p}.in_proj", tree["in_proj"])
    _put_linear(out, f"{p}.out_proj", tree["out_proj"])
    out[f"{p}.short_filter.weight"] = np.ascontiguousarray(
        _np(tree["short_filter"]["kernel"]).transpose(2, 1, 0))
    out[f"{p}.short_filter.bias"] = _np(tree["short_filter"]["bias"])


def to_reference_state_dict(state_dict: dict, cfg: MDGenConfig) -> Dict[str, torch.Tensor]:
    """The port's state_dict -> the reference ``LatentMDGenModel``'s names
    and layouts; ``convert_state_dict`` inverts it exactly."""
    tree = to_flax(state_dict, cfg)["params"]
    out: Dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        if name == "t_embedder":
            _put_linear(out, "t_embedder.mlp.0", sub["mlp0"])
            _put_linear(out, "t_embedder.mlp.2", sub["mlp2"])
        elif name == "emb_to_latent":
            _put_linear(out, "emb_to_latent.adaLN_modulation.1", sub["adaLN"])
            _put_linear(out, "emb_to_latent.linear", sub["linear"])
        elif name.startswith(("layers_", "ipa_layers_")):
            p = name.replace("_", ".").replace("ipa.layers", "ipa_layers")
            _put_linear(out, f"{p}.adaLN_modulation.1", sub["adaLN"])
            _put_mha(out, f"{p}.mha_l.attn", sub["mha_l"])
            _put_linear(out, f"{p}.fc1", sub["fc1"])
            _put_linear(out, f"{p}.fc2", sub["fc2"])
            if "mha_t" in sub:
                if "filter_fn" in sub["mha_t"]:
                    _put_hyena(out, f"{p}.mha_t", sub["mha_t"])
                else:
                    _put_mha(out, f"{p}.mha_t.attn", sub["mha_t"])
            if "ipa" in sub:
                out[f"{p}.ipa_norm.weight"] = _np(sub["ipa_norm"]["scale"])
                out[f"{p}.ipa_norm.bias"] = _np(sub["ipa_norm"]["bias"])
                _put_ipa(out, f"{p}.ipa", sub["ipa"])
        elif "embedding" in sub:
            out[f"{name}.weight"] = _np(sub["embedding"])
        else:
            _put_linear(out, name, sub)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


def write_reference_checkpoint(path: str, state_dict: dict, cfg: MDGenConfig,
                               ema: Optional[dict] = None, hparams: Optional[dict] = None):
    """Save the port's weights as a reference Lightning ``.ckpt``: the
    model's state_dict under ``model.``, ``ema`` (the port's EMA
    state_dict) under ``ema.params``, ``hparams`` as ``hyper_parameters``."""
    ckpt = {"state_dict": {f"model.{k}": v
                           for k, v in to_reference_state_dict(state_dict, cfg).items()},
            "hyper_parameters": hparams or {}}
    if ema is not None:
        ckpt["ema"] = {"params": to_reference_state_dict(ema, cfg), "decay": cfg.train.ema_decay}
    torch.save(ckpt, path)
