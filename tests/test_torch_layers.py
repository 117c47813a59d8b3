"""PyTorch port, building blocks: layers, RoPE and dense attention held
against their JAX functions on the same numpy inputs, in float32 on the CPU;
and the port's sources checked (with ``ast``) to import no JAX, no flax and
nothing of the JAX package.

Tolerances: rtol 1e-4 / atol 1e-5 — the two frameworks sum in different
orders, which moves f32 results by a few ulps; nothing here should differ by
more.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.models import attention as jattn
from mdgen_finetune_tpu.models import layers as jl
from mdgen_finetune_tpu.models import rope as jrope
from mdgen_finetune_tpu.ops.adaln_mlp import _gelu_fast as j_gelu_fast
from mdgen_finetune_tpu_torch.models import attention as tattn
from mdgen_finetune_tpu_torch.models import layers as tl
from mdgen_finetune_tpu_torch.models import rope as trope

RTOL, ATOL = 1e-4, 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_layer_norm_modulate_gate():
    r = _rng(1)
    x = r.normal(size=(2, 5, 24)).astype(np.float32) * 3 + 1
    sh, sc, g = (r.normal(size=(2, 24)).astype(np.float32) for _ in range(3))
    _close(tl.layer_norm(torch.from_numpy(x)), jl.layer_norm(jnp.asarray(x)))
    _close(tl.modulate(torch.from_numpy(x), torch.from_numpy(sh), torch.from_numpy(sc)),
           jl.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)))
    _close(tl.gate(torch.from_numpy(x), torch.from_numpy(g)), jl.gate(jnp.asarray(x), jnp.asarray(g)))


@pytest.mark.parametrize("fn", ["gelu_erf", "gelu_fast"])
def test_gelus(fn):
    a = np.linspace(-9, 9, 2001).astype(np.float32)
    ref = jl.gelu_erf(jnp.asarray(a)) if fn == "gelu_erf" else j_gelu_fast(jnp.asarray(a))
    _close(getattr(tl, fn)(torch.from_numpy(a)), ref)


def test_timestep_embedding_and_embedder():
    import jax

    t = np.array([0.0, 3.5, 37.0, 99.0], np.float32)
    _close(tl.timestep_embedding(torch.from_numpy(t), 256),
           jl.timestep_embedding(jnp.asarray(t), 256), atol=1e-4)
    mod = jl.TimestepEmbedder(32)
    params = mod.init(jax.random.key(0), jnp.asarray(t))
    emb = tl.TimestepEmbedder(32)
    p = params["params"]
    with torch.no_grad():
        for name in ("mlp0", "mlp2"):
            getattr(emb, name).weight.copy_(torch.from_numpy(np.array(p[name]["kernel"]).T))
            getattr(emb, name).bias.copy_(torch.from_numpy(np.array(p[name]["bias"])))
        _close(emb(torch.from_numpy(t)), mod.apply(params, jnp.asarray(t)), atol=1e-4)


def test_sincos_pos_embed():
    np.testing.assert_array_equal(tl.sincos_pos_embed(96, 7), jl.sincos_pos_embed(96, 7))


def test_rope():
    r = _rng(2)
    q = r.normal(size=(2, 3, 5, 24)).astype(np.float32)
    k = r.normal(size=(2, 3, 6, 24)).astype(np.float32)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k))
    _close(tq, jq)
    _close(tk, jk)


def test_dense_attn_with_padded_key():
    r = _rng(3)
    S, N, C, H = 3, 5, 96, 4  # head dim 24, as the flagship
    q, k, v = (r.normal(size=(S, N, C)).astype(np.float32) * 0.5 for _ in range(3))
    bk, bv = (r.normal(size=(1, 1, C)).astype(np.float32) for _ in range(2))
    mask = np.ones((S, N), np.float32)
    mask[0, -1] = 0.0
    mask[1, :] = 0.0  # a row that can only attend to the bias key
    out = tattn.dense_attn(*(torch.from_numpy(a) for a in (q, k, v, mask, bk, bv)), H)
    ref = jattn.dense_attn(*(jnp.asarray(a) for a in (q, k, v, mask, bk, bv)), H)
    _close(out, ref)


def _port_sources():
    files = sorted((REPO / "mdgen_finetune_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _banned(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "flax", "jaxlib") or name == "mdgen_finetune_tpu" \
        or name.startswith("mdgen_finetune_tpu.")


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 10 and (REPO / "chip_smoke.py").exists()
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
                names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names if _banned(n)]
    assert not bad, bad
