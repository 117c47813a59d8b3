"""PyTorch port, the rounding points of the trunk's attention core, held
against the JAX package on the CPU.

The TPU kernel (``time_attention._pallas_fwd``, TPU rows b and 11a) rounds
the RoPE'd q and k to the input dtype before its logits, and the
probabilities to bf16 before their product with v. The port's plain math
models that rounding with ``rope_attention_math(stage=...)``, which the
card tests use as the reference where the logits are so large that the
rounding, not the kernel, sets the error (the card's long-sequence kernel
rounds to fp16, a finer grid). Here the bf16-staged math meets the TPU
kernel in interpret mode on bf16 inputs, in both softmax modes and with
logits of ~1e2, where the f32 math (no staging) is measurably further from
it.

Sizes: B = 2, T = 40, L = 3, C = 48, 2 heads (head dim 24, as the
flagship), some keys masked; inputs seeded numpy rounded to bf16.
Tolerance: 1e-2 x max(1, max |out|), the card's kernel rule (the bf16
rounding of the output alone is up to 2^-8 of |out|, and the two sides sum
in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.ops import time_attention as jta
from mdgen_finetune_tpu_torch.models.attention_core import LOG2E
from mdgen_finetune_tpu_torch.ops.rope_attention import rope_attention_math

B, T, L, C, H = 2, 40, 3, 48, 2
D = C // H
TOL = 1e-2


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _inputs(base2, q_scale, half_lanes, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, L, C)).astype(np.float32) for _ in range(3))
    q *= D ** -0.5 * q_scale * (LOG2E if base2 else 1.0)
    bk, bv = (rng.normal(size=C).astype(np.float32) for _ in range(2))
    if half_lanes:  # RoPE is then one product per lane: both sides round the same values
        for a in (q, k):
            a.reshape(B, T, L, H, 2, D // 2)[..., 1, :] = 0
        bk.reshape(H, 2, D // 2)[:, 1] = 0
    mask = (rng.random((B, T, L)) > 0.25).astype(np.float32)
    mask[1, :, 0] = 0  # a residue whose only valid frame key is the bias token
    return [_bf16(a) for a in (q, k, v, bk, bv)] + [mask]


def _err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("base2,q_scale,half_lanes", [(True, 1.0, False), (False, 1.0, False),
                                                      (False, 40.0, True)])
def test_staged_math_matches_the_tpu_kernel_on_bf16_inputs(base2, q_scale, half_lanes):
    q, k, v, bk, bv, mask = _inputs(base2, q_scale, half_lanes)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    kern = jta._pallas_fwd(jb(q), jb(k), jb(v), jb(bk.reshape(1, 1, C)), jb(bv.reshape(1, 1, C)),
                           jnp.asarray(mask.transpose(0, 2, 1)), H, interpret=True, base2=base2)
    kern = np.asarray(kern.astype(jnp.float32))
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    args = (qkv, torch.from_numpy(bk), torch.from_numpy(bv), torch.from_numpy(mask))
    staged = rope_attention_math(*args, num_heads=H, base2=base2, stage=torch.bfloat16)
    assert _err(staged, kern) <= TOL, _err(staged, kern)
    if q_scale > 1.0:  # logits ~1e2: the staging is what brings the math to the kernel
        plain = rope_attention_math(*args, num_heads=H, base2=base2)
        assert _err(plain, kern) > 4 * _err(staged, kern), (_err(plain, kern), _err(staged, kern))
