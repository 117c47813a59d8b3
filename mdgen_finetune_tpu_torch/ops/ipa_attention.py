"""ipa_attention: the Invariant Point Attention core (c_z = 0) from the
scalar/point projections to the output features.

Kernel: ``csrc/ipa_attention.cu``; it replaces the IPA part of the JAX
package's ``ops/ipa_encoder.py::_encoder_call`` kernel. Four forms: at
L <= ``SHORT_L`` and the model's widths (``short_route``: the 4AA peptides)
a persistent grid streams units of whole elements (``ipa_plan``: SPB
elements x all H heads), the next unit's rows in flight while a thread per
(element, query, head) attends in f32; from ``TC_MIN_L`` at the widths of
``TC_WIDTHS`` (ATLAS, L = 256) blocks of warps of 16 queries of one
(element, head) (``tc_plan``) stream its keys through a ring in shared
memory and form the logits and the value sums as products of augmented
rows on the tensor cores (TF32; ``ipa_attention_tc_math`` is that
arithmetic in plain PyTorch), with an online softmax in registers; at
other widths one block per (element, head) holds the L x L logits in
shared memory up to ``RESIDENT_MAX_L``, and above it one block per
(element, head, 64-query tile) streams the keys with a running-max
softmax, a query's state in shared memory (``tiled_bytes``), so no
buffer grows with L. The wrapper raises ``ValueError`` for widths whose
state or resident logits would not fit one block's shared memory.
``ipa_attention_plain`` is
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

import dataclasses
import functools
import math

import torch

from . import _cuda
from ._cuda import SMS
from .rope_attention import SMEM_BYTES

_INF = 1e5
_ARGTYPES = [_cuda.P, _cuda.I64, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I64,
             _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32,
             _cuda.P, _cuda.I32, _cuda.I32, _cuda.I32]
SHORT_L = 16  # the streaming form takes L <= 16 ...
RESIDENT_MAX_L = 64  # the resident form up to here at other widths, the key-tiled form above
TC_MIN_L = 17  # the tensor-core form from here at TC_WIDTHS (tools/form_clock.py ipa_long_forms)
REGISTER_WIDTHS = (32, 8, 8)  # (Ch, Pq, Pv): the model's, which the streaming form takes
TC_WIDTHS = ((32, 8, 8), (16, 4, 6))  # (Ch, Pq, Pv) the tensor-core form is built for
TC_KEYS = 64  # csrc/ipa_attention.cu tc::KT: keys per ring stage
TC_STAGES = 2  # ... tc::STAGES: ring stages
TC_MAX_WARPS = 8  # ... tc::MAX_WARPS: warps per block, 16 queries each
FORMS = ("streaming", "resident", "key-tiled", "tensor-core")
SHORT_THREADS = 256  # csrc/ipa_attention.cu: the streaming form's block
QUERY_THREADS = 4    # ... of which four threads per (element, query, head)
SHORT_BUDGET = 115_712  # bytes of a streaming block: two resident per SM (233,472 / 2 less 1 KB)


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


def tc_bytes(Ch: int, Pq: int, Pv: int) -> int:
    """Shared memory of the tensor-core form (csrc/ipa_attention.cu
    ``tc::Shape::SMEM``): ``TC_STAGES`` ring stages of ``TC_KEYS`` keys, each
    the keys' augmented rows [k | w k_pts] (the points' TF32 high parts) and
    the points' low parts, the same for [v | v_pts], the frames, mask, bias
    and mask term, f32; every row padded to 4 mod 8 floats."""
    pvp = -(-Pv // 8) * 8
    kq = -(-(Ch + 3 * Pq) // 8) * 8
    rows = (kq + 4) + (kq - Ch + 4) + (Ch + 3 * pvp + 4) + (3 * pvp + 4) + 9 + 3 + 3
    return TC_STAGES * TC_KEYS * rows * 4


@dataclasses.dataclass(frozen=True)
class TcPlan:
    warps: int    # warps per block, 16 queries each
    qgroups: int  # blocks per (element, head)
    blocks: int   # the grid: B x H x qgroups
    smem: int     # bytes of shared memory per block


@functools.lru_cache(maxsize=256)
def tc_plan(B: int, L: int, H: int, Ch: int, Pq: int, Pv: int) -> TcPlan:
    """The tensor-core form's blocks for a call over B elements of L
    residues: an (element, head)'s ceil(L / 16) query tiles (a warp each) in
    the fewest blocks of at most ``TC_MAX_WARPS`` warps, evenly (at L = 256:
    2 blocks of 8 warps per (element, head); 800 blocks at B = 100, 8 at
    B = 1). Every block stages and lifts the keys of its (element, head)
    once, so more warps a block share that work: at B = 1, 8 blocks of 8
    warps measured 2.5x faster than 64 blocks of one (PERF.md). Raises
    ``ValueError`` at widths not in ``TC_WIDTHS``."""
    if (Ch, Pq, Pv) not in TC_WIDTHS or min(B, L, H) < 1:
        raise ValueError(f"tc_plan: (B, L, H, Ch, Pq, Pv) = {(B, L, H, Ch, Pq, Pv)} is not taken "
                         f"by the tensor-core form (widths {TC_WIDTHS})")
    tiles = -(-L // 16)
    qgroups = -(-tiles // TC_MAX_WARPS)
    warps = -(-tiles // qgroups)
    return TcPlan(warps, qgroups, B * H * qgroups, tc_bytes(Ch, Pq, Pv))


def short_route(L: int, H: int, Ch: int, Pq: int, Pv: int) -> bool:
    """Whether a call at (L, H, Ch, Pq, Pv) takes the streaming form: L <=
    ``SHORT_L`` at ``REGISTER_WIDTHS`` with H a multiple of 4 (a proj row is
    then a whole number of 128-byte chunks), one element's unit fitting a
    block's shared memory."""
    return (1 <= L <= SHORT_L and (Ch, Pq, Pv) == REGISTER_WIDTHS and H > 0 and H % 4 == 0
            and ipa_bytes(1, L, H) <= SMEM_BYTES)


def ipa_bytes(spb: int, L: int, H: int) -> int:
    """Shared memory of a streaming unit of ``spb`` elements at the model's
    widths (csrc/ipa_attention.cu ``ShortLayout``): two raw buffers, each
    the unit's proj rows with 4 pad floats after every 32 and its rot,
    trans and mask floats (each span rounded up to 16 bytes); the unit's
    bf16 features."""
    rows, W, F = spb * L, proj_width(H, *REGISTER_WIDTHS), feat_width(H, 32, 8)

    def a16(b):
        return -(-b // 16) * 16

    raw = rows * (W + W // 8) * 4 + a16(rows * 36) + a16(rows * 12) + a16(rows * 4)
    return 2 * raw + rows * F * 2


@dataclasses.dataclass(frozen=True)
class IpaPlan:
    spb: int    # elements per unit
    smem: int   # bytes of shared memory per block
    units: int  # units of the call


@functools.lru_cache(maxsize=256)
def ipa_plan(B: int, L: int, H: int, Ch: int, Pq: int, Pv: int) -> IpaPlan:
    """The streaming form's unit for a call over B elements of L residues:
    about ``QUERY_THREADS`` threads per query (SPB = ``SHORT_THREADS`` //
    (4 L H)), no more
    elements than leave 3 units per SM (of ``SMS``), within
    ``SHORT_BUDGET``. Raises ``ValueError`` where ``short_route`` is
    false."""
    if not short_route(L, H, Ch, Pq, Pv):
        raise ValueError(f"ipa_plan: (L, H, Ch, Pq, Pv) = {(L, H, Ch, Pq, Pv)} is not taken by "
                         f"the streaming form (1 <= L <= {SHORT_L}, widths {REGISTER_WIDTHS}, "
                         "H a multiple of 4)")
    spb = max(1, SHORT_THREADS // (QUERY_THREADS * L * H))
    spb = min(spb, max(1, B // (3 * SMS)))
    while spb > 1 and ipa_bytes(spb, L, H) > SHORT_BUDGET:
        spb -= 1
    return IpaPlan(spb, ipa_bytes(spb, L, H), -(-B // spb))


def proj_width(H: int, Ch: int, Pq: int, Pv: int) -> int:
    return 3 * H * Ch + 6 * H * Pq + 3 * H * Pv


def feat_width(H: int, Ch: int, Pv: int) -> int:
    return H * Ch + 4 * H * Pv


def ipa_attention_math(proj, rot, trans, mask, head_weights, *, H: int, Ch: int,
                       Pq: int, Pv: int, out_dtype=None, dropout=None):
    """The plain PyTorch math of ``ipa_attention`` (same arguments), counted
    nowhere; the scalar path runs in proj's dtype, the point path in f32.
    ``dropout``: a function applied to the attention weights (B, H, L, L)
    after the softmax, as the JAX package's ``ipa_forward`` applies its
    dropout (``models/ipa.py:124-125``); the kernel has none."""
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
    if dropout is not None:
        a = dropout(a)

    o = torch.einsum("bhqk,bkhc->bqhc", a.to(v.dtype), v).reshape(B, L, HCh)
    o_pt = torch.einsum("bhqk,bkhpx->bqhpx", a, v_pts).reshape(B, L, HPv, 3)
    o_pt = ((o_pt - trans[:, :, None])[..., :, None] * rot[:, :, None]).sum(-2)  # R^T (g - t)
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + 1e-8)
    dt = out_dtype or proj.dtype
    return torch.cat([o.to(dt), o_pt[..., 0].to(dt), o_pt[..., 1].to(dt), o_pt[..., 2].to(dt),
                      o_pt_norm.to(dt)], dim=-1)


def tf32(x, truncate: bool = False):
    """x (f32) rounded to TF32, to nearest with ties away from zero (the
    kernels' ``cvt.rna.tf32.f32``), or truncated (what the tensor cores read
    of an f32 operand): 10 bits of mantissa."""
    i = x.float().contiguous().view(torch.int32)
    return ((i if truncate else i + 0x1000) & -0x2000).view(torch.float32)


def ipa_attention_tc_math(proj, rot, trans, mask, head_weights, *, H: int, Ch: int, Pq: int,
                          Pv: int, split: bool = True):
    """The tensor-core form's arithmetic (csrc/ipa_attention.cu, namespace
    ``tc``) in plain PyTorch, on the CPU too, counted nowhere (same
    arguments as ``ipa_attention``): the logits as one product of augmented
    rows Q_aug = [q | q_pts] and K_aug = [c k | w k_pts] plus the per-key
    bias -w/2 |k_pts|^2 and the mask term 1e5 m_q (m_k - 1) (the per-query
    terms cancel in the softmax; a query with m_q = 0 attends over every
    key); the values one product of the unnormalised weights with
    [v | v_pts], divided by their f32 sum. Operands rounded as the kernel
    rounds them: the scalar columns single TF32 (c q and the weights rounded,
    k and v truncated: the kernel feeds them as they landed), the point
    columns split into TF32 high and low parts whose three products (low x
    low dropped) are summed (``split``; single TF32 with ``split=False``, to
    show what that would cost); the sums in f64, then f32. The lift, bias,
    softmax, inverse map and the features in f32 (the kernel writes bf16)."""
    B, L, _ = proj.shape
    HCh, HPq, HPv = H * Ch, H * Pq, H * Pv
    proj = proj.float()
    q = proj[..., :HCh].reshape(B, L, H, Ch)
    k = proj[..., HCh:2 * HCh].reshape(B, L, H, Ch)
    v = proj[..., 2 * HCh:3 * HCh].reshape(B, L, H, Ch)
    o0 = 3 * HCh

    def points(lo, HP, P):  # lifted, (B, L, H, 3 P): x | y | z
        t = proj[..., lo:lo + 3 * HP].reshape(B, L, 3, HP).transpose(-1, -2)
        g = (rot[:, :, None] * t[..., None, :]).sum(-1) + trans[:, :, None]
        return g.reshape(B, L, H, P, 3).transpose(-1, -2).reshape(B, L, H, 3 * P)

    q_pts, k_pts, v_pts = points(o0, HPq, Pq), points(o0 + 3 * HPq, HPq, Pq), \
        points(o0 + 6 * HPq, HPv, Pv)
    c = math.sqrt(1.0 / (3 * Ch))
    w = torch.nn.functional.softplus(head_weights.float()) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))

    def prod(eq, a, b, three, trunc_b=False):
        if not three:
            return torch.einsum(eq, tf32(a).double(), tf32(b, trunc_b).double())
        ah, bh = tf32(a), tf32(b)
        al, bl = tf32(a - ah), tf32(b - bh)
        return sum(torch.einsum(eq, x.double(), y.double()) for x, y in ((al, bh), (ah, bl), (ah, bh)))

    qk = "bqhc,bkhc->bhqk"
    s = (prod(qk, c * q, k, False, True) + prod(qk, q_pts, w[:, None] * k_pts, split)).float()
    bias = (-0.5 * w[:, None] * (k_pts ** 2).sum(-1).transpose(1, 2))  # (B, H, L)
    s = s + bias[:, :, None, :] + (1e5 * mask[:, :, None] * (mask[:, None, :] - 1))[:, None]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    den = p.sum(-1).transpose(1, 2)[..., None].double()  # (B, L, H, 1)
    pv = "bhqk,bkhc->bqhc"
    o = (prod(pv, p, v, False, True) / den).float().reshape(B, L, HCh)
    o_pt = (prod(pv, p, v_pts, split) / den).float().reshape(B, L, H, 3, Pv).transpose(-1, -2)
    o_pt = o_pt.reshape(B, L, HPv, 3)
    o_pt = ((o_pt - trans[:, :, None])[..., :, None] * rot[:, :, None]).sum(-2)  # R^T (g - t)
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + 1e-8)
    return torch.cat([o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm], dim=-1)


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
    f32 = torch.float32
    if W != proj_width(H, Ch, Pq, Pv) or proj.dtype != f32 or not proj.is_contiguous():
        raise ValueError("ipa_attention: proj must be a contiguous f32 (B, L, proj_width) tensor")
    if not (rot.dtype == trans.dtype == mask.dtype == head_weights.dtype == f32
            and rot.shape == (B, L, 3, 3) and trans.shape == (B, L, 3) and mask.shape == (B, L)
            and head_weights.shape == (H,) and rot.is_contiguous() and trans.is_contiguous()
            and mask.is_contiguous() and head_weights.is_contiguous()):
        for name, t, shape in (("rot", rot, (B, L, 3, 3)), ("trans", trans, (B, L, 3)),
                               ("mask", mask, (B, L)), ("head_weights", head_weights, (H,))):
            if t.dtype != f32 or not t.is_contiguous() or tuple(t.shape) != shape:
                raise ValueError(f"ipa_attention: {name} must be a contiguous f32 {shape} tensor")
    if out_dtype not in (None, torch.bfloat16):
        raise ValueError("ipa_attention: the kernel writes bf16 features")
    form = _form(B, L, H, Ch, Pq, Pv)
    F = feat_width(H, Ch, Pv)
    out = torch.empty(B, L, F, dtype=torch.bfloat16, device=proj.device)
    lib = _cuda.library("ipa_attention", _ARGTYPES)
    spb = grid = warps = 0
    if form == 0:
        p = ipa_plan(B, L, H, Ch, Pq, Pv)
        spb = p.spb
        # the persistent grid: the resident blocks, at most a unit each
        grid = min(p.units, _slots(proj.device.index, L, H, spb))
    elif form == 3:
        p = tc_plan(B, L, H, Ch, Pq, Pv)
        grid, warps = p.qgroups, p.warps
    code = lib.ipa_attention(proj.data_ptr(), W, rot.data_ptr(), trans.data_ptr(),
                             mask.data_ptr(), head_weights.data_ptr(), out.data_ptr(), F,
                             B, L, H, Ch, Pq, Pv, (0, 0, 1, 2)[form], _cuda.stream_ptr(proj), spb,
                             grid, warps)
    _cuda.check(code, "ipa_attention")
    ipa_attention.launches += 1
    ipa_attention.forms[form] += 1
    return out


ipa_attention.launches = 0
ipa_attention.forms = [0, 0, 0, 0]  # launches by form (``FORMS``)


@functools.lru_cache(maxsize=256)
def _form(B: int, L: int, H: int, Ch: int, Pq: int, Pv: int) -> int:
    """The form a call over B elements at these sizes takes (an index of
    ``FORMS``): 0 streaming (``short_route``; it measured faster than the
    resident form at every B from 100 elements up, PERF.md); 3 tensor-core
    at ``TC_WIDTHS`` from ``TC_MIN_L`` (it measured 1.4-16x faster than the
    resident form at L = 17 to 65 over 1 and 100 elements, PERF.md); 1
    resident up to ``RESIDENT_MAX_L`` and 2 key-tiled above it at other
    widths (and resident below ``TC_MIN_L``); raises ``ValueError`` where
    the one it would take does not fit a block's shared memory."""
    if short_route(L, H, Ch, Pq, Pv):
        return 0
    if (Ch, Pq, Pv) in TC_WIDTHS and L >= TC_MIN_L:
        return 3
    if L > RESIDENT_MAX_L:
        if tiled_bytes(Ch, Pq, Pv) > SMEM_BYTES:
            raise ValueError(f"ipa_attention: the key-tiled kernel needs "
                             f"{tiled_bytes(Ch, Pq, Pv):,} bytes of shared memory at (Ch, Pq, Pv) "
                             f"= {(Ch, Pq, Pv)}, more than the {SMEM_BYTES:,} a block may use")
        return 2
    if resident_bytes(L, Ch, Pq, Pv) > SMEM_BYTES:
        raise ValueError(f"ipa_attention: the resident kernel needs "
                         f"{resident_bytes(L, Ch, Pq, Pv):,} bytes of shared memory at L = {L}, "
                         f"more than the {SMEM_BYTES:,} a block may use")
    return 1


def _info(L: int, H: int, spb: int, warps: int = 0):
    """The C query behind ``resources`` (at the model's widths): the
    streaming form at plan spb > 0, else the tensor-core form in blocks of
    ``warps`` warps."""
    fn = _cuda.built("ipa_attention").ipa_attention_resources
    fn.argtypes = [_cuda.I32, _cuda.I32, _cuda.I32, _cuda.I32, _cuda.P]
    info = (_cuda.I64 * 4)()
    _cuda.check(fn(L, H, spb, warps, info), "ipa_attention_resources")
    return list(info)


@functools.lru_cache(maxsize=64)
def _slots(device: int, L: int, H: int, spb: int) -> int:
    """Resident streaming blocks at plan spb on card ``device``: its SMs x
    blocks per SM of this checkout's build (queried once per plan)."""
    with torch.cuda.device(device):
        per_sm = _info(L, H, spb)[3]
        if per_sm <= 0:
            raise RuntimeError(f"ipa_attention: the streaming plan spb = {spb} fits no block "
                               "on an SM")
        return torch.cuda.get_device_properties(device).multi_processor_count * per_sm


def resources(B: int, L: int, H: int = 4) -> dict:
    """The launch resources of the kernel that a call over B elements of L
    residues runs at the model's widths, the streaming or the tensor-core
    form (on the card): registers and local (spill) bytes per thread,
    dynamic shared memory per block, resident blocks per SM, the form; the
    form's plan and grid."""
    form = _form(B, L, H, *REGISTER_WIDTHS)
    if form not in (0, 3):
        raise ValueError(f"ipa_attention.resources: the {FORMS[form]} form's are not queried")
    if form == 0:
        p = ipa_plan(B, L, H, *REGISTER_WIDTHS)
        info = _info(L, H, p.spb)
        grid = min(p.units, torch.cuda.get_device_properties(0).multi_processor_count * info[3])
    else:
        p = tc_plan(B, L, H, *REGISTER_WIDTHS)
        info = _info(L, H, 0, p.warps)
        grid = p.blocks
    return dict(form=FORMS[form], registers=info[0], local_bytes=info[1], smem_bytes=info[2],
                blocks_per_sm=info[3], plan=dataclasses.asdict(p), grid=grid)
