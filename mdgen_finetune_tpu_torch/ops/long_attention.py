"""The block schedule of the long-key attention kernels
(``csrc/long_attention.cuh``): ``tiled_attention`` (the frame core's
forward), ``fused_attention``'s forward (``fused_plan``: its long form, or
its short form for rows of at most 16 queries) and the two passes of
``fused_attention_bwd``.

A block of 8 warps owns a chunk of 16-row tiles of one attention row (query
tiles in the forward and the dq pass, key tiles in the dK / dV pass) and
keeps the rows of the other side resident in shared memory. ``plan`` picks

- the window: every resident row at once where they fit a block's share of
  an SM at two blocks per SM (``BUDGET``), else the most rows in multiples
  of 64 that do (the block then takes one round of tiles, one per warp or
  two in the forward, so that each window is staged once per block);
- the chunk: all of a row's tiles in one block where the grid of rows alone
  fills the SMs at two blocks each, else the row's tiles split into as many
  chunks as that takes, with at least two tiles per warp in each. Every
  chunk stages the row's resident side again, which on the H100 costs more
  than the last wave's idle SMs: at T = 1000 (512 rows, 1.94 waves) one
  chunk per row beat two (3.9 waves) by 4-6% in the forward
  (``tools/long_attention_ablation``).

The launchers take the chunk and the window as arguments and size their
shared memory from the window (``Plan.smem`` is their count).
"""
from __future__ import annotations

import dataclasses

from ._cuda import SMS

WARPS = 8
SMEM_PER_SM = 233_472      # 228 KB, of which each resident block reserves 1 KB
BUDGET = SMEM_PER_SM // 2 - 1024
SLOTS = 2 * SMS            # blocks in flight at two per SM


def row_stride(D: int) -> int:
    """A staged row's stride in 2-byte elements: D lanes, an odd number of
    16-byte units (24 at D = 16 and 24, 40 at 32, 72 at 64)."""
    return D if (D // 8) % 2 else D + 8


@dataclasses.dataclass(frozen=True)
class Plan:
    chunk: int    # 16-row tiles per block
    win: int      # resident rows per window (a multiple of 16)
    chunks: int   # blocks per attention row
    blocks: int   # the grid
    smem: int     # dynamic shared memory per block, bytes
    windows: int  # windows per block
    form: int = 0  # fused_attention's forward: 0 the long form, 1 the short one
    rows: int = 0  # the short form's attention rows per block


def plan(rows: int, n_own: int, n_res: int, row_bytes: int, fixed_bytes: int = 0,
         per_warp: int = 1) -> Plan:
    """The schedule of ``rows`` attention rows, each with ``n_own`` rows in
    tiles of 16 owned by the warps (``per_warp`` tiles per warp at once) and
    ``n_res`` resident rows of ``row_bytes`` bytes each, plus ``fixed_bytes``
    of shared memory per block."""
    res_p = -(-n_res // 16) * 16
    if fixed_bytes + res_p * row_bytes <= BUDGET:
        win = res_p
    else:
        win = (BUDGET - fixed_bytes) // row_bytes // 64 * 64
    tiles = -(-n_own // 16)
    if win >= res_p:
        want = max(1, min(-(-tiles // (2 * WARPS)), -(-SLOTS // rows)))
        chunk = -(-tiles // want)
    else:
        chunk = WARPS * per_warp
    chunks = -(-tiles // chunk)
    return Plan(chunk=chunk, win=win, chunks=chunks, blocks=rows * chunks,
                smem=fixed_bytes + win * row_bytes, windows=-(-res_p // win))


FWD_TILES_PER_WARP = 2  # tiled_attention.cu's TQ


def forward_plan(seq_heads: int, N: int, D: int) -> Plan:
    """``tiled_attention``: query tiles, two per warp at once, against the
    N + 1 keys (k and v rows and an f32 mask each), with each warp's 32
    query rows."""
    rs = row_stride(D)
    return plan(seq_heads, N, N + 1, 4 * rs + 4, WARPS * FWD_TILES_PER_WARP * 16 * rs * 2,
                FWD_TILES_PER_WARP)


SHORT_MAX_N, SHORT_MAX_KEYS, SHORT_THREADS = 16, 32, 256  # csrc/fused_attention.cu


def fused_plan(R: int, N: int, M: int, D: int) -> Plan:
    """``fused_attention``'s forward over R rows of N queries and M keys.
    The short form where N <= 16 and M <= 32 and a block of 256 threads
    (one a query) gets at least two warps' worth of rows whose keys and
    values (4D bytes a key) fit its share of an SM; else the long form: row
    g's schedule without the appended key (``forward_plan``), the key's
    additive mask beside its k and v rows."""
    if N <= SHORT_MAX_N and M <= SHORT_MAX_KEYS:
        rows = min(SHORT_THREADS // N, BUDGET // (M * D * 4), R)
        if rows * N >= min(64, R * N):
            return Plan(chunk=0, win=M, chunks=1, blocks=-(-R // rows), smem=rows * M * D * 4,
                        windows=1, form=1, rows=rows)
    rs = row_stride(D)
    return plan(R, N, M, 4 * rs + 4, WARPS * FWD_TILES_PER_WARP * 16 * rs * 2, FWD_TILES_PER_WARP)


def dq_plan(R: int, N: int, M: int, D: int) -> Plan:
    """``fused_attention_bwd``'s dq pass: query tiles against the M keys (k
    and v rows and an f32 mask each)."""
    return plan(R, N, M, 4 * row_stride(D) + 4)


def dkdv_plan(R: int, N: int, M: int, D: int) -> Plan:
    """Its dK / dV pass: key tiles against the N queries (q and dout rows,
    stat and delta each)."""
    return plan(R, M, N, 4 * row_stride(D) + 8)
