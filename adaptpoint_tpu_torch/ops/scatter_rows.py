"""Launch shapes of the scatter-adds of rows 13 and 15, and their ordered plain function.

``csrc/scatter_rows.cuh`` holds the block templates behind the 3-NN weighted
gather's d_feat backward (``ops.fpinterp``, kernel row 13) and the row
gather's backward (``ops.gather``, row 15): a block owns a tile of one
cloud's destination rows and a channel slice, lists each row's slots in
shared memory in ascending order and sums each list in f32 registers in that
order, writing each row once. :func:`choose` picks its launch shape on the
host and :func:`smem_bytes` copies its shared-memory layout (``chip_smoke.py``
holds the two equal to the kernels' own). :func:`scatter_rows_ordered` is a
plain function of the kernels' sum order, which they equal bit for bit; the
smoke run and the tests use it, the port does not.

Two other designs share the wrappers: ``STAGED`` (the weighted gather's, where
it fits: a 128-channel slice of the cloud's source rows staged in shared
memory once, so no source row is read once for each row that names it) and
``L2RED`` (a thread a slot and 4 channels, 16-byte L2 reductions into a
zeroed f32 buffer, and a rounding pass for bf16), the default for small
scatters, where launches and barriers outlast the work.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = ["ORDERED", "L2RED", "STAGED", "DESIGNS", "ScatterTiling", "choose",
           "smem_bytes", "scatter_rows_ordered"]

ORDERED, L2RED, STAGED = 0, 1, 2
DESIGNS = {"ordered": ORDERED, "l2red": L2RED, "staged": STAGED}

_THREADS = 256  # a block: 8 warps
_WARPS = 8
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_SMEM_TWO_BLOCKS = 115712  # the most a block may use for two an SM
# slots a round at most, a multiple of 3 (the weighted gather stages whole
# rows of three slots); half as many for the weighted gather, whose slots
# carry two more words: 72 and 84 KB
_CHUNK = 12288
_MAX_ROWS = 1024  # destination rows a block at most
# B * S * C at most where L2RED is the default: there the ordered design's
# fixed chain of barriers and two dependent loads outlasts the work
# (PERF.md, PR 14: 2.7 against 5.5 us at the resampling shape)
_SMALL = 1 << 18
# blocks a launch keeps at least while its tile grows: about two an SM,
# the fastest tile at the GAN step's shapes (PERF.md, PR 14)
_MIN_BLOCKS = 256


class ScatterTiling(NamedTuple):
    """A launch shape, in the order the C entry points take it: the design,
    ``vec`` channels a lane moves at once (1, 4, or 8 for bf16 sources and
    for STAGED), ``lshift``
    the log2 of the lanes that share a destination row, ``rows``
    destination rows a block, ``chunk`` slots a round (the lists'
    capacity; the cloud's slots take ceil(S / chunk) rounds)."""
    design: int
    vec: int
    lshift: int
    rows: int
    chunk: int


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def _vector_width(C: int, elem_bytes: int, aligned: bool) -> int:
    """Channels a lane loads at once: 16 bytes (8 bf16, 4 f32) where ``C``
    and the pointers allow, 8 bytes of bf16 where ``C % 4 == 0``, else 1."""
    if aligned and elem_bytes == 2 and C % 8 == 0:
        return 8
    if aligned and C % 4 == 0:
        return 4
    return 1


def smem_bytes(t: ScatterTiling, S: int, aux: bool, src_rows: int = 0) -> int:
    """Shared memory of one block, as ``csrc/scatter_rows.cuh`` smem_bytes
    computes it: each warp's counts per row (16 bits), the rows' list
    starts, the scan's 32 segment totals and 8 warp totals; for each slot of
    a round its tile row, its place among the compacted slots and its list
    entry (16 bits each) and, with ``aux`` (the weighted gather's op), its
    word of weights by slot and by list entry; ORDERED, when the ``S`` slots
    take more than one round, the rows' partial sums; STAGED, the
    ``src_rows`` source rows of the block's channel slice in bf16. L2RED
    uses none."""
    if t.design not in (ORDERED, STAGED):
        return 0
    cs = (1 << t.lshift) * t.vec
    lists = (_a16(_WARPS * t.rows * 2) + _a16((t.rows + 41) * 4)
             + 3 * _a16(t.chunk * 2) + (2 * _a16(t.chunk * 4) if aux else 0))
    if t.design == STAGED:
        return lists + _a16(src_rows * cs * 2)
    return lists + (t.rows * cs * 4 if S > t.chunk else 0)


def _staged(S: int, M: int, C: int):
    """STAGED's launch shape for the weighted gather (S = 3 N slots), or
    None where it does not fit: one round, a tile of all M rows, a slice of
    128 channels (16 lanes of 8) whose N source rows, in bf16, fit two
    blocks an SM beside the lists. Narrower slices lost to ORDERED (PERF.md,
    PR 14): each slice builds the cloud's lists again."""
    groups = _THREADS // 16
    t = ScatterTiling(STAGED, 8, 4, -(-M // groups) * groups, S)
    if C < 128 or t.rows > _MAX_ROWS \
            or smem_bytes(t, S, True, S // 3) > _SMEM_TWO_BLOCKS:
        return None
    return t


@functools.lru_cache(maxsize=256)
def choose(B: int, S: int, M: int, C: int, aux: bool, elem_bytes: int,
           aligned: bool = True, design: int | None = None) -> ScatterTiling:
    """The launch shape for ``S`` slots onto ``M`` destination rows of
    ``C`` channels in each of ``B`` clouds, source elements of
    ``elem_bytes``, ``aux`` for an op that stages a word of weights a slot
    (the weighted gather's); ``aligned``: the source and output pointers are
    16-byte aligned.

    ``design`` None picks L2RED for small scatters (B * S * C <= 2^18,
    where launches and barriers dominate), STAGED for the weighted gather
    where it fits (16-byte aligned rows of C % 8 == 0 channels, C >= 128,
    M <= 1024, a 128-channel slice of the cloud's source rows in shared
    memory), ORDERED otherwise.

    ORDERED: the lanes of a row group cover up to ``32 * vec`` channels
    (fewer for narrow rows, so that a lane owns a row at C <= vec); the
    block's tile is the tallest (up to 1024 rows) that still gives 256
    blocks, about two an SM, so that few blocks stage the cloud's slots
    again; a round takes up to 12288 slots (6144 with ``aux``). Where the
    slots take more than one round the tile shrinks until the rows' partial
    sums fit beside the lists. Raises ValueError on a shape the kernels do
    not take."""
    if min(B, S, M, C) < 1:
        raise ValueError(f"the scatter takes B, slots, rows, C >= 1; got "
                         f"B={B} S={S} M={M} C={C}")
    if B * M >= 2 ** 31 or S >= 2 ** 31:
        raise ValueError(f"B * M = {B * M} and S = {S} must stay below 2^31")
    vec = _vector_width(C, elem_bytes, aligned)
    staged = (_staged(S, M, C) if aux and vec == 4 and C % 8 == 0
              and S < 2 ** 16 else None)
    if design is None:
        design = (L2RED if B * S * C <= _SMALL
                  else ORDERED if staged is None else STAGED)
    if design == STAGED:
        if staged is None:
            raise ValueError(f"STAGED does not take S={S} M={M} C={C}")
        return staged
    if design == L2RED:
        return ScatterTiling(L2RED, min(vec, 4), 0, 1, 1)
    if design != ORDERED:
        raise ValueError(f"unknown scatter design {design}")
    lanes = 1
    while lanes < 32 and lanes * vec < C:
        lanes *= 2
    slices = -(-C // (lanes * vec))
    rows = _THREADS // lanes
    while (rows * 2 <= _MAX_ROWS and rows < M
           and B * -(-M // (rows * 2)) * slices >= _MIN_BLOCKS):
        rows *= 2
    chunk = min(S, _CHUNK // 2 if aux else _CHUNK)
    t = ScatterTiling(ORDERED, vec, lanes.bit_length() - 1, rows, chunk)
    while smem_bytes(t, S, aux) > _SMEM_TWO_BLOCKS \
            and t.rows > _THREADS // lanes:
        t = t._replace(rows=t.rows // 2)
    return t


def scatter_rows_ordered(addends: torch.Tensor, dest: torch.Tensor,
                         m: int) -> torch.Tensor:
    """``addends (B, S, C)`` f32 summed onto ``(B, m, C)`` f32 rows by
    ``dest (B, S)`` (a slot outside ``[0, m)`` adds nothing) in the ordered
    kernels' order: each row's sum starts from 0 and takes its slots in
    ascending order. A loop over list positions, vectorised over rows."""
    B, S, C = addends.shape
    dest = dest.long()
    key = torch.where((dest >= 0) & (dest < m), dest, torch.full_like(dest, m))
    order = torch.sort(key, dim=1, stable=True).indices  # by row, then slot
    cnt = torch.zeros((B, m + 1), dtype=torch.long, device=dest.device)
    cnt.scatter_add_(1, key, torch.ones_like(key))
    cnt = cnt[:, :m]
    start = torch.cumsum(cnt, dim=1) - cnt
    acc = torch.zeros((B, m, C), dtype=torch.float32, device=addends.device)
    for k in range(int(cnt.max()) if cnt.numel() else 0):
        has = (cnt > k)[..., None]
        slot = torch.gather(order, 1, (start + k).clamp(max=S - 1))
        add = torch.gather(addends, 1, slot[..., None].expand(-1, -1, C))
        acc = torch.where(has, acc + add, acc)
    return acc
