"""Restore planning in one dimension: which saved pieces does a rank
need, and which slice of each?

Counterpart of batch_shipyard_tpu/parallel/restore_plan.py: the same
even-split math (``shard_ranges``, ``host_reads``, ``plan``,
``read_fraction``), plus ``range_reads`` for the ragged ranges the port
saves (parallel/sharding.py: a rank's chunk of an fsdp unit covers
ranges of the unit's tensors that start and end anywhere). A resized
gang reads, on each rank, only the parts of the saved pieces that
overlap the range it holds.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ShardRead:
    """Take ``[lo, hi)`` (source-shard-local indices) of source shard
    ``shard`` and place it at ``[dst_lo, dst_lo + hi - lo)`` of the
    target's block."""

    shard: int
    lo: int
    hi: int
    dst_lo: int


def shard_ranges(dim: int, parts: int) -> list[tuple[int, int]]:
    """The ``parts`` equal contiguous [lo, hi) blocks of an axis of size
    ``dim`` (indivisible axes raise)."""
    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    if dim % parts:
        raise ValueError(
            f"axis of size {dim} does not split over {parts} shards")
    block = dim // parts
    return [(k * block, (k + 1) * block) for k in range(parts)]


def range_reads(source: Sequence[tuple[int, int]], lo: int, hi: int
                ) -> list[ShardRead]:
    """The reads that fill the target range [lo, hi) from source shards
    covering the axis at ``source`` ([lo, hi) each, any lengths), in
    order; a part of [lo, hi) that no source covers is not read."""
    reads = []
    for shard, (s_lo, s_hi) in enumerate(source):
        a, b = max(lo, s_lo), min(hi, s_hi)
        if b > a:
            reads.append(ShardRead(shard=shard, lo=a - s_lo, hi=b - s_lo,
                                   dst_lo=a - lo))
    return reads


def host_reads(dim: int, source_parts: int, target_parts: int,
               target_index: int) -> list[ShardRead]:
    """The reads target ``target_index`` (of ``target_parts``) issues
    against ``source_parts`` even shards: the whole target block exactly
    once, in order."""
    if not 0 <= target_index < target_parts:
        raise ValueError(f"target_index {target_index} out of range "
                         f"[0, {target_parts})")
    t_lo, t_hi = shard_ranges(dim, target_parts)[target_index]
    return range_reads(shard_ranges(dim, source_parts), t_lo, t_hi)


def plan(dim: int, source_parts: int,
         target_parts: int) -> dict[int, list[ShardRead]]:
    """The full N -> M plan: target index -> its reads."""
    return {m: host_reads(dim, source_parts, target_parts, m)
            for m in range(target_parts)}


def read_fraction(dim: int, source_parts: int, target_parts: int,
                  target_index: int) -> float:
    """The fraction of the axis one target reads (1/M for an even
    resize)."""
    reads = host_reads(dim, source_parts, target_parts, target_index)
    return sum(r.hi - r.lo for r in reads) / float(dim)
