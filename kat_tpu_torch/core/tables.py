"""Operations over count tables that the tool engines share: bulk lookups
(with the choice between the sort-merge join and the binary search), table
compaction, and the key helpers of the window profiles.

Port of kat_tpu/core/tables.py, narrow half: a table is a CountTable of
int64 keys (k <= 31).  kat_tpu's wide tables (k 32-255) are not ported yet
(ROADMAP.md §1 item 12); what would take one raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import counting, kmers

# The join's streaming passes cost O(capacity + m); below this many queries
# the per-query binary search is the cheaper route whatever the table.
JOIN_MIN_QUERIES = 1 << 16


def real_mask(table) -> torch.Tensor:
    """True for slots holding a real key (non-sentinel)."""
    return table.keys != kmers.SENTINEL


def _join_policy(m: int, cap: int, device: torch.device) -> bool:
    """Route a bulk lookup of m queries through the sort-merge join
    (ops/join.py)?  Only where its sorts and merges are kernels, that is
    for a table on the card, and only once the query batch is within a
    couple of orders of magnitude of the table: the join reads the whole
    table once per call, the binary search log2(cap) slots per query."""
    return device.type == "cuda" and m >= max(JOIN_MIN_QUERIES, cap // 256)


def lookup(table, qkeys: torch.Tensor, assume_sorted: bool = False,
           method: str | None = None, key_bits: int = 63) -> torch.Tensor:
    """Counts (int32, 0 where absent) for int64 query keys of any shape.

    method: "join" (ops/join.counts_join), "search" (counting.lookup), or
    None to choose by `_join_policy`.  Both give identical counts.
    assume_sorted=True promises the flattened queries are already ascending
    (they are another sorted table's keys); the join then skips its query
    sort and scatter.  The binary search ignores it.
    key_bits: as in counts_join; 2k+1 shortens the join's query sort.
    """
    if method not in (None, "join", "search"):
        raise ValueError(f"method={method!r}: expected None, 'join' or "
                         "'search'")
    if method is None:
        method = "join" if _join_policy(qkeys.numel(), table.capacity,
                                        table.keys.device) else "search"
    if method == "join":
        from ..ops.join import counts_join

        return counts_join(table.keys, table.counts, qkeys,
                           queries_sorted=assume_sorted, key_bits=key_bits)
    return counting.lookup(table, qkeys)


def lookup_dual(t_a, t_b):
    """Counts of each table's keys in the OTHER table through one merge
    (ops/join.counts_join_dual): comp's pass-1/2 cross probes fused.

    Returns (b_counts_for_a_keys, a_counts_for_b_keys) aligned with each
    table's capacity, or None when the join policy would not engage for
    either direction (callers fall back to two independent lookups)."""
    dev = t_a.keys.device
    if not (_join_policy(t_a.capacity, t_b.capacity, dev)
            and _join_policy(t_b.capacity, t_a.capacity, dev)):
        return None
    from ..ops.join import counts_join_dual

    return counts_join_dual(t_a.keys, t_a.counts, t_b.keys, t_b.counts)


def compact(table, min_capacity: int = 1 << 17):
    """Shrink a FINISHED table to the smallest power-of-two capacity holding
    its real entries (sorted layout: real rows are a prefix).

    The join pays streaming work over the table's capacity per bulk lookup,
    so probing a table whose capacity doubled past its final fill wastes up
    to 2x; tools call this once before their lookup loops."""
    n = table.n_unique
    tgt = max(min_capacity, 1 << max(0, int(np.ceil(np.log2(max(n, 1))))))
    if tgt >= table.capacity:
        return table
    return counting.CountTable(table.keys[:tgt], table.counts[:tgt], n)


def canonicalize(qkeys: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp) per key (sentinel-preserving)."""
    return kmers.canonicalize(qkeys, k)


def gc_count(qkeys: torch.Tensor) -> torch.Tensor:
    return kmers.gc_count(qkeys)


def extract(codes: torch.Tensor, k: int, canonical: bool):
    """(keys, valid) for any supported k."""
    if k > kmers.MAX_K:
        raise NotImplementedError(
            f"k={k} > {kmers.MAX_K} (wide keys) not ported yet: "
            "ROADMAP.md §1 item 12")
    return kmers.extract_kmers(codes, k, canonical)


def gc_of_keys(table) -> torch.Tensor:
    """GC count per table slot (0 at sentinel slots)."""
    return gc_count(table.keys)


def where_real(table, values: torch.Tensor, fill=0) -> torch.Tensor:
    return torch.where(real_mask(table), values, fill)
