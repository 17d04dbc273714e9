"""Operations over count tables that the tool engines share: bulk lookups
(with the choice between the sort-merge join and the binary search), table
compaction, and the key helpers of the window profiles.

Port of kat_tpu/core/tables.py: a table is a narrow CountTable of int64
keys (k <= 31) or a WideTable of [W, capacity] int64 words (31 < k <= 255,
core/wide.py).  Every lookup, narrow or wide, goes to one of two routes:
the sort-merge join (ops/join.py, K1 with a value, K2 with payload planes
and K4, in their one-word or W-word forms) or the binary search
(counting.lookup, wide.lookup_wide).  `_join_policy` picks between them
from the card's measurements (benchmarks/sweep_lookup.py, PERF.md).
"""

from __future__ import annotations

import numpy as np
import torch

from . import counting, kmers, wide

# The join's streaming passes cost O(capacity + m), the search's log2(cap)
# dependent gathers per query.  Below JOIN_MIN_QUERIES queries, or below
# capacity / JOIN_CAP_RATIO of them, the search is the cheaper route.
JOIN_MIN_QUERIES = 1 << 16
JOIN_CAP_RATIO = 256


def is_wide(table) -> bool:
    return isinstance(table, wide.WideTable)


def real_mask(table) -> torch.Tensor:
    """True for slots holding a real key (non-sentinel)."""
    keys = table.keys[0] if is_wide(table) else table.keys
    return keys != kmers.SENTINEL


def _join_policy(m: int, cap: int, device: torch.device, n_words: int = 1,
                 dual: bool = False) -> bool:
    """Route a bulk lookup of m queries against a table of `cap` slots with
    keys of `n_words` words through the sort-merge join (ops/join.py)?
    dual: the fused probe of two tables (m is the other table's capacity),
    against two searches.

    Only where the join's sorts and merges are kernels, that is for a table
    on the card, and only once the batch is within JOIN_CAP_RATIO of the
    table.  The card's measurements (benchmarks/sweep_lookup.py, PERF.md
    §6, an H100): the one-word search beat the one-word join in every
    cell (by 1.6x to 13x), so a narrow single lookup takes the search; the
    W-word join beat the W-word search in every cell (1.9x to 10x: the
    search is ~400 launches a call), and the fused probe two searches
    (1.2x narrow, 38-41x wide)."""
    if device.type != "cuda" or (n_words == 1 and not dual):
        return False
    return m >= max(JOIN_MIN_QUERIES, cap // JOIN_CAP_RATIO)


def _n_words(table) -> int:
    return table.n_words if is_wide(table) else 1


def lookup(table, qkeys: torch.Tensor, assume_sorted: bool = False,
           method: str | None = None, key_bits: int = 63) -> torch.Tensor:
    """Counts (int32, 0 where absent) for int64 query keys of any shape
    ([W, ...] words for a wide table; the counts then have shape [...]).

    method: "join" (ops/join.counts_join), "search" (counting.lookup,
    wide.lookup_wide), or None to choose by `_join_policy`.  Both give
    identical counts.
    assume_sorted=True promises the flattened queries are already ascending
    (they are another sorted table's keys); the join then skips its query
    sort and scatter.  The binary search ignores it.
    key_bits: as in counts_join; 2k+1 shortens the join's query sort.
    """
    if method not in (None, "join", "search"):
        raise ValueError(f"method={method!r}: expected None, 'join' or "
                         "'search'")
    n_words = _n_words(table)
    if method is None:
        m = qkeys.numel() // n_words
        method = "join" if _join_policy(m, table.capacity,
                                        table.keys.device,
                                        n_words) else "search"
    if method == "join":
        from ..ops.join import counts_join

        return counts_join(table.keys, table.counts, qkeys,
                           queries_sorted=assume_sorted, key_bits=key_bits)
    if n_words > 1:
        return wide.lookup_wide(table, qkeys)
    return counting.lookup(table, qkeys)


def lookup_dual(t_a, t_b):
    """Counts of each table's keys in the OTHER table through one merge
    (ops/join.counts_join_dual): comp's pass-1/2 cross probes fused.

    Returns (b_counts_for_a_keys, a_counts_for_b_keys) aligned with each
    table's capacity, or None when the join policy would not engage for
    either direction (callers fall back to two independent lookups).  The
    two tables' keys have the same number of words (one k)."""
    n_words = _n_words(t_a)
    if _n_words(t_b) != n_words:
        raise ValueError("lookup_dual: the tables' keys differ in words")
    dev = t_a.keys.device
    if not (_join_policy(t_a.capacity, t_b.capacity, dev, n_words, True)
            and _join_policy(t_b.capacity, t_a.capacity, dev, n_words,
                             True)):
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
    if is_wide(table):
        return wide.WideTable(table.keys[:, :tgt].contiguous(),
                              table.counts[:tgt], n)
    return counting.CountTable(table.keys[:tgt], table.counts[:tgt], n)


def canonicalize(qkeys: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp) per key (sentinel-preserving); [W, ...] words for
    k > 31."""
    if k > kmers.MAX_K:
        return kmers.canonicalize_words(qkeys, k)
    return kmers.canonicalize(qkeys, k)


def gc_count(qkeys: torch.Tensor, k: int) -> torch.Tensor:
    """G/C bases per key (0 for SENTINEL); [W, ...] words for k > 31."""
    if k > kmers.MAX_K:
        return kmers.gc_count_words(qkeys)
    return kmers.gc_count(qkeys)


def extract(codes: torch.Tensor, k: int, canonical: bool):
    """(keys, valid) for any supported k: int64 keys for k <= 31, [W, ...]
    words beyond."""
    if k > kmers.MAX_K:
        return kmers.extract_kmers_wide(codes, k, canonical)
    return kmers.extract_kmers(codes, k, canonical)


def gc_of_keys(table) -> torch.Tensor:
    """GC count per table slot (0 at sentinel slots)."""
    if is_wide(table):
        return kmers.gc_count_words(table.keys)
    return kmers.gc_count(table.keys)


def where_real(table, values: torch.Tensor, fill=0) -> torch.Tensor:
    return torch.where(real_mask(table), values, fill)
