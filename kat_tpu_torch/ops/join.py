"""Sort-merge-join point lookups: the bulk-query engine of the analysis
phase (sect / cold / comp probes / filter-seq profiles).

Port of kat_tpu/ops/join.py.  The reference tool serves its second hot loop,
random point probes into a shared hash (src/sect.cc:536, src/comp.cc:401-447),
one probe at a time; here a whole batch of queries is answered by streaming
passes over the sorted table:

1. sort the queries by key, each carrying its position (K1 with a payload,
   ops/sort_kernel.sort_pairs);
2. merge them with the resident sorted table (K2 with a payload,
   ops/merge_kernel.merge_sorted_payload): table rows carry -1, queries
   their position;
3. give every query the count of the table row that leads its run of equal
   keys.  The merge is stable with the table first on ties and table keys
   are unique, so that row is the last table row at or before the query:
   a running count of table rows gives its slot in the table, and its
   count holds only where its key equals the query's;
4. pull the query rows out of the merged stream with one stable compaction
   (K4, ops/reduce_kernel.compact_flagged) and scatter the counts back to
   the queries' own order.

Wide keys (31 < k <= 255, [W, n] int64 words) take the same steps through
the W-word forms of K1 with a value (sort_words_pairs) and K2 with payload
planes (merge_sorted_words_payload); the equality tests run over every
word, and K4 is the same.

kat_tpu rides the position as one more key word through its bitonic sort,
carries the counts through the merge and spreads them with 2*log2(n)
shifted passes (`_run_max_multi`) because its merge is unstable, and
un-permutes with a second sort for want of a scatter; none of that is
carried over.
"""

from __future__ import annotations

import torch

from .merge_kernel import merge_sorted_payload, merge_sorted_words_payload
from .reduce_kernel import compact_flagged
from .sort_kernel import sort_pairs, sort_words_pairs


def _full(n: int, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=like.device)


def _top_bits(key_bits: int, n_words: int) -> int:
    """The query sort's top_bits for W-word keys: a wide k-mer's 2k+1 less
    62 bits a lower word; key_bits <= 63 says nothing of k (all 63)."""
    return key_bits - 62 * (n_words - 1) if key_bits > 63 else 63


def _equal(keys: torch.Tensor, i: torch.Tensor,
           other: torch.Tensor) -> torch.Tensor:
    """keys at columns i == other, over every word ([W, n] or 1-D), one
    word at a time so that no [W, len(i)] gather is held."""
    if keys.dim() == 1:
        return keys.index_select(0, i) == other
    eq = keys[0].index_select(0, i) == other[0]
    for w in range(1, keys.shape[0]):
        eq &= keys[w].index_select(0, i) == other[w]
    return eq


def counts_join(tkeys: torch.Tensor, tcounts: torch.Tensor,
                qkeys: torch.Tensor, queries_sorted: bool = False,
                key_bits: int = 63) -> torch.Tensor:
    """Counts for query keys against a sorted unique-key table.

    tkeys: int64 [cap], ascending, SENTINEL padding at the tail (counts 0
      there), or [W, cap] words of wide keys.  tcounts: int32 [cap].
    qkeys: int64 query keys of any shape, [W, ...] for a wide table;
      SENTINEL queries and absent keys return 0.  Returns int32 counts in
      the queries' shape ([...] for wide queries).
    queries_sorted=True promises the flattened queries are already
      ascending (they are another sorted table's keys, say) and skips the
      query sort and the scatter back.
    key_bits: every real key is < 2^(key_bits-1) (2k+1 for k-mers); the
      query sort then takes ceil(key_bits / 8) passes (for wide keys, 8 a
      lower word and ceil((2k+1 - 62 (W-1)) / 8) over the top word).
    """
    wide = tkeys.dim() == 2
    cap = tkeys.shape[-1]
    shape = qkeys.shape[1:] if wide else qkeys.shape
    q = (qkeys.reshape(qkeys.shape[0], -1) if wide
         else qkeys.reshape(-1)).contiguous()
    m = q.shape[-1]
    if m == 0 or cap == 0:
        return torch.zeros(shape, dtype=torch.int32, device=qkeys.device)
    idx = torch.arange(m, dtype=torch.int32, device=q.device)
    if queries_sorted:
        sq, sidx = q, idx
    elif wide:
        sq, sidx = sort_words_pairs(q, idx, _top_bits(key_bits, q.shape[0]))
    else:
        sq, sidx = sort_pairs(q, idx, key_bits)
    merge = merge_sorted_words_payload if wide else merge_sorted_payload
    mkeys, (midx,) = merge(tkeys, (_full(cap, -1, tkeys),), sq, (sidx,))

    is_table = midx < 0
    # table rows at or before each position, less one: the table slot of
    # the row that leads the position's run (-1 before every table row)
    lead = torch.cumsum(is_table, 0, dtype=torch.int32) - 1
    lead_c = lead.clamp_min(0)
    hit = (lead >= 0) & _equal(tkeys, lead_c, mkeys)
    c = torch.where(hit, tcounts.index_select(0, lead_c), 0)

    ki, kc, _n_kept = compact_flagged((midx, c), ~is_table, m)
    if queries_sorted:
        return kc.reshape(shape)
    out = torch.empty(m, dtype=torch.int32, device=q.device)
    out.index_copy_(0, ki.to(torch.int64), kc)
    return out.reshape(shape)


def counts_join_dual(akeys: torch.Tensor, acounts: torch.Tensor,
                     bkeys: torch.Tensor, bcounts: torch.Tensor):
    """Counts of each sorted unique-key table's keys in the OTHER table,
    through one merge (comp's pass-1 and pass-2 cross probes fused).

    Every run of equal keys in the merged stream holds at most one row of
    each table, `a`'s first, so an `a` row finds its `b` partner one
    position ahead and a `b` row its `a` partner one position back.  Two
    stable compactions, driven by the source plane (1 = a, 2 = b), return
    each table's answers in its own sorted order.

    akeys, bkeys: int64 [n] keys, or [W, n] words of wide keys.
    Returns (b_counts_for_a_keys [len(a)], a_counts_for_b_keys [len(b)]),
    int32; SENTINEL (padding) rows get 0.
    """
    wide = akeys.dim() == 2
    na, nb = akeys.shape[-1], bkeys.shape[-1]
    merge = merge_sorted_words_payload if wide else merge_sorted_payload
    mkeys, (mcnt, msrc) = merge(
        akeys, (acounts, _full(na, 1, akeys)),
        bkeys, (bcounts, _full(nb, 2, bkeys)))
    # row i's count for its equal neighbour: an equal neighbour is of the
    # other table (keys are unique per table, except the SENTINEL padding,
    # whose counts are 0 anyway); written into shifted slices, with no
    # copy of the stream
    from_next = torch.zeros(na + nb, dtype=torch.int32, device=mkeys.device)
    from_prev = torch.zeros_like(from_next)
    if na + nb > 1:
        words = mkeys if wide else mkeys[None]
        same = words[0, 1:] == words[0, :-1]
        for w in range(1, words.shape[0]):
            same &= words[w, 1:] == words[w, :-1]
        zero = torch.zeros((), dtype=torch.int32, device=mkeys.device)
        torch.where(same, mcnt[1:], zero, out=from_next[:-1])
        torch.where(same, mcnt[:-1], zero, out=from_prev[1:])
    out_a, _n1 = compact_flagged((from_next,), msrc == 1, na)
    out_b, _n2 = compact_flagged((from_prev,), msrc == 2, nb)
    return out_a, out_b
