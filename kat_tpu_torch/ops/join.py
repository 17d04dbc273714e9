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

kat_tpu rides the position as one more key word through its bitonic sort,
carries the counts through the merge and spreads them with 2*log2(n)
shifted passes (`_run_max_multi`) because its merge is unstable, and
un-permutes with a second sort for want of a scatter; none of that is
carried over.
"""

from __future__ import annotations

import torch

from .merge_kernel import merge_sorted_payload
from .reduce_kernel import compact_flagged
from .sort_kernel import sort_pairs


def _full(n: int, value: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=like.device)


def counts_join(tkeys: torch.Tensor, tcounts: torch.Tensor,
                qkeys: torch.Tensor, queries_sorted: bool = False,
                key_bits: int = 63) -> torch.Tensor:
    """Counts for query keys against a sorted unique-key table.

    tkeys: int64 [cap], ascending, SENTINEL padding at the tail (counts 0
      there).  tcounts: int32 [cap].
    qkeys: int64 query keys of any shape; SENTINEL queries and absent keys
      return 0.  Returns int32 counts in the queries' shape.
    queries_sorted=True promises the flattened queries are already
      ascending (they are another sorted table's keys, say) and skips the
      query sort and the scatter back.
    key_bits: every real key is < 2^(key_bits-1) (2k+1 for k-mers); the
      query sort then takes ceil(key_bits / 8) passes.
    """
    shape = qkeys.shape
    q = qkeys.reshape(-1)
    m = q.numel()
    if m == 0 or tkeys.numel() == 0:
        return torch.zeros(shape, dtype=torch.int32, device=qkeys.device)
    idx = torch.arange(m, dtype=torch.int32, device=q.device)
    if queries_sorted:
        sq, sidx = q.contiguous(), idx
    else:
        sq, sidx = sort_pairs(q.contiguous(), idx, key_bits)
    mkeys, (midx,) = merge_sorted_payload(
        tkeys, (_full(tkeys.numel(), -1, tkeys),), sq, (sidx,))

    is_table = midx < 0
    # table rows at or before each position, less one: the table slot of
    # the row that leads the position's run (-1 before every table row)
    lead = torch.cumsum(is_table, 0, dtype=torch.int32) - 1
    lead_c = lead.clamp_min(0)
    hit = (lead >= 0) & (tkeys.index_select(0, lead_c) == mkeys)
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

    Returns (b_counts_for_a_keys [len(a)], a_counts_for_b_keys [len(b)]),
    int32; SENTINEL (padding) rows get 0.
    """
    na, nb = akeys.numel(), bkeys.numel()
    mkeys, (mcnt, msrc) = merge_sorted_payload(
        akeys, (acounts, _full(na, 1, akeys)),
        bkeys, (bcounts, _full(nb, 2, bkeys)))
    same_next = torch.zeros(na + nb, dtype=torch.bool, device=mkeys.device)
    if na + nb > 1:
        # an equal neighbour is of the other table: keys are unique per
        # table, except the SENTINEL padding, whose counts are 0 anyway
        same_next[:-1] = mkeys[1:] == mkeys[:-1]
    zero = torch.zeros((), dtype=torch.int32, device=mkeys.device)
    from_next = torch.where(same_next, mcnt.roll(-1), zero)
    from_prev = torch.where(same_next.roll(1), mcnt.roll(1), zero)
    out_a, _n1 = compact_flagged((from_next,), msrc == 1, na)
    out_b, _n2 = compact_flagged((from_prev,), msrc == 2, nb)
    return out_a, out_b
