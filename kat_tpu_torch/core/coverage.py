"""Per-base k-mer coverage lookups: the device side of sect/cold and filter
seq (reference src/sect.cc:490-602 processSeq, src/cold.cc:303-407,
src/filter_sequence.cc:330-368 getProfile).

Port of kat_tpu/core/coverage.py.  The reference walks each sequence base by
base, building a mer_dna per window and probing the shared hash
(sect.cc:527-541).  Here a whole batch of sequence chunks becomes one
[rows, W] window extraction and one bulk lookup against the sorted count
table (core/tables.lookup: the sort-merge join or the binary search, as
its policy picks from the card's measurements).
"""

from __future__ import annotations

import torch

from . import tables


def window_hit_counts(table, codes: torch.Tensor, k: int, canonical: bool,
                      method: str | None = None):
    """Per-row (valid windows with count > 0, valid windows): the
    device-reduced form of `window_counts` for consumers that only need
    per-record hit ratios (filter seq, src/filter_sequence.cc:330-368).
    Fetching two [rows] vectors instead of [rows, W] count planes keeps
    host<->device traffic off the profile loop."""
    counts, _gc, valid = window_counts(table, codes, k, canonical, method)
    hits = ((counts > 0) & valid).sum(-1, dtype=torch.int32)
    nwin = valid.sum(-1, dtype=torch.int32)
    return hits, nwin


def window_counts(table, codes: torch.Tensor, k: int, canonical: bool,
                  method: str | None = None):
    """Counts + GC per window of each row of a [.., L] uint8 code batch.

    Returns (counts [.., W] int32, 0 for invalid windows;
             gc [.., W] int32, -1 for invalid windows (sect.cc:530);
             valid [.., W] bool).
    Queries are canonicalized when the hash was counted canonically
    (JellyfishHelper::getCount semantics, jellyfish_helper.cc:189-194); GC
    is that of the forward k-mer.  `method` as in tables.lookup, for a
    narrow table (k <= 31) and a wide one ([W, ...] words) alike.
    """
    keys, valid = tables.extract(codes, k, canonical=False)
    q = tables.canonicalize(keys, k) if canonical else keys
    counts = tables.lookup(table, q, method=method, key_bits=2 * k + 1)
    counts = torch.where(valid, counts, 0)
    gc = torch.where(valid, tables.gc_count(keys, k).to(torch.int32), -1)
    return counts, gc, valid
