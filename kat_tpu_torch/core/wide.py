"""Wide-key (31 < k <= 255) count tables: the port of kat_tpu/core/wide.py.

A key is W = kmers.words_for_k(k) int64 words of 31 bases, most significant
first (core/kmers.py), and a table holds them as one [W, capacity] tensor,
each word's plane contiguous for the kernels.  The engine is the narrow
one's (core/counting.py) over W-word keys: the streaming counter's flush
sorts the fresh windows (K1 W-word), merges them with the resident table's
real entries (K2 W-word) and reduces by key into `capacity` slots (K3
W-word, in pieces past counting.MAX_STREAM keys: counting.reduce_stream);
when the reduce reports more runs than slots, capacity doubles and the
merge and reduce replay from the pre-flush table.

Left behind from kat_tpu, as in the narrow port: the LSM run mode
(`lsm_runs`, `_run_fn`, `_merge_runs`), measured a net loss on the TPU.
kat_tpu's `_grow_table` is not needed: a replay merges only the table's
real entries, so nothing pads the old table to the new capacity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.merge_kernel import merge_sorted_words
from ..ops.sort_kernel import sort_words, words_order_plain
from . import kmers
from .counting import (TableFullError, _same_device, check_stream,
                       reduce_stream)
from .kmers import SENTINEL


class WideTable(NamedTuple):
    """Sorted unique-key table with W-word keys.

    keys: [W, capacity] int64, ascending lexicographically; padding slots
      (beyond n_unique) hold SENTINEL in every word.
    counts: [capacity] int32 (read as unsigned), 0 in padding slots.
    n_unique: number of real entries (a host int).
    """
    keys: torch.Tensor
    counts: torch.Tensor
    n_unique: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[1]

    @property
    def n_words(self) -> int:
        return self.keys.shape[0]


def empty_table(capacity: int, n_words: int, *, device) -> WideTable:
    """An all-padding table on `device`, which the caller names."""
    return WideTable(
        keys=torch.full((n_words, capacity), SENTINEL, dtype=torch.int64,
                        device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        n_unique=0)


def _unique_reduce(keys: torch.Tensor, w: torch.Tensor,
                   out_size: int) -> WideTable:
    """Sort [W, n] keys carrying weights w, then reduce duplicates (K3
    W-word, in pieces past counting.MAX_STREAM keys: `reduce_stream`).
    For tables built off the flush path; the sort is plain tensor code, as
    kat_tpu's lax.sort at wide.py:52.  Sentinel keys must weigh 0."""
    perm = words_order_plain(keys)
    return WideTable(*reduce_stream(keys[:, perm], w[perm].contiguous(),
                                    out_size))


class WideCodeStreamingCounter:
    """Streaming counter over raw 2-bit code batches for 31 < k <= 255.

    Each host batch is uploaded to `device`, its windows extracted at once
    (kmers.extract_kmers_wide) and their [W, N] words queued.  The flush
    budget counts batches: `flush_batches`, or, when `flush_windows` is
    given, flush_windows // (windows of a batch), so a flush holds about
    flush_windows keys whatever the batch shape (CodeStreamingCounter's
    sizing).  A batch with another length, or more rows than the current
    shape, flushes first and adopts its shape.

    The overflow check is synchronous: each flush fetches n_unique.
    """

    def __init__(self, k: int, canonical: bool = True,
                 initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_batches: int = 16, flush_windows: int | None = None,
                 *, device):
        kmers.wide_spec_valid(k)
        self.k = k
        self.canonical = canonical
        self.n_words = kmers.words_for_k(k)
        self.top_bits = 2 * kmers.top_bases(k) + 1
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.flush_batches = int(flush_batches)
        self.flush_windows = flush_windows
        self.device = torch.device(device)
        self.table = empty_table(self.capacity, self.n_words,
                                 device=self.device)
        self._fresh: list[torch.Tensor] = []
        self._shape: tuple | None = None
        self._fb_eff = self.flush_batches

    def add_codes(self, codes) -> None:
        codes = torch.as_tensor(codes, dtype=torch.uint8)
        if codes.dim() != 2:
            raise ValueError("expected [rows, length] code batch")
        if codes.device.type != "cpu" and not _same_device(codes.device,
                                                           self.device):
            raise ValueError(f"codes: on {codes.device}, but the counter "
                             f"is on {self.device}")
        if self._shape is not None and (codes.shape[1] != self._shape[1]
                                        or codes.shape[0] > self._shape[0]):
            self._flush()
        if self._shape is None:
            self._shape = tuple(codes.shape)
            w = codes.shape[0] * (codes.shape[1] - self.k + 1)
            self._fb_eff = (max(1, self.flush_windows // max(w, 1))
                            if self.flush_windows else self.flush_batches)
        words, _valid = kmers.extract_kmers_wide(codes.to(self.device),
                                                 self.k, self.canonical)
        self._fresh.append(words.reshape(self.n_words, -1))
        if len(self._fresh) >= self._fb_eff:
            self._flush()

    def _merge_reduce(self, prev: WideTable, fresh: torch.Tensor,
                      cap: int) -> WideTable:
        # only the table's real entries join: its padding is all sentinel
        n = prev.n_unique
        mkeys, mw = merge_sorted_words(prev.keys[:, :n], prev.counts[:n],
                                       fresh)
        return WideTable(*reduce_stream(mkeys, mw, cap))

    def _flush(self) -> None:
        self._shape = None
        if not self._fresh:
            return
        fresh = (torch.cat(self._fresh, dim=1) if len(self._fresh) > 1
                 else self._fresh[0])
        self._fresh = []
        check_stream(fresh.shape[1], "the fresh windows")  # before any launch
        fresh = sort_words(fresh, self.top_bits)
        prev = self.table
        table = self._merge_reduce(prev, fresh, self.capacity)
        while table.n_unique > self.capacity:
            self._grow()
            del table  # before the replay allocates its own
            table = self._merge_reduce(prev, fresh, self.capacity)
        self.table = table

    def _grow(self) -> None:
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
            raise TableFullError(
                f"Count table full at capacity {self.capacity}")
        self.capacity *= 2

    def finish(self) -> WideTable:
        self._flush()
        return self.table


def lookup_wide(table: WideTable, qwords: torch.Tensor) -> torch.Tensor:
    """Counts (int32, 0 where absent or SENTINEL) for [W, ...] query keys,
    the queries' shape [...] preserved: a lexicographic binary search over
    the sorted table, ceil(log2(capacity)) + 1 steps of W gathers each (the
    counterpart of kat_tpu's lookup_wide, wide.py:95)."""
    shape = qwords.shape[1:]
    q = qwords.reshape(qwords.shape[0], -1)
    cap = table.capacity
    if cap == 0:
        return torch.zeros(shape, dtype=torch.int32, device=qwords.device)
    lo = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, cap)
    for _ in range(int(np.ceil(np.log2(max(cap, 2)))) + 1):
        mid = (lo + hi) // 2
        m = mid.clamp_max(cap - 1)
        less = torch.zeros_like(lo, dtype=torch.bool)
        eq = torch.ones_like(less)
        for tw, qw in zip(table.keys, q):
            t = tw[m]
            less |= eq & (t < qw)
            eq &= t == qw
        less &= mid < cap
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    pos = lo.clamp_max(cap - 1)
    found = lo < cap
    for tw, qw in zip(table.keys, q):
        found &= tw[pos] == qw
    return torch.where(found, table.counts[pos], 0).reshape(shape)


def table_words_to_numpy(table: WideTable):
    """([W, n] int64 words, u32 counts) of the real entries, on the host."""
    n = table.n_unique
    return (table.keys[:, :n].cpu().numpy(),
            table.counts[:n].cpu().numpy().astype(np.uint32))


def table_to_numpy(table: WideTable):
    """(python-int keys list, u32 counts) of the real entries: the types
    kat_tpu's wide table_to_numpy returns."""
    words, counts = table_words_to_numpy(table)
    return kmers.words_to_ints(words), counts


def table_from_words(words, counts, capacity: int | None = None,
                     *, device) -> WideTable:
    """A table from host ([W, n] int64 words, counts); keys need not be
    sorted or unique (duplicates are summed)."""
    words = np.ascontiguousarray(words, np.int64)
    counts = np.asarray(counts, np.int64).astype(np.int32)
    cap = capacity or max(1, words.shape[1])
    return _unique_reduce(torch.from_numpy(words).to(device),
                          torch.from_numpy(counts).to(device), cap)


def table_from_ints(keys, counts, k: int, capacity: int | None = None,
                    *, device) -> WideTable:
    """A table from python-int keys (< 4^k) and their counts."""
    return table_from_words(kmers.ints_to_words(keys, k), counts, capacity,
                            device=device)


def table_from_jax_words(words, counts, n_unique, k: int,
                         *, device) -> WideTable:
    """A kat_tpu WideTable's planes (its big-first uint32 `words` tuple, or
    [n, nw], fetched as numpy), counts and n_unique, as a port table of the
    same capacity; kat_tpu's all-ones sentinel becomes SENTINEL."""
    keys = torch.from_numpy(kmers.from_ref_words(words, k)).to(device)
    c = torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int32))
    return WideTable(keys, c.to(device), int(n_unique))
