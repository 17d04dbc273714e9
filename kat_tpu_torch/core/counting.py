"""Sort + merge + reduce k-mer counting: the port of kat_tpu/core/counting.py.

A count table is a *sorted* fixed-capacity array of unique int64 keys with
int32 counts; slots past `n_unique` hold SENTINEL / 0.  The streaming
counter keeps one such table resident on the device and folds in the fresh
windows once per flush: sort the fresh keys (K1), merge them with the
table (K2), reduce by key into `capacity` slots (K3).  When the reduce
reports more runs than slots, capacity doubles and the merge + reduce
replay from the pre-flush table, which is the observable behaviour of
jellyfish's cooperative resize (hash_counter.hpp:204-244).

Left behind from kat_tpu: the LSM run mode (`lsm_runs`, measured a net
loss on the TPU), `lookup`, and `StreamingCounter`; both readers feed
CodeStreamingCounter.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.merge_kernel import merge_sorted
from ..ops.reduce_kernel import reduce_by_key
from ..ops.sort_kernel import sort_keys
from .kmers import SENTINEL, extract_kmers, from_planes


class CountTable(NamedTuple):
    """Sorted unique-key count table.

    keys: [capacity] int64, ascending; padding slots (beyond n_unique) hold
      SENTINEL.
    counts: [capacity] int32, 0 in padding slots.
    n_unique: number of real entries (a host int: the port fetches it once
      per flush).
    """
    keys: torch.Tensor
    counts: torch.Tensor
    n_unique: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def empty_table(capacity: int, device="cpu") -> CountTable:
    return CountTable(
        keys=torch.full((capacity,), SENTINEL, dtype=torch.int64,
                        device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        n_unique=0)


def _unique_reduce(keys: torch.Tensor, w: torch.Tensor,
                   out_size: int) -> CountTable:
    """Sort flat (keys, w) and reduce duplicate keys by summing weights.

    Plain tensor code for the tables built off the flush path (merges of
    two tables, host tables): a stable `torch.sort` that carries w, then
    the reduce of ops/reduce_kernel.py.  Sentinel keys sort last; their
    weights must be 0."""
    keys, perm = torch.sort(keys, stable=True)
    k, c, nu = reduce_by_key(keys, w[perm].contiguous(), out_size)
    return CountTable(k, c, int(nu))


def merge_tables(a: CountTable, b: CountTable,
                 capacity: int | None = None) -> CountTable:
    """Merge two count tables; output capacity defaults to capA + capB.

    The caller must check `n_unique <= capacity` afterwards."""
    cap = capacity or (a.capacity + b.capacity)
    return _unique_reduce(torch.cat([a.keys, b.keys]),
                          torch.cat([a.counts, b.counts]), cap)


class TableFullError(RuntimeError):
    pass


class CodeStreamingCounter:
    """Streaming counter over raw 2-bit code batches.

    Each batch is moved to `device` and its windows extracted at once;
    the int64 keys wait in a list until the flush budget is reached (the
    JAX counter stacks the code batches instead and extracts inside its
    fused flush).  A flush concatenates them, sorts them (K1), merges them
    with the resident table (K2) and reduces into `capacity` slots (K3).

    Batches are [rows, length] code arrays (numpy or torch).  A batch with
    another length, or more rows than the current shape, flushes first and
    adopts its shape; batches with fewer rows join the current flush.

    The overflow check is synchronous: each flush fetches n_unique from the
    device (kat_tpu defers that fetch by one flush to keep the TPU busy).
    """

    def __init__(self, k: int, canonical: bool = True,
                 initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_batches: int = 16, flush_windows: int | None = None,
                 device="cpu"):
        self.k = k
        self.canonical = canonical
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.flush_batches = int(flush_batches)
        # Windows-based flush sizing: when set (e.g. 1<<26), the per-shape
        # batch budget becomes flush_windows // windows_per_batch, so a
        # flush holds about flush_windows keys whatever the batch shape.
        self.flush_windows = int(flush_windows) if flush_windows else None
        self.device = torch.device(device)
        self._fb_eff = self.flush_batches
        self.table = empty_table(self.capacity, self.device)
        self._fresh: list[torch.Tensor] = []
        self._shape: tuple | None = None

    def add_codes(self, codes) -> None:
        codes = torch.as_tensor(codes, dtype=torch.uint8)
        if codes.dim() != 2:
            raise ValueError("expected [rows, length] code batch")
        if self._shape is not None and codes.shape[1] != self._shape[1]:
            self._flush()
        if self._shape is None:
            self._set_shape(tuple(codes.shape))
        elif codes.shape[0] > self._shape[0]:
            self._flush()
            self._set_shape(tuple(codes.shape))
        keys, _valid = extract_kmers(codes.to(self.device), self.k,
                                     self.canonical)
        self._fresh.append(keys.reshape(-1))
        if len(self._fresh) >= self._fb_eff:
            self._flush()

    def _set_shape(self, shape) -> None:
        """Adopt a new batch geometry and recompute the flush budget for
        it.  EVERY shape change must come through here: the budget counts
        batches, so carrying a budget computed for a small first batch
        (parallel range readers often yield a short batch first) onto
        full-size batches would hold flush_windows x (new/old batch ratio)
        keys in one flush — a 25 GB OOM in kat_tpu's history."""
        self._shape = shape
        if self.flush_windows:
            w = shape[0] * (shape[1] - self.k + 1)
            self._fb_eff = max(1, self.flush_windows // max(w, 1))
        else:
            self._fb_eff = self.flush_batches

    def _merge_reduce(self, prev: CountTable, fresh: torch.Tensor,
                      cap: int) -> CountTable:
        # only the table's real entries join: its padding is all sentinel
        n = prev.n_unique
        mkeys, mw = merge_sorted(prev.keys[:n], prev.counts[:n], fresh)
        keys, counts, n_unique = reduce_by_key(mkeys, mw, cap)
        return CountTable(keys, counts, int(n_unique))

    def _flush(self) -> None:
        if not self._fresh:
            return
        fresh = (torch.cat(self._fresh) if len(self._fresh) > 1
                 else self._fresh[0])
        self._fresh = []
        self._shape = None
        fresh = sort_keys(fresh, 2 * self.k + 1)
        prev = self.table
        table = self._merge_reduce(prev, fresh, self.capacity)
        while table.n_unique > self.capacity:
            self._grow()
            table = self._merge_reduce(prev, fresh, self.capacity)
        self.table = table

    def _grow(self) -> None:
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
            raise TableFullError(
                f"Count table full at capacity {self.capacity}")
        self.capacity *= 2

    def finish(self) -> CountTable:
        self._flush()
        return self.table


def table_to_numpy(table: CountTable):
    """(keys u64, counts u32) as host numpy arrays, real entries only —
    the same types kat_tpu's table_to_numpy returns."""
    n = table.n_unique
    keys = table.keys[:n].cpu().numpy().astype(np.uint64)
    counts = table.counts[:n].cpu().numpy().astype(np.uint32)
    return keys, counts


def table_from_numpy(keys: np.ndarray, counts: np.ndarray,
                     capacity: int | None = None,
                     device="cpu") -> CountTable:
    """Build a table from host (u64 keys, counts); keys need not be sorted
    or unique (duplicates are summed)."""
    keys = np.asarray(keys, np.uint64).astype(np.int64)
    counts = np.asarray(counts, np.int64).astype(np.int32)
    cap = capacity or max(1, len(keys))
    return _unique_reduce(torch.from_numpy(keys).to(device),
                          torch.from_numpy(counts).to(device), cap)


def table_from_jax_numpy(keys_hi, keys_lo, counts, n_unique,
                         device="cpu") -> CountTable:
    """A kat_tpu CountTable's planes, fetched as numpy, as a port table of
    the same capacity; the all-ones (hi, lo) sentinel becomes SENTINEL."""
    keys = torch.from_numpy(from_planes(keys_hi, keys_lo)).to(device)
    c = torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int32))
    return CountTable(keys, c.to(device), int(n_unique))
