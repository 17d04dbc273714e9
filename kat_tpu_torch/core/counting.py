"""Sort + merge + reduce k-mer counting: the port of kat_tpu/core/counting.py.

A count table is a *sorted* fixed-capacity array of unique int64 keys with
int32 counts; slots past `n_unique` hold SENTINEL / 0.  The streaming
counter keeps one such table resident on the device and folds in the fresh
windows once per flush: sort the fresh keys (K1), merge them with the
table (K2), reduce by key into `capacity` slots (K3).  When the reduce
reports more runs than slots, capacity doubles and the merge + reduce
replay from the pre-flush table, which is the observable behaviour of
jellyfish's cooperative resize (hash_counter.hpp:204-244).  A merged
stream too long for one K3 launch is reduced in pieces (`reduce_stream`),
so a table may pass 2^30 distinct keys when its max capacity allows.

`lookup` is the binary-search route of the bulk lookups (the join of
ops/join.py is the other, core/tables.py picks).  Left behind from kat_tpu:
the LSM run mode (`lsm_runs`, measured a net loss on the TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.merge_kernel import merge_sorted
from ..ops.reduce_kernel import reduce_by_key, reduce_by_key_words
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


def _same_device(a: torch.device, b: torch.device) -> bool:
    """`cuda` without an index names the same card as any `cuda:<i>`."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def empty_table(capacity: int, *, device) -> CountTable:
    """An all-padding table on `device`, which the caller names: nothing
    here picks the CPU for a caller that said nothing."""
    return CountTable(
        keys=torch.full((capacity,), SENTINEL, dtype=torch.int64,
                        device=device),
        counts=torch.zeros(capacity, dtype=torch.int32, device=device),
        n_unique=0)


def _unique_reduce(keys: torch.Tensor, w: torch.Tensor,
                   out_size: int) -> CountTable:
    """Sort flat (keys, w) and reduce duplicate keys by summing weights.

    For the tables built off the flush path (merges of two tables, host
    tables, the shards merged): a stable `torch.sort` that carries w (plain
    tensor code, as kat_tpu's lax.sort), then K3 over the sorted stream in
    pieces past MAX_STREAM keys (`reduce_stream`), so such a table may hold
    2^30 keys or more.  Sentinel keys sort last; their weights must be 0."""
    keys, perm = torch.sort(keys, stable=True)
    return CountTable(*reduce_stream(keys, w[perm].contiguous(), out_size))


def merge_tables(a: CountTable, b: CountTable,
                 capacity: int | None = None) -> CountTable:
    """Merge two count tables; output capacity defaults to capA + capB.

    The caller must check `n_unique <= capacity` afterwards."""
    cap = capacity or (a.capacity + b.capacity)
    return _unique_reduce(torch.cat([a.keys, b.keys]),
                          torch.cat([a.counts, b.counts]), cap)


class TableFullError(RuntimeError):
    pass


# K1 and K3 keep counts in 30 bits of their status words and take fewer
# than 2^30 keys a launch.  A flush's fresh windows go through K1 in one
# launch; its merged stream (the table's real entries and the fresh
# windows), and the sorted stream of a table built off the flush path,
# go through K3 in pieces of fewer than MAX_STREAM keys (`reduce_stream`);
# the bucketed flush's final re-sort sorts pieces and merges them
# (core/bucketed.py).  Read it at call time, as `counting.MAX_STREAM`: the
# tests lower it to reach the pieces at small sizes; it is not a setting.
MAX_STREAM = 1 << 30


def check_stream(n: int, what: str) -> None:
    """Raise TableFullError for a stream K1 would refuse (the fresh
    windows of one flush), before any launch."""
    if n >= MAX_STREAM:
        raise TableFullError(
            f"{what} holds {n} keys: the sort kernel takes fewer than "
            f"{MAX_STREAM} a launch; flush more often")


def _key_at(keys: torch.Tensor, i: int) -> list[int]:
    return keys[:, i].tolist()


def _run_start(keys: torch.Tensor, lo: int, p: int) -> int:
    """The first index in [lo, p] whose key equals the key at p, in a
    sorted [W, n] stream (a binary search on the host, W words a step)."""
    want = _key_at(keys, p)
    hi = p
    while lo < hi:
        mid = (lo + hi) // 2
        if _key_at(keys, mid) < want:
            lo = mid + 1
        else:
            hi = mid
    return lo


def reduce_stream(keys: torch.Tensor, w: torch.Tensor, out_size: int):
    """K3 over a sorted stream of any length: 1-D int64 keys
    (`reduce_by_key`) or [W, n] words (`reduce_by_key_words`).

    A stream of fewer than MAX_STREAM keys is one launch.  A longer one is
    cut into pieces of fewer than MAX_STREAM keys, each ending where the
    key changes, so no run straddles two pieces (a run of SENTINEL, never
    emitted, may); each piece's runs are
    written from the table's fill so far (its offset in the output), and
    the slots after the last run are padded at the end.  Returns (keys,
    counts, n_unique as a host int), n_unique the true number of runs even
    past out_size, as `reduce_by_key`."""
    wide = keys.dim() == 2
    reduce = reduce_by_key_words if wide else reduce_by_key
    n = keys.shape[-1]
    if n < MAX_STREAM:
        k, c, nu = reduce(keys, w, out_size)
        return k, c, int(nu)
    lead = (keys.shape[0],) if wide else ()
    out_keys = torch.empty(lead + (out_size,), dtype=torch.int64,
                           device=keys.device)
    out_counts = torch.empty(out_size, dtype=torch.int32, device=keys.device)
    words = keys if wide else keys[None]
    start = fill = 0
    while start < n:
        end = n
        if n - start >= MAX_STREAM:
            end = cut = start + MAX_STREAM - 1
            # a run of SENTINEL (the padding of merged tables) is never
            # emitted, so a piece may end inside it
            if _key_at(words, cut)[0] != SENTINEL:
                end = _run_start(words, start, cut)
            if end == start:
                raise TableFullError(
                    f"a run of at least {MAX_STREAM} equal keys cannot be "
                    "reduced in pieces")
        lo = min(fill, out_size)
        size = min(out_size - lo, end - start)  # a piece's runs fit its length
        nu = reduce(keys[..., start:end], w[start:end], size,
                    out=(out_keys[..., lo:lo + size],
                         out_counts[lo:lo + size]))[2]
        fill += int(nu)
        start = end
    lo = min(fill, out_size)
    out_keys[..., lo:] = SENTINEL
    out_counts[lo:] = 0
    return out_keys, out_counts, fill


class StreamingCounter:
    """Streaming accumulator over extracted int64 keys, with capacity
    doubling.

    Keys wait in a list on `device` until `flush_windows` of them are
    pending.  A flush concatenates them, sorts them (K1), merges them with
    the resident table (K2) and reduces into `capacity` slots (K3).  When
    the reduce reports more runs than slots, capacity doubles and the merge
    and reduce replay from the pre-flush table.

    key_bits: every real key is < 2^(key_bits-1) (2k+1 for k-mers).
    device: where the table lives and the kernels run.  The caller names
      it (tools/common.default_device() is the card); keys handed to `add`
      must already lie there, they are never moved off their device.

    The overflow check is synchronous: each flush fetches n_unique from the
    device (kat_tpu defers that fetch by one flush to keep the TPU busy).
    """

    def __init__(self, initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_windows: int = 1 << 25, key_bits: int = 63,
                 *, device):
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.flush_windows = int(flush_windows)
        self.key_bits = key_bits
        self.device = torch.device(device)
        self.table = empty_table(self.capacity, device=self.device)
        self._fresh: list[torch.Tensor] = []
        self._fresh_n = 0

    def add(self, keys: torch.Tensor, valid: torch.Tensor | None = None):
        """Queue keys of any shape; where `valid` is given and false the
        key counts as SENTINEL.  Keys (and `valid`) on another device
        than the counter's raise."""
        for name, t in (("keys", keys), ("valid", valid)):
            if t is not None and not _same_device(t.device, self.device):
                raise ValueError(f"{name}: on {t.device}, but the counter "
                                 f"is on {self.device}")
        keys = keys.reshape(-1)
        if valid is not None:
            keys = torch.where(valid.reshape(-1), keys, SENTINEL)
        if self._fresh_n + keys.numel() > self.flush_windows:
            self._flush()
        self._fresh.append(keys)
        self._fresh_n += keys.numel()
        if self._fresh_n >= self.flush_windows:
            self._flush()

    def _merge_reduce(self, prev: CountTable, fresh: torch.Tensor,
                      cap: int) -> CountTable:
        # only the table's real entries join: its padding is all sentinel
        n = prev.n_unique
        mkeys, mw = merge_sorted(prev.keys[:n], prev.counts[:n], fresh)
        return CountTable(*reduce_stream(mkeys, mw, cap))

    def _flush(self) -> None:
        if not self._fresh:
            return
        fresh = (torch.cat(self._fresh) if len(self._fresh) > 1
                 else self._fresh[0])
        self._fresh = []
        self._fresh_n = 0
        check_stream(fresh.numel(), "the fresh windows")  # before any launch
        fresh = sort_keys(fresh, self.key_bits)
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

    def finish(self) -> CountTable:
        self._flush()
        return self.table


class CodeStreamingCounter(StreamingCounter):
    """Streaming counter over raw 2-bit code batches.

    Each host batch is uploaded to `device` (a tensor that already lies
    on another card raises) and its windows extracted at once;
    the int64 keys wait for the flush as in StreamingCounter (the JAX
    counter stacks the code batches instead and extracts inside its fused
    flush).  The flush budget counts batches.

    Batches are [rows, length] code arrays (numpy or torch).  A batch with
    another length, or more rows than the current shape, flushes first and
    adopts its shape; batches with fewer rows join the current flush.
    """

    def __init__(self, k: int, canonical: bool = True,
                 initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30, disable_grow: bool = False,
                 flush_batches: int = 16, flush_windows: int | None = None,
                 *, device):
        super().__init__(initial_capacity, max_capacity, disable_grow,
                         flush_windows or 1 << 25, 2 * k + 1, device=device)
        self.k = k
        self.canonical = canonical
        self.flush_batches = int(flush_batches)
        # Windows-based flush sizing: when flush_windows is given (e.g.
        # 1<<26), the per-shape batch budget becomes flush_windows //
        # windows_per_batch, so a flush holds about flush_windows keys
        # whatever the batch shape.
        self._sized_by_windows = bool(flush_windows)
        self._fb_eff = self.flush_batches
        self._shape: tuple | None = None

    def add_codes(self, codes) -> None:
        codes = torch.as_tensor(codes, dtype=torch.uint8)
        if codes.dim() != 2:
            raise ValueError("expected [rows, length] code batch")
        if codes.device.type != "cpu" and not _same_device(codes.device,
                                                           self.device):
            raise ValueError(f"codes: on {codes.device}, but the counter "
                             f"is on {self.device}")
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
        if self._sized_by_windows:
            w = shape[0] * (shape[1] - self.k + 1)
            self._fb_eff = max(1, self.flush_windows // max(w, 1))
        else:
            self._fb_eff = self.flush_batches

    def _flush(self) -> None:
        self._shape = None
        super()._flush()


def lookup(table: CountTable, qkeys: torch.Tensor) -> torch.Tensor:
    """Counts for query keys by binary search (0 where absent or SENTINEL);
    the queries' shape is preserved.  The analogue of jellyfish's
    `get_key_id` random probing (large_hash_array.hpp:404-476) over the
    sorted table: `torch.searchsorted`, compare, gather."""
    cap = table.capacity
    if cap == 0:
        return torch.zeros(qkeys.shape, dtype=torch.int32,
                           device=qkeys.device)
    q = qkeys.reshape(-1)
    pos = torch.searchsorted(table.keys, q).clamp_max(cap - 1)
    found = table.keys[pos] == q
    return torch.where(found, table.counts[pos], 0).reshape(qkeys.shape)


def table_to_numpy(table: CountTable):
    """(keys u64, counts u32) as host numpy arrays, real entries only —
    the same types kat_tpu's table_to_numpy returns."""
    n = table.n_unique
    keys = table.keys[:n].cpu().numpy().astype(np.uint64)
    counts = table.counts[:n].cpu().numpy().astype(np.uint32)
    return keys, counts


def table_from_numpy(keys: np.ndarray, counts: np.ndarray,
                     capacity: int | None = None,
                     *, device) -> CountTable:
    """Build a table from host (u64 keys, counts); keys need not be sorted
    or unique (duplicates are summed)."""
    keys = np.asarray(keys, np.uint64).astype(np.int64)
    counts = np.asarray(counts, np.int64).astype(np.int32)
    cap = capacity or max(1, len(keys))
    return _unique_reduce(torch.from_numpy(keys).to(device),
                          torch.from_numpy(counts).to(device), cap)


def table_from_jax_numpy(keys_hi, keys_lo, counts, n_unique,
                         *, device) -> CountTable:
    """A kat_tpu CountTable's planes, fetched as numpy, as a port table of
    the same capacity; the all-ones (hi, lo) sentinel becomes SENTINEL."""
    keys = torch.from_numpy(from_planes(keys_hi, keys_lo)).to(device)
    c = torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int32))
    return CountTable(keys, c.to(device), int(n_unique))
