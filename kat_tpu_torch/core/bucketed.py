"""Minimizer-bucketed streaming counter: the chunked counting flush.

Port of kat_tpu/core/bucketed.py.  The native supermer router
(io/native.SupermerRouter over kat_tpu/native/fastxio.cpp) delivers each
flush pre-grouped into minimizer-hash buckets that are a PREFIX of the
transformed key order (core/minimizer.py), so the device:

  1. expands supermer records to per-window key' (minimizer.expand_records,
     plain elementwise torch),
  2. sorts each chunk on its own inside one thread block, in ONE pass over
     device memory (K5, ops/sort_kernel.sort_chunks),
  3. merges the chunk runs of the few hot buckets the router reports (K6,
     ops/sort_kernel.merge_runs, once per group, on that group's slice),
  4. reduces the whole chunk stream in one pass (K3): interior sentinel gaps
     between chunks are legal for reduce_by_key (sentinel runs are never
     emitted) and all copies of one k-mer land in one bucket, so this
     collapses the coverage-fold multiplicity BEFORE the table merge,
  5. merges the reduced fresh uniques with the resident table, itself kept
     in key'-space, counts riding on both sides (K2, merge_sorted_payload),
     and reduces again (K3).

finish() decodes the table back to plain canonical keys and re-sorts once
with the counts as values (K1, sort_pairs; past counting.MAX_STREAM keys in
pieces that K2 merges), returning a standard counting.CountTable: nothing
downstream sees key'-space.

Left behind from kat_tpu on purpose: the deferred-runs mode
(KAT_TPU_BUCKETED_RUNS, kat_tpu/core/bucketed.py:229-374), which measured a
net loss there.  kat_tpu's KAT_TPU_SMR_CHUNKS and KAT_TPU_SMR_SLOTS_LOG
environment variables are the keyword arguments `max_chunks` and
`slots_log` of count_paths_bucketed.  The overflow checks are synchronous
(two scalar fetches per flush), as in counting.StreamingCounter.

Chunk geometry on the H100: a chunk must fit one block's shared memory, so
it holds at most 2^14 slots (kat_tpu's TPU chunks hold 2^17).  The defaults
below (`SLOTS_LOG`, `MAX_CHUNKS`, `BUCKET_BITS`) were picked together from
a sweep on that card (benchmarks/sweep_bucketed.py; PERF.md has the
numbers); the router reports up to 512 hot groups per flush, kat_tpu's
value, and that sweep saw at most 2.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.merge_kernel import merge_sorted_payload
from ..ops.reduce_kernel import reduce_by_key
from ..ops.sort_kernel import merge_runs, sort_chunks, sort_pairs
from . import minimizer
from . import counting
from .counting import (CountTable, TableFullError, _same_device, empty_table,
                       reduce_stream)
from .kmers import SENTINEL

SLOTS_LOG = 14     # log2 of the key' slots of one chunk
MAX_CHUNKS = 2048  # chunks of one flush: 2^25 slots
BUCKET_BITS = 14   # router buckets: about 8 per chunk


class BucketedCodeCounter:
    """Streaming counter over routed supermer chunk flushes.

    Feed with add_flush(chunks, groups) using the router's output shape
    [n_chunks, rec_per_chunk] (pad short flushes with zero records);
    finish() returns a standard key-space CountTable.  `device` is where the
    table lives and the kernels run; host chunks are uploaded to it, a
    tensor that lies elsewhere raises.
    """

    def __init__(self, k: int, m: int = minimizer.M_DEFAULT,
                 initial_capacity: int = 1 << 20,
                 max_capacity: int = 1 << 30,
                 disable_grow: bool = False, *, device):
        if not minimizer.supports(k, m):
            raise ValueError(f"bucketed counter unsupported for k={k}, "
                             f"m={m} (needs m < k <= m+16)")
        self.k = k
        self.m = m
        self.capacity = int(initial_capacity)
        self.max_capacity = int(max_capacity)
        self.disable_grow = disable_grow
        self.device = torch.device(device)
        self.table = empty_table(self.capacity, device=self.device)  # key'

    # -- flush program -----------------------------------------------------

    def _merge_group(self, stream: torch.Tensor, start_chunk: int, g: int,
                     chunk_slots: int) -> None:
        """Merge an aligned group of g sorted chunk runs (one hot bucket) in
        place within the flat chunk-sorted stream."""
        sl = stream[start_chunk * chunk_slots:(start_chunk + g) * chunk_slots]
        sl.copy_(merge_runs(sl, chunk_slots))

    def _sorted_stream(self, rec: torch.Tensor, groups) -> torch.Tensor:
        """Records [n_chunks, rec_per_chunk] -> the flat key' stream, sorted
        inside every chunk and every reported group."""
        S = minimizer.rec_windows(self.k)
        chunk_slots = rec.shape[1] * S
        keyp = minimizer.expand_records(rec, self.k, self.m)
        # [S, chunks, records] -> chunk-major slots
        stream = sort_chunks(keyp.transpose(0, 1).reshape(-1), chunk_slots)
        for start, lg in groups:
            self._merge_group(stream, start, 1 << lg, chunk_slots)
        return stream

    def _run_flush(self, prev: CountTable, rec: torch.Tensor,
                   groups) -> CountTable:
        """prev + one flush, at the current capacity or a grown one; prev is
        not modified, so growth replays from it."""
        stream = self._sorted_stream(rec, groups)
        w = (stream != SENTINEL).to(torch.int32)
        # chunk-local dedup: every copy of a k-mer shares a bucket, so the
        # reduced stream is the flush's distinct keys, and the table merge
        # runs at table scale, not stream scale
        while True:
            fk, fc, fnu = reduce_by_key(stream, w, self.capacity)
            fnu = int(fnu)
            if fnu <= self.capacity:
                break
            self._grow()
        del stream, w
        n = prev.n_unique
        while True:
            mk, (mc,) = merge_sorted_payload(
                prev.keys[:n], (prev.counts[:n],), fk[:fnu], (fc[:fnu],))
            table = CountTable(*reduce_stream(mk, mc, self.capacity))
            if table.n_unique <= self.capacity:
                return table
            del table, mk, mc  # before the replay allocates its own
            self._grow()

    # -- streaming protocol ------------------------------------------------

    def add_flush(self, chunks, groups) -> None:
        """One router flush: chunks [n_chunks, rec_per_chunk] records (a
        uint64 or int64 host array, or an int64 tensor already staged on the
        counter's device), groups [(start_chunk, log2_chunks), ...]."""
        if isinstance(chunks, torch.Tensor):
            if not _same_device(chunks.device, self.device):
                raise ValueError(f"chunks: on {chunks.device}, but the "
                                 f"counter is on {self.device}")
            rec = chunks
        else:
            rec = torch.from_numpy(
                np.ascontiguousarray(chunks).view(np.int64)).to(self.device)
        if rec.dim() != 2 or rec.dtype != torch.int64:
            raise ValueError("expected [n_chunks, rec_per_chunk] 64-bit "
                             "records")
        groups = [(int(a), int(b))
                  for a, b in np.asarray(groups).reshape(-1, 2)]
        self.table = self._run_flush(self.table, rec, groups)

    def _grow(self) -> None:
        if self.disable_grow or self.capacity * 2 > self.max_capacity:
            raise TableFullError(
                f"Count table full at capacity {self.capacity}")
        self.capacity *= 2

    def finish(self) -> CountTable:
        """Decode key' -> canonical keys, re-sort ONCE with the counts as
        values, and return a standard-order CountTable."""
        n = self.table.n_unique
        keys, counts = _sort_counts(
            minimizer.decode_keys(self.table.keys[:n], self.k, self.m),
            self.table.counts[:n].contiguous(), 2 * self.k + 1)
        out = empty_table(self.capacity, device=self.device)
        out.keys[:n] = keys
        out.counts[:n] = counts
        return CountTable(out.keys, out.counts, n)


def _sort_counts(keys: torch.Tensor, counts: torch.Tensor, key_bits: int):
    """The distinct decoded keys sorted, their counts riding: one K1 launch
    (`sort_pairs`) below counting.MAX_STREAM keys; past it, pieces of fewer
    than MAX_STREAM keys each sorted by K1, then merged pairwise in a
    balanced tree by K2 with one count plane on both sides
    (`merge_sorted_payload`, which takes any length).  The keys are
    distinct, so the merge's tie order never shows."""
    n, piece = keys.numel(), counting.MAX_STREAM - 1
    if n <= piece:
        return sort_pairs(keys, counts, key_bits)
    runs = [sort_pairs(keys[lo:lo + piece], counts[lo:lo + piece], key_bits)
            for lo in range(0, n, piece)]
    while len(runs) > 1:
        merged = [merge_sorted_payload(ak, (ac,), bk, (bc,))
                  for (ak, ac), (bk, bc) in zip(runs[::2], runs[1::2])]
        runs = [(k, c) for k, (c,) in merged] + runs[len(merged) * 2:]
    return runs[0]


def geometry(k: int, max_chunks: int = MAX_CHUNKS,
             slots_log: int = SLOTS_LOG) -> tuple[int, int]:
    """(rec_per_chunk, bucket_bits) for a chunk of 2^slots_log key' slots:
    up to 16 buckets per chunk (first-fit packing wastes about half a
    bucket per chunk boundary, so smaller buckets pack chunks tighter), at
    most 2^BUCKET_BITS: with the 4 workers tools.common.Input routes
    with on an 8-core host, 2^14 buckets counted a file 1.2-1.3x faster
    than 2^16 (benchmarks/sweep_bucketed.py; with 8 workers the router
    alone was faster with 2^16)."""
    rec_per_chunk = (1 << slots_log) // minimizer.rec_windows(k)
    bucket_bits = min(BUCKET_BITS, max(6, (max_chunks * 16).bit_length() - 1))
    return rec_per_chunk, bucket_bits


def pad_flush(chunks: np.ndarray, max_chunks: int) -> np.ndarray:
    """A SHORT flush (a range worker's tail, the end of the input) padded
    with zero records to the next power of two of chunks, at least 8, not
    to the full grid: the device sorts every padded chunk."""
    n = chunks.shape[0]
    tgt = min(max_chunks, 1 << max(3, (n - 1).bit_length()))
    if n >= tgt:
        return chunks
    return np.vstack([chunks,
                      np.zeros((tgt - n, chunks.shape[1]), chunks.dtype)])


def count_paths_bucketed(paths, k: int, m: int = minimizer.M_DEFAULT,
                         trim5=None, max_chunks: int = MAX_CHUNKS,
                         slots_log: int = SLOTS_LOG,
                         bucket_bits: int | None = None,
                         initial_capacity: int = 1 << 20,
                         max_capacity: int = 1 << 30,
                         disable_grow: bool = False,
                         stats: dict | None = None, *, device) -> CountTable:
    """Count canonical k-mers of FASTX paths through the bucketed flush.

    bucket_bits defaults to `geometry(k, max_chunks, slots_log)`'s.  Raises
    when the router cannot be built (with the compiler's output) or k is
    outside minimizer.supports.  `stats`, when given, receives flushes,
    chunks, windows, key' slots and hot groups."""
    from ..io import native
    from ..io.prefetch import prefetch

    native.require_lib()
    rec_per_chunk, default_bits = geometry(k, max_chunks, slots_log)
    sc = BucketedCodeCounter(k, m, initial_capacity=initial_capacity,
                             max_capacity=max_capacity,
                             disable_grow=disable_grow, device=device)
    paths = list(paths)
    tally = dict(flushes=0, chunks=0, windows=0, slots=0, groups=0)
    # one flush ahead: the host routes the next while the card counts this
    for chunks, groups, nw in prefetch(native.route_flushes(
            paths, k, m, bucket_bits or default_bits, max_chunks,
            rec_per_chunk, trim5=trim5,
            threads=native.reader_threads_default(len(paths))), depth=1):
        chunks = pad_flush(chunks, max_chunks)
        sc.add_flush(chunks, groups)
        tally["flushes"] += 1
        tally["chunks"] += chunks.shape[0]
        tally["windows"] += nw
        tally["slots"] += chunks.shape[0] << slots_log
        tally["groups"] += len(groups)
    if stats is not None:
        stats.update(tally)
    return sc.finish()


def table_from_jax_numpy(keys_hi, keys_lo, counts, n_unique, k: int,
                         m: int = minimizer.M_DEFAULT, *, device) -> CountTable:
    """A kat_tpu BucketedCodeCounter's mid-stream table (key'-space planes,
    fetched as numpy) as a port table of the same capacity, for comparing
    `BucketedCodeCounter.table` across the two packages."""
    keys = torch.from_numpy(minimizer.keyp_from_planes(keys_hi, keys_lo, k, m))
    c = torch.from_numpy(np.asarray(counts, np.uint32).astype(np.int32))
    return CountTable(keys.to(device), c.to(device), int(n_unique))
