"""Sequence parallelism for very long contigs: window coverage over a mesh,
one span of the contig per shard with a (k-1)-base ring halo.

Port of kat_tpu/parallel/longseq.py.  The reference streams multi-Mbp
contigs through 4 KB chunks with a (k-1)-base seam so no window is lost
(mer_overlap_sequence_parser.hpp:44-52).  Here the contig's codes are cut
into n spans, one per shard; each shard also takes the first k-1 bases of
the NEXT span (kat_tpu's `ppermute` ring; the last span takes span 0's, and
the windows that wrap fall past L - k + 1 and are sliced off), extracts its
span's windows, and answers them: from a replicated table
(`sharded_window_profile`) or by routed lookups into a live ShardedCounter,
the table staying sharded (`sharded_window_profile_routed`).  Narrow and
wide keys alike.  Across processes every process passes the same contig,
answers its own shards' spans, and the spans' answers are all-gathered, so
every process gets the whole profile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import tables
from .analysis import _routed_counts_local
from .sharded import Mesh, ShardedCounter


def _span_codes(codes, k: int, mesh: Mesh):
    """Each local shard's span of the contig (n spans over every
    process's shards) plus its ring halo, on the shard's device: L tensors
    of span + k - 1 codes (invalid codes pad the last span)."""
    if not isinstance(codes, torch.Tensor):
        codes = torch.from_numpy(np.ascontiguousarray(codes, np.uint8))
    codes = codes.to(torch.uint8).reshape(-1)
    n = mesh.n
    span = -(-codes.numel() // n)
    padded = torch.cat([codes, torch.full(
        (n * span - codes.numel(),), 255, dtype=torch.uint8,
        device=codes.device)])
    ring = torch.cat([padded, padded[:k - 1]])
    first = mesh.first
    return [ring[(first + i) * span:(first + i) * span + span + k - 1].to(dev)
            for i, dev in enumerate(mesh.devices)], span


def _profile(counts, gcs, n_windows: int, mesh: Mesh):
    """The local spans' answers in span order (every process's, gathered
    across processes), cut to the contig's windows, as numpy."""
    c = torch.cat([x.cpu() for x in counts])
    g = torch.cat([x.cpu() for x in gcs])
    if mesh.multiprocess:
        from .distributed import all_gather

        c, g = torch.cat(all_gather(c)), torch.cat(all_gather(g))
    return c[:n_windows].numpy().astype(np.uint32), g[:n_windows].numpy()


def _to(table, dev):
    return type(table)(table.keys.to(dev), table.counts.to(dev),
                       table.n_unique)


def sharded_window_profile(table, codes, k: int, canonical: bool,
                           mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """Per-window (counts, gc) of one long coded sequence ([L] codes, >= 4
    invalid) against a table replicated on every shard's device, one span
    per shard.  Returns [L - k + 1] uint32 counts (0 for invalid windows)
    and int32 GC (-1 for invalid windows), as numpy."""
    L = len(codes)
    if L < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    spans, _span = _span_codes(codes, k, mesh)
    counts, gcs = [], []
    for ext, dev in zip(spans, mesh.devices):
        keys, valid = tables.extract(ext[None], k, canonical=False)
        q = tables.canonicalize(keys, k) if canonical else keys
        c = tables.lookup(_to(table, dev), q, key_bits=2 * k + 1)
        counts.append(torch.where(valid, c, 0).reshape(-1))
        gcs.append(torch.where(valid, tables.gc_count(keys, k).to(
            torch.int32), -1).reshape(-1))
    return _profile(counts, gcs, L - k + 1, mesh)


def sharded_window_counts(table, codes, k: int, canonical: bool,
                          mesh: Mesh) -> np.ndarray:
    """Counts-only convenience wrapper over sharded_window_profile."""
    return sharded_window_profile(table, codes, k, canonical, mesh)[0]


def sharded_window_profile_routed(counter: ShardedCounter, codes, k: int,
                                  canonical: bool
                                  ) -> tuple[np.ndarray, np.ndarray]:
    """sharded_window_profile against a live ShardedCounter: each shard's
    span windows are answered by routed lookups into the sharded table
    (reference sect.cc:527-541 random probes; the table is never
    replicated).  A bucket's slots start at 4x the uniform share and double
    while queries are dropped."""
    L = len(codes)
    if L < k:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    counter.check()
    spans, span = _span_codes(codes, k, counter.mesh)
    lead = (counter.n_words,) if counter.wide else ()
    qs, valids, gcs = [], [], []
    for ext in spans:
        keys, valid = tables.extract(ext[None], k, canonical=False)
        q = tables.canonicalize(keys, k) if canonical else keys
        qs.append(q.reshape(*lead, -1).contiguous())
        valids.append(valid.reshape(-1))
        gcs.append(torch.where(valid, tables.gc_count(keys, k).to(
            torch.int32), -1).reshape(-1))
    n = counter.n
    qcap = max(1, min(span, int(np.ceil(span / n * 4.0))))
    while True:
        outs, dropped = _routed_counts_local(counter, qs, qcap)
        if dropped == 0:
            break
        if qcap >= span:
            raise RuntimeError("routed halo lookup cannot converge")
        qcap = min(span, qcap * 2)
    counts = [torch.where(v, c, 0) for v, c in zip(valids, outs)]
    return _profile(counts, gcs, L - k + 1, counter.mesh)
