"""The analysis phase over mesh-sharded tables, in one process.

Port of kat_tpu/parallel/analysis.py.  Every input is counted with the
same canonical-hash partition (parallel/sharded.py `owner_shard`), so a
key and every probe derived from it (raw, reverse complement,
canonicalized) live on the same shard in every table of one mesh.  comp's
cross-table probes are then local joins on co-partitioned shards, and
histograms, GC matrices, comp's counters, spectra and matrices are per-shard
results summed exactly in int64 (kat_tpu's uint64 `psum_exact`).  Each
shard's table is itself sorted with a sentinel tail and carries its own
n_unique, the promise `tables.lookup_dual` and the `sorted1/2/3` probes
rely on.

Point lookups (`ShardedLookup`, `window_counts_routed`) route each query
to the shard owning its canonical form, answer it there by the port's bulk
lookup, and bring the answer back to the query's source position (the
mesh analogue of the reference's random probes into a shared hash,
src/sect.cc:527-541).

Across processes (parallel/distributed.global_mesh) each process sums its
own shards and one `all_reduce` a tensor makes every result replicated;
a routed lookup is a collective: every process passes its own queries
(their number may differ), the padded width and the bucket slots are
agreed by all_gather, and each process gets exactly its own queries'
counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import comp_engine, stats, tables
from ..core.kmers import SENTINEL
from .sharded import ShardedCounter, _Exchange, owner_shard, owner_shard_np


def _sum(parts, dev):
    """Exact sum of per-shard results of one structure (tensors, dicts and
    tuples of them, None), on `dev`."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {key: _sum([p[key] for p in parts], dev) for key in first}
    if isinstance(first, tuple):
        return tuple(_sum(list(z), dev) for z in zip(*parts))
    return sum(p.to(dev) for p in parts)


def _sum_shards(parts, mesh):
    """`_sum` of this process's shards' results on the first local shard's
    device, then, across processes, each tensor summed by all_reduce."""
    total = _sum(parts, mesh.devices[0])
    if not mesh.multiprocess:
        return total
    from .distributed import all_reduce_sum

    def each(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {key: each(v) for key, v in x.items()}
        if isinstance(x, tuple):
            return tuple(each(v) for v in x)
        return all_reduce_sum(x)

    return each(total)


def hist_sharded(c: ShardedCounter, base: int, ceil_: int, inc: int,
                 nb_buckets: int) -> np.ndarray:
    """Occurrence histogram per shard, summed (uint64 numpy)."""
    return c.histogram(base, ceil_, inc, nb_buckets)


def gcp_sharded(c: ShardedCounter, mer_len: int, cvg_bins: int,
                cvg_scale: float = 1.0) -> np.ndarray:
    """GC x coverage matrix per shard, summed (reference gcp.cc:179-197):
    uint64 numpy [mer_len + 1, cvg_bins + 1]."""
    c.check()
    grid = _sum_shards([stats.gcp_matrix(t, mer_len, cvg_bins, cvg_scale)
                        for t in c.tables], c.mesh)
    return grid.cpu().numpy().astype(np.uint64)


def comp_sharded(c1: ShardedCounter, c2: ShardedCounter,
                 c3: ShardedCounter | None, *, k: int, d1_bins: int,
                 d2_bins: int, dm_size: int, d1_scale: float,
                 d2_scale: float, canon2: bool, canon3: bool,
                 sorted1: bool = False, sorted2: bool = False,
                 sorted3: bool = False):
    """comp's three passes with the tables left on their shards.

    Returns (pass-1 outputs, pass-2 outputs, pass-3 counters) with the
    single-table passes' structure (comp_engine.pass1/2/3), each the exact
    sum over shards (over every process's), on the first local shard's
    device."""
    counters = [c for c in (c1, c2, c3) if c is not None]
    for c in counters:
        if c.mesh != c1.mesh:
            raise ValueError("comp_sharded: the inputs were counted on "
                             "different meshes (not co-partitioned)")
        c.check()
    three = c3 is not None
    outs = []
    for s in range(c1.mesh.n_local):
        t1 = tables.compact(c1.tables[s])
        t2 = tables.compact(c2.tables[s])
        t3 = tables.compact(c3.tables[s]) if three else None
        pre = tables.lookup_dual(t1, t2) if (sorted2 and sorted1) else None
        h2_pre, h1_pre = pre if pre is not None else (None, None)
        outs1 = comp_engine.pass1(
            t1, t2, t3, k=k, d1_bins=d1_bins, d2_bins=d2_bins,
            dm_size=dm_size, d1_scale=d1_scale, d2_scale=d2_scale,
            canon2=canon2, canon3=canon3, three=three, sorted2=sorted2,
            sorted3=sorted3, h2_pre=h2_pre)
        outs2 = comp_engine.pass2(t2, t1, k=k, d2_bins=d2_bins,
                                  dm_size=dm_size, d2_scale=d2_scale,
                                  sorted1=sorted1, h1_pre=h1_pre)
        outs.append((outs1, outs2, comp_engine.pass3(t3) if three else {}))
    return _sum_shards(outs, c1.mesh)


# -- shard-routed point lookups ---------------------------------------------


def _route_queries_local(q: torch.Tensor, n_dest: int, qcap: int, k: int):
    """Source side of a routed lookup: one source's queries ([m] int64 or
    [W, m] words) sorted by owner shard into [*lead, n_dest, qcap] buckets
    (SENTINEL-padded), sentinel queries parked (never routed).  Returns
    (buckets, each slot's source position [n_dest * qcap], m for an empty
    slot, queries past their bucket's qcap slots)."""
    wide = q.dim() == 2
    m = q.shape[-1]
    dev = q.device
    dest = owner_shard(q, k, n_dest)
    dest = torch.where((q[0] if wide else q) == SENTINEL, n_dest, dest)
    d_s, perm = torch.sort(dest, stable=True)
    starts = torch.searchsorted(
        d_s, torch.arange(n_dest + 1, dtype=torch.int64, device=dev))
    pos = torch.arange(m, dtype=torch.int64, device=dev) - starts[d_s]
    routed = d_s < n_dest
    in_range = (pos < qcap) & routed
    # slot n_dest * qcap takes every query that is not routed: cut below
    target = torch.where(in_range, d_s * qcap + pos, n_dest * qcap)
    lead = (q.shape[0],) if wide else ()
    bufs = torch.full((*lead, n_dest * qcap + 1), SENTINEL,
                      dtype=torch.int64, device=dev)
    bufs[..., target] = q[..., perm]
    idx = torch.full((n_dest * qcap + 1,), m, dtype=torch.int64, device=dev)
    idx[target] = perm
    dropped = int((routed & ~in_range).sum())
    return (bufs[..., :-1].reshape(*lead, n_dest, qcap), idx[:-1], dropped)


def _routed_counts_local(c: ShardedCounter, qs: list, qcap: int):
    """Counts (int32) of every local source shard's queries qs[s] (on its
    device) in the sharded table: queries go to their owner shard, are
    answered by the port's bulk lookup (tables.lookup) there, and ride back
    to their source position.  Returns (counts per local source, queries
    dropped by every process's sources)."""
    lead = (c.n_words,) if c.wide else ()
    ex = _Exchange(c.mesh, lead, qcap, torch.int64)
    idxs, dropped = [], 0
    for s, q in enumerate(qs):
        bufs, idx, d = _route_queries_local(q, c.n, qcap, c.k)
        ex.send(s, bufs)
        idxs.append(idx)
        dropped += d
    ex.exchange()
    back = _Exchange(c.mesh, (), qcap, torch.int32)
    for d, t in enumerate(c.tables):
        counts = tables.lookup(t, ex.recv[d].reshape(*lead, -1),
                               key_bits=2 * c.k + 1)
        back.send(d, counts.reshape(c.n, qcap))
    del ex
    back.exchange()
    if c.mesh.multiprocess:
        from .distributed import sum_int

        dropped = sum_int(dropped)
    outs = []
    for s, q in enumerate(qs):
        m = q.shape[-1]
        out = torch.zeros(m + 1, dtype=torch.int32, device=q.device)
        out[idxs[s]] = back.recv[s].reshape(-1)  # empty slots land at m
        outs.append(out[:m])
    return outs, dropped


class ShardedLookup:
    """Batch point lookups against a live ShardedCounter.  Queries of any
    shape are flattened, padded with SENTINEL to one equal row per local
    shard (row s from local shard s), routed, answered, and returned in
    the callers' layout; sentinel queries count 0.  Across processes a
    lookup is a collective: every process calls it, each with its own
    queries."""

    def __init__(self, counter: ShardedCounter):
        counter.check()
        self.c = counter

    def _plan_qcap(self, qs: np.ndarray, per_dev: int) -> int:
        """The EXACT routing capacity from a host pass over this process's
        queries ([L * per_dev] keys or [W, L * per_dev] words, L the local
        shards): the largest (source shard, owner shard) bucket, rounded up
        to a power of two (at most per_dev)."""
        c = self.c
        n_rows = c.mesh.n_local
        real = (qs[0] if qs.ndim == 2 else qs) != SENTINEL
        dest = owner_shard_np(qs, c.k, c.n)
        src = np.repeat(np.arange(n_rows, dtype=np.int64), per_dev)
        flat = np.where(real, src * c.n + dest, n_rows * c.n)
        counts = np.bincount(flat,
                             minlength=n_rows * c.n + 1)[:n_rows * c.n]
        need = int(counts.max()) if counts.size else 1
        qcap = 1 << max(0, int(np.ceil(np.log2(max(need, 1)))))
        return max(1, min(qcap, per_dev))

    def lookup(self, qkeys) -> torch.Tensor:
        """Counts (int32, on the mesh's first local device) of int64 query
        keys of any shape ([W, ...] words for 31 < k), the queries' shape
        kept ([...] for words).  Across processes the row width and the
        bucket slots are the largest any process needs (one all_gather
        each), so every process runs the same exchange."""
        c = self.c
        mesh = c.mesh
        q = torch.as_tensor(qkeys, dtype=torch.int64)
        lead = (c.n_words,) if c.wide else ()
        shape = q.shape[len(lead):]
        q = q.reshape(*lead, -1)
        m = q.shape[-1]
        widest = m
        if mesh.multiprocess:
            from .distributed import gather_ints

            widest = int(gather_ints([m]).max())
        per_dev = -(-max(widest, 1) // mesh.n_local)
        pad = per_dev * mesh.n_local - m
        q = torch.cat([q, torch.full((*lead, pad), SENTINEL,
                                     dtype=torch.int64, device=q.device)],
                      dim=-1)
        qcap = self._plan_qcap(q.cpu().numpy(), per_dev)
        if mesh.multiprocess:
            qcap = int(gather_ints([qcap]).max())
        qs = [q[..., s * per_dev:(s + 1) * per_dev].to(dev).contiguous()
              for s, dev in enumerate(mesh.devices)]
        while True:
            outs, dropped = _routed_counts_local(c, qs, qcap)
            if dropped == 0:
                break
            # safety net only: the exact plan above never drops
            qcap = min(per_dev, qcap * 2)
        dev0 = c.mesh.devices[0]
        return torch.cat([o.to(dev0) for o in outs])[:m].reshape(shape)


def window_counts_routed(svc: ShardedLookup, codes: torch.Tensor, k: int,
                         canonical: bool):
    """The sharded-table counterpart of core/coverage.window_counts:
    windows extracted on the codes' device, counts answered by routed
    lookups.  Returns (counts int32, 0 for invalid windows; gc int32, -1
    for invalid windows; valid bool), [.., W] each."""
    keys, valid = tables.extract(codes, k, canonical=False)
    q = tables.canonicalize(keys, k) if canonical else keys
    counts = svc.lookup(q).to(valid.device)
    counts = torch.where(valid, counts, 0)
    gc = torch.where(valid, tables.gc_count(keys, k).to(torch.int32), -1)
    return counts, gc, valid
