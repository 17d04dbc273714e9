"""K-mer-space sharded counting over a mesh of shards, in one process.

Port of kat_tpu/parallel/sharded.py.  A mesh is n shards, each with a
device (`make_mesh`): the shards go round-robin over the visible cards, so
on one card all n live on it, and on the CPU (the tests) all on the CPU.
Every key is owned by one shard, the murmur3-fmix32 hash of its canonical
form mod n, bit-exact with kat_tpu (`owner_shard`), so a key, its reverse
complement and any canonical probe of it land on one shard in every table
counted on the same mesh.

Per flush, every source shard

  1. extracts the windows of its rows of the buffered batches,
  2. computes each window's owner and sorts by (owner, key) once (K1): the
     owner is folded into spare high key bits where they exist, else it
     is one extra leading key word (K1 over W words),
  3. cuts its sorted stream into n buckets of `route_cap` slots by binary
     search; what passes a bucket's slots counts as `dropped`;

then the exchange (kat_tpu's `all_to_all`) hands every destination the n
buckets addressed to it: a [n_src, n_dest, route_cap] buffer read as
[n_dest, n_src, route_cap], one index permutation on one device and one
copy per (source, destination) pair across cards.  Every destination shard

  4. strips the fold, merges its n arriving sorted runs into one stream
     (K6, narrow or over W words: csrc/merge_runs.cu),
  5. merges that stream with its resident table's real entries (K2) and
     reduces by key into `shard_capacity` slots (K3).

Capacity overflow and routing drops are checked at the next flush or
`check()` (kat_tpu's deferred `_settle`); the flush then replays in place
from the kept pre-flush tables at doubled capacity (doubled until it holds
the reduce's count of runs) or doubled route slack, the observable
behaviour of jellyfish's cooperative resize (hash_counter.hpp:204-244).

Across processes (parallel/distributed.global_mesh) each process holds
only its own shards, global shards first .. first + L - 1: it buffers its
own rows, the exchange is one `all_to_all_single` over the route buffers,
every flush all-gathers the shards' unique counts and drops, so every
process takes the same replay decision at the same flush (kat_tpu's
replicated `dropped`), `histogram` sums in int64 with `all_reduce`, and
`finish` all-gathers the shards' tables, giving every process the same
table.  The kernels run inside each shard as in one process.  Not ported:
the `route_identity` timing knob.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import counting, kmers, stats, tables, wide
from ..core.kmers import MAX_K, SENTINEL
from ..ops.merge_kernel import merge_sorted, merge_sorted_words
from ..ops.sort_kernel import (merge_runs, merge_runs_words, sort_keys,
                               sort_words)


class Mesh(NamedTuple):
    """This process's shards' devices, global shard first + i on
    devices[i].  `procs` processes hold as many shards each, process-major
    (parallel/distributed.global_mesh); in one process (procs = 1) they
    are every shard."""
    devices: tuple
    procs: int = 1
    rank: int = 0

    @property
    def n(self) -> int:
        """Shards over every process."""
        return len(self.devices) * self.procs

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return self.procs > 1

    @property
    def one_device(self) -> bool:
        return len(set(self.devices)) == 1


def make_mesh(n: int | None = None, devices=None) -> Mesh:
    """A mesh of n shards placed round-robin over `devices`: by default the
    visible cards (an error without one: the CPU is never chosen for a
    caller that said nothing), n defaulting to their number."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: torch.cuda.is_available() is false.  A "
                "mesh lies on the cards unless the caller names its "
                "devices, e.g. make_mesh(8, devices=['cpu']).")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    n = len(devs) if n is None else int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(tuple(devs[i % len(devs)] for i in range(n)))


# -- ownership: murmur3-fmix32 over kat_tpu's uint32 words ------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c, by
    the two 16-bit halves of c: no product passes 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def shard_hash_words(words) -> torch.Tensor:
    """murmur3-fmix32 over mixed uint32 words (a sequence of int64 tensors
    with values in [0, 2^32), or one [nw, ...] tensor): kat_tpu's
    shard_hash_words, every step kept in [0, 2^32)."""
    x = words[0] ^ 0x9E3779B9
    for w in words:
        x = _mul32(x ^ w, 0x85EBCA6B)
        x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def shard_hash_words_np(words) -> np.ndarray:
    """numpy mirror of shard_hash_words over uint32 words (wrapping uint32
    arithmetic), for host-side plans that touch no device."""
    u = np.uint32
    words = [np.asarray(w, np.uint32) for w in words]
    x = words[0] ^ u(0x9E3779B9)
    for w in words:
        x = (x ^ w) * u(0x85EBCA6B)
        x = x ^ (x >> u(16))
    x = x * u(0x7FEB352D)
    x = x ^ (x >> u(15))
    x = x * u(0x846CA68B)
    return x ^ (x >> u(16))


def owner_shard(keys: torch.Tensor, k: int, n_dest: int) -> torch.Tensor:
    """The shard owning each key (int64 keys for k <= 31, [W, ...] words
    beyond): fmix32 of kat_tpu's uint32 words of the CANONICAL form, mod
    n_dest.  int64 of the keys' shape ([...] for wide words)."""
    canon = tables.canonicalize(keys, k)
    return shard_hash_words(kmers.ref_words(canon, k)) % n_dest


def owner_shard_np(keys, k: int, n_dest: int) -> np.ndarray:
    """owner_shard of host keys (int64 array, or [W, n] int64 words), on
    the host: the same torch arithmetic on CPU tensors."""
    t = torch.from_numpy(np.ascontiguousarray(keys, np.int64))
    return owner_shard(t, k, n_dest).numpy()


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(int(n), 1)))))


def _fold_shift(k: int, n_dest: int) -> int | None:
    """The bit at which the owner folds into the key (into the top word of
    a wide key): above its 2k (2 top_bases(k)) used bits, while the owner's
    bits still end at or below bit 62, so a folded key stays below
    INT64_MAX.  None where it does not fit: the owner is then a leading
    key word."""
    used = 2 * k if k <= MAX_K else 2 * kmers.top_bases(k)
    return used if used + (n_dest - 1).bit_length() <= 62 else None


class _Exchange:
    """The exchange's receive buffers: local destination d gets [*lead,
    n_src, cap] (global source s at [..., s, :]) once `exchange()` ran.

    In one process, on one device they are the views [..., d, :, :] of one
    [*lead, n_dest, n_src, cap] buffer, so a source's [*lead, n_dest, cap]
    buckets go in by one strided copy; across cards a source's bucket for
    d is copied to d's device.  Across processes the local sources'
    buckets are laid out [n_dest, L_src, *lead, cap] (destinations
    process-major) and `exchange()` is one all_to_all_single: process q
    gets its L destinations' rows from every process."""

    def __init__(self, mesh: Mesh, lead: tuple, cap: int,
                 dtype: torch.dtype):
        n, L = mesh.n, mesh.n_local
        self.mesh, self.lead, self.cap = mesh, lead, cap
        self.big = self.out = None
        if mesh.multiprocess:
            self.out = torch.empty((n, L, *lead, cap), dtype=dtype,
                                   device=mesh.devices[0])
            self.recv = None
        elif mesh.one_device:
            self.big = torch.empty((*lead, n, n, cap), dtype=dtype,
                                   device=mesh.devices[0])
            self.recv = [self.big[..., d, :, :] for d in range(n)]
        else:
            self.recv = [torch.empty((*lead, n, cap), dtype=dtype,
                                     device=dev) for dev in mesh.devices]

    def send(self, s: int, buckets: torch.Tensor) -> None:
        """Local source s's [*lead, n_dest, cap] buckets into every
        destination."""
        if self.out is not None:
            self.out[:, s] = buckets.movedim(-2, 0)
        elif self.big is not None:
            self.big[..., :, s, :] = buckets
        else:
            for d, r in enumerate(self.recv):
                r[..., s, :].copy_(buckets[..., d, :])

    def exchange(self) -> None:
        """Hand every destination its buckets (across processes, the one
        collective; in one process the sends already did)."""
        if self.out is None:
            return
        from .distributed import all_to_all

        m = self.mesh
        got = all_to_all(self.out).view(m.procs, m.n_local, m.n_local,
                                        *self.lead, self.cap)
        self.out = None
        self.recv = [got[:, d].reshape(m.n, *self.lead, self.cap)
                     .movedim(0, -2).to(dev)
                     for d, dev in enumerate(m.devices)]


class ShardedCounter:
    """Streaming k-mer counter whose table lives sharded over a mesh.

    Local shard s's table is `tables[s]`: a counting.CountTable (k <= 31)
    or a wide.WideTable (31 < k <= 255) of `shard_capacity` slots on the
    shard's device, sorted with a sentinel tail; `n_unique[mesh.first + s]`
    real entries (`n_unique` and `n_max` cover every process's shards).
    `add_codes` buffers one [rows, L] code batch, rows padded with invalid
    codes to a multiple of the local shards and cut into as many row
    slices, local shard s taking the s-th (across processes every process
    passes its own rows, the same shape everywhere:
    distributed.lockstep_code_batches); every `flush_batches` batches (or
    at a shape change, or `flush()`) the buffered batches go through one
    flush.  `finish` merges the shards into one table; `histogram` sums
    per-shard histograms.
    """

    def __init__(self, mesh: Mesh, k: int, canonical: bool = True,
                 shard_capacity: int = 1 << 18,
                 route_slack: float = 2.0,
                 flush_batches: int = 16,
                 disable_grow: bool = False,
                 max_capacity: int = 1 << 30):
        self.n_words = kmers.words_for_k(k)  # raises outside [1, 255]
        self.mesh = mesh
        self.n = mesh.n
        self.k = k
        self.canonical = canonical
        self.wide = k > MAX_K
        self.shard_capacity = int(shard_capacity)
        self.route_slack = float(route_slack)
        self.flush_batches = int(flush_batches)
        self.disable_grow = bool(disable_grow)
        self.max_capacity = int(max_capacity)
        self._fold = _fold_shift(k, self.n)
        self.tables = [self._empty(d) for d in mesh.devices]
        self.n_unique = np.zeros(self.n, np.int64)
        # running max of per-flush unique counts: an overflow of ANY flush
        # is seen even if later flushes report fewer
        self.n_max = np.zeros(self.n, np.int64)
        self._dropped = 0
        self._codes: list = []
        self._shape: tuple | None = None
        # the one flush whose overflow and drops are not settled yet:
        # (pre-flush state, codes, b, rows, length), kept so that it can
        # replay in place
        self._pending: tuple | None = None

    def _empty(self, dev):
        if self.wide:
            return wide.empty_table(self.shard_capacity, self.n_words,
                                    device=dev)
        return counting.empty_table(self.shard_capacity, device=dev)

    def _route_cap(self, b: int, rows: int, length: int) -> int:
        """Slots of one (source, destination) bucket: the uniform share of
        a source's windows times route_slack, a power of two (capped at
        the source's window count)."""
        windows_local = max(b * (rows // self.n) * (length - self.k + 1), 1)
        rc = int(np.ceil(windows_local / self.n * self.route_slack))
        rc = max(min(rc, windows_local), 1)
        return min(_next_pow2(rc), windows_local)

    def _put(self, codes) -> list:
        """Pad rows to a multiple of the local shards (invalid codes) and
        cut them into as many row slices, slice s on local shard s's
        device."""
        if isinstance(codes, torch.Tensor):
            codes = codes.to(torch.uint8)
        else:  # the reader may reuse its buffers: take a copy
            codes = torch.tensor(np.asarray(codes, np.uint8))
        if codes.dim() != 2:
            raise ValueError("expected [rows, length] code batch")
        rows, length = codes.shape
        n_local = self.mesh.n_local
        if rows % n_local:
            pad = n_local - rows % n_local
            codes = torch.cat([codes, torch.full(
                (pad, length), 255, dtype=torch.uint8, device=codes.device)])
        per = codes.shape[0] // n_local
        return [codes[s * per:(s + 1) * per].to(dev)
                for s, dev in enumerate(self.mesh.devices)]

    def add_codes(self, codes) -> None:
        parts = self._put(codes)
        shape = (parts[0].shape[0] * self.n, parts[0].shape[1])
        if self._shape is not None and shape != self._shape:
            self.flush()
        self._shape = shape
        self._codes.append(parts)
        if len(self._codes) >= self.flush_batches:
            self.flush()

    def flush(self) -> None:
        """Absorb every buffered batch into the shard tables.  The previous
        flush is settled first; this one is settled by the next flush or
        `check()`, and replays then if it overflowed or dropped keys."""
        if not self._codes:
            return
        self._settle()
        rows, length = self._shape
        codes, b = self._codes, len(self._codes)
        self._codes = []
        self._shape = None
        prev = (self.tables, self.n_max, self._dropped)
        self._apply(self._run_flush(codes, b, rows, length, self.tables),
                    self.n_max, self._dropped)
        self._pending = (prev, codes, b, rows, length)

    def _apply(self, out, prev_nmax, prev_dropped) -> None:
        self.tables, n_u, dropped = out
        self.n_unique = np.asarray(n_u, np.int64)
        self.n_max = np.maximum(prev_nmax, self.n_unique)
        self._dropped = prev_dropped + dropped

    def _owner_sort(self, keys: torch.Tensor, valid: torch.Tensor):
        """K1 over (owner, key) of one source's windows.  Returns (the
        sorted key planes to send, [N] or [W, N]; each slot's owner, [N],
        ascending, >= n at the sentinel tail)."""
        n, shift = self.n, self._fold
        dest = owner_shard(keys, self.k, n)
        bits = (n - 1).bit_length()
        if shift is not None:
            top = keys[0] if self.wide else keys
            folded = torch.where(valid, (dest << shift) | top, SENTINEL)
            if not self.wide:
                s = sort_keys(folded, shift + bits + 1)
                return s, s >> shift
            s = sort_words(torch.cat([folded[None], keys[1:]]),
                           shift + bits + 1)
            return s, s[0] >> shift
        lead = torch.where(valid, dest, SENTINEL)
        planes = torch.cat([lead[None], keys if self.wide else keys[None]])
        s = sort_words(planes, bits + 1)
        return (s[1:] if self.wide else s[1]), s[0]

    def _strip(self, arr: torch.Tensor) -> torch.Tensor:
        """Clear the folded owner bits of arriving keys (sentinels kept)."""
        if self._fold is None:
            return arr
        mask = (1 << self._fold) - 1
        top = arr[0] if self.wide else arr
        top = torch.where(top == SENTINEL, top, top & mask)
        if not self.wide:
            return top
        arr[0] = top
        return arr

    def _run_flush(self, codes, b: int, rows: int, length: int, prev):
        """One flush of the buffered code batches into the local tables
        `prev`: (new local tables, n_unique of every shard, keys dropped in
        routing by every shard)."""
        n, k = self.n, self.k
        rc = self._route_cap(b, rows, length)
        lead = (self.n_words,) if self.wide else ()
        ex = _Exchange(self.mesh, lead, rc, torch.int64)
        dropped = 0
        for s, dev in enumerate(self.mesh.devices):
            keys, valid = tables.extract(torch.cat([c[s] for c in codes]),
                                         k, self.canonical)
            send, dest = self._owner_sort(keys.reshape(*lead, -1),
                                          valid.reshape(-1))
            del keys, valid
            starts = torch.searchsorted(
                dest, torch.arange(n + 1, dtype=torch.int64, device=dev))
            cnts = starts[1:] - starts[:-1]
            dropped += int((cnts - rc).clamp_min(0).sum())
            pos = torch.arange(rc, dtype=torch.int64, device=dev)
            idx = (starts[:-1, None] + pos).clamp_max(dest.numel() - 1)
            ex.send(s, torch.where(pos < cnts[:, None], send[..., idx],
                                   SENTINEL))
            del send, dest, idx
        ex.exchange()
        out, n_u = [], []
        for d in range(self.mesh.n_local):
            arr = self._strip(ex.recv[d].reshape(*lead, -1))
            t = prev[d]
            nu = t.n_unique
            if self.wide:
                merged = merge_runs_words(arr, rc)
                mk, mw = merge_sorted_words(t.keys[:, :nu], t.counts[:nu],
                                            merged)
                table = wide.WideTable(*counting.reduce_stream(
                    mk, mw, self.shard_capacity))
            else:
                merged = merge_runs(arr.contiguous(), rc)
                mk, mw = merge_sorted(t.keys[:nu], t.counts[:nu], merged)
                table = counting.CountTable(*counting.reduce_stream(
                    mk, mw, self.shard_capacity))
            del arr, merged, mk, mw
            out.append(table)
            n_u.append(table.n_unique)
        if self.mesh.multiprocess:
            from .distributed import gather_ints

            every = gather_ints([*n_u, dropped])
            n_u, dropped = every[:, :-1].reshape(-1), int(every[:, -1].sum())
        return out, n_u, dropped

    def _grow_capacity(self) -> None:
        if self.disable_grow or self.shard_capacity * 2 > self.max_capacity:
            raise RuntimeError(
                f"shard table overflow: unique keys > capacity "
                f"{self.shard_capacity} and growth is "
                f"{'disabled' if self.disable_grow else 'capped'}")
        self.shard_capacity *= 2

    def _settle(self) -> None:
        """Settle the pending flush: replay it in place from the pre-flush
        tables on overflow (capacity doubled) or on routing drops (route
        slack doubled), until neither happens."""
        if self._pending is None:
            return
        (prev_t, prev_nmax, prev_dropped), codes, b, rows, length = \
            self._pending
        self._pending = None
        while True:
            need = int(self.n_unique.max())
            grew_drops = self._dropped > prev_dropped
            if need <= self.shard_capacity and not grew_drops:
                return
            # the reduce counted every run past the slots: double straight
            # to the capacity that holds them (kat_tpu doubles once a
            # replay; the capacity it ends at is the same)
            while self.shard_capacity < need:
                self._grow_capacity()
            if grew_drops:
                windows_local = b * (rows // self.n) * (length - self.k + 1)
                if self._route_cap(b, rows, length) >= windows_local:
                    raise RuntimeError(  # cannot happen: a bucket holds all
                        f"{self._dropped - prev_dropped} k-mers dropped in "
                        "routing at maximum route capacity")
                self.route_slack *= 2
            self._apply(self._run_flush(codes, b, rows, length, prev_t),
                        prev_nmax, prev_dropped)

    def check(self) -> None:
        """Flush and settle; raise on drops or overflow (backstops: the
        settle replays both in place)."""
        self.flush()
        self._settle()
        if self._dropped:
            raise RuntimeError(f"{self._dropped} k-mers dropped in routing; "
                               "increase route_slack")
        if (self.n_max > self.shard_capacity).any():
            raise RuntimeError(
                f"shard table overflow: {int(self.n_max.max())} unique keys "
                f"> capacity {self.shard_capacity}")

    @property
    def dropped(self) -> int:
        return int(self._dropped)

    def finish(self):
        """The shards merged into one table on the first local shard's
        device (a CountTable or a WideTable), capacity the next power of
        two of the real entries; equal to the one-device counter's table.
        Across processes the shards' entries are all-gathered first, so
        every process gets the same table."""
        self.check()
        dev0 = self.mesh.devices[0]
        total = int(self.n_unique.sum())
        cap = 1 << max(1, int(np.ceil(np.log2(max(total, 2)))))
        counts = torch.cat([t.counts[:t.n_unique].to(dev0)
                            for t in self.tables])
        if self.wide:
            keys = torch.cat([t.keys[:, :t.n_unique].to(dev0)
                              for t in self.tables], dim=1)
        else:
            keys = torch.cat([t.keys[:t.n_unique].to(dev0)
                              for t in self.tables])
        if self.mesh.multiprocess:
            keys, counts = self._gather_entries(keys, counts)
        reduce = wide._unique_reduce if self.wide else \
            counting._unique_reduce
        return reduce(keys, counts, cap)

    def _gather_entries(self, keys: torch.Tensor, counts: torch.Tensor):
        """Every process's real entries (keys [...] or [W, ...], counts),
        concatenated in rank order: one all_gather of each, padded to the
        largest process's total (known from n_unique)."""
        from .distributed import all_gather

        m = self.mesh
        totals = [int(t) for t in
                  self.n_unique.reshape(m.procs, m.n_local).sum(1)]
        pad = max(totals) - counts.numel()
        keys = torch.cat([keys, torch.full(
            (*keys.shape[:-1], pad), SENTINEL, dtype=keys.dtype,
            device=keys.device)], dim=-1)
        counts = torch.cat([counts, counts.new_zeros(pad)])
        ks, cs = all_gather(keys), all_gather(counts)
        return (torch.cat([x[..., :t] for x, t in zip(ks, totals)], dim=-1),
                torch.cat([x[:t] for x, t in zip(cs, totals)]))

    def histogram(self, base: int, ceil: int, inc: int,
                  nb_buckets: int) -> np.ndarray:
        """Occurrence histogram: one per shard, summed exactly in int64
        (an all_reduce across processes; uint64 numpy, as kat_tpu's)."""
        self.check()
        dev0 = self.mesh.devices[0]
        h = sum(stats.hist_from_counts(t.counts, base, ceil, inc,
                                       nb_buckets).to(dev0)
                for t in self.tables)
        if self.mesh.multiprocess:
            from .distributed import all_reduce_sum

            h = all_reduce_sum(h.to(torch.int64))
        return h.cpu().numpy().astype(np.uint64)
