"""Shared tool plumbing: the analogue of KAT's `InputHandler`
(reference lib/src/input_handler.cc) — glob expansion, file-type sniffing,
COUNT-vs-LOAD dispatch, 5' trim lists, hash dumping, and the window
lookups of the sequence tools.

Port of kat_tpu/tools/common.py: COUNT through CodeStreamingCounter
(`flush="classic"`, the default; for 31 < k <= 255
core/wide.WideCodeStreamingCounter), through the minimizer-bucketed flush
of core/bucketed.py (`flush="bucketed"`, the counterpart of kat_tpu's
KAT_TPU_MINIMIZER switch; it raises where its conditions fail and never
turns into the classic flush by itself), or on a mesh of shards
(parallel/sharded.ShardedCounter, `n_shards`: the counterpart of kat_tpu's
mesh branch), LOAD from a .jf (narrow or wide keys).  A sharded input
keeps its tables on their shards: lookups are routed there
(parallel/analysis.py) and `host_table()` merges them on demand.  In a
multi-process run (parallel/distributed.init_distributed) a count always
shards, over every process's local shards; each process reads its slice
of the files (with their 5' trims) and feeds lockstep batches.
"""

from __future__ import annotations

import glob as _glob
import os
import sys
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from .. import DEFAULT_HASH_SIZE, DEFAULT_MER_LEN
from ..core import counting, kmers, wide
from ..io import fastx, jellyfish
from ..utils.profiling import annotate
from ..utils.timer import stage

FLUSHES = ("classic", "bucketed")


class InputMode(Enum):
    COUNT = 0
    LOAD = 1


def default_device() -> torch.device:
    """The first card.  Without one this raises: counting on the CPU is
    never chosen silently, the caller has to ask for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is false.  "
            "kat_tpu_torch runs on an NVIDIA card by default; to run on "
            "the CPU ask for it: `--device cpu` on the command line, or "
            "Input(device=torch.device('cpu')).")
    return torch.device("cuda", 0)


def brace_expand(pattern: str) -> list[str]:
    """Minimal {a,b} brace expansion (glob(3) GLOB_BRACE)."""
    i = pattern.find("{")
    if i < 0:
        return [pattern]
    depth = 0
    for j in range(i, len(pattern)):
        if pattern[j] == "{":
            depth += 1
        elif pattern[j] == "}":
            depth -= 1
            if depth == 0:
                inner = pattern[i + 1:j]
                parts = []
                d = 0
                last = 0
                for t, ch in enumerate(inner):
                    if ch == "{":
                        d += 1
                    elif ch == "}":
                        d -= 1
                    elif ch == "," and d == 0:
                        parts.append(inner[last:t])
                        last = t + 1
                parts.append(inner[last:])
                out = []
                for p in parts:
                    out.extend(brace_expand(pattern[:i] + p + pattern[j + 1:]))
                return out
    return [pattern]


def glob_files(spec: str | list[str]) -> list[str]:
    """Glob expansion mirroring InputHandler::globFiles (input_handler.cc:
    245-316): space-separated patterns, tilde + brace expansion, NOCHECK
    (pattern kept verbatim when nothing matches)."""
    elements = [spec] if isinstance(spec, str) else list(spec)
    out: list[str] = []
    for el in elements:
        # "shard://<pattern>" marks a multi-process input group: the
        # pattern expands as usual here (every process sees the same path
        # list, so headers and artifact names agree); each process's file
        # slice is taken at read time (Input._shard_paths_trims), with or
        # without the prefix.
        if el.startswith("shard://"):
            el = el[len("shard://"):]
        if fastx.is_generator_path(el):
            # a gen:<shell command> is opaque: the command may contain
            # spaces/globs that belong to the SHELL, not to this group
            out.append(el)
            continue
        # each element may itself hold space-separated patterns (the
        # reference passes one quoted "file1 file2" positional through
        # boost::po and splits inside globFiles)
        for raw in el.split(" "):
            if not raw:
                continue
            matched_any = False
            for pat in brace_expand(os.path.expanduser(raw)):
                hits = sorted(_glob.glob(pat))
                if hits:
                    out.extend(hits)
                    matched_any = True
            if not matched_any:
                out.append(raw)
    if not out:
        raise ValueError("No input provided for this input group")
    return out


@dataclass
class Input:
    """One input group: either sequence files to count or a .jf to load.

    device: where the table lives and the kernels run; None means the
    card (`default_device()`, which raises when there is none).
    flush: "classic" (sort, merge and reduce of extracted windows) or
    "bucketed" (the minimizer-bucketed chunk flush).
    n_shards: count on a mesh of this many shards (`mesh()`); None shards
    where kat_tpu does, over every card when more than one is visible and
    the device is a card.  In a multi-process run it is the number of this
    process's shards, by default one per visible card (or one on the
    CPU)."""
    paths: list[str]
    index: int = 1
    canonical: bool = True
    mer_len: int = DEFAULT_MER_LEN
    hash_size: int = DEFAULT_HASH_SIZE
    trim5: list[int] = field(default_factory=list)
    dump_hash: bool = False
    disable_grow: bool = False
    mode: InputMode = InputMode.COUNT
    table: counting.CountTable | wide.WideTable | None = None
    header: jellyfish.JfHeader | None = None
    device: torch.device | None = None
    flush: str = "classic"
    # what the bucketed flush tallied (flushes, chunks, windows, record
    # slots, hot groups); empty after a classic count
    flush_stats: dict = field(default_factory=dict)
    n_shards: int | None = None
    # the live mesh-sharded counter of a sharded COUNT: its tables stay on
    # their shards, `table` is filled only by host_table()
    shards: object | None = None

    def _device(self) -> torch.device:
        if self.device is None:
            self.device = default_device()
        return self.device

    def validate(self) -> None:
        if self.trim5 and len(self.trim5) not in (1, len(self.paths)):
            raise ValueError(
                "Inconsistent number of inputs and trimming settings.")
        mode = None
        for p in self.paths:
            if not fastx.is_stream_path(p) and not os.path.exists(p):
                raise FileNotFoundError(
                    f"Could not find input file at: {p}; please check the "
                    "path and try again.")
            m = (InputMode.COUNT if fastx.is_sequence_file(p)
                 else InputMode.LOAD)
            if mode is None:
                mode = m
            elif m != mode:
                raise ValueError(
                    "Cannot mix sequence files and jellyfish hashes.  "
                    f"Input: {p}")
        self.mode = mode or InputMode.COUNT

    # -- naming helpers (input_handler.cc:160-178) --
    def path_string(self) -> str:
        return " ".join(self.paths)

    def file_name(self) -> str:
        return " ".join(os.path.basename(p) for p in self.paths)

    # -- counting --
    def count(self, quiet: bool = False) -> None:
        kmers.words_for_k(self.mer_len)  # raises outside [1, 255]
        if self.flush not in FLUSHES:
            raise ValueError(f"flush={self.flush!r}: expected one of "
                             f"{FLUSHES}")
        # Start small and let the streaming counter double as needed; the
        # user's hash_size is an upper bound like jellyfish's initial size.
        cap0 = 1 << 20
        with stage(f"Input {self.index} is a sequence file.  Counting kmers "
                   f"for input {self.index} ({self.path_string()})",
                   quiet=quiet):
            caps = dict(
                initial_capacity=min(cap0, _next_pow2(self.hash_size)),
                max_capacity=max(_next_pow2(self.hash_size), cap0),
                disable_grow=self.disable_grow, device=self._device())
            mesh = self.mesh()
            if mesh is not None:
                if self.flush == "bucketed":
                    raise ValueError("flush='bucketed' does not run on a "
                                     "mesh: drop --shards or --flush")
                self.shards = self._count_sharded(mesh)
            elif self.flush == "bucketed":
                from ..core import bucketed

                self._require_bucketed()
                self.table = bucketed.count_paths_bucketed(
                    self.paths, self.mer_len, trim5=self.trim5 or None,
                    stats=self.flush_stats, **caps)
            else:
                # Flushes are sized by window count (1<<26, as kat_tpu's
                # kernel path), whatever batch geometry the reader emits.
                counter = (wide.WideCodeStreamingCounter
                           if self.mer_len > kmers.MAX_K
                           else counting.CodeStreamingCounter)
                sc = counter(self.mer_len, self.canonical,
                             flush_windows=1 << 26, **caps)
                batches = iter(self._code_batches())
                while True:
                    with annotate("kat.input.wait"):  # the reader's next batch
                        batch = next(batches, None)
                    if batch is None:
                        break
                    sc.add_codes(batch)
                self.table = sc.finish()
        n_uniq = (int(self.shards.n_unique.sum()) if self.shards is not None
                  else self.table.n_unique)
        self.header = jellyfish.JfHeader(
            key_len=2 * self.mer_len, counter_len=4,
            canonical=self.canonical, size=_next_pow2(2 * n_uniq))

    def mesh(self):
        """The mesh this input counts on, or None for one device: n_shards
        shards when it is set (`--shards N`; on the CPU when the device is
        the CPU, else round-robin over the visible cards), else every card
        when more than one is visible, the device is a card and the flush
        is the classic one (kat_tpu's rule, kat_tpu/tools/common.py:157-189;
        the bucketed flush runs on one device).  In a multi-process run
        always a mesh over every process's shards (kat_tpu's rule at
        :164-166: a private table would hold only this process's files),
        n_shards of them here, by default one per visible card, or one on
        the CPU; the same mesh on every call (`global_mesh` is a
        collective)."""
        from ..parallel import distributed
        from ..parallel.sharded import make_mesh

        dev = self._device()
        if distributed.process_count() > 1:
            if getattr(self, "_global_mesh", None) is None:
                n = self.n_shards or (1 if dev.type == "cpu" else None)
                self._global_mesh = distributed.global_mesh(
                    n, devices=[dev] if dev.type == "cpu" else None)
            return self._global_mesh
        if self.n_shards is None:
            if (dev.type == "cuda" and torch.cuda.device_count() > 1
                    and self.flush == "classic"):
                return make_mesh()
            return None
        return make_mesh(self.n_shards,
                         devices=[dev] if dev.type == "cpu" else None)

    def _count_sharded(self, mesh):
        """Count on the mesh: k-mers routed to their owner shards
        (parallel/sharded.py).  Growth happens in place inside the counter
        (a flush that overflows or drops replays at doubled capacity or
        slack); this outer restart loop is kat_tpu's fallback, and the
        raise path when growth is disabled or capped.  Returns the live
        ShardedCounter."""
        from ..parallel.sharded import ShardedCounter

        shard_cap = _next_pow2(max(self.hash_size // mesh.n, 1 << 16))
        slack = 4.0
        while True:
            sc = ShardedCounter(mesh, self.mer_len, canonical=self.canonical,
                                shard_capacity=shard_cap, route_slack=slack,
                                disable_grow=self.disable_grow)
            try:
                for batch in self._code_batches():
                    sc.add_codes(batch)
                sc.check()
                return sc
            except RuntimeError as e:
                msg = str(e)
                if "dropped in routing" in msg and "maximum" not in msg:
                    slack *= 2
                elif "shard table overflow" not in msg:
                    raise
                elif self.disable_grow or shard_cap * 2 > sc.max_capacity:
                    raise counting.TableFullError(msg) from e
                else:
                    shard_cap *= 2

    def _require_bucketed(self) -> None:
        """kat_tpu's conditions for the bucketed flush
        (kat_tpu/tools/common.py:173-186).  Where one fails this raises: a
        bucketed request never counts through the classic flush."""
        from ..core import minimizer
        from ..io import native

        why = None
        if not self.canonical:
            why = "it counts canonical k-mers only (drop --non_canonical)"
        elif not minimizer.supports(self.mer_len):
            why = (f"k={self.mer_len} is outside ({minimizer.M_DEFAULT}, "
                   f"{minimizer.M_DEFAULT + 16}]")
        elif any(fastx.is_stream_path(p) for p in self.paths):
            why = "the supermer router reads files, not pipes or stdin"
        if why:
            raise ValueError(f"flush='bucketed' cannot take this input: "
                             f"{why}")
        native.require_lib()  # raises with the compiler's output

    def window_counts(self, codes):
        """(counts u32, gc i32, valid bool) per window of a [rows, L] code
        batch, as host arrays: each plane crosses to the host once per
        batch, so callers slice rows without touching the device.  A
        sharded input answers by routed lookups into its shards."""
        from ..core import coverage

        if self.shards is not None:
            c, g, v = self._routed_window_counts(codes)
        else:
            c, g, v = coverage.window_counts(
                self._compacted_table(), self._codes(codes), self.mer_len,
                self.canonical)
        return (c.cpu().numpy().astype(np.uint32), g.cpu().numpy(),
                v.cpu().numpy())

    def window_hit_counts(self, codes):
        """Per-row (hits, valid windows) with the reduction done on the
        device: two [rows] vectors come back instead of [rows, W] planes
        (the profile loop of filter seq only needs ratios)."""
        from ..core import coverage

        if self.shards is not None:
            c, _g, v = self._routed_window_counts(codes)
            return (((c > 0) & v).sum(-1).cpu().numpy().astype(np.int64),
                    v.sum(-1).cpu().numpy().astype(np.int64))
        hits, nwin = coverage.window_hit_counts(
            self._compacted_table(), self._codes(codes), self.mer_len,
            self.canonical)
        return hits.cpu().numpy(), nwin.cpu().numpy()

    def _codes(self, codes) -> torch.Tensor:
        return torch.as_tensor(codes, dtype=torch.uint8).to(self._device())

    def _routed_window_counts(self, codes):
        """window_counts of a sharded input: parallel/analysis.py's routed
        lookups, the service kept per counter."""
        from ..parallel.analysis import ShardedLookup, window_counts_routed

        if getattr(self, "_lookup_src", None) is not self.shards:
            self._lookup_svc = ShardedLookup(self.shards)
            self._lookup_src = self.shards
        return window_counts_routed(
            self._lookup_svc,
            torch.as_tensor(codes, dtype=torch.uint8).to(
                self.shards.mesh.devices[0]), self.mer_len, self.canonical)

    def _compacted_table(self):
        """The finished table compacted for the lookup phase (cached per
        table identity): bulk lookups pay streaming passes over the
        table's capacity, so probing at the growth policy's final
        (possibly 2x-oversized) capacity wastes bandwidth."""
        from ..core import tables

        if getattr(self, "_lookup_table_src", None) is not self.table:
            self._lookup_table = tables.compact(self.table)
            self._lookup_table_src = self.table
        return self._lookup_table

    def host_table(self):
        """The finished table, merged from the mesh's shards on first demand
        (ShardedCounter.finish) for a sharded input.  The sharded tools
        (hist, gcp, comp, sect, cold, filter seq) never call it for one; it
        backs .jf dumps, the filter kmer export and comp of mixed LOAD and
        COUNT inputs."""
        if self.table is None and self.shards is not None:
            self.table = self.shards.finish()
        return self.table

    def _shard_paths_trims(self):
        """This process's slice of the input files in a multi-process run
        (balanced by size, the round-robin of distributed.shard_files),
        with 5' trims following their files.  One process: everything."""
        from ..parallel.distributed import process_count, process_index

        cnt = process_count()
        if cnt <= 1:
            return self.paths, (self.trim5 or None)
        order = sorted(
            range(len(self.paths)),
            key=lambda i: -os.path.getsize(self.paths[i])
            if os.path.exists(self.paths[i]) else 0)
        mine = sorted(order[process_index()::cnt])
        paths = [self.paths[i] for i in mine]
        if self.trim5 and len(self.trim5) == len(self.paths):
            trims = [self.trim5[i] for i in mine]
        else:
            trims = self.trim5 or None  # one value applies to every file
        return paths, trims

    def _code_batches(self):
        """2-bit code batches for counting: the native densely packed
        reader when available (native/fastxio.cpp), else the
        pure-Python bucketed encoder (always for generator pipes, FIFOs
        and stdin).  A background thread keeps the parser a few batches
        ahead of device compute (io/prefetch.py).  A multi-process run
        reads this process's file slice and passes every batch through
        the lockstep padder, so the sharded counter's flushes line up in
        every process."""
        from ..io import native
        from ..io.prefetch import prefetch
        from ..parallel.distributed import (lockstep_code_batches,
                                            process_count)

        paths, trims = self._shard_paths_trims()
        if not paths:
            it = iter(())
        else:
            any_stream = any(fastx.is_stream_path(p) for p in paths)
            if native.available() and not any_stream:
                it = native.stream_code_batches(
                    paths, self.mer_len, trims,
                    threads=native.reader_threads_default(len(paths)))
            else:
                recs = fastx.read_records_multi(paths, trims)
                it = fastx.encode_batches(recs, self.mer_len)
            it = prefetch(it)
        if process_count() > 1:
            return lockstep_code_batches(it)
        return it

    def load(self, quiet: bool = False) -> None:
        with stage("Loading hashes into memory", quiet=quiet):
            wide_keys = jellyfish.read_header(
                self.paths[0])[0].mer_len > kmers.MAX_K
            hdr, keys, counts = (jellyfish.read_jf_words if wide_keys
                                 else jellyfish.read_jf)(self.paths[0])
            self.header = hdr
            self.canonical = hdr.canonical
            self.mer_len = hdr.mer_len
            build = (wide.table_from_words if wide_keys
                     else counting.table_from_numpy)
            self.table = build(keys, counts,
                               capacity=_next_pow2(max(len(counts), 1)),
                               device=self._device())

    def validate_mer_len(self, mer_len: int) -> None:
        if self.mode == InputMode.LOAD and self.header is not None:
            if self.header.key_len != mer_len * 2:
                raise ValueError(
                    "Cannot process hashes that were created with different "
                    f"K-mer lengths.  Expected: {mer_len}.  Key length was "
                    f"{self.header.key_len // 2} for : {self.paths[0]}")

    def count_or_load(self, quiet: bool = False) -> None:
        if self.mode == InputMode.COUNT:
            self.count(quiet=quiet)
        else:
            self.load(quiet=quiet)

    def dump(self, out_path: str, quiet: bool = False) -> None:
        if self.mode == InputMode.COUNT:
            with stage(f"Dumping hash to {out_path}", quiet=quiet):
                if os.path.lexists(out_path):
                    os.remove(out_path)
                table = self.host_table()
                keys, counts = (
                    wide.table_words_to_numpy(table)
                    if isinstance(table, wide.WideTable)
                    else counting.table_to_numpy(table))
                jellyfish.write_jf(out_path, keys, counts, self.mer_len,
                                   self.canonical, cmdline=list(sys.argv))
        else:
            if os.path.lexists(out_path):
                os.remove(out_path)
            os.symlink(self.paths[0], out_path)


def _next_pow2(n: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(int(n), 2)))))


def parse_trim_list(spec: str) -> list[int]:
    """Comma-separated 5' trim values (histogram.cc:334-337)."""
    return [int(v) for v in spec.split(",")]


def ensure_parent_dir(path_prefix: str) -> None:
    parent = os.path.dirname(os.path.abspath(path_prefix))
    os.makedirs(parent, exist_ok=True)
