"""Shared tool plumbing: the analogue of KAT's `InputHandler`
(reference lib/src/input_handler.cc) — glob expansion, file-type sniffing,
COUNT-vs-LOAD dispatch, 5' trim lists, hash dumping, and the window
lookups of the sequence tools.

Port of kat_tpu/tools/common.py for k <= 31 on one device: COUNT through
CodeStreamingCounter (`flush="classic"`, the default) or through the
minimizer-bucketed flush of core/bucketed.py (`flush="bucketed"`, the
counterpart of kat_tpu's KAT_TPU_MINIMIZER switch; it raises where its
conditions fail and never turns into the classic flush by itself), LOAD
from a .jf.  kat_tpu's mesh and wide-key branches are not ported.
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
from ..core import counting, kmers
from ..io import fastx, jellyfish
from ..utils.timer import stage

_WIDE_TODO = "(wide keys) not ported yet: ROADMAP.md §1 item 12"
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
    "bucketed" (the minimizer-bucketed chunk flush)."""
    paths: list[str]
    index: int = 1
    canonical: bool = True
    mer_len: int = DEFAULT_MER_LEN
    hash_size: int = DEFAULT_HASH_SIZE
    trim5: list[int] = field(default_factory=list)
    dump_hash: bool = False
    disable_grow: bool = False
    mode: InputMode = InputMode.COUNT
    table: counting.CountTable | None = None
    header: jellyfish.JfHeader | None = None
    device: torch.device | None = None
    flush: str = "classic"
    # what the bucketed flush tallied (flushes, chunks, windows, record
    # slots, hot groups); empty after a classic count
    flush_stats: dict = field(default_factory=dict)

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
        if self.mer_len > kmers.MAX_K:
            raise NotImplementedError(
                f"k={self.mer_len} > {kmers.MAX_K} {_WIDE_TODO}")
        kmers.spec_valid(self.mer_len)
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
            if self.flush == "bucketed":
                from ..core import bucketed

                self._require_bucketed()
                self.table = bucketed.count_paths_bucketed(
                    self.paths, self.mer_len, trim5=self.trim5 or None,
                    stats=self.flush_stats, **caps)
            else:
                # Flushes are sized by window count (1<<26, as kat_tpu's
                # kernel path), whatever batch geometry the reader emits.
                sc = counting.CodeStreamingCounter(
                    self.mer_len, self.canonical, flush_windows=1 << 26,
                    **caps)
                for batch in self._code_batches():
                    sc.add_codes(batch)
                self.table = sc.finish()
        self.header = jellyfish.JfHeader(
            key_len=2 * self.mer_len, counter_len=4,
            canonical=self.canonical,
            size=_next_pow2(2 * self.table.n_unique))

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
        batch, so callers slice rows without touching the device."""
        from ..core import coverage

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

        hits, nwin = coverage.window_hit_counts(
            self._compacted_table(), self._codes(codes), self.mer_len,
            self.canonical)
        return hits.cpu().numpy(), nwin.cpu().numpy()

    def _codes(self, codes) -> torch.Tensor:
        return torch.as_tensor(codes, dtype=torch.uint8).to(self._device())

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
        """The finished table (the hook where kat_tpu gathers its mesh
        shards; one device here)."""
        return self.table

    def _code_batches(self):
        """2-bit code batches for counting: the native densely packed
        reader when available (kat_tpu/native/fastxio.cpp), else the
        pure-Python bucketed encoder (always for generator pipes, FIFOs
        and stdin).  A background thread keeps the parser a few batches
        ahead of device compute (io/prefetch.py)."""
        from ..io import native
        from ..io.prefetch import prefetch

        paths, trims = self.paths, (self.trim5 or None)
        if not paths:
            return iter(())
        any_stream = any(fastx.is_stream_path(p) for p in paths)
        if native.available() and not any_stream:
            it = native.stream_code_batches(
                paths, self.mer_len, trims,
                threads=native.reader_threads_default(len(paths)))
        else:
            recs = fastx.read_records_multi(paths, trims)
            it = fastx.encode_batches(recs, self.mer_len)
        return prefetch(it)

    def load(self, quiet: bool = False) -> None:
        with stage("Loading hashes into memory", quiet=quiet):
            hdr, keys, counts = jellyfish.read_jf(self.paths[0])
            self.header = hdr
            self.canonical = hdr.canonical
            self.mer_len = hdr.mer_len
            if hdr.mer_len > kmers.MAX_K:
                raise NotImplementedError(
                    f"{self.paths[0]}: k={hdr.mer_len} > {kmers.MAX_K} "
                    f"{_WIDE_TODO}")
            self.table = counting.table_from_numpy(
                keys, counts, capacity=_next_pow2(max(len(keys), 1)),
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
                keys, counts = counting.table_to_numpy(self.host_table())
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
