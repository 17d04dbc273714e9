"""Shared tool plumbing: the analogue of KAT's `InputHandler`
(reference lib/src/input_handler.cc) — glob expansion, file-type sniffing,
COUNT-vs-LOAD dispatch and 5' trim lists.

Port of kat_tpu/tools/common.py, COUNT path only: k <= 31 on one device
through CodeStreamingCounter.  LOAD mode (.jf inputs) and hash dumping
need the .jf codec, which is not ported yet (ROADMAP §1 item 6); kat_tpu's
mesh, minimizer-bucketed and wide-key branches are not ported either.
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field
from enum import Enum

import numpy as np
import torch

from .. import DEFAULT_HASH_SIZE, DEFAULT_MER_LEN
from ..core import counting, kmers
from ..io import fastx
from ..utils.timer import stage

_JF_TODO = ("not ported yet: needs the .jf codec, ROADMAP.md §1 item 6 "
            "(io/jellyfish.py)")


class InputMode(Enum):
    COUNT = 0
    LOAD = 1


def default_device() -> torch.device:
    """The card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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
    """One input group: sequence files to count (a .jf to load is
    recognised but not supported yet)."""
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
    device: torch.device = field(default_factory=default_device)

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
                f"k={self.mer_len} > {kmers.MAX_K} (wide keys) not ported "
                "yet: ROADMAP.md §1 item 12")
        kmers.spec_valid(self.mer_len)
        # Start small and let the streaming counter double as needed; the
        # user's hash_size is an upper bound like jellyfish's initial size.
        cap0 = 1 << 20
        with stage(f"Input {self.index} is a sequence file.  Counting kmers "
                   f"for input {self.index} ({self.path_string()})",
                   quiet=quiet):
            # Flushes are sized by window count (1<<26, as kat_tpu's
            # kernel path), whatever batch geometry the reader emits.
            sc = counting.CodeStreamingCounter(
                self.mer_len, self.canonical,
                initial_capacity=min(cap0, _next_pow2(self.hash_size)),
                max_capacity=max(_next_pow2(self.hash_size), cap0),
                disable_grow=self.disable_grow,
                flush_windows=1 << 26, device=self.device)
            for batch in self._code_batches():
                sc.add_codes(batch)
            self.table = sc.finish()

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
        raise NotImplementedError(f"LOAD mode (.jf input) {_JF_TODO}")

    def count_or_load(self, quiet: bool = False) -> None:
        if self.mode == InputMode.COUNT:
            self.count(quiet=quiet)
        else:
            self.load(quiet=quiet)

    def dump(self, out_path: str, quiet: bool = False) -> None:
        raise NotImplementedError(f"--dump_hash {_JF_TODO}")


def _next_pow2(n: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(int(n), 2)))))


def parse_trim_list(spec: str) -> list[int]:
    """Comma-separated 5' trim values (histogram.cc:334-337)."""
    return [int(v) for v in spec.split(",")]


def ensure_parent_dir(path_prefix: str) -> None:
    parent = os.path.dirname(os.path.abspath(path_prefix))
    os.makedirs(parent, exist_ok=True)
