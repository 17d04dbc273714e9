"""`kat filter kmer` — keep k-mers within count and GC bounds (port of
kat_tpu/tools/filter_kmer.py; a sharded input is merged by
Input.host_table()).

Output-parity re-implementation of reference src/filter_kmer.cc: counts (or
loads) a hash, partitions its k-mers by `inBounds` (low/high count x
low/high GC, filter_kmer.cc:296-309) honouring invert/separate, prints the
distinct/total counter summary (filter_kmer.cc:221-236) and dumps the
resulting hash(es) as jellyfish-compatible .jf files through
io/jellyfish.write_jf.  The slice-parallel scan (filterSlice, :258-292) is
one mask over the sorted table; GC comes from a popcount over the key (on
the device), counts are read unsigned, as kat_tpu's uint32 counts.  Wide
keys (31 < k <= 255) are kept as [W, n] words.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core import counting, tables, wide
from ..io import jellyfish
from ..utils.timer import stage
from .common import Input, ensure_parent_dir


class FilterKmer:
    def __init__(self, inputs: list[str]):
        self.input = Input(paths=list(inputs), index=1)
        self.output_prefix = "kat.filter-kmer"
        self.low_count = 0
        self.high_count = 10000
        self.low_gc = 0
        self.high_gc = 31
        self.invert = False
        self.separate = False
        self.verbose = False
        self.quiet = False
        self.counters: dict[str, tuple[int, int]] = {}

    def execute(self) -> None:
        if self.high_count < self.low_count:
            raise ValueError(
                "High kmer count value must be >= to low kmer count value")
        if self.high_gc < self.low_gc:
            raise ValueError(
                "High GC count value must be >= to low GC count value")
        self.input.validate()
        ensure_parent_dir(self.output_prefix)
        self.input.count_or_load(quiet=self.quiet)
        self.filter_table()

    def filter_table(self) -> None:
        """Partition the counted (or loaded, or given) table, print the
        summary and dump the kept (and with `separate` the discarded)
        k-mers."""
        with stage("Filtering kmers", quiet=self.quiet):
            table = self.input.host_table()
            if tables.is_wide(table):
                keys, counts = wide.table_words_to_numpy(table)
            else:
                keys, counts = counting.table_to_numpy(table)
            n = len(counts)
            gc = tables.gc_of_keys(table)[:n].cpu().numpy()
            in_gc = (self.low_gc <= gc) & (gc <= self.high_gc)
            wide_counts = counts.astype(np.int64)
            in_cvg = ((self.low_count <= wide_counts)
                      & (wide_counts <= self.high_count))
            in_bounds = in_gc & in_cvg
            keep = in_bounds if self.separate else in_bounds ^ self.invert

            self.counters["all"] = (n, int(counts.sum(dtype=np.uint64)))
            self.counters["in"] = (int(keep.sum()),
                                   int(counts[keep].sum(dtype=np.uint64)))
            if self.separate:
                self.counters["out"] = (
                    int((~keep).sum()),
                    int(counts[~keep].sum(dtype=np.uint64)))

        self._print_summary(sys.stdout)

        k = self.input.mer_len
        canonical = (self.input.header.canonical
                     if self.input.header else self.input.canonical)
        self._dump(f"{self.output_prefix}-in.jf{k}", keys[..., keep],
                   counts[keep], canonical)
        if self.separate:
            self._dump(f"{self.output_prefix}-out.jf{k}", keys[..., ~keep],
                       counts[~keep], canonical)

    def _print_summary(self, out) -> None:
        def fmt(c):
            return f"{c[0]} distinct; {c[1]} total."
        out.write(f"K-mers in input   : {fmt(self.counters['all'])}\n")
        out.write(f"K-mers to keep    : {fmt(self.counters['in'])}\n")
        if self.separate:
            out.write(f"K-mers to discard : {fmt(self.counters['out'])}\n")
        out.write("\n")

    def _dump(self, path: str, keys, counts, canonical: bool) -> None:
        if os.path.lexists(path):
            os.remove(path)
        with stage(f"Dumping hash to {path}", quiet=self.quiet):
            jellyfish.write_jf(path, keys, counts, self.input.mer_len,
                               canonical, cmdline=list(sys.argv))
