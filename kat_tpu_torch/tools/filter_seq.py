"""`kat filter seq` — keep sequences whose k-mer hit ratio meets a
threshold (port of kat_tpu/tools/filter_seq.py; on a mesh, the lookups are
routed to the shards through Input.window_hit_counts).

Output-parity re-implementation of reference src/filter_sequence.cc: builds
a presence profile per sequence (getProfile, :330-368: invalid windows
count as misses but stay in the denominator), keeps records whose
`matches / nb_kmers >= threshold` (xor invert), optionally subsamples by
frequency, writes kept and discarded records to `.in`/`.out` files (paired
mode reads two files in lockstep into `.R1`/`.R2` outputs; a `.gz` prefix
writes gzip) and an optional stats TSV.  The one-at-a-time hash probes
become batched lookups whose hit counts are reduced on the device
(Input.window_hit_counts).

Subsampling draws from `self.rng`, a random.Random the tool holds,
unseeded as kat_tpu's is; a caller that needs a repeatable draw sets it.
kat_tpu's KAT_TPU_SEQ_BATCH override is not ported.
"""

from __future__ import annotations

import gzip
import math
import os
import random

import numpy as np

from ..io import fastx
from ..utils.timer import stage
from .common import Input, ensure_parent_dir

PROFILE_BATCH = 1024  # records per batch, reference src/sect.hpp:66


class _Writer:
    """FASTA/FASTQ record writer matching the input file's format."""

    def __init__(self, path: str, fmt: str):
        self.fmt = fmt
        if path.endswith(".gz"):
            self.f = gzip.open(path, "wt")
        else:
            self.f = open(path, "w")

    def write(self, rec: fastx.Record) -> None:
        if self.fmt == "fastq" and rec.qual is not None:
            self.f.write(f"@{rec.name}\n{rec.seq.decode()}\n+\n"
                         f"{rec.qual.decode()}\n")
        else:
            self.f.write(f">{rec.name}\n{rec.seq.decode()}\n")

    def close(self) -> None:
        self.f.close()


class FilterSeq:
    def __init__(self, seq_file: str, seq_file_2: str | None,
                 inputs: list[str]):
        self.seq_file = seq_file
        self.seq_file_2 = seq_file_2
        self.input = Input(paths=list(inputs), index=1)
        self.output_prefix = "kat.filter.seq"
        self.threshold = 0.1
        self.frequency = 0.0
        self.invert = False
        self.separate = False
        self.do_stats = False
        self.verbose = False
        self.quiet = False
        self.keepers = 0
        self.total = 0
        self.rng = random.Random()

    @property
    def paired(self) -> bool:
        return self.seq_file_2 is not None

    def execute(self) -> None:
        for p in (self.seq_file, self.seq_file_2):
            if p is not None and not os.path.exists(p):
                raise FileNotFoundError(
                    f"Could not find input file at: {p}; please check the "
                    "path and try again.")
        self.input.validate()
        ensure_parent_dir(self.output_prefix)
        self.input.count_or_load(quiet=self.quiet)

        with stage("Filtering sequences", quiet=self.quiet):
            self.filter_records()
        if not self.quiet:
            print(f"Found {self.keepers} / {self.total} to keep")
            print()

    def filter_records(self) -> None:
        """Profile every record (pair) against the counted (or loaded, or
        given) table and write the kept and discarded ones and the
        stats."""
        ext = os.path.splitext(self.seq_file)[1]
        fmt = fastx.sniff_format(self.seq_file)
        r1 = "" if not self.paired else ".R1"
        in_w = _Writer(f"{self.output_prefix}.in{r1}{ext}", fmt)
        out_w = _Writer(f"{self.output_prefix}.out{r1}{ext}", fmt) \
            if self.separate else None
        in_w2 = out_w2 = None
        if self.paired:
            in_w2 = _Writer(f"{self.output_prefix}.in.R2{ext}", fmt)
            if self.separate:
                out_w2 = _Writer(f"{self.output_prefix}.out.R2{ext}", fmt)
        stats_f = None
        if self.do_stats:
            stats_f = open(f"{self.output_prefix}.stats", "w")
            stats_f.write("index\tnb_bases\tnb_kmers\tnb_hits\tratio\n")

        it1 = fastx.read_records(self.seq_file)
        it2 = fastx.read_records(self.seq_file_2) if self.paired else None

        try:
            batch: list[tuple[fastx.Record, fastx.Record | None]] = []
            while True:
                rec1 = next(it1, None)
                if rec1 is None:
                    break
                rec2 = None
                if self.paired:
                    rec2 = next(it2, None)
                    if rec2 is None:
                        raise ValueError(
                            "First sequence file appears to be longer than "
                            "the second.")
                batch.append((rec1, rec2))
                if len(batch) == PROFILE_BATCH:
                    self._do_batch(batch, in_w, in_w2, out_w, out_w2,
                                   stats_f)
                    batch = []
            if self.paired and next(it2, None) is not None:
                raise ValueError(
                    "Second sequence file appears to be longer than the "
                    "first.")
            if batch:
                self._do_batch(batch, in_w, in_w2, out_w, out_w2, stats_f)
        finally:
            for w in (in_w, in_w2, out_w, out_w2):
                if w:
                    w.close()
            if stats_f:
                stats_f.close()

    def _profiles(self, records: list[fastx.Record]):
        """(matches, nb_kmers) per record.  A row holds one record's chunk
        (padding is invalid), so the device's per-row hit count is the
        row's share of the record's matches."""
        matches = np.zeros(len(records), np.int64)
        nb_kmers = np.zeros(len(records), np.int64)
        for codes, meta in fastx.encode_batch_indexed(
                records, k=self.input.mer_len):
            hits, _nwin = self.input.window_hit_counts(codes)
            for row, (ri, _start, nw) in enumerate(meta):
                matches[ri] += int(hits[row])
                nb_kmers[ri] += nw
        return matches, nb_kmers

    def _do_batch(self, batch, in_w, in_w2, out_w, out_w2, stats_f) -> None:
        recs1 = [r1 for r1, _ in batch]
        m1, n1 = self._profiles(recs1)
        if self.paired:
            m2, n2 = self._profiles([r2 for _, r2 in batch])
            m1 = m1 + m2
            n1 = n1 + n2

        for i, (rec1, rec2) in enumerate(batch):
            matches = int(m1[i])
            kmer_count = int(n1[i])
            ratio = matches / kmer_count if kmer_count else float("nan")

            keep = True
            # NaN ratio (0 k-mers) fails both comparisons, like C++.
            if ((not math.isnan(ratio))
                    and ((ratio >= self.threshold and not self.invert)
                         or (self.invert and ratio < self.threshold))):
                if 0.0 < self.frequency < self.rng.random():
                    keep = False
                else:
                    self.keepers += 1
                    in_w.write(rec1)
                    if self.paired:
                        in_w2.write(rec2)
            else:
                keep = False

            if self.separate and not keep:
                out_w.write(rec1)
                if self.paired:
                    out_w2.write(rec2)

            if stats_f:
                nb_bases = len(rec1.seq) + (
                    len(rec2.seq) if self.paired else 0)
                ratio_str = "-nan" if math.isnan(ratio) else f"{ratio:g}"
                stats_f.write(f"{self.total}\t{nb_bases}\t{kmer_count}\t"
                              f"{matches}\t{ratio_str}\n")
            self.total += 1
