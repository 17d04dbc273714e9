"""`kat cold` — per-assembly-sequence read coverage and assembly copy
number (port of kat_tpu/tools/cold.py; on a mesh, the lookups are routed to
the shards through Input.window_counts).

Output-parity re-implementation of reference src/cold.cc: counts (or loads)
a reads hash and an assembly hash, then for every assembly sequence computes
the median and mean read k-mer coverage, the median assembly k-mer count
(copy number) and GC%, streaming batches of 1024 records
(sect.hpp:66 BATCH_SIZE).  The per-window probes (cold.cc:303-407
processSeq) become batched lookups against both sorted tables
(core/coverage.py through Input.window_counts: the join or the binary
search, as core/tables.py's policy picks, for narrow and wide keys alike).
kat_tpu's KAT_TPU_SEQ_BATCH override is not ported.
"""

from __future__ import annotations

import numpy as np

from ..io import fastx
from ..utils.timer import stage
from .common import Input, ensure_parent_dir

BATCH_SIZE = 1024  # records per batch, reference src/sect.hpp:66

STATS_HEADER = ("seq_name\tread_median_cvg\tread_mean_cvg\tasm_cn\tgc%\t"
                "seq_length\tkmers_in_seq\tinvalid_kmers\t%_invalid\t"
                "non_zero_kmers\t%_non_zero\t%_non_zero_corrected")


class Cold:
    def __init__(self, reads_files: list[str], asm_file: str):
        self.reads = Input(paths=list(reads_files), index=1)
        self.assembly = Input(paths=[asm_file], index=1)
        self.output_prefix = "kat-cold"
        self.gc_bins = 1001
        self.cvg_bins = 1001
        self.dump_hashes = False
        self.verbose = False
        self.quiet = False

    def execute(self) -> None:
        self.reads.validate()
        self.assembly.validate()
        ensure_parent_dir(self.output_prefix)
        self.reads.count_or_load(quiet=self.quiet)
        self.assembly.count_or_load(quiet=self.quiet)

        with stage("Calculating kmer coverage across sequences",
                   quiet=self.quiet):
            self.write_stats()

        if self.dump_hashes:
            self.reads.dump(
                f"{self.output_prefix}-reads_hash.jf{self.reads.mer_len}",
                quiet=self.quiet)
            self.assembly.dump(
                f"{self.output_prefix}-asm_hash.jf{self.assembly.mer_len}",
                quiet=self.quiet)

    def write_stats(self) -> None:
        """The stats TSV of every assembly sequence, from the counted (or
        loaded, or given) reads and assembly tables."""
        with open(f"{self.output_prefix}-stats.tsv", "w") as stats_f:
            stats_f.write(STATS_HEADER + "\n")
            batch: list[fastx.Record] = []
            for rec in fastx.read_records(self.assembly.paths[0]):
                batch.append(rec)
                if len(batch) == BATCH_SIZE:
                    self._do_batch(batch, stats_f)
                    batch = []
            if batch:
                self._do_batch(batch, stats_f)

    def _do_batch(self, records, stats_f) -> None:
        """Both tables probed with every window of the batch: each bucket's
        [rows, W] planes come to the host once (Input.window_counts); the
        per-row stitching below is host work."""
        k = self.reads.mer_len
        rcounts: list[np.ndarray | None] = [None] * len(records)
        acounts: list[np.ndarray | None] = [None] * len(records)
        invalids: list[np.ndarray | None] = [None] * len(records)
        for codes, meta in fastx.encode_batch_indexed(records, k):
            rc, _g, valid = self.reads.window_counts(codes)
            ac, _g2, _v2 = self.assembly.window_counts(codes)
            for row, (ri, start, nw) in enumerate(meta):
                if rcounts[ri] is None:
                    w_total = len(records[ri].seq) - k + 1
                    rcounts[ri] = np.zeros(w_total, np.uint64)
                    acounts[ri] = np.zeros(w_total, np.uint64)
                    invalids[ri] = np.zeros(w_total, np.bool_)
                rcounts[ri][start:start + nw] = rc[row, :nw]
                acounts[ri][start:start + nw] = ac[row, :nw]
                invalids[ri][start:start + nw] = ~valid[row, :nw]

        for i, rec in enumerate(records):
            self._print_stat_line(stats_f, rec, rcounts[i], acounts[i],
                                  invalids[i])

    def _print_stat_line(self, out, rec, rcounts, acounts, invalid) -> None:
        """One stats row, with kat_tpu's quirks: upper medians
        (sorted[n/2]), the GC% denominator without Ns, `kmers_in_seq`
        through uint32 arithmetic (it wraps for sequences shorter than
        k)."""
        k = self.reads.mer_len
        seq = rec.seq
        seq_len = len(seq)
        nb_counts = seq_len - k + 1
        if rcounts is None or nb_counts <= 0:
            median = 0
            mean = 0.0
            asm_cn = 0
            nb_invalid = 0
            nb_nonzero = 0
        else:
            nb_invalid = int(invalid[:nb_counts].sum())
            nb_nonzero = int((rcounts[:nb_counts] != 0).sum())
            sr = np.sort(rcounts)
            median = int(sr[len(sr) // 2])
            mean = float(rcounts.sum(dtype=np.float64)) / nb_counts
            sa = np.sort(acounts)
            asm_cn = int(sa[len(sa) // 2])

        pct_nonzero = 0.0 if (nb_nonzero == 0 or nb_counts <= 0) else \
            nb_nonzero / nb_counts * 100.0
        pct_invalid = 0.0 if (nb_invalid == 0 or nb_counts <= 0) else \
            nb_invalid / nb_counts * 100.0
        not_invalid = nb_counts - nb_invalid
        pct_nonzero_corr = 0.0 if (nb_nonzero == 0 or not_invalid <= 0) else \
            nb_nonzero / not_invalid * 100.0

        gs = seq.count(b"G") + seq.count(b"g")
        cs = seq.count(b"C") + seq.count(b"c")
        ns = seq.count(b"N") + seq.count(b"n")
        denom = seq_len - ns
        gc_perc = (gs + cs) / denom if denom else float("nan")

        kmers_in_seq = (seq_len - self.assembly.mer_len + 1) % (1 << 32)

        out.write(f"{rec.name}\t{median}\t{mean:.5f}\t{asm_cn}\t"
                  f"{gc_perc:.5f}\t{seq_len}\t{kmers_in_seq}\t{nb_invalid}\t"
                  f"{pct_invalid:.5f}\t{nb_nonzero}\t{pct_nonzero:.5f}\t"
                  f"{pct_nonzero_corr:.5f}\n")
