"""`kat sect` — SEquence Coverage estimator Tool (port of
kat_tpu/tools/sect.py).

Output-parity re-implementation of reference src/sect.cc: per-sequence,
per-base k-mer coverage of a FASTA/Q target against a count hash, streamed
in batches of 1024 records (sect.hpp:66 BATCH_SIZE) so memory stays bounded.
The per-thread per-window hash probes (processSeq, sect.cc:490-602) become
batched device lookups (core/coverage.py); long sequences are chunked with a
(k-1)-base seam and stitched.  On a mesh of more than one shard, contigs of
at least `halo_min` bases (1 Mbp) take the halo-exchange path instead
(parallel/longseq.py: one span per shard and a (k-1)-base ring halo),
answered by routed lookups into a sharded input's shards, or from a loaded
table replicated per shard (k <= 31, as kat_tpu).

Quirk parity (SURVEY §5.1.1/.7): `average_cvg` is never assigned in the
reference, so every sequence lands in coverage-bin 0 of the contamination
matrix; median is sorted[n/2] (upper median); GC%% denominator excludes Ns;
`kmers_in_seq` is printed through uint32 arithmetic and wraps for sequences
shorter than k.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..core.kmers import MAX_K, encode_ascii
from ..core.matrix import Matrix
from ..io import fastx, mme
from ..utils.timer import stage
from .common import Input, ensure_parent_dir

BATCH_SIZE = 1024  # records per batch, reference src/sect.hpp:66
# contigs this long or longer take the halo path on a mesh (kat_tpu's
# KAT_TPU_HALO_MIN default)
HALO_MIN = 1 << 20

STATS_HEADER = ("seq_name\tmedian\tmean\tgc%\tseq_length\tkmers_in_seq\t"
                "invalid_kmers\t%_invalid\tnon_zero_kmers\t%_non_zero\t"
                "%_non_zero_corrected")


class Sect:
    def __init__(self, counts_files: list[str], seq_file: str):
        self.input = Input(paths=list(counts_files), index=1)
        self.seq_file = seq_file
        self.output_prefix = "kat-sect"
        self.gc_bins = 1001
        self.cvg_bins = 1001
        self.cvg_logscale = False
        self.no_count_stats = False
        self.output_gc_stats = False
        self.extract_nr = False
        self.extract_r = False
        self.min_repeat = 2
        self.max_repeat = 0
        self.halo_min = HALO_MIN
        self.verbose = False
        self.quiet = False
        self.contamination_mx: Matrix | None = None

    def execute(self) -> None:
        if not os.path.exists(self.seq_file):
            raise FileNotFoundError(
                f"Could not find sequence file at: {self.seq_file}; please "
                "check the path and try again.")
        self.input.validate()
        ensure_parent_dir(self.output_prefix)
        self.input.count_or_load(quiet=self.quiet)

        # Accumulate GC == gc_bins hits in an extra row that is never
        # printed (same out-of-logical-bounds behaviour as the reference's
        # unchecked SparseMatrix::inc, SURVEY §5.1.3 pattern).
        self._grid = np.zeros((self.gc_bins + 1, self.cvg_bins), np.uint64)

        with stage("Calculating kmer coverage across sequences",
                   quiet=self.quiet):
            self._process_seq_file()
        self.contamination_mx = Matrix(self._grid, m=self.gc_bins,
                                       n=self.cvg_bins)

        if self.input.dump_hash:
            self.input.dump(
                f"{self.output_prefix}-hash.jf{self.input.mer_len}",
                quiet=self.quiet)

        with stage("Merging matrices", quiet=self.quiet):
            pass

    # -- streaming over record batches (sect.cc:143-256) --
    def _process_seq_file(self) -> None:
        pre = self.output_prefix
        count_f = None if self.no_count_stats else open(
            f"{pre}-counts.cvg", "w")
        gc_f = open(f"{pre}-counts.gc", "w") if self.output_gc_stats else None
        nr_f = open(f"{pre}-non_repetitive.fa", "w") if self.extract_nr \
            else None
        r_f = open(f"{pre}-repetitive.fa", "w") if self.extract_r else None
        stats_f = open(f"{pre}-stats.tsv", "w")
        stats_f.write(STATS_HEADER + "\n")
        try:
            batch: list[fastx.Record] = []
            for rec in fastx.read_records(self.seq_file):
                batch.append(rec)
                if len(batch) == BATCH_SIZE:
                    self._do_batch(batch, count_f, gc_f, nr_f, r_f, stats_f)
                    batch = []
            if batch:
                self._do_batch(batch, count_f, gc_f, nr_f, r_f, stats_f)
        finally:
            for f in (count_f, gc_f, nr_f, r_f, stats_f):
                if f:
                    f.close()

    def _do_batch(self, records, count_f, gc_f, nr_f, r_f, stats_f) -> None:
        counts, gcs = self._analyse_batch(records)
        if count_f:
            self._print_counts(count_f, records, counts)
        if gc_f:
            self._print_gc_counts(gc_f, records, gcs)
        if nr_f:
            self._print_regions(nr_f, records, counts, 1, self.min_repeat)
        if r_f:
            self._print_regions(r_f, records, counts, self.min_repeat,
                                self.max_repeat)
        self._print_stat_table(stats_f, records, counts, gcs)

    def _halo(self):
        """The halo-path profile of one coded contig on this input's mesh,
        or None when there is no mesh of more than one shard."""
        from ..parallel import longseq

        inp, k = self.input, self.input.mer_len
        if inp.shards is not None:
            if inp.shards.n < 2:
                return None
            return lambda codes: longseq.sharded_window_profile_routed(
                inp.shards, codes, k, inp.canonical)
        mesh = inp.mesh() if k <= MAX_K else None
        if mesh is None or mesh.n < 2:
            return None
        return lambda codes: longseq.sharded_window_profile(
            inp.table, codes, k, inp.canonical, mesh)

    def _analyse_batch(self, records):
        """Batched device lookups with seam-stitched long-sequence chunks.
        Each bucket's [rows, W] planes come to the host once
        (Input.window_counts); the per-row slicing below is host work.  On
        a mesh, contigs of at least halo_min bases take the halo path."""
        k = self.input.mer_len
        counts: list[np.ndarray | None] = [None] * len(records)
        gcs: list[np.ndarray | None] = [None] * len(records)
        halo = self._halo()
        chunked = []
        for ri, rec in enumerate(records):
            if halo is not None and len(rec.seq) >= max(self.halo_min, k):
                c, g = halo(encode_ascii(np.frombuffer(rec.seq, np.uint8)))
                counts[ri] = c.astype(np.uint64)
                gcs[ri] = g.astype(np.int16)
            else:
                chunked.append(ri)
        for codes, meta in fastx.encode_batch_indexed(
                [records[i] for i in chunked], k):
            c, g, _v = self.input.window_counts(codes)
            for row, (ci, start, nw) in enumerate(meta):
                ri = chunked[ci]
                if counts[ri] is None:
                    w_total = len(records[ri].seq) - k + 1
                    counts[ri] = np.zeros(w_total, np.uint64)
                    gcs[ri] = np.zeros(w_total, np.int16)
                counts[ri][start:start + nw] = c[row, :nw]
                gcs[ri][start:start + nw] = g[row, :nw]
        return counts, gcs

    # -- per-batch output (sect.cc:328-441) --
    def _print_counts(self, out, records, counts) -> None:
        for rec, c in zip(records, counts):
            out.write(f">{rec.name}\n")
            if c is not None and len(c):
                out.write(" ".join(str(int(v)) for v in c))
                out.write("\n")
            else:
                out.write("0\n")

    def _gc_pct(self, count: int) -> str:
        k = self.input.mer_len
        v = -0.1 if count == -1 else (count / k) * 100.0
        return f"{v:.1f}"

    def _print_gc_counts(self, out, records, gcs) -> None:
        for rec, g in zip(records, gcs):
            out.write(f">{rec.name}\n")
            if g is not None and len(g):
                out.write(" ".join(self._gc_pct(int(v)) for v in g))
                out.write("\n")
            else:
                out.write("0.0\n")

    def _print_regions(self, out, records, counts, min_count: int,
                       max_count: int) -> None:
        """Exact region-emission algorithm of sect.cc:372-421, including the
        skipped base at the position that closes a region."""
        k = self.input.mer_len
        for rec, c in zip(records, counts):
            if c is None or not len(c):
                continue
            seq = rec.seq.decode()
            maxcntstr = f"-{max_count}" if max_count > 0 else "+"
            index = 1
            start = 0
            in_region = False
            ss: list[str] = []
            for j, cj in enumerate(int(v) for v in c):
                if cj >= min_count and (cj <= max_count or max_count == 0):
                    if not in_region:
                        start = j
                        in_region = True
                    ss.append(seq[j])
                elif in_region:
                    end = j + k - 1
                    out.write(f">{rec.name}___region:{index}_length:"
                              f"{end - start - 1}_pos:{start + 1}:{end}"
                              f"_cov:{min_count}{maxcntstr}\n")
                    out.write("".join(ss))
                    out.write(seq[j + 1:end])
                    out.write("\n")
                    index += 1
                    in_region = False
                    ss = []
            if in_region:
                end = len(c) + k - 1
                out.write(f">{rec.name}___region:{index}_length:"
                          f"{end - start - 1}_pos:{start + 1}:{end}"
                          f"_cov:{min_count}{maxcntstr}\n")
                out.write("".join(ss))
                out.write(seq[len(c):end])
                out.write("\n")

    def _print_stat_table(self, out, records, counts, gcs) -> None:
        k = self.input.mer_len
        for rec, c, g in zip(records, counts, gcs):
            seq = rec.seq
            seq_len = len(seq)
            nb_counts = seq_len - k + 1
            if c is None or nb_counts <= 0:
                median = 0
                mean = 0.0
                nb_invalid = 0
                nb_nonzero = 0
            else:
                nb_invalid = int((g[:nb_counts] == -1).sum())
                nb_nonzero = int((c[:nb_counts] != 0).sum())
                s = np.sort(c)
                median = int(s[len(s) // 2])  # upper median (sect.cc:548)
                mean = float(c.sum(dtype=np.float64)) / nb_counts

            pct_nonzero = 0.0 if (nb_nonzero == 0 or nb_counts <= 0) else \
                nb_nonzero / nb_counts * 100.0
            pct_invalid = 0.0 if (nb_invalid == 0 or nb_counts <= 0) else \
                nb_invalid / nb_counts * 100.0
            not_invalid = nb_counts - nb_invalid
            pct_nonzero_corr = 0.0 if (nb_nonzero == 0 or not_invalid <= 0) \
                else nb_nonzero / not_invalid * 100.0

            gs = seq.count(b"G") + seq.count(b"g")
            cs = seq.count(b"C") + seq.count(b"c")
            ns = seq.count(b"N") + seq.count(b"n")
            denom = seq_len - ns
            gc_perc = (gs + cs) / denom if denom else float("nan")

            # uint32 wraparound for sequences shorter than k (the reference
            # prints `lengths[i] - merLen + 1` through uint32 arithmetic).
            kmers_in_seq = (seq_len - k + 1) % (1 << 32)

            out.write(f"{rec.name}\t{median}\t{mean:.5f}\t{gc_perc:.5f}\t"
                      f"{seq_len}\t{kmers_in_seq}\t{nb_invalid}\t"
                      f"{pct_invalid:.5f}\t{nb_nonzero}\t"
                      f"{pct_nonzero:.5f}\t{pct_nonzero_corr:.5f}\n")

            # Contamination matrix y bin (reference sect.cc:592-601).
            # average_cvg is declared but never assigned (sect.cc:503,
            # SURVEY §5.1.1) so it is always 0.0; we execute the same
            # compression arithmetic anyway so the -l/--cvg_logscale path
            # exercises log10 exactly like the reference: log10(0) = -inf,
            # and the double->uint16_t conversion of -inf goes through
            # x86 cvttsd2si (INT32_MIN) truncated to 16 bits = 0 — i.e.
            # y == 0 in both modes, by the same route the binary takes.
            average_cvg = 0.0
            if self.cvg_logscale:
                log_cvg = (math.log10(average_cvg) if average_cvg > 0
                           else float("-inf"))
                compressed_cvg = log_cvg * (self.cvg_bins / 5.0)
            else:
                compressed_cvg = average_cvg * 0.1
            if compressed_cvg >= self.cvg_bins:
                y = self.cvg_bins - 1
            elif math.isfinite(compressed_cvg) and 0 <= compressed_cvg:
                y = int(compressed_cvg) & 0xFFFF
            else:
                y = 0x8000_0000 & 0xFFFF  # cvttsd2si sentinel, truncated
            if not math.isnan(gc_perc):
                x = int(gc_perc * self.gc_bins)
                self._grid[min(x, self.gc_bins), y] += np.uint64(seq_len)
            else:
                self._grid[0, y] += np.uint64(seq_len)

    def print_contamination_matrix(self, out) -> None:
        mx = self.contamination_mx
        # `hashFile` is never assigned in the reference (sect.hpp:91), so
        # the title ends with an empty quoted boost::filesystem::path.
        out.write(f'{mme.KEY_TITLE}Contamination Plot for {self.seq_file} '
                  f'and ""\n')
        out.write(f"{mme.KEY_X_LABEL}GC%\n")
        out.write(f"{mme.KEY_Y_LABEL}Average K-mer Coverage\n")
        out.write(f"{mme.KEY_Z_LABEL}Base Count per bin\n")
        out.write(f"{mme.KEY_NB_COLUMNS}{self.gc_bins}\n")
        out.write(f"{mme.KEY_NB_ROWS}{self.cvg_bins}\n")
        out.write(f"{mme.KEY_MAX_VAL}{mx.get_max_val()}\n")
        out.write(f"{mme.KEY_TRANSPOSE}0\n")
        out.write(f"{mme.MX_META_END}\n")
        mx.print_matrix(out)

    def save(self) -> None:
        with stage("Saving results to disk", quiet=self.quiet):
            with open(f"{self.output_prefix}-contamination.mx", "w") as f:
                self.print_contamination_matrix(f)
