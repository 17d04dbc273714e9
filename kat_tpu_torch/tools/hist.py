"""`kat hist` — k-mer occurrence histogram (port of kat_tpu/tools/hist.py).

Output-parity re-implementation of reference src/histogram.cc: same bucket
rules (base = low>1 ? low-1 : 1, ceil = high+1, clamping catch-all first/last
buckets, histogram.hpp:172-177 + histogram.cc:188-196) and the same
mme-headered text artifact (histogram.cc:131-144).  A sharded input bins
each shard's table and sums the histograms (parallel/analysis.py).
"""

from __future__ import annotations

import numpy as np

from ..core import stats
from ..io import mme
from ..utils.profiling import annotate
from ..utils.timer import stage
from .common import Input, ensure_parent_dir


class Histogram:
    def __init__(self, inputs: list[str], low: int = 1, high: int = 10000,
                 inc: int = 1):
        self.input = Input(paths=list(inputs), index=1)
        self.output_prefix = "kat-hist"
        self.low = low
        self.high = high
        self.inc = inc
        self.verbose = False
        self.quiet = False
        # histogram.hpp:172-177
        self.base = self.low - 1 if self.low > 1 else 1
        self.ceil = self.high + 1
        self.nb_buckets = self.ceil + 1 - self.base
        self.data: np.ndarray | None = None

    def execute(self) -> None:
        if self.high < self.low:
            raise ValueError(
                "High count value must be >= to low count value.  "
                f"High: {self.high}; Low: {self.low}")
        self.input.validate()
        ensure_parent_dir(self.output_prefix)
        self.input.count_or_load(quiet=self.quiet)

        with stage("Bining kmers", quiet=self.quiet):
            if self.input.shards is not None:
                from ..parallel.analysis import hist_sharded

                self.data = hist_sharded(self.input.shards, self.base,
                                         self.ceil, self.inc,
                                         self.nb_buckets)
            else:
                hist = stats.hist_from_counts(
                    self.input.table.counts, self.base, self.ceil, self.inc,
                    self.nb_buckets)
                self.data = hist.cpu().numpy().astype(np.uint64)

        if self.input.dump_hash:
            self.input.dump(
                f"{self.output_prefix}-hash.jf{self.input.mer_len}",
                quiet=self.quiet)

        with stage("Merging counts", quiet=self.quiet):
            pass  # merge is a no-op: the bincount is already global

    def print_to(self, out) -> None:
        k = self.input.mer_len
        with annotate("kat.save"):
            out.write(f"{mme.KEY_TITLE}{k}-mer spectra for: "
                      f"{self.input.file_name()}\n")
            out.write(f"{mme.KEY_X_LABEL}{k}-mer frequency\n")
            out.write(f"{mme.KEY_Y_LABEL}# distinct {k}-mers\n")
            out.write(f"{mme.KEY_KMER}{k}\n")
            out.write(f"{mme.KEY_INPUT_1}{self.input.path_string()}\n")
            out.write(f"{mme.MX_META_END}\n")
            col = self.base
            for v in self.data:
                out.write(f"{col} {int(v)}\n")
                col += self.inc

    def save(self) -> None:
        with stage("Saving results to disk", quiet=self.quiet):
            with open(str(self.output_prefix), "w") as f:
                self.print_to(f)
