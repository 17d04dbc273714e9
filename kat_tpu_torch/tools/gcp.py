"""`kat gcp` — GC count x k-mer frequency matrix over distinct k-mers (port
of kat_tpu/tools/gcp.py; a sharded input sums its shards' matrices,
parallel/analysis.py).

Output-parity re-implementation of reference src/gcp.cc.  The per-thread
hash-slice scan (gcp.cc:179-197 `analyseSlice`) becomes one binned sum over
the sorted count table (`stats.gcp_matrix`, the binned-sums kernel on the
card); the GC count of a packed key is a popcount bit trick.

Quirk parity (SURVEY §5.1.3): the reference sizes the matrix
`ThreadedSparseMatrix(merLen, cvgBins+1, T)` (gcp.cc:93) but GC counts can
equal merLen; those entries are accumulated yet never printed
(sparse_matrix.hpp:251-279 prints m rows) and excluded from MaxVal
(sparse_matrix.hpp:162-173).  We reproduce this by computing the full
[merLen+1, cvgBins+1] grid and setting the logical height to merLen.
"""

from __future__ import annotations

import numpy as np

from ..core import stats
from ..core.matrix import Matrix
from ..io import mme
from ..utils.timer import stage
from .common import Input, ensure_parent_dir


class Gcp:
    def __init__(self, inputs: list[str]):
        self.input = Input(paths=list(inputs), index=1)
        self.output_prefix = "kat-gcp"
        self.cvg_scale = 1.0
        self.cvg_bins = 1000
        self.verbose = False
        self.quiet = False
        self.matrix: Matrix | None = None

    def execute(self) -> None:
        self.input.validate()
        ensure_parent_dir(self.output_prefix)
        self.input.count_or_load(quiet=self.quiet)

        with stage("Analysing kmers in hash", quiet=self.quiet):
            mer_len = self.input.mer_len
            if self.input.shards is not None:
                from ..parallel.analysis import gcp_sharded

                grid = gcp_sharded(self.input.shards, mer_len,
                                   self.cvg_bins, self.cvg_scale)
            else:
                grid = stats.gcp_matrix(self.input.table, mer_len,
                                        self.cvg_bins, self.cvg_scale)
                grid = grid.cpu().numpy().astype(np.uint64)
            # Logical height merLen: the GC == merLen row is accumulated but
            # never printed (reference quirk, see module docstring).
            self.matrix = Matrix(grid, m=mer_len, n=self.cvg_bins + 1)

        if self.input.dump_hash:
            self.input.dump(
                f"{self.output_prefix}-hash.jf{self.input.mer_len}",
                quiet=self.quiet)

        with stage("Merging matrices", quiet=self.quiet):
            pass  # the binned sum is already global

    def print_main_matrix(self, out) -> None:
        k = self.input.mer_len
        out.write(f"{mme.KEY_TITLE}K-mer coverage vs GC count plot for: "
                  f"{self.input.file_name()}\n")
        out.write(f"{mme.KEY_X_LABEL}{k}-mer frequency\n")
        out.write(f"{mme.KEY_Y_LABEL}GC count\n")
        out.write(f"{mme.KEY_Z_LABEL}# distinct {k}-mers\n")
        out.write(f"{mme.KEY_NB_COLUMNS}{self.matrix.n}\n")
        out.write(f"{mme.KEY_NB_ROWS}{self.matrix.m}\n")
        out.write(f"{mme.KEY_MAX_VAL}{self.matrix.get_max_val()}\n")
        out.write(f"{mme.KEY_TRANSPOSE}0\n")
        out.write(f"{mme.KEY_KMER}{k}\n")
        out.write(f"{mme.KEY_INPUT_1}{self.input.path_string()}\n")
        out.write(f"{mme.MX_META_END}\n")
        self.matrix.print_matrix(out)

    def save(self) -> None:
        with stage("Saving results to disk", quiet=self.quiet):
            with open(f"{self.output_prefix}.mx", "w") as f:
                self.print_main_matrix(f)
