"""Dense host-side matrix with KAT SparseMatrix print/load semantics.

The reference's `SparseMatrix<uint64_t>` (lib/include/kat/sparse_matrix.hpp)
is a map-of-maps accumulated per thread and merged; its on-disk form is a
space-separated dense grid after an mme header.  Here the tools accumulate
into a dense array and this class only formats/parses the text artifact
(a copy of kat_tpu/core/matrix.py, numpy only):

  - `print_matrix(out, transpose)` mirrors sparse_matrix.hpp:251-279: row i of
    the logical [m, n] matrix on one line, space separated; transpose swaps
    loops.
  - `get_max_val()` mirrors sparse_matrix.hpp:162-173 (scans only i < m, so
    rows beyond the logical height — e.g. gcp's GC == k row, SURVEY §5.1.3 —
    are excluded).
  - `load(path)` mirrors the file ctor at sparse_matrix.hpp:72-99 (skips
    `#` lines, one row per non-empty line).
"""

from __future__ import annotations

import numpy as np


class Matrix:
    """Logical [m, n] uint64 matrix over (possibly larger) dense storage."""

    def __init__(self, data: np.ndarray, m: int | None = None,
                 n: int | None = None):
        self.data = np.asarray(data, np.uint64)
        self.m = int(m if m is not None else self.data.shape[0])
        self.n = int(n if n is not None else self.data.shape[1])

    @classmethod
    def zeros(cls, m: int, n: int) -> "Matrix":
        return cls(np.zeros((m, n), np.uint64))

    @classmethod
    def load(cls, path: str) -> "Matrix":
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([int(v) for v in line.split(" ")])
        return cls(np.asarray(rows, np.uint64))

    def get(self, i: int, j: int) -> int:
        if i < self.data.shape[0] and j < self.data.shape[1]:
            return int(self.data[i, j])
        return 0

    def inc(self, i: int, j: int, val: int = 1) -> None:
        self.data[i, j] += np.uint64(val)

    def get_max_val(self) -> int:
        if self.m == 0 or self.n == 0:
            return 0
        return int(self.data[:self.m, :self.n].max(initial=np.uint64(0)))

    # sumColumn/sumRow naming follows the reference, where the matrix is
    # indexed (x=first, y=second): sum_column(i) sums over the second index.
    def sum_column(self, col: int, start: int = 0, end: int | None = None) -> int:
        end = self.n - 1 if end is None else end
        return int(self.data[col, start:end + 1].sum(dtype=np.uint64))

    def sum_row(self, row: int, start: int = 0, end: int | None = None) -> int:
        end = self.m - 1 if end is None else end
        return int(self.data[start:end + 1, row].sum(dtype=np.uint64))

    def print_matrix(self, out, transpose: bool = False) -> None:
        view = self.data[:self.m, :self.n]
        it = view.T if transpose else view
        for row in it:
            out.write(" ".join(str(int(v)) for v in row))
            out.write("\n")
