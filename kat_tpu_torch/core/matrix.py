"""Dense matrix with KAT SparseMatrix print/load semantics, and the one
writer of its text.

The reference's `SparseMatrix<uint64_t>` (lib/include/kat/sparse_matrix.hpp)
is a map-of-maps accumulated per thread and merged; its on-disk form is a
space-separated dense grid after an mme header.  Here the tools accumulate
into a dense array and this class formats/parses the text artifact (a copy
of kat_tpu/core/matrix.py, but the grid's text comes from `format_rows`):

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
import torch

from ..utils.profiling import annotate, count


def format_rows(values: torch.Tensor, transpose: bool = False) -> bytes:
    """The 2-D int64 grid `values` (its transpose when `transpose`) as KAT
    writes it: each row's cells in decimal, one space apart, each row
    ended by a newline, no header.

    Runs on the tensor's own device in a fixed number of tensor passes:
    every cell is written right-aligned into `width + 1` bytes (`width`
    the digits of the largest cell, the last byte its separator), one pass
    a digit, and one masked selection keeps each cell's digits from its
    leading one on.  Three synchronous reads, each a `kat.read.format`:
    the least and largest cell, the selection's length, and the text,
    copied to the host once at the end.  A negative cell (a uint64 of
    2^63 or more seen as int64) raises ValueError."""
    if values.dim() != 2 or values.dtype != torch.int64:
        raise TypeError(f"a 2-D int64 tensor, not {values.dim()}-D "
                        f"{values.dtype}")
    grid = (values.T if transpose else values).contiguous()
    rows, cols = grid.shape
    if rows == 0 or cols == 0:
        return b"\n" * rows
    with annotate("kat.read.format"):
        count("host_reads")
        lo, hi = torch.stack(torch.aminmax(grid)).tolist()
    if lo < 0:
        raise ValueError(f"a matrix cell reads {lo} as int64: cells are "
                         "counts, at least 0 and below 2^63")
    width = len(str(hi))
    dev = grid.device
    text = torch.empty(rows, cols, width + 1, dtype=torch.uint8, device=dev)
    text[:, :, width] = ord(" ")
    text[:, -1, width] = ord("\n")
    q = grid
    for at in range(width - 1, -1, -1):
        text[:, :, at] = q % 10 + ord("0")
        q = q // 10
    # byte `at` of a cell is kept from its leading digit on: 10^(width-1-at)
    # <= cell, with the units digit and the separator always kept
    least = torch.tensor([10 ** p for p in range(width - 1, 0, -1)] + [0, 0],
                         dtype=torch.int64, device=dev)
    keep = grid.unsqueeze(-1) >= least
    with annotate("kat.read.format"):
        count("host_reads")
        text = text.view(-1)[keep.view(-1)]
    with annotate("kat.read.format"):
        count("host_reads")
        return text.cpu().numpy().tobytes()


class Matrix:
    """Logical [m, n] uint64 matrix over (possibly larger) dense storage.

    `cells`, when given, is the same storage as an int64 tensor where it
    was computed (comp's matrices on the card): `print_matrix` formats
    from it instead of the host copy."""

    def __init__(self, data: np.ndarray, m: int | None = None,
                 n: int | None = None, cells: torch.Tensor | None = None):
        self.data = np.asarray(data, np.uint64)
        self.m = int(m if m is not None else self.data.shape[0])
        self.n = int(n if n is not None else self.data.shape[1])
        self.cells = cells

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
        cells = (self.cells if self.cells is not None
                 else torch.from_numpy(self.data.view(np.int64)))
        out.write(format_rows(cells[:self.m, :self.n], transpose)
                  .decode("ascii"))
