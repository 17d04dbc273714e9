"""The matrix text writer: `core.matrix.format_rows` and
`Matrix.print_matrix` (from the host copy and from `cells`) held to the
per-cell loop that wrote KAT's matrix text before them, which this file
keeps as the reference, byte for byte; and the cells that have no text
refused."""

import io

import numpy as np
import pytest
import torch

from kat_tpu_torch.benchmarks import workloads
from kat_tpu_torch.core.matrix import Matrix, format_rows

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

I64_MAX = 2**63 - 1


def print_matrix_loop(data: np.ndarray, m: int, n: int,
                      transpose: bool) -> str:
    """The writer `format_rows` replaced: one Python conversion a cell."""
    out = io.StringIO()
    view = data[:m, :n]
    it = view.T if transpose else view
    for row in it:
        out.write(" ".join(str(int(v)) for v in row))
        out.write("\n")
    return out.getvalue()


def _grid(rows, cols, values):
    return np.asarray(values, np.uint64).reshape(rows, cols)


def _boundaries(p):
    """10^p - 1 and 10^p (p digits, then p + 1) beside 0 and their
    neighbours, on a 2 x 3 grid."""
    return _grid(2, 3, [10**p - 1, 10**p, 0, 10**p + 1, 10**p - 2, 1])


def _sparse(seed, top):
    """A 1001 x 1001 grid, 2% of it cells of any magnitude up to `top`."""
    rng = np.random.default_rng(seed)
    data = np.zeros((1001, 1001), np.uint64)
    at = rng.integers(0, 1001, (20_000, 2))
    digits = rng.integers(0, len(str(top)), 20_000)
    data[at[:, 0], at[:, 1]] = np.minimum(
        rng.integers(0, 10, 20_000, dtype=np.uint64) *
        (10 ** digits).astype(np.uint64) + rng.integers(0, 10, 20_000,
                                                        dtype=np.uint64),
        np.uint64(top))
    return data


# name -> (storage, logical m, logical n, transpose)
CASES = {
    "zeros": (np.zeros((5, 7), np.uint64), 5, 7, False),
    "zeros_transposed": (np.zeros((5, 7), np.uint64), 5, 7, True),
    "no_rows": (np.zeros((0, 4), np.uint64), 0, 4, False),
    "no_columns": (np.zeros((4, 0), np.uint64), 4, 0, False),
    "no_columns_transposed": (np.zeros((4, 0), np.uint64), 4, 0, True),
    "empty_view_of_storage": (np.ones((3, 3), np.uint64), 0, 3, False),
    "one_by_one_zero": (_grid(1, 1, [0]), 1, 1, False),
    "one_by_one": (_grid(1, 1, [7]), 1, 1, True),
    # gcp: k rows over a k + 1 row grid (the GC == k row never printed)
    "gcp_view": (np.arange(28 * 11, dtype=np.uint64).reshape(28, 11) * 37,
                 27, 11, False),
    "sect_view_transposed": (
        np.arange(6 * 9, dtype=np.uint64).reshape(6, 9) ** 3, 5, 8, True),
    "non_square_transposed": (
        np.arange(3 * 5, dtype=np.uint64).reshape(3, 5) * 999, 3, 5, True),
    **{f"boundary_10e{p}": (_boundaries(p), 2, 3, p % 2 == 0)
       for p in range(1, 19)},
    "int64_max": (_grid(2, 2, [I64_MAX, 0, 9, I64_MAX]), 2, 2, False),
    "int64_max_transposed": (_grid(1, 3, [1, I64_MAX, 10]), 1, 3, True),
    "sparse_1001_to_2e9": (_sparse(1, 2_000_000_000), 1001, 1001, False),
    "sparse_1001_to_int64_max": (_sparse(2, I64_MAX), 1001, 1001, True),
    "chr14_comp": (workloads.comp_matrix(5).astype(np.uint64), 1001, 1001,
                   False),
    "chr14_comp_transposed": (workloads.comp_matrix(6).astype(np.uint64),
                              1001, 1001, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_writer_matches_the_per_cell_loop(name):
    data, m, n, transpose = CASES[name]
    want = print_matrix_loop(data, m, n, transpose)
    cells = torch.from_numpy(data.astype(np.int64))
    assert format_rows(cells[:m, :n], transpose) == want.encode("ascii")
    for mx in (Matrix(data, m, n), Matrix(data, m, n, cells=cells)):
        out = io.StringIO()
        mx.print_matrix(out, transpose)
        assert out.getvalue() == want


@pytest.mark.parametrize("name,make", [
    ("negative", lambda: format_rows(torch.tensor([[0, -1]]))),
    ("int64_min", lambda: format_rows(torch.tensor([[-2**63]]))),
    ("negative_transposed",
     lambda: format_rows(torch.tensor([[3], [-10**12]]), transpose=True)),
    ("uint64_2e63", lambda: Matrix(_grid(1, 2, [1, 2**63])).print_matrix(
        io.StringIO())),
    ("uint64_max_transposed",
     lambda: Matrix(_grid(2, 1, [0, 2**64 - 1])).print_matrix(
         io.StringIO(), transpose=True)),
])
def test_cells_without_text_raise(name, make):
    with pytest.raises(ValueError, match="at least 0 and below 2"):
        make()


def test_uint64_cell_outside_the_view_is_not_read():
    data = _grid(2, 2, [5, 2**63, 6, 7])
    out = io.StringIO()
    Matrix(data, m=2, n=1).print_matrix(out)
    assert out.getvalue() == print_matrix_loop(data, 2, 1, False) == "5\n6\n"


@pytest.mark.parametrize("values", [
    torch.zeros(2, 2, dtype=torch.float64), torch.zeros(4, dtype=torch.int64),
    torch.zeros(1, 1, 1, dtype=torch.int64)], ids=["float", "1d", "3d"])
def test_only_2d_int64_grids(values):
    with pytest.raises(TypeError):
        format_rows(values)
