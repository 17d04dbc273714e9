"""Text formatting helpers matching C++ iostream output bit-for-bit (a
copy of kat_tpu/utils/fmt.py, which imports nothing of JAX).

The reference writes doubles with default `std::ostream` formatting
(6 significant digits, %g-style trailing-zero trimming) in the comp .stats
distances, and with `std::fixed << std::setprecision(5)` in the sect/cold
stats tables (sect.cc:426, cold.cc:255).
"""

from __future__ import annotations


def cpp_double(x: float) -> str:
    """Default `operator<<(ostream, double)` rendering: %g with precision 6."""
    x = float(x)
    if x != x:
        # glibc prints the default x86 QNaN from 0.0/0.0 (sign bit SET under
        # SSE) as "-nan"; the reference's comp .stats contains exactly that
        # for the Cosine/Jaccard divisions on empty spectra.
        return "-nan"
    s = f"{x:.6g}"
    # C++ prints exponents with at least 2 digits and no '+' stripping —
    # python %g already matches (e.g. 1.23457e+06); but python renders
    # negative zero as '-0' like C++.
    return s


def cpp_fixed(x: float, precision: int = 5) -> str:
    """`std::fixed << std::setprecision(p)` rendering."""
    return f"{float(x):.{precision}f}"
