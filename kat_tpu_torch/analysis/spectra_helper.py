"""Histogram helpers: first-minimum / peak / 97%-cumulative-limit finding.

Behavioral re-implementation of reference
lib/include/kat/spectra_helper.hpp (findFirstMin :55-75, findPeak :77-96,
lim97 :98-130, loadHist :149-170) — including findPeak's exact walk
semantics (a peak is recorded only on the sample AFTER a rise, best-by-value
wins).  Histograms are lists of (bin, value) pairs as loaded from .hist
artifacts.
"""

from __future__ import annotations

Pos = tuple[int, int]


def load_hist(path: str) -> list[Pos]:
    histo: list[Pos] = []
    with open(path) as f:
        for linenb, line in enumerate(f, start=1):
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(
                    f"Encountered unexpected syntax on line {linenb}")
            try:
                histo.append((int(parts[0]), int(parts[1])))
            except ValueError as e:
                raise ValueError(
                    f"Encountered unexpected syntax on line {linenb}") from e
    return histo


def find_first_min(histo: list[Pos], skip_first: bool = False) -> int:
    """Index of the first local minimum (0 if monotonically decreasing)."""
    previous = None
    for i in range(1 if skip_first else 0, len(histo)):
        if previous is None or histo[i][1] <= previous:
            previous = histo[i][1]
        else:
            return i
    return 0


def find_peak(histo: list[Pos], find_min: bool = True) -> Pos:
    """Highest (bin, value) peak after the error-kmer minimum."""
    previous = None
    best_max: Pos = (0, 0)
    start = find_first_min(histo) if find_min else 1
    for i in range(start, len(histo)):
        if previous is not None and histo[i][1] > previous:
            last_max = histo[i]
            best_max = last_max if last_max[1] > best_max[1] else best_max
        previous = histo[i][1]
    return best_max


def lim97(histo: list[Pos]) -> Pos:
    """(bin, cumulative) where the cumulative volume past the first
    minimum crosses 97% — used for plot axis limits."""
    x_start = find_first_min(histo, skip_first=True)
    if x_start == 0:
        return (0, 0)
    total = sum(v for _b, v in histo[x_start:])
    cumulative = 0
    for b, v in histo[x_start:]:
        cumulative += v
        if cumulative / total > 0.97:
            return (b, cumulative)
    return (0, 0)
