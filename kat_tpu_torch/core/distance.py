"""Spectral distance metrics (reference lib/include/kat/distance_metrics.hpp;
a copy of kat_tpu/core/distance.py).

Host-side numpy: spectra are tiny (<= 1001 bins) so these never touch the
device.  Semantics matched exactly, including the reference's integer
accumulation for Minkowski (distance_metrics.hpp:50-60: `uint64_t sum`) and
float accumulation for the rest.
"""

from __future__ import annotations

import numpy as np


def minkowski(s1: np.ndarray, s2: np.ndarray, p: int) -> float:
    s1 = np.asarray(s1, np.uint64)
    s2 = np.asarray(s2, np.uint64)
    diff = np.where(s1 < s2, s2 - s1, s1 - s2)
    # uint64 accumulation like the reference; pow of uint64 diff stays exact
    # for p == 1; for p == 2 the reference also sums into uint64 (std::pow
    # returns double, implicitly converted) — match the double-pow-then-
    # truncate-to-uint64 behaviour.
    if p == 1:
        return float(diff.sum(dtype=np.uint64))
    total = np.uint64(0)
    for d in diff:
        total += np.uint64(float(d) ** p)
    return float(total) ** (1.0 / p)


def manhattan(s1, s2) -> float:
    return minkowski(s1, s2, 1)


def euclidean(s1, s2) -> float:
    return minkowski(s1, s2, 2)


def cosine(s1, s2) -> float:
    a = np.asarray(s1, np.float64)
    b = np.asarray(s2, np.float64)
    dot = float((a * b).sum())
    na = float((a * a).sum())
    nb = float((b * b).sum())
    with np.errstate(invalid="ignore", divide="ignore"):
        # 0/0 -> nan, exactly like the C++ double division
        return float(1.0 - np.float64(dot) / (np.sqrt(na) * np.sqrt(nb)))


def canberra(s1, s2) -> float:
    a = np.asarray(s1, np.float64)
    b = np.asarray(s2, np.float64)
    tot = a + b
    with np.errstate(divide="ignore", invalid="ignore"):
        term = np.where(tot > 0, np.abs(a - b) / tot, 0.0)
    return float(term.sum())


def jaccard(s1, s2) -> float:
    a = np.asarray(s1, np.uint64)
    b = np.asarray(s2, np.uint64)
    mins = float(np.minimum(a, b).sum(dtype=np.float64))
    maxs = float(np.maximum(a, b).sum(dtype=np.float64))
    with np.errstate(invalid="ignore", divide="ignore"):
        # 0/0 -> nan, exactly like the C++ double division
        return float(1.0 - np.float64(mins) / np.float64(maxs))


ALL_METRICS = [
    ("Manhattan", manhattan),
    ("Euclidean", euclidean),
    ("Cosine", cosine),
    ("Canberra", canberra),
    ("Jaccard", jaccard),
]
