"""The comparison passes of `kat comp` (port of
kat_tpu/core/comp_engine.py).

The reference walks hash1 slice-parallel, probing hash2/hash3 once per key
(src/comp.cc:366-484 `compareSlice`).  Here the tables are sorted arrays,
so every probe is a bulk lookup (core/tables.py: the sort-merge join or the
binary search) and every counter, spectrum and matrix is a sum or a binned
sum (core/stats.py, the binned-sums kernel on the card) — three passes
instead of a mutex-merged thread pool.  Narrow (k <= 31) and wide tables
alike.  Counts are int32 in the port and read as kat_tpu's uint32;
counters and bins are int64 (kat_tpu's uint64).

Quirk parity (SURVEY §5.1.2): in the reference's pass 2 the canonical flag
argument receives a *pointer* (`src/comp.cc:447`), i.e. always true, so
pass-2 queries into hash1 are canonicalized regardless of how hash1 was
counted.  `pass2` reproduces exactly that.
"""

from __future__ import annotations

import torch

from . import tables
from .stats import (binned_sum, binned_sums, mask_bincount,
                    monotone_packed_sums, spectrum, spectrum_bins, unsigned)


def _scale_clamp(counts: torch.Tensor, scale: float,
                 bins: int) -> torch.Tensor:
    """scaleCounter + clamp (comp.hpp:303-306, comp.cc:458-463): int64
    min(ceil(count x scale), bins - 1), 0 for a zero count, in float64."""
    scaled = torch.where(counts == 0, 0,
                         torch.ceil(counts.to(torch.float64) * scale)
                         .to(torch.int64))
    return torch.clamp_max(scaled, bins - 1)


def _maybe_canonical(keys: torch.Tensor, k: int, canonical: bool):
    if canonical:
        return tables.canonicalize(keys, k)
    return keys


def _probe(table, probed, q, k: int, assume_sorted: bool) -> torch.Tensor:
    """Unsigned counts in `table` of the k-mers `q` drawn from `probed`'s
    slots, 0 at its padding slots."""
    return torch.where(tables.real_mask(probed), unsigned(tables.lookup(
        table, q, assume_sorted=assume_sorted, key_bits=2 * k + 1)), 0)


def pass1(t1, t2, t3, k: int, d1_bins: int, d2_bins: int, dm_size: int,
          d1_scale: float, d2_scale: float, canon2: bool, canon3: bool,
          three: bool, sorted2: bool = False, sorted3: bool = False,
          h2_pre=None):
    """Iterate hash1 entries; probe hash2 (and hash3).  Returns counters
    (0-d int64 tensors), spectra and matrices (comp.cc:366-433).

    sorted2/sorted3: the probe stream is t1's own sorted keys and the
    canonicalization applied to it is an identity, so the join skips its
    query sort and scatter.  h2_pre: t2's counts of t1's keys from the fused
    dual probe (tables.lookup_dual), aligned with t1's slots."""
    real = tables.real_mask(t1)
    h1 = torch.where(real, unsigned(t1.counts), 0)
    if h2_pre is not None:
        h2 = torch.where(real, unsigned(h2_pre), 0)
    else:
        h2 = _probe(t2, t1, _maybe_canonical(t1.keys, k, canon2), k,
                    sorted2)
    if three:
        h3 = _probe(t3, t1, _maybe_canonical(t1.keys, k, canon3), k,
                    sorted3)

    shared = real & (h1 > 0) & (h2 > 0)
    only = real & (h2 == 0)
    counters = {
        "hash1_total": h1.sum(),
        "hash1_distinct": real.sum(),
        "hash1_only_total": torch.where(only, h1, 0).sum(),
        "hash1_only_distinct": only.sum(),
        "shared_hash1_total": torch.where(shared, h1, 0).sum(),
        "shared_hash2_total": torch.where(shared, h2, 0).sum(),
        "shared_distinct": shared.sum(),
    }
    s1 = _scale_clamp(h1, d1_scale, d1_bins)
    s2 = _scale_clamp(h2, d2_scale, d2_bins)
    if d1_scale == 1.0 and d1_bins == dm_size and \
            d1_bins * d2_bins < 2**31:
        # Default config: with a unit scale and d1_bins == dm_size the
        # matrix row IS the spectrum bin, so spectrum1, shared_spectrum1
        # and the main matrix all derive from one packed key and share one
        # pass (kat_tpu shares one sort here).
        spectrum1, shared_spectrum1, mx = monotone_packed_sums(
            s1 * d2_bins + s2,
            ((d2_bins, dm_size, 0), (d2_bins, dm_size, 1),
             (1, d1_bins * d2_bins, 0)), (real, shared))
        main_mx = mx.reshape(d1_bins, d2_bins)
    else:
        spectrum1, shared_spectrum1 = binned_sums(
            dm_size, spectrum_bins(h1, dm_size), (real, shared))
        main_mx = binned_sum(d1_bins * d2_bins, s1 * d2_bins + s2,
                             real).reshape(d1_bins, d2_bins)
    if h2_pre is not None:
        # Under the dual probe the shared key set is symmetric, so
        # shared_spectrum2 (binned by t2's own count) is computed on pass2's
        # stream; callers add the two contributions and this one is zero.
        shared_spectrum2 = torch.zeros(dm_size, dtype=torch.int64,
                                       device=h1.device)
    else:
        shared_spectrum2 = spectrum(h2, shared, dm_size)

    if three:
        s3 = _scale_clamp(h3, d2_scale, d2_bins)
        ends_mx, mixed_mx, middle_mx = (
            m.reshape(d1_bins, d2_bins) for m in binned_sums(
                d1_bins * d2_bins, s1 * d2_bins + s3,
                (real & (s2 == s3), real & (s2 != s3) & (h3 > 0),
                 real & (s2 != s3) & (h3 == 0))))
    else:
        ends_mx = mixed_mx = middle_mx = None

    return counters, spectrum1, shared_spectrum1, shared_spectrum2, \
        main_mx, ends_mx, mixed_mx, middle_mx


def pass2(t2, t1, k: int, d2_bins: int, dm_size: int, d2_scale: float,
          sorted1: bool = False, h1_pre=None):
    """Iterate hash2 entries; probe hash1 (comp.cc:436-463).  Queries are
    ALWAYS canonicalized — the reference's pointer-as-bool bug (§5.1.2).
    sorted1: t2 stores canonical keys, so that canonicalization is an
    identity and the probe stream stays sorted.

    Returns (counters, spectrum2, row0, shared_spectrum2): the last is this
    pass's contribution to shared_spectrum2, non-zero only under the dual
    probe (h1_pre); callers add it to pass1's."""
    real = tables.real_mask(t2)
    h2 = torch.where(real, unsigned(t2.counts), 0)
    if h1_pre is not None:
        h1 = torch.where(real, unsigned(h1_pre), 0)
    else:
        h1 = _probe(t1, t2, tables.canonicalize(t2.keys, k), k, sorted1)

    only = real & (h1 == 0)
    counters = {
        "hash2_total": h2.sum(),
        "hash2_distinct": real.sum(),
        "hash2_only_total": torch.where(only, h2, 0).sum(),
        "hash2_only_distinct": only.sum(),
    }
    want_shared2 = h1_pre is not None
    shared2 = real & (h1 > 0) & (h2 > 0)
    zeros = torch.zeros(dm_size, dtype=torch.int64, device=h2.device)

    s2 = _scale_clamp(h2, d2_scale, d2_bins)
    spec2 = spectrum_bins(h2, dm_size).to(torch.int64)
    if dm_size * d2_bins < 2**31 and d2_scale > 0:
        # spectrum2, row0 (and shared_spectrum2) derive from one packed
        # key: one pass for all of them
        reqs = ((d2_bins, dm_size, 0), (1, d2_bins, 1)) + (
            ((d2_bins, dm_size, 2),) if want_shared2 else ())
        masks = (real, only) + ((shared2,) if want_shared2 else ())
        outs = monotone_packed_sums(spec2 * d2_bins + s2, reqs, masks)
        spectrum2, row0 = outs[0], outs[1]
        shared_spectrum2 = outs[2] if want_shared2 else zeros
    else:
        spectrum2 = spectrum(h2, real, dm_size)
        row0 = mask_bincount(d2_bins, s2, only)
        shared_spectrum2 = (spectrum(h2, shared2, dm_size) if want_shared2
                            else zeros)
    return counters, spectrum2, row0, shared_spectrum2


def pass3(t3) -> dict:
    """Totals over hash3 (comp.cc:466-479)."""
    real = tables.real_mask(t3)
    return {"hash3_total": torch.where(real, unsigned(t3.counts), 0).sum(),
            "hash3_distinct": real.sum()}
