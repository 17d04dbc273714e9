"""Reductions over count tables: histogram binning, GC-vs-coverage
matrices, spectra (port of kat_tpu/core/stats.py).

Every binned sum here goes through ops/binned_kernel.py: on the card the
one-pass kernel of csrc/binned.cu, on the CPU its plain version (one
`torch.bincount` per mask).  kat_tpu routes large binnings through its sort
and reduce kernels (the binned form of K1 + K3) because scatters are slow
on the TPU; the card's shared-memory atomics compute the same sums
directly.  Sums are int64 (kat_tpu's uint64); int32 counts are read as
unsigned, as kat_tpu's uint32 counts.
"""

from __future__ import annotations

import torch

from ..ops import binned_kernel
from ..utils.profiling import annotate


def unsigned(counts: torch.Tensor) -> torch.Tensor:
    """int32 counts read as kat_tpu's uint32: int64 in [0, 2^32), a new
    tensor (masked in place: one int64 copy of the counts, not two)."""
    return counts.to(torch.int64, copy=True).bitwise_and_(0xFFFFFFFF)


def _masks(masks) -> torch.Tensor:
    return torch.stack([m.reshape(-1).to(torch.bool) for m in masks])


def binned_sums(total_bins: int, bins: torch.Tensor, masks) -> tuple:
    """Sum one to three 0/1 masks into `total_bins` flat bins: one int64
    [total_bins] tensor per mask.  `bins` MUST already be in range."""
    return tuple(binned_kernel.binned_sums(
        bins.reshape(-1).to(torch.int32), _masks(masks), total_bins))


def binned_sum(total_bins: int, bins: torch.Tensor,
               mask01: torch.Tensor) -> torch.Tensor:
    return binned_sums(total_bins, bins, (mask01,))[0]


def mask_bincount(size: int, idx: torch.Tensor,
                  mask01: torch.Tensor) -> torch.Tensor:
    """Count of the masked indices per bin: int64 [size] (kat_tpu's
    scatter-add of a 0/1 mask; `idx` in range)."""
    return binned_sum(size, idx, mask01)


def monotone_packed_sums(packed: torch.Tensor, requests, masks) -> tuple:
    """Several binned 0/1-mask sums whose bins derive from one packed key,
    ``bin = (packed // div) % mod``: one read of the keys and masks for
    all of them, where kat_tpu shares one sort.

    requests: 1-3 tuples (div, mod, mask_index) into `masks`; packed in
    [0, 2^31).  Returns one int64 [mod] tensor per request, every request
    exact (kat_tpu's `runs_cap` bound on cross-coarsened requests has no
    counterpart: nothing is truncated).
    """
    used = sorted({mi for _d, _m, mi in requests})
    return binned_kernel.packed_sums(
        packed.reshape(-1).to(torch.int32), _masks([masks[i] for i in used]),
        [(div, mod, used.index(mi)) for div, mod, mi in requests])


def hist_from_counts(counts: torch.Tensor, base: int, ceil: int, inc: int,
                     nb_buckets: int) -> torch.Tensor:
    """Occurrence histogram with KAT's bucket rules (histogram.cc:188-196):
    val < base -> bucket 0; val > ceil -> last bucket; else (val-base)/inc.
    Padding entries (count 0 in a table) are excluded — jellyfish hashes
    never store zero counts.  int32 counts are read as unsigned, as
    kat_tpu's uint32 counts: a count of 2^31 or more lands in the last
    bucket.  Returns int64 [nb_buckets] on counts' device.
    """
    with annotate("kat.bin"):
        # the buckets in place over the one int64 copy: at a table's 2^28
        # slots each int64 temporary is 2 GiB, and this runs beside the
        # table and the job's staged reads
        c = unsigned(counts)
        real, low, high = c > 0, c < base, c > ceil
        bucket = c.sub_(base).floor_divide_(inc)
        bucket.masked_fill_(low, 0).masked_fill_(high, nb_buckets - 1)
        del low, high
        return binned_sum(nb_buckets, bucket, real)


def gcp_matrix(table, mer_len: int, cvg_bins: int,
               cvg_scale: float = 1.0) -> torch.Tensor:
    """GC-count x coverage matrix of distinct k-mers (gcp.cc:179-197).

    Returns int64 [mer_len + 1, cvg_bins + 1]: rows by GC count
    (0..mer_len), columns by ceil(count x cvg_scale) of the unsigned count
    in float64, clamped to cvg_bins.  The reference sizes the matrix
    `mer_len` rows and never prints GC == mer_len (SURVEY §5.1.3): the
    writer applies that quirk.  Narrow and wide tables alike.
    """
    from . import tables

    with annotate("kat.bin"):
        gc = tables.gc_of_keys(table).to(torch.int64)
        c = unsigned(table.counts)
        cvg = torch.where(c == 0, 0,
                          torch.ceil(c.to(torch.float64) * cvg_scale)
                          .to(torch.int64))
        cvg = torch.clamp_max(cvg, cvg_bins)
        flat = gc * (cvg_bins + 1) + cvg
        return binned_sum((mer_len + 1) * (cvg_bins + 1), flat,
                          c > 0).reshape(mer_len + 1, cvg_bins + 1)


def spectrum_bins(counts: torch.Tensor, nb_bins: int) -> torch.Tensor:
    """The spectrum's bin per entry (CompCounters::updateSpectrum,
    comp_counters.cc:130-140): count <= 0 -> 0, count >= nb_bins -> the
    last bin, else the count.  int32."""
    c = counts.to(torch.int64)
    return torch.where(c <= 0, 0,
                       torch.where(c >= nb_bins, nb_bins - 1, c)).to(
        torch.int32)


def spectrum(counts: torch.Tensor, weights: torch.Tensor,
             nb_bins: int) -> torch.Tensor:
    """int64 [nb_bins] spectrum of `counts` over the 0/1 `weights`."""
    return binned_sum(nb_bins, spectrum_bins(counts, nb_bins), weights)
