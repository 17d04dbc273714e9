"""Reductions over count tables: histogram binning (port of
kat_tpu/core/stats.py, `hist_from_counts` only so far).

kat_tpu routes large binnings through its sort + reduce kernels
(`binned_sums`) because scatters are slow on the TPU; here the binning is
one `torch.bincount` over int64 bucket indices, the same scatter-add that
kat_tpu's own non-kernel path (`mask_bincount`) does.
"""

from __future__ import annotations

import torch


def hist_from_counts(counts: torch.Tensor, base: int, ceil: int, inc: int,
                     nb_buckets: int) -> torch.Tensor:
    """Occurrence histogram with KAT's bucket rules (histogram.cc:188-196):
    val < base -> bucket 0; val > ceil -> last bucket; else (val-base)/inc.
    Padding entries (count 0 in a table) are excluded — jellyfish hashes
    never store zero counts.  int32 counts are read as unsigned, as
    kat_tpu's uint32 counts: a count of 2^31 or more lands in the last
    bucket.  Returns int64 [nb_buckets] on counts' device.
    """
    c = counts.to(torch.int64) & 0xFFFFFFFF
    bucket = torch.where(c < base, 0,
                         torch.where(c > ceil, nb_buckets - 1,
                                     (c - base) // inc))
    # zero counts go to an extra bin that is cut off (a boolean mask would
    # force a device sync)
    bucket = torch.where(c > 0, bucket, nb_buckets)
    return torch.bincount(bucket, minlength=nb_buckets + 1)[:nb_buckets]
