"""Binned sums of 0/1 masks: the binned form of K1 + K3.

kat_tpu computes a binned sum (kat_tpu/core/stats.py::binned_sums and
::monotone_packed_sums) by sorting the bin plane with the masks riding
(K1, `sort_planes_padded`) and reducing the sorted bins (K3,
`reduce_compact_sorted`), because scatters are slow on the TPU.  On a CUDA
tensor `binned_sums` and `packed_sums` launch the one-pass kernel of
csrc/binned.cu instead (block-private shared-memory counters over a window
of low bins, warp-aggregated atomics beyond it); on a CPU tensor they take
the plain versions, one `torch.bincount` per mask or request.  Both are
exact: integer counts, any order of adds.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

MAX_MASKS = 3
MAX_REQUESTS = 3


def _check(keys: torch.Tensor, masks: torch.Tensor, what: str) -> None:
    _cuda.require(keys, f"{what} keys", torch.int32)
    if masks.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{what} masks: expected bool or uint8, got "
                        f"{masks.dtype}")
    if masks.dim() != 2 or not 1 <= masks.shape[0] <= MAX_MASKS:
        raise ValueError(f"{what} masks: expected [M, n] with 1 <= M <= "
                         f"{MAX_MASKS}, got {tuple(masks.shape)}")
    if masks.shape[1] != keys.numel():
        raise ValueError(f"{what}: keys and masks differ in length")
    if not masks.is_contiguous():
        raise ValueError(f"{what} masks: expected a contiguous tensor")
    if masks.device != keys.device:
        raise ValueError(f"{what} masks: on {masks.device}, expected "
                         f"{keys.device}")
    if keys.numel() >= 1 << 32:
        raise ValueError(f"{what}: n={keys.numel()} must be < 2^32")


def _check_requests(requests, n_masks: int) -> tuple:
    requests = tuple((int(d), int(m), int(i)) for d, m, i in requests)
    if not 1 <= len(requests) <= MAX_REQUESTS:
        raise ValueError(f"expected 1-{MAX_REQUESTS} requests, got "
                         f"{len(requests)}")
    for div, mod, mi in requests:
        if not (1 <= div < 1 << 31 and 1 <= mod < 1 << 31
                and 0 <= mi < n_masks):
            raise ValueError(f"request (div={div}, mod={mod}, mask={mi}): "
                             f"need 1 <= div, mod < 2^31 and a mask index "
                             f"below {n_masks}")
    return requests


def _bincount(bins: torch.Tensor, mask: torch.Tensor, size: int):
    """int64 [size] counts of the masked bins: the unmasked ones go to an
    extra bin that is cut off (a boolean index would force a sync)."""
    b = torch.where(mask.to(torch.bool), bins.to(torch.int64), size)
    return torch.bincount(b, minlength=size + 1)[:size]


def packed_sums_plain(packed: torch.Tensor, masks: torch.Tensor, requests):
    """Plain PyTorch version of `packed_sums`: one `torch.bincount` of
    (packed // div) % mod per request."""
    return tuple(_bincount((packed.to(torch.int64) // div) % mod, masks[mi],
                           mod) for div, mod, mi in requests)


def binned_sums_plain(bins: torch.Tensor, masks: torch.Tensor,
                      total_bins: int) -> torch.Tensor:
    """Plain PyTorch version of `binned_sums`: one `torch.bincount` per
    mask."""
    return torch.stack([_bincount(bins, m, total_bins) for m in masks])


def _launch(packed: torch.Tensor, masks: torch.Tensor, requests):
    """The requests' bins back to back in one int64 tensor, from one launch
    (requests already checked; packed on the card)."""
    dev = packed.device
    out = torch.zeros(sum(mod for _d, mod, _m in requests), dtype=torch.int64,
                      device=dev)
    n = packed.numel()
    if n:
        req = (ctypes.c_int64 * (3 * len(requests)))(
            *[v for r in requests for v in r])
        _cuda.launch("kat_binned_sums", dev, packed.data_ptr(),
                     masks.view(torch.uint8).data_ptr(), masks.shape[0], n,
                     ctypes.addressof(req), len(requests), out.data_ptr())
        binned_sums.launches += 1
    return out


def packed_sums(packed: torch.Tensor, masks: torch.Tensor, requests):
    """Several binned sums over bins derived from one key plane.

    packed: int32 [n], every value >= 0.  masks: bool or uint8 [M, n], 1 <=
    M <= 3 (non-zero counts one).  requests: 1-3 tuples (div, mod,
    mask_index).  Returns one int64 [mod] tensor per request, bin b holding
    the number of elements whose mask is set and whose (packed // div) %
    mod is b: all requests from one read of the keys and the masks.
    """
    _check(packed, masks, "packed_sums")
    requests = _check_requests(requests, masks.shape[0])
    if not _cuda.on_cuda(packed, "packed_sums"):
        return packed_sums_plain(packed, masks, requests)
    return tuple(_launch(packed, masks, requests).split(
        [mod for _d, mod, _m in requests]))


def binned_sums(bins: torch.Tensor, masks: torch.Tensor,
                total_bins: int) -> torch.Tensor:
    """Sum each 0/1 mask into `total_bins` bins: int64 [M, total_bins],
    row m equal to torch.bincount of the bins where mask m is set.

    bins: int32 [n], already in [0, total_bins).  masks: bool or uint8
    [M, n], 1 <= M <= 3 (non-zero counts one).  One launch of the kernel
    reads the bins and every mask once.
    """
    _check(bins, masks, "binned_sums")
    requests = _check_requests(
        [(1, total_bins, m) for m in range(masks.shape[0])], masks.shape[0])
    if not _cuda.on_cuda(bins, "binned_sums"):
        return binned_sums_plain(bins, masks, total_bins)
    return _launch(bins, masks, requests).view(masks.shape[0], total_bins)


binned_sums.launches = 0  # kernel launches, read by chip_smoke.py


def window_len() -> int:
    """Shared-memory counters a block of the card's kernel holds, as the
    compiled library reports it."""
    return int(_cuda.LIBRARY.get().kat_binned_sums_window())
