"""Binned sums of 0/1 masks: the binned form of K1 + K3.

kat_tpu computes a binned sum (kat_tpu/core/stats.py::binned_sums and
::monotone_packed_sums) by sorting the bin plane with the masks riding
(K1, `sort_planes_padded`) and reducing the sorted bins (K3,
`reduce_compact_sorted`), because scatters are slow on the TPU.  On a CUDA
tensor `binned_sums` and `packed_sums` launch the kernels of
csrc/binned.cu instead: requests that share (div, mod) form a group; a
group whose counters fit in a block's shared memory is counted in one pass
over the keys, a larger one is partitioned into ranges of bins that a
block counts whole (`partition_model` is that design step by step in
plain PyTorch).  On a CPU tensor they take the plain versions, one
`torch.bincount` per mask or request.  All are exact: integer counts, any
order of adds.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

MAX_MASKS = 3
MAX_REQUESTS = 3
# csrc/binned.cu's geometry: counters a block of the one-pass groups holds,
# ranges of all partitioned groups, the count window's bits (one request,
# two or three), where a word's request bits start, keys a tile
SMALL_COUNTERS = 32 * 1024
MAX_RANGES = 4096
WINDOW_BITS = (14, 13)
QBIT = 29
TILE = 4096


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


# -- the card's design, step by step ------------------------------------

def magic(d: int) -> tuple[int, int]:
    """(m, s) with x // d == (x * m) >> 32 >> s for every 0 <= x < 2^31
    (m = 0: d == 1, no step), as csrc/binned.cu's host computes them:
    l = ceil(log2 d), m = ceil(2^(31 + l) / d) < 2^32, s = l - 1."""
    if d == 1:
        return 0, 0
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), lg - 1


def _div(x: torch.Tensor, m: int, s: int) -> torch.Tensor:
    return x if m == 0 else ((x * m) >> 32) >> s


def bin_of(keys: torch.Tensor, div: int, mod: int) -> torch.Tensor:
    """(keys // div) % mod by the card's multiply-high and shift (keys:
    int64 in [0, 2^31))."""
    q = _div(keys, *magic(div))
    return q - _div(q, *magic(mod)) * mod


def plan(requests, small: int = SMALL_COUNTERS, max_ranges: int = MAX_RANGES,
         window_bits: tuple[int, int] = WINDOW_BITS):
    """csrc/binned.cu's make_plan: requests of equal (div, mod) form a
    group (request q of a group reads mask masks[q], its bins start at
    out_off[q]); the groups by cost (requests x mod, stable) are counted
    in one pass while their counters fit in `small`, the rest are
    partitioned into ranges of 2^rb bins, rb the count window's bits
    (window_bits[0] for one request, [1] for more), widened one bit at a
    time on the group with the most ranges until all hold at most
    max_ranges.  Returns (one-pass groups, partitioned groups), dicts."""
    groups, off = [], 0
    for div, mod, mi in requests:
        g = next((g for g in groups if g["div"] == div and g["mod"] == mod),
                 None)
        if g is None:
            g = dict(div=div, mod=mod, masks=[], out_off=[])
            groups.append(g)
        g["masks"].append(mi)
        g["out_off"].append(off)
        off += mod
    one_pass, parted, win = [], [], 0
    for g in sorted(groups, key=lambda g: len(g["masks"]) * g["mod"]):
        cost = len(g["masks"]) * g["mod"]
        if not parted and win + cost <= small:
            g["win_off"] = win
            win += cost
            one_pass.append(g)
        else:
            g["wb"] = g["rb"] = window_bits[len(g["masks"]) > 1]
            parted.append(g)
    while parted:
        for g in parted:
            g["nr"] = -(-g["mod"] >> g["rb"])
        if sum(g["nr"] for g in parted) <= max_ranges:
            break
        max(parted, key=lambda g: g["nr"])["rb"] += 1
    roff = 0
    for g in parted:
        g["roff"] = roff
        roff += g["nr"]
    return one_pass, parted


def partition_model(keys: torch.Tensor, masks: torch.Tensor, requests, *,
                    small: int = SMALL_COUNTERS,
                    max_ranges: int = MAX_RANGES,
                    window_bits: tuple[int, int] = WINDOW_BITS,
                    blocks: int = 264, tile: int = TILE) -> tuple:
    """The card's binned sums step by step in plain PyTorch, equal to
    `packed_sums_plain` for every input the kernels take: `plan`; the
    one-pass groups' bincounts; the first pass's words a range; the plan
    kernel (each range's slice of the word buffer; a range with more than
    max(share of the words a block, twice its counters) words cut into
    pieces); the second pass, tile by tile, each tile's words (bin within
    the range | request bits << QBIT) put in range order at each range's
    cursor; the count kernel, a piece at a time (the card takes a piece's
    range a window of 2^wb bins at a time, which splits the same counts),
    storing a whole range's bins and adding a cut range's into bins the
    second pass zeroed.  Bins nobody writes stay -1 (the
    card's output is not zeroed first) and raise."""
    requests = _check_requests(requests, masks.shape[0])
    one_pass, parted = plan(requests, small, max_ranges, window_bits)
    k = keys.to(torch.int64)
    bits = (masks != 0) & (k >= 0)
    out = torch.full((sum(mod for _d, mod, _m in requests),), -1,
                     dtype=torch.int64, device=keys.device)
    for g in one_pass:
        b = bin_of(k.clamp_min(0), g["div"], g["mod"])
        for mi, o in zip(g["masks"], g["out_off"]):
            out[o:o + g["mod"]] = _bincount(b, bits[mi], g["mod"])
    if parted:
        R = sum(g["nr"] for g in parted)
        rng, word = [], []  # of every element, per partitioned group
        tot = torch.zeros(R, dtype=torch.int64, device=keys.device)
        for g in parted:
            qb = sum(bits[mi].to(torch.int64) << q
                     for q, mi in enumerate(g["masks"]))
            b = bin_of(k.clamp_min(0), g["div"], g["mod"])
            rng.append(torch.where(qb != 0, g["roff"] + (b >> g["rb"]), -1))
            word.append((b & ((1 << g["rb"]) - 1)) | (qb << QBIT))
            tot += torch.bincount(rng[-1][qb != 0], minlength=R)
        start = torch.cumsum(tot, 0) - tot
        total = int(tot.sum())
        share = [max(-(-total // blocks), 2 * (len(g["masks"]) << g["rb"]))
                 for g in parted for _r in range(g["nr"])]
        pieces = [max(1, int(w) // s) for w, s in zip(tot, share)]
        words = torch.full((total,), -1, dtype=torch.int64,
                           device=keys.device)
        cursor = start.clone()
        for t0 in range(0, k.numel(), tile):
            for r_all, w_all in zip(rng, word):
                r, w = r_all[t0:t0 + tile], w_all[t0:t0 + tile]
                keep = r >= 0
                r, w = r[keep], w[keep]
                order = torch.sort(r, stable=True).indices
                r, w = r[order], w[order]
                cnt = torch.bincount(r, minlength=R)
                first = torch.cumsum(cnt, 0) - cnt
                rank = torch.arange(r.numel(), device=keys.device) - first[r]
                words[cursor[r] + rank] = w
                cursor += cnt
        for g in parted:
            for local in range(g["nr"]):
                r = g["roff"] + local
                lbase = local << g["rb"]
                span = min(1 << g["rb"], g["mod"] - lbase)
                cut = pieces[r] > 1
                if cut:
                    for o in g["out_off"]:
                        out[o + lbase:o + lbase + span] = 0
                psize = -(-int(tot[r]) // pieces[r])
                for p in range(pieces[r]):
                    w0 = int(start[r]) + p * psize
                    ws = words[w0:min(int(start[r] + tot[r]), w0 + psize)]
                    local_bin = ws & ((1 << g["rb"]) - 1)
                    for q, o in enumerate(g["out_off"]):
                        sel = ((ws >> (QBIT + q)) & 1) == 1
                        got = torch.bincount(local_bin[sel],
                                             minlength=span)
                        lo = o + lbase
                        if cut:
                            out[lo:lo + span] += got
                        else:
                            out[lo:lo + span] = got
    if bool((out < 0).any()):
        raise AssertionError("a bin was never written")
    return tuple(out.split([mod for _d, mod, _m in requests]))


# -- the kernel ------------------------------------------------------------

def _launch(packed: torch.Tensor, masks: torch.Tensor, requests):
    """The requests' bins back to back in one int64 tensor, from one call
    of the kernels (requests already checked; packed on the card)."""
    dev = packed.device
    total = sum(mod for _d, mod, _m in requests)
    n = packed.numel()
    if n == 0:
        return torch.zeros(total, dtype=torch.int64, device=dev)
    out = torch.empty(total, dtype=torch.int64, device=dev)
    req = (ctypes.c_int64 * (3 * len(requests)))(
        *[v for r in requests for v in r])
    n_scratch = _cuda.scratch_len("kat_binned_sums_scratch", n,
                                  ctypes.addressof(req), len(requests),
                                  masks.shape[0])
    scratch = (torch.empty(n_scratch, dtype=torch.int64, device=dev)
               if n_scratch else None)
    _cuda.launch("kat_binned_sums", dev, packed.data_ptr(),
                 masks.view(torch.uint8).data_ptr(), masks.shape[0], n,
                 ctypes.addressof(req), len(requests), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr())
    binned_sums.launches += 1
    return out


def packed_sums(packed: torch.Tensor, masks: torch.Tensor, requests):
    """Several binned sums over bins derived from one key plane.

    packed: int32 [n], every value >= 0.  masks: bool or uint8 [M, n], 1 <=
    M <= 3 (non-zero counts one).  requests: 1-3 tuples (div, mod,
    mask_index).  Returns one int64 [mod] tensor per request, bin b holding
    the number of elements whose mask is set and whose (packed // div) %
    mod is b: all requests from one read of the keys and the masks (two
    where a group is partitioned).
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
    [M, n], 1 <= M <= 3 (non-zero counts one).  One call of the kernels
    reads the bins and every mask once (twice past a block's counters).
    """
    _check(bins, masks, "binned_sums")
    requests = _check_requests(
        [(1, total_bins, m) for m in range(masks.shape[0])], masks.shape[0])
    if not _cuda.on_cuda(bins, "binned_sums"):
        return binned_sums_plain(bins, masks, total_bins)
    return _launch(bins, masks, requests).view(masks.shape[0], total_bins)


binned_sums.launches = 0  # calls that launched the kernels, for chip_smoke


def window_len() -> int:
    """Counters a block of the card's one-pass groups holds, as the
    compiled library reports it."""
    return int(_cuda.LIBRARY.get().kat_binned_sums_window())
