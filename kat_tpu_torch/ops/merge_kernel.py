"""K2: merge of two sorted key streams: the count table with the sorted
fresh keys (`merge_sorted`, the counting flush; `merge_sorted_words` for
wide keys of W int64 words, the wide flush), or two streams that each carry
1-3 int32 payload planes (`merge_sorted_payload`, the sort-merge join;
`merge_sorted_words_payload` for wide keys, the wide join).

Counterpart of kat_tpu/ops/merge_kernel.py::merge_sorted_kernel (the
final-phase mode of kat_tpu's bitonic `_window_kernel`).  On a CUDA tensor
they launch the merge of csrc/merge.cu (a partition launch that finds
every tile's split on the merge path, then one block per tile); on a CPU
tensor they take the plain versions (`*_plain`).  The output is exactly len(a) + len(b) long,
with no block padding, and ties take the `a` element first.
"""

from __future__ import annotations

import torch

from ..core.kmers import SENTINEL
from . import _cuda
from .sort_kernel import words_order_plain


def tile_len() -> int:
    """Outputs one thread block of the card's merge takes, as the compiled
    library reports it."""
    return int(_cuda.LIBRARY.get().kat_merge_sorted_tile())


def _splits(n: int, device: torch.device) -> torch.Tensor:
    """Scratch for the merge's tile splits."""
    return torch.empty(_cuda.scratch_len("kat_merge_sorted_scratch", n),
                       dtype=torch.int64, device=device)


def merge_sorted_plain(a_keys: torch.Tensor, a_counts: torch.Tensor,
                       b_keys: torch.Tensor):
    """Plain PyTorch version: concatenate, then a stable sort that carries
    the weights through its permutation (ties keep the table first)."""
    keys = torch.cat([a_keys, b_keys])
    w = torch.cat([a_counts, (b_keys != SENTINEL).to(torch.int32)])
    keys, perm = torch.sort(keys, stable=True)
    return keys, w[perm]


def merge_sorted(a_keys: torch.Tensor, a_counts: torch.Tensor,
                 b_keys: torch.Tensor):
    """Stable merge of a sorted table (int64 keys, int32 counts) with sorted
    fresh int64 keys, whose weight is (key != SENTINEL).

    Returns (keys int64, weights int32), both len(a) + len(b) long."""
    _cuda.require(a_keys, "a_keys", torch.int64)
    _cuda.require(a_counts, "a_counts", torch.int32, a_keys.device)
    _cuda.require(b_keys, "b_keys", torch.int64, a_keys.device)
    if a_counts.numel() != a_keys.numel():
        raise ValueError("a_keys and a_counts differ in length")
    if not _cuda.on_cuda(a_keys, "merge_sorted"):
        return merge_sorted_plain(a_keys, a_counts, b_keys)
    na, nb = a_keys.numel(), b_keys.numel()
    out_keys = torch.empty(na + nb, dtype=torch.int64, device=a_keys.device)
    out_w = torch.empty(na + nb, dtype=torch.int32, device=a_keys.device)
    if na + nb == 0:
        return out_keys, out_w
    _cuda.launch("kat_merge_sorted", a_keys.device, a_keys.data_ptr(),
                 a_counts.data_ptr(), na, b_keys.data_ptr(), nb,
                 out_keys.data_ptr(), out_w.data_ptr(),
                 _splits(na + nb, a_keys.device).data_ptr())
    merge_sorted.launches += 1
    return out_keys, out_w


merge_sorted.launches = 0  # kernel launches, read by chip_smoke.py


def merge_sorted_payload_plain(a_keys, a_planes, b_keys, b_planes):
    """Plain PyTorch version: concatenate, then a stable sort whose
    permutation gathers every plane (ties keep `a` first)."""
    keys, perm = torch.sort(torch.cat([a_keys, b_keys]), stable=True)
    return keys, tuple(torch.cat([pa, pb])[perm]
                       for pa, pb in zip(a_planes, b_planes))


def _check_planes(a_planes, b_planes, na: int, nb: int,
                  dev: torch.device) -> int:
    """What the payload merges take: the same number (1-3) of int32 planes
    on each side, each as long as its side's keys.  Returns the number."""
    n_planes = len(a_planes)
    if not 1 <= n_planes <= 3 or len(b_planes) != n_planes:
        raise ValueError("expected 1-3 payload planes on each side, got "
                         f"{n_planes} and {len(b_planes)}")
    for planes, n, side in ((a_planes, na, "a"), (b_planes, nb, "b")):
        for i, p in enumerate(planes):
            _cuda.require(p, f"{side}_planes[{i}]", torch.int32, dev)
            if p.numel() != n:
                raise ValueError(f"{side}_planes[{i}] and {side}_keys differ "
                                 "in length")
    return n_planes


def _plane_ptrs(planes, n_planes: int) -> list:
    return [p.data_ptr() for p in planes] + [None] * (3 - n_planes)


def merge_sorted_payload(a_keys, a_planes, b_keys, b_planes):
    """Stable merge of two sorted int64 key streams, each carrying the same
    number (1-3) of int32 payload planes; ties take `a` first.

    Returns (keys int64, planes tuple of int32), all len(a) + len(b) long."""
    dev = a_keys.device
    _cuda.require(a_keys, "a_keys", torch.int64)
    _cuda.require(b_keys, "b_keys", torch.int64, dev)
    n_planes = _check_planes(a_planes, b_planes, a_keys.numel(),
                             b_keys.numel(), dev)
    if not _cuda.on_cuda(a_keys, "merge_sorted_payload"):
        return merge_sorted_payload_plain(a_keys, a_planes, b_keys, b_planes)
    na, nb = a_keys.numel(), b_keys.numel()
    out_keys = torch.empty(na + nb, dtype=torch.int64, device=dev)
    out = tuple(torch.empty(na + nb, dtype=torch.int32, device=dev)
                for _ in range(n_planes))
    if na + nb == 0:
        return out_keys, out
    _cuda.launch("kat_merge_sorted_payload", dev, a_keys.data_ptr(),
                 *_plane_ptrs(a_planes, n_planes), na, b_keys.data_ptr(),
                 *_plane_ptrs(b_planes, n_planes), nb, n_planes,
                 out_keys.data_ptr(), *_plane_ptrs(out, n_planes),
                 _splits(na + nb, dev).data_ptr())
    merge_sorted_payload.launches += 1
    return out_keys, out


merge_sorted_payload.launches = 0  # kernel launches, read by chip_smoke.py


def words_tile_len(n_words: int) -> int:
    """Outputs one thread block of the card's W-word merge takes."""
    return int(_cuda.LIBRARY.get().kat_merge_sorted_words_tile(n_words))


def merge_sorted_words_plain(a_keys: torch.Tensor, a_counts: torch.Tensor,
                             b_keys: torch.Tensor):
    """Plain PyTorch version of `merge_sorted_words`: concatenate, then the
    plain W-word sort, whose permutation carries the weights."""
    keys = torch.cat([a_keys, b_keys], dim=1)
    w = torch.cat([a_counts, (b_keys[0] != SENTINEL).to(torch.int32)])
    perm = words_order_plain(keys)
    return keys[:, perm], w[perm]


def merge_sorted_words(a_keys: torch.Tensor, a_counts: torch.Tensor,
                       b_keys: torch.Tensor):
    """Stable merge of a sorted W-word table ([W, na] int64 keys, int32
    counts) with sorted fresh [W, nb] keys, whose weight is (key !=
    SENTINEL); ties take the table first.  The table's planes may lie
    apart (its prefix of real entries).

    Returns (keys [W, na + nb] int64, weights [na + nb] int32)."""
    _cuda.require_words(a_keys, "a_keys")
    _cuda.require_words(b_keys, "b_keys", a_keys.device)
    _cuda.require(a_counts, "a_counts", torch.int32, a_keys.device)
    if b_keys.shape[0] != a_keys.shape[0]:
        raise ValueError("a_keys and b_keys differ in words")
    if a_counts.numel() != a_keys.shape[1]:
        raise ValueError("a_keys and a_counts differ in length")
    if not _cuda.on_cuda(a_keys, "merge_sorted_words"):
        return merge_sorted_words_plain(a_keys, a_counts, b_keys)
    W, na = a_keys.shape
    nb = b_keys.shape[1]
    dev = a_keys.device
    out_keys = torch.empty((W, na + nb), dtype=torch.int64, device=dev)
    out_w = torch.empty(na + nb, dtype=torch.int32, device=dev)
    if na + nb == 0:
        return out_keys, out_w
    scratch = torch.empty(
        _cuda.scratch_len("kat_merge_sorted_words_scratch", na + nb, W),
        dtype=torch.int64, device=dev)
    _cuda.launch("kat_merge_sorted_words", dev, a_keys.data_ptr(),
                 a_keys.stride(0), a_counts.data_ptr(), na, b_keys.data_ptr(),
                 b_keys.stride(0), nb, W, out_keys.data_ptr(),
                 out_keys.stride(0), out_w.data_ptr(), scratch.data_ptr())
    merge_sorted_words.launches += 1
    return out_keys, out_w


merge_sorted_words.launches = 0  # kernel launches, read by chip_smoke.py


def merge_sorted_words_payload_plain(a_keys, a_planes, b_keys, b_planes):
    """Plain PyTorch version of `merge_sorted_words_payload`: concatenate,
    then the plain W-word sort, whose stable permutation gathers every
    plane (ties keep `a` first)."""
    keys = torch.cat([a_keys, b_keys], dim=1)
    perm = words_order_plain(keys)
    return keys[:, perm], tuple(torch.cat([pa, pb])[perm]
                                for pa, pb in zip(a_planes, b_planes))


def merge_sorted_words_payload(a_keys, a_planes, b_keys, b_planes):
    """Stable merge of two sorted streams of [W, n] int64 wide keys, each
    carrying the same number (1-3) of int32 payload planes; ties take `a`
    first.  Each word's plane must be contiguous (planes may lie apart).

    Returns (keys [W, na + nb] int64, planes tuple of int32 [na + nb])."""
    dev = a_keys.device
    _cuda.require_words(a_keys, "a_keys")
    _cuda.require_words(b_keys, "b_keys", dev)
    if b_keys.shape[0] != a_keys.shape[0]:
        raise ValueError("a_keys and b_keys differ in words")
    W, na = a_keys.shape
    nb = b_keys.shape[1]
    n_planes = _check_planes(a_planes, b_planes, na, nb, dev)
    if not _cuda.on_cuda(a_keys, "merge_sorted_words_payload"):
        return merge_sorted_words_payload_plain(a_keys, a_planes, b_keys,
                                                b_planes)
    out_keys = torch.empty((W, na + nb), dtype=torch.int64, device=dev)
    out = tuple(torch.empty(na + nb, dtype=torch.int32, device=dev)
                for _ in range(n_planes))
    if na + nb == 0:
        return out_keys, out
    scratch = torch.empty(
        _cuda.scratch_len("kat_merge_sorted_words_scratch", na + nb, W),
        dtype=torch.int64, device=dev)
    _cuda.launch("kat_merge_sorted_words_payload", dev, a_keys.data_ptr(),
                 a_keys.stride(0), *_plane_ptrs(a_planes, n_planes), na,
                 b_keys.data_ptr(), b_keys.stride(0),
                 *_plane_ptrs(b_planes, n_planes), nb, W, n_planes,
                 out_keys.data_ptr(), out_keys.stride(0),
                 *_plane_ptrs(out, n_planes), scratch.data_ptr())
    merge_sorted_words_payload.launches += 1
    return out_keys, out


merge_sorted_words_payload.launches = 0  # kernel launches, read by chip_smoke.py
