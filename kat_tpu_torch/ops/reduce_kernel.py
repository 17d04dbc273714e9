"""K3: reduce-by-key of a sorted (key, weight) stream, compacted to the
front (`reduce_by_key`; `reduce_by_key_words` for wide keys of W int64
words), and K4: stable compaction of the flagged elements of int32 planes.

Counterparts of kat_tpu/ops/reduce_kernel.py::reduce_compact_sorted and
::compact_flagged.  On a CUDA tensor `reduce_by_key` launches the
single-pass kernel of csrc/reduce.cu (a segmented sum by decoupled
look-back) and `compact_flagged` the kernels of csrc/compact.cu; on a CPU
tensor they take the plain versions, `reduce_by_key_plain` and
`compact_flagged_plain`.
"""

from __future__ import annotations

import torch

from ..core.kmers import SENTINEL
from . import _cuda


def _into(out, got):
    """The plain versions' results copied into the caller's `out` tensors
    (the kernels write there directly), or returned as they are."""
    if out is None:
        return got
    for o, g in zip(out, got[:2]):
        o.copy_(g)
    return (*out, got[2])


def _check_out(out, shapes, dev: torch.device):
    """`out`, when given, is (keys, counts) of the output shapes on the
    stream's device: a place in a larger table, whose word planes may lie
    apart but each run contiguous."""
    if out is None:
        return
    for t, shape, dtype, name in zip(out, shapes, (torch.int64, torch.int32),
                                     ("out keys", "out counts")):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: each plane must be contiguous")


def reduce_by_key_plain(keys: torch.Tensor, w: torch.Tensor, out_size: int,
                        out=None):
    """Plain PyTorch version: runs by `unique_consecutive`, sums by an
    int64 `index_add_`, sentinel runs dropped, then padded/truncated."""
    runs, inverse = torch.unique_consecutive(keys, return_inverse=True)
    sums = torch.zeros(runs.numel(), dtype=torch.int64, device=keys.device)
    sums.index_add_(0, inverse, w.to(torch.int64))
    real = runs != SENTINEL
    runs, sums = runs[real], sums[real]
    m = min(runs.numel(), out_size)
    out_keys = torch.full((out_size,), SENTINEL, dtype=torch.int64,
                          device=keys.device)
    out_counts = torch.zeros(out_size, dtype=torch.int32, device=keys.device)
    out_keys[:m] = runs[:m]
    out_counts[:m] = sums[:m].to(torch.int32)
    return _into(out, (out_keys, out_counts, torch.tensor(
        runs.numel(), dtype=torch.int64, device=keys.device)))


def tile_len() -> int:
    """Elements one thread block of the card's reduce takes, as the compiled
    library reports it."""
    return int(_cuda.LIBRARY.get().kat_reduce_by_key_tile())


def reduce_by_key(keys: torch.Tensor, w: torch.Tensor, out_size: int,
                  out=None):
    """Reduce a sorted int64 key stream with int32 weights to its runs.

    Returns (keys int64 [out_size], counts int32 [out_size], n_unique):
    each non-sentinel run's key and summed weight, in stream order, padded
    with SENTINEL / 0.  n_unique (a 0-d int64 tensor) is the true number of
    such runs, even when it exceeds out_size; the caller then grows.
    Sentinel runs are never emitted, wherever they lie in the stream.
    out: optional (keys, counts) tensors of out_size elements to write
    into (a piece's place in a larger table); they are returned.
    """
    _cuda.require(keys, "keys", torch.int64)
    _cuda.require(w, "w", torch.int32, keys.device)
    if w.numel() != keys.numel():
        raise ValueError("keys and w differ in length")
    if out_size < 0:
        raise ValueError(f"out_size={out_size} < 0")
    # the kernel's status words count runs in 30 bits
    if keys.numel() >= 1 << 30:
        raise ValueError(f"reduce_by_key: n={keys.numel()} must be < 2^30")
    _check_out(out, ((out_size,), (out_size,)), keys.device)
    if not _cuda.on_cuda(keys, "reduce_by_key"):
        return reduce_by_key_plain(keys, w, out_size, out)
    dev = keys.device
    out_keys, out_counts = out if out is not None else (
        torch.empty(out_size, dtype=torch.int64, device=dev),
        torch.empty(out_size, dtype=torch.int32, device=dev))
    n_unique = torch.empty(1, dtype=torch.int64, device=dev)
    n = keys.numel()
    scratch = torch.empty(_cuda.scratch_len("kat_reduce_by_key_scratch", n),
                          dtype=torch.int64, device=dev)
    _cuda.launch("kat_reduce_by_key", dev, keys.data_ptr(), w.data_ptr(), n,
                 out_keys.data_ptr(), out_counts.data_ptr(), out_size,
                 scratch.data_ptr(), n_unique.data_ptr())
    reduce_by_key.launches += 1
    return out_keys, out_counts, n_unique[0]


reduce_by_key.launches = 0  # kernel launches, read by chip_smoke.py


def reduce_by_key_words_plain(keys: torch.Tensor, w: torch.Tensor,
                              out_size: int, out=None):
    """Plain PyTorch version of `reduce_by_key_words`: a run starts where
    any word differs from the key before; an int64 `index_add_` over run
    numbers sums it; sentinel runs dropped, then padded/truncated."""
    W, n = keys.shape
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    if n > 1:
        new[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
    run = new.cumsum(0) - 1
    sums = torch.zeros(int(new.sum()), dtype=torch.int64, device=keys.device)
    sums.index_add_(0, run, w.to(torch.int64))
    runs = keys[:, new]
    real = runs[0] != SENTINEL
    runs, sums = runs[:, real], sums[real]
    m = min(runs.shape[1], out_size)
    out_keys = torch.full((W, out_size), SENTINEL, dtype=torch.int64,
                          device=keys.device)
    out_counts = torch.zeros(out_size, dtype=torch.int32, device=keys.device)
    out_keys[:, :m] = runs[:, :m]
    out_counts[:m] = sums[:m].to(torch.int32)
    return _into(out, (out_keys, out_counts, torch.tensor(
        runs.shape[1], dtype=torch.int64, device=keys.device)))


def reduce_by_key_words(keys: torch.Tensor, w: torch.Tensor, out_size: int,
                        out=None):
    """`reduce_by_key` for a sorted stream of [W, n] int64 wide keys: a run
    ends where any word differs from the next key.  Each word's plane must
    be contiguous; planes may lie apart (a piece of a longer stream).

    Returns (keys [W, out_size] int64, counts [out_size] int32, n_unique):
    each non-sentinel run's key and summed weight in stream order, padded
    with SENTINEL / 0, and the true number of such runs (a 0-d int64
    tensor) even when it exceeds out_size.  out: as in `reduce_by_key`,
    keys [W, out_size]."""
    _cuda.require_words(keys, "keys")
    _cuda.require(w, "w", torch.int32, keys.device)
    if w.numel() != keys.shape[1]:
        raise ValueError("keys and w differ in length")
    if out_size < 0:
        raise ValueError(f"out_size={out_size} < 0")
    # the kernel's status words count runs in 30 bits
    if keys.shape[1] >= 1 << 30:
        raise ValueError(f"reduce_by_key_words: n={keys.shape[1]} must be "
                         "< 2^30")
    W, n = keys.shape
    _check_out(out, ((W, out_size), (out_size,)), keys.device)
    if not _cuda.on_cuda(keys, "reduce_by_key_words"):
        return reduce_by_key_words_plain(keys, w, out_size, out)
    dev = keys.device
    out_keys, out_counts = out if out is not None else (
        torch.empty((W, out_size), dtype=torch.int64, device=dev),
        torch.empty(out_size, dtype=torch.int32, device=dev))
    n_unique = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(_cuda.scratch_len("kat_reduce_by_key_scratch", n),
                          dtype=torch.int64, device=dev)
    _cuda.launch("kat_reduce_by_key_words", dev, keys.data_ptr(),
                 keys.stride(0), W, w.data_ptr(), n, out_keys.data_ptr(),
                 out_keys.stride(0), out_counts.data_ptr(), out_size,
                 scratch.data_ptr(), n_unique.data_ptr())
    reduce_by_key_words.launches += 1
    return out_keys, out_counts, n_unique[0]


reduce_by_key_words.launches = 0  # kernel launches, read by chip_smoke.py


def compact_flagged_plain(planes, flag: torch.Tensor, out_size: int):
    """Plain PyTorch version: boolean indexing per plane, zero padding."""
    keep = flag.to(torch.bool)
    outs = []
    for p in planes:
        kept = p[keep][:out_size]
        out = torch.zeros(out_size, dtype=torch.int32, device=p.device)
        out[:kept.numel()] = kept
        outs.append(out)
    return (*outs, keep.sum())


def compact_flagged(planes, flag: torch.Tensor, out_size: int):
    """Stable stream compaction: the elements of 1-3 int32 planes [n] whose
    flag (bool or uint8 [n]) is set move to the front of out_size slots,
    order preserved, every plane alike.

    Returns (*compacted int32 [out_size], n_kept): slots after n_kept are
    zero; n_kept (a 0-d int64 tensor on the planes' device) is the true
    number of flagged elements even when it exceeds out_size, and writes
    past out_size are dropped."""
    planes = tuple(planes)
    if not 1 <= len(planes) <= 3:
        raise ValueError(f"expected 1-3 planes, got {len(planes)}")
    if out_size < 0:
        raise ValueError(f"out_size={out_size} < 0")
    dev = planes[0].device
    for i, p in enumerate(planes):
        _cuda.require(p, f"planes[{i}]", torch.int32, dev)
    if flag.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"flag: expected bool or uint8, got {flag.dtype}")
    _cuda.require(flag, "flag", flag.dtype, dev)
    n = flag.numel()
    if any(p.numel() != n for p in planes):
        raise ValueError("planes and flag differ in length")
    if not _cuda.on_cuda(flag, "compact_flagged"):
        return compact_flagged_plain(planes, flag, out_size)
    outs = tuple(torch.empty(out_size, dtype=torch.int32, device=dev)
                 for _ in planes)
    n_kept = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(_cuda.scratch_len("kat_compact_flagged_scratch", n),
                          dtype=torch.int64, device=dev)
    pad = [None] * (3 - len(planes))
    _cuda.launch("kat_compact_flagged", dev,
                 *[p.data_ptr() for p in planes], *pad, len(planes),
                 flag.data_ptr(), n, *[o.data_ptr() for o in outs], *pad,
                 out_size, scratch.data_ptr(), n_kept.data_ptr())
    compact_flagged.launches += 1
    return (*outs, n_kept[0])


compact_flagged.launches = 0  # kernel launches, read by chip_smoke.py
