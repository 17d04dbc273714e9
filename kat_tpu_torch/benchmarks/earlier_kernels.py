"""The kernels that the current K4, W-word K1, K6, binned sums and K5
replaced (the four-launch compaction, the W-word LSD sort over every digit
of every word, the tree of pairwise run merges, the window of shared
counters with u64 atomics past it, the bitonic chunk sort), built from
benchmarks/earlier/ into a library of their own, so that chip_smoke.py and
the benchmarks can time the current kernels against them on the same
card.  The port never calls them.  Same inputs and outputs as
`reduce_kernel.compact_flagged`, `sort_kernel.sort_words`,
`sort_kernel.sort_words_pairs`, `sort_kernel.merge_runs`,
`sort_kernel.merge_runs_words`, `binned_kernel.binned_sums`,
`binned_kernel.packed_sums` and `sort_kernel.sort_chunks`, CUDA tensors
only."""

from __future__ import annotations

import ctypes
import os

import torch

from ..ops import _cuda

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
LIBRARY = _cuda.KernelLibrary(
    csrc=os.path.join(os.path.dirname(os.path.abspath(__file__)), "earlier"),
    signatures={
        "kat_earlier_compact_flagged": [_P, _P, _P, _INT, _P, _I64, _P, _P,
                                        _P, _I64, _P, _P, _P],
        "kat_earlier_compact_flagged_scratch": [_I64],
        "kat_earlier_sort_words": [_P, _P, _P, _P, _I64, _INT, _INT, _P],
        "kat_earlier_sort_words_pairs": [_P, _P, _P, _P, _P, _P, _P, _I64,
                                         _INT, _INT, _P],
        "kat_earlier_sort_words_scratch": [_I64, _INT, _INT],
        "kat_earlier_merge_runs": [_P, _P, _P, _I64, _I64, _P],
        "kat_earlier_merge_runs_words": [_P, _I64, _P, _P, _I64, _I64, _INT,
                                         _P],
        "kat_earlier_binned_sums": [_P, _P, _INT, _I64, _P, _INT, _P, _P],
        "kat_earlier_sort_chunks": [_P, _P, _I64, _INT, _P],
    })


def _call(name: str, dev: torch.device, *args) -> None:
    lib = LIBRARY.get()
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*args,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def compact_flagged(planes, flag: torch.Tensor, out_size: int):
    """The four-launch K4 (the flags read twice)."""
    dev = flag.device
    n = flag.numel()
    outs = tuple(torch.empty(out_size, dtype=torch.int32, device=dev)
                 for _ in planes)
    n_kept = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(
        int(LIBRARY.get().kat_earlier_compact_flagged_scratch(n)),
        dtype=torch.int64, device=dev)
    pad = [None] * (3 - len(planes))
    _call("kat_earlier_compact_flagged", dev,
          *[p.data_ptr() for p in planes], *pad, len(planes),
          flag.data_ptr(), n, *[o.data_ptr() for o in outs], *pad, out_size,
          scratch.data_ptr(), n_kept.data_ptr())
    return (*outs, n_kept[0])


def sort_words(keys: torch.Tensor, top_bits: int,
               values: torch.Tensor | None = None):
    """The W-word LSD sort (carrying values when given): keys [W, n]
    contiguous; returns keys, or (keys, values)."""
    W, n = keys.shape
    dev = keys.device
    out, alt = torch.empty_like(keys), torch.empty_like(keys)
    scratch = torch.empty(
        int(LIBRARY.get().kat_earlier_sort_words_scratch(n, W, top_bits)),
        dtype=torch.int32, device=dev)
    if values is None:
        _call("kat_earlier_sort_words", dev, keys.data_ptr(), out.data_ptr(),
              alt.data_ptr(), scratch.data_ptr(), n, W, top_bits)
        return out
    vout, valt = torch.empty_like(values), torch.empty_like(values)
    _call("kat_earlier_sort_words_pairs", dev, keys.data_ptr(),
          values.data_ptr(), out.data_ptr(), vout.data_ptr(), alt.data_ptr(),
          valt.data_ptr(), scratch.data_ptr(), n, W, top_bits)
    return out, vout


def merge_runs(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """The merge-path tree over one-word keys [n]: log2(runs) launches."""
    n = keys.numel()
    out = torch.empty_like(keys)
    tmp = torch.empty_like(keys) if n > 2 * run_len else None
    _call("kat_earlier_merge_runs", keys.device, keys.data_ptr(),
          out.data_ptr(), None if tmp is None else tmp.data_ptr(), n, run_len)
    return out


def merge_runs_words(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """The merge-path tree over [W, n] keys (each plane contiguous)."""
    W, n = keys.shape
    out = torch.empty((W, n), dtype=torch.int64, device=keys.device)
    tmp = torch.empty_like(out) if n > 2 * run_len else None
    _call("kat_earlier_merge_runs_words", keys.device, keys.data_ptr(),
          keys.stride(0), out.data_ptr(),
          None if tmp is None else tmp.data_ptr(), n, run_len, W)
    return out


def _binned(packed: torch.Tensor, masks: torch.Tensor, requests):
    """The one-pass window kernel: the requests' bins back to back."""
    out = torch.zeros(sum(mod for _d, mod, _m in requests),
                      dtype=torch.int64, device=packed.device)
    req = (ctypes.c_int64 * (3 * len(requests)))(
        *[v for r in requests for v in r])
    _call("kat_earlier_binned_sums", packed.device, packed.data_ptr(),
          masks.view(torch.uint8).data_ptr(), masks.shape[0],
          packed.numel(), ctypes.addressof(req), len(requests),
          out.data_ptr())
    return out


def packed_sums(packed: torch.Tensor, masks: torch.Tensor, requests):
    """The one-pass window kernel: one int64 [mod] tensor per request."""
    return tuple(_binned(packed, masks, requests).split(
        [mod for _d, mod, _m in requests]))


def binned_sums(bins: torch.Tensor, masks: torch.Tensor,
                total_bins: int) -> torch.Tensor:
    """The one-pass window kernel: int64 [M, total_bins]."""
    return _binned(bins, masks, [(1, total_bins, m)
                                 for m in range(masks.shape[0])]).view(
        masks.shape[0], total_bins)


def sort_chunks(keys: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """The bitonic chunk sort."""
    out = torch.empty_like(keys)
    _call("kat_earlier_sort_chunks", keys.device, keys.data_ptr(),
          out.data_ptr(), keys.numel() // chunk_elems,
          chunk_elems.bit_length() - 1)
    return out
