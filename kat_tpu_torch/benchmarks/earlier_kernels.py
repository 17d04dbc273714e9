"""The kernels that the current K4 and W-word K1 replaced (the four-launch
compaction, the W-word LSD sort over every digit of every word), built
from benchmarks/earlier/ into a library of their own, so that
chip_smoke.py and the benchmarks can time the current kernels against them
on the same card.  The port never calls them.  Same inputs and outputs
as `reduce_kernel.compact_flagged`, `sort_kernel.sort_words` and
`sort_kernel.sort_words_pairs`, CUDA tensors only."""

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
