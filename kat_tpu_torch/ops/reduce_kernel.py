"""K3: reduce-by-key of a sorted (key, weight) stream, compacted to the front.

Counterpart of kat_tpu/ops/reduce_kernel.py::reduce_compact_sorted.  On a
CUDA tensor `reduce_by_key` launches the scan-based kernels of
csrc/reduce.cu; on a CPU tensor it takes the plain version,
`reduce_by_key_plain`.  kat_tpu's compaction kernel (`compact_flagged`) is
not ported yet.
"""

from __future__ import annotations

import torch

from ..core.kmers import SENTINEL
from . import _cuda


def reduce_by_key_plain(keys: torch.Tensor, w: torch.Tensor, out_size: int):
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
    return out_keys, out_counts, torch.tensor(runs.numel(), dtype=torch.int64,
                                              device=keys.device)


def reduce_by_key(keys: torch.Tensor, w: torch.Tensor, out_size: int):
    """Reduce a sorted int64 key stream with int32 weights to its runs.

    Returns (keys int64 [out_size], counts int32 [out_size], n_unique):
    each non-sentinel run's key and summed weight, in stream order, padded
    with SENTINEL / 0.  n_unique (a 0-d int64 tensor) is the true number of
    such runs, even when it exceeds out_size; the caller then grows.
    Sentinel runs are never emitted, wherever they lie in the stream.
    """
    _cuda.require(keys, "keys", torch.int64)
    _cuda.require(w, "w", torch.int32, keys.device)
    if w.numel() != keys.numel():
        raise ValueError("keys and w differ in length")
    if out_size < 0:
        raise ValueError(f"out_size={out_size} < 0")
    if not _cuda.on_cuda(keys, "reduce_by_key"):
        return reduce_by_key_plain(keys, w, out_size)
    dev = keys.device
    out_keys = torch.empty(out_size, dtype=torch.int64, device=dev)
    out_counts = torch.empty(out_size, dtype=torch.int32, device=dev)
    n_unique = torch.empty(1, dtype=torch.int64, device=dev)
    n = keys.numel()
    scratch = torch.empty(
        _cuda.scratch_len("kat_reduce_by_key_scratch", n, out_size),
        dtype=torch.int64, device=dev)
    _cuda.launch("kat_reduce_by_key", dev, keys.data_ptr(), w.data_ptr(), n,
                 out_keys.data_ptr(), out_counts.data_ptr(), out_size,
                 scratch.data_ptr(), n_unique.data_ptr())
    reduce_by_key.launches += 1
    return out_keys, out_counts, n_unique[0]


reduce_by_key.launches = 0  # kernel launches, read by chip_smoke.py
