"""K2: merge of the sorted count table with the sorted fresh keys.

Counterpart of kat_tpu/ops/merge_kernel.py::merge_sorted_kernel (the
final-phase mode of kat_tpu's bitonic `_window_kernel`).  On a CUDA tensor
`merge_sorted` launches the merge-path merge of csrc/merge.cu; on a CPU
tensor it takes the plain version, `merge_sorted_plain`.  The output is
exactly len(a) + len(b) long, with no block padding.
"""

from __future__ import annotations

import torch

from ..core.kmers import SENTINEL
from . import _cuda


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
                 out_keys.data_ptr(), out_w.data_ptr())
    merge_sorted.launches += 1
    return out_keys, out_w


merge_sorted.launches = 0  # kernel launches, read by chip_smoke.py
