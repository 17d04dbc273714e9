"""K1: sort of int64 k-mer keys, alone (the fresh windows of the counting
flush) or carrying one int32 value each (the queries of the sort-merge join).

Counterpart of kat_tpu/ops/sort_kernel.py (`sort_planes_padded`, full-sort
mode of `_window_kernel`).  On a CUDA tensor `sort_keys` and `sort_pairs`
launch the LSD radix sort of csrc/sort.cu; on a CPU tensor they take the
plain versions, `sort_keys_plain` and `sort_pairs_plain`.  No padding to a
power of two: the radix sort takes any length.
"""

from __future__ import annotations

import torch

from . import _cuda


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ascending sort (SENTINEL = INT64_MAX last)."""
    return torch.sort(keys).values


def _check(keys: torch.Tensor, key_bits: int, name: str) -> None:
    _cuda.require(keys, "keys", torch.int64)
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits={key_bits} outside [1, 63]")
    if keys.numel() >= 1 << 31:
        raise ValueError(f"{name}: n={keys.numel()} must be < 2^31")


def sort_keys(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Ascending sort of a 1-D int64 key tensor, returned as a new tensor.

    key_bits: every non-sentinel key must be < 2^(key_bits-1), so that the
    sentinel (INT64_MAX, bit key_bits-1 set) sorts last.  Counting passes
    2k+1; the kernel then sorts only ceil(key_bits / 8) 8-bit digits.
    """
    _check(keys, key_bits, "sort_keys")
    if not _cuda.on_cuda(keys, "sort_keys"):
        return sort_keys_plain(keys)
    n = keys.numel()
    out = torch.empty_like(keys)
    if n == 0:
        return out
    alt = torch.empty_like(keys) if key_bits > 8 else None
    scratch = torch.empty(_cuda.scratch_len("kat_radix_sort_scratch", n),
                          dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort", keys.device, keys.data_ptr(),
                 out.data_ptr(), alt.data_ptr() if alt is not None else None,
                 scratch.data_ptr(), n, key_bits)
    sort_keys.launches += 1
    return out


sort_keys.launches = 0  # kernel launches, read by chip_smoke.py


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version: stable ascending sort, values gathered
    through its permutation."""
    keys, perm = torch.sort(keys, stable=True)
    return keys, values[perm]


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, key_bits: int):
    """Stable ascending sort of 1-D int64 keys carrying one int32 value
    each; returns new (keys, values) tensors.  Equal keys keep their input
    order, which the join relies on.  key_bits as in `sort_keys`."""
    _check(keys, key_bits, "sort_pairs")
    _cuda.require(values, "values", torch.int32, keys.device)
    if values.numel() != keys.numel():
        raise ValueError("keys and values differ in length")
    if not _cuda.on_cuda(keys, "sort_pairs"):
        return sort_pairs_plain(keys, values)
    n = keys.numel()
    out, vout = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return out, vout
    alt = torch.empty_like(keys) if key_bits > 8 else None
    valt = torch.empty_like(values) if key_bits > 8 else None
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_pairs_scratch", n),
        dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort_pairs", keys.device, keys.data_ptr(),
                 values.data_ptr(), out.data_ptr(), vout.data_ptr(),
                 alt.data_ptr() if alt is not None else None,
                 valt.data_ptr() if valt is not None else None,
                 scratch.data_ptr(), n, key_bits)
    sort_pairs.launches += 1
    return out, vout


sort_pairs.launches = 0  # kernel launches, read by chip_smoke.py
