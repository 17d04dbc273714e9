"""K1: sort of int64 k-mer keys, for the fresh windows of the counting flush.

Counterpart of kat_tpu/ops/sort_kernel.py (`sort_planes_padded`, full-sort
mode of `_window_kernel`), keys only.  On a CUDA tensor `sort_keys`
launches the LSD radix sort of csrc/sort.cu; on a CPU tensor it takes the
plain version, `sort_keys_plain`.  No padding to a power of two: the radix
sort takes any length.
"""

from __future__ import annotations

import torch

from . import _cuda


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ascending sort (SENTINEL = INT64_MAX last)."""
    return torch.sort(keys).values


def sort_keys(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Ascending sort of a 1-D int64 key tensor, returned as a new tensor.

    key_bits: every non-sentinel key must be < 2^(key_bits-1), so that the
    sentinel (INT64_MAX, bit key_bits-1 set) sorts last.  Counting passes
    2k+1; the kernel then sorts only ceil(key_bits / 8) 8-bit digits.
    """
    _cuda.require(keys, "keys", torch.int64)
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits={key_bits} outside [1, 63]")
    if not _cuda.on_cuda(keys, "sort_keys"):
        return sort_keys_plain(keys)
    n = keys.numel()
    if n >= 1 << 31:
        raise ValueError(f"sort_keys: n={n} must be < 2^31")
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
