"""K1: sort of int64 k-mer keys, alone (the fresh windows of the counting
flush) or carrying one int32 value each (the queries of the sort-merge join).
K5: independent sort of every aligned chunk, and K6: merge of sorted runs
(both of the minimizer-bucketed flush, core/bucketed.py).

Counterpart of kat_tpu/ops/sort_kernel.py: `sort_planes_padded` (full-sort
mode of `_window_kernel`), `bitonic_sort_chunks` (chunk mode) and
`bitonic_merge_runs` (runs mode).  On a CUDA tensor `sort_keys` and
`sort_pairs` launch the LSD radix sort of csrc/sort.cu, `sort_chunks` the
shared-memory bitonic sort of csrc/chunk_sort.cu and `merge_runs` the
merge-path tree of csrc/merge_runs.cu; on a CPU tensor they take the plain
versions (`*_plain`).  No padding to a power of two: the radix sort and the
run merge take any length.
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


MIN_CHUNK, MAX_CHUNK = 1 << 5, 1 << 14  # what csrc/chunk_sort.cu takes


def sort_chunks_plain(keys: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Plain PyTorch version: a row-wise sort of the [chunks, chunk_elems]
    view."""
    return keys.view(-1, chunk_elems).sort(dim=1).values.reshape(-1)


def sort_chunks(keys: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Sort every aligned span of `chunk_elems` int64 keys ascending, each
    on its own, into a new tensor: sentinels (INT64_MAX) end up at each
    chunk's tail.  Keys compare as signed int64, all 64 bits (so there is
    no key_bits to pass).

    chunk_elems: a power of two in [32, 16384] (one thread block holds a
    chunk in shared memory) that divides len(keys)."""
    _cuda.require(keys, "keys", torch.int64)
    if not (MIN_CHUNK <= chunk_elems <= MAX_CHUNK) or \
            chunk_elems & (chunk_elems - 1):
        raise ValueError(f"chunk_elems={chunk_elems} must be a power of two "
                         f"in [{MIN_CHUNK}, {MAX_CHUNK}]")
    if keys.numel() % chunk_elems:
        raise ValueError(f"n={keys.numel()} must be a multiple of "
                         f"chunk_elems={chunk_elems}")
    if not _cuda.on_cuda(keys, "sort_chunks"):
        return sort_chunks_plain(keys, chunk_elems)
    out = torch.empty_like(keys)
    if keys.numel() == 0:
        return out
    _cuda.launch("kat_sort_chunks", keys.device, keys.data_ptr(),
                 out.data_ptr(), keys.numel() // chunk_elems,
                 chunk_elems.bit_length() - 1)
    sort_chunks.launches += 1
    return out


sort_chunks.launches = 0  # kernel launches, read by chip_smoke.py


def merge_runs_plain(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Plain PyTorch version: a full sort (the runs' order is no help to
    it)."""
    return torch.sort(keys).values


def merge_runs(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Merge the ascending runs keys[r*run_len : (r+1)*run_len] into one
    ascending stream, returned as a new tensor.  Any length and any
    run_len >= 1: the last run may be short."""
    _cuda.require(keys, "keys", torch.int64)
    if run_len < 1:
        raise ValueError(f"run_len={run_len} < 1")
    if keys.numel() >= 1 << 40:
        raise ValueError(f"merge_runs: n={keys.numel()} must be < 2^40")
    if not _cuda.on_cuda(keys, "merge_runs"):
        return merge_runs_plain(keys, run_len)
    n = keys.numel()
    out = torch.empty_like(keys)
    if n == 0:
        return out
    tmp = torch.empty_like(keys) if n > 2 * run_len else None
    _cuda.launch("kat_merge_runs", keys.device, keys.data_ptr(),
                 out.data_ptr(), tmp.data_ptr() if tmp is not None else None,
                 n, run_len)
    merge_runs.launches += 1
    return out


merge_runs.launches = 0  # kernel launches, read by chip_smoke.py
