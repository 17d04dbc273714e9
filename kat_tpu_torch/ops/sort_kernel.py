"""K1: sort of int64 k-mer keys, alone (the fresh windows of the counting
flush) or carrying one int32 value each (the queries of the sort-merge join),
and of wide keys of W int64 words, alone (`sort_words`, the fresh windows of
the wide counting flush, core/wide.py) or carrying one int32 value each
(`sort_words_pairs`, the queries of the wide join).
K5: independent sort of every aligned chunk, and K6: merge of sorted runs
(both of the minimizer-bucketed flush, core/bucketed.py; K6 also merges the
runs that arrive at a shard in the sharded flush, narrow and over W
words).

Counterpart of kat_tpu/ops/sort_kernel.py: `sort_planes_padded` (full-sort
mode of `_window_kernel`), `bitonic_sort_chunks` (chunk mode) and
`bitonic_merge_runs` (runs mode).  On a CUDA tensor `sort_keys`,
`sort_pairs`, `sort_words` and `sort_words_pairs` launch the one-sweep LSD
radix sort of
csrc/sort.cu,
`sort_chunks` the shared-memory bitonic sort of csrc/chunk_sort.cu and
`merge_runs` / `merge_runs_words` (K6 over W words, the arrival merge of
the sharded flush, parallel/sharded.py) the merge-path tree of
csrc/merge_runs.cu; on a CPU tensor they
take the plain versions (`*_plain`).  No padding to a power of two: the radix sort and the
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
    # the kernel's status words keep a count in 30 bits
    if keys.numel() >= 1 << 30:
        raise ValueError(f"{name}: n={keys.numel()} must be < 2^30")


def tile_len(with_values: bool) -> int:
    """Keys (or pairs) one thread block of the card's sort takes, as the
    compiled library reports it."""
    lib = _cuda.LIBRARY.get()
    return int(lib.kat_radix_sort_pairs_tile() if with_values
               else lib.kat_radix_sort_tile())


def pass_floor_bytes(n: int, with_values: bool, key_bits: int) -> int:
    """Bytes the card's sort must move by its pass structure: one read of
    the keys for the histograms, then one read and one write of every key
    (and value) per 8-bit digit of key_bits."""
    passes = (key_bits + 7) // 8
    return n * ((12 + 24 * passes) if with_values else (8 + 16 * passes))


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
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_scratch", n, key_bits),
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
        _cuda.scratch_len("kat_radix_sort_pairs_scratch", n, key_bits),
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


def merge_runs_words_plain(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Plain PyTorch version of `merge_runs_words`: the plain W-word sort
    (the runs' order is no help to it)."""
    return sort_words_plain(keys)


def merge_runs_words(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Merge the ascending runs keys[:, r*run_len : (r+1)*run_len] of
    [W, n] int64 wide keys (word 0 most significant, 2 <= W <= 9) into one
    ascending lexicographic stream, returned as a new contiguous [W, n]
    tensor; each word's plane must be contiguous (planes may lie apart).
    Any length and any run_len >= 1: the last run may be short.  Keys
    compare as signed int64 words, so SENTINEL tails merge last."""
    _cuda.require_words(keys, "keys")
    if run_len < 1:
        raise ValueError(f"run_len={run_len} < 1")
    W, n = keys.shape
    if n >= 1 << 40:
        raise ValueError(f"merge_runs_words: n={n} must be < 2^40")
    if not _cuda.on_cuda(keys, "merge_runs_words"):
        return merge_runs_words_plain(keys, run_len)
    out = torch.empty((W, n), dtype=torch.int64, device=keys.device)
    if n == 0:
        return out
    if keys.stride(0) < n:  # planes overlap (a broadcast view)
        keys = keys.contiguous()
    tmp = torch.empty_like(out) if n > 2 * run_len else None
    _cuda.launch("kat_merge_runs_words", keys.device, keys.data_ptr(),
                 keys.stride(0), out.data_ptr(),
                 tmp.data_ptr() if tmp is not None else None, n, run_len, W)
    merge_runs_words.launches += 1
    return out


merge_runs_words.launches = 0  # kernel launches, read by chip_smoke.py


def words_order_plain(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts [W, n] keys stably: W stable torch.sort
    calls from the least significant word up, each through the last's
    order."""
    perm = None
    for w in reversed(range(keys.shape[0])):
        col = keys[w] if perm is None else keys[w][perm]
        idx = torch.sort(col, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def sort_words_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `sort_words`."""
    return keys[:, words_order_plain(keys)]


def words_passes(n_words: int, top_bits: int) -> int:
    """8-bit digit passes of the W-word sort: 8 over each lower word (62
    bits), ceil(top_bits / 8) over the top word."""
    return 8 * (n_words - 1) + (top_bits + 7) // 8


def words_tile_len(n_words: int) -> int:
    """Keys one thread block of the card's W-word sort takes, as the
    compiled library reports it for W words."""
    return int(_cuda.LIBRARY.get().kat_radix_sort_words_tile(n_words))


def words_pass_floor_bytes(n: int, n_words: int, top_bits: int,
                           with_values: bool = False) -> int:
    """Bytes the card's W-word sort must move by its pass structure: one
    read of every word for the histograms, then one read and one write of
    every word of every key (and its value) per pass."""
    passes = words_passes(n_words, top_bits)
    return n * (8 * n_words * (1 + 2 * passes)
                + (8 * passes if with_values else 0))


def _check_words(keys: torch.Tensor, top_bits: int, name: str) -> None:
    _cuda.require_words(keys, name)
    if not 1 <= top_bits <= 63:
        raise ValueError(f"top_bits={top_bits} outside [1, 63]")
    # the kernel's status words keep a count in 30 bits
    if keys.shape[1] >= 1 << 30:
        raise ValueError(f"{name}: n={keys.shape[1]} must be < 2^30")


def sort_words(keys: torch.Tensor, top_bits: int) -> torch.Tensor:
    """Ascending lexicographic sort of [W, n] int64 wide keys (word 0 most
    significant), returned as a new contiguous [W, n] tensor.

    top_bits: every non-sentinel key's top word is < 2^(top_bits-1), so
    that the sentinel (INT64_MAX in every word) sorts last; counting passes
    2 top_bases(k) + 1.  Lower words are < 2^62."""
    _check_words(keys, top_bits, "sort_words")
    if not _cuda.on_cuda(keys, "sort_words"):
        return sort_words_plain(keys)
    keys = keys.contiguous()
    W, n = keys.shape
    out = torch.empty_like(keys)
    if n == 0:
        return out
    alt = torch.empty_like(keys)
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_words_scratch", n, W, top_bits),
        dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort_words", keys.device, keys.data_ptr(),
                 out.data_ptr(), alt.data_ptr(), scratch.data_ptr(), n, W,
                 top_bits)
    sort_words.launches += 1
    return out


sort_words.launches = 0  # kernel launches, read by chip_smoke.py


def sort_words_pairs_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version of `sort_words_pairs`: the stable W-word
    permutation gathers keys and values."""
    perm = words_order_plain(keys)
    return keys[:, perm], values[perm]


def sort_words_pairs(keys: torch.Tensor, values: torch.Tensor,
                     top_bits: int):
    """Stable ascending lexicographic sort of [W, n] int64 wide keys
    carrying one int32 value each; returns new (keys [W, n] contiguous,
    values [n]).  Equal keys keep their input order, which the wide join
    relies on.  top_bits as in `sort_words`."""
    _check_words(keys, top_bits, "sort_words_pairs")
    _cuda.require(values, "values", torch.int32, keys.device)
    if values.numel() != keys.shape[1]:
        raise ValueError("keys and values differ in length")
    if not _cuda.on_cuda(keys, "sort_words_pairs"):
        return sort_words_pairs_plain(keys, values)
    keys = keys.contiguous()
    W, n = keys.shape
    out, vout = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return out, vout
    alt, valt = torch.empty_like(keys), torch.empty_like(values)
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_words_scratch", n, W, top_bits),
        dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort_words_pairs", keys.device, keys.data_ptr(),
                 values.data_ptr(), out.data_ptr(), vout.data_ptr(),
                 alt.data_ptr(), valt.data_ptr(), scratch.data_ptr(), n, W,
                 top_bits)
    sort_words_pairs.launches += 1
    return out, vout


sort_words_pairs.launches = 0  # kernel launches, read by chip_smoke.py
