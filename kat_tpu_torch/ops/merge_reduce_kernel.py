"""K2 + K3 fused: the counting flush's merge of the resident table with the
sorted fresh keys, reduced by key straight into the new table
(`merge_reduce`).

Fuses kat_tpu/ops/merge_kernel.py:73 (K2, here `merge_kernel.merge_sorted`)
with kat_tpu/ops/reduce_kernel.py:147 (K3, `reduce_kernel.reduce_by_key`).
On a CUDA tensor it launches the fused kernel of csrc/reduce.cu (K2's
partition, then one block a tile that merges in shared memory and reduces
in the same pass with K3's look-back, then K3's padding launch): the merged
stream is never written to device memory.  What bounds it: device-memory
traffic, 12 na + 8 nb + 12 out_size + 8 bytes (the table read once, the
fresh keys read once, each output slot and the run count written once),
where K2 then K3 move 24 (na + nb) bytes more.  On a CPU tensor it takes the
plain version, K2's and K3's plain versions in a row, which is its
definition.
"""

from __future__ import annotations

import torch

from . import _cuda
from .merge_kernel import merge_sorted_plain
from .reduce_kernel import reduce_by_key_plain

MAX_N = 1 << 30  # the kernel's status words count runs in 30 bits


def tile_len() -> int:
    """Merged elements one thread block of the card's fused kernel takes,
    as the compiled library reports it."""
    return int(_cuda.LIBRARY.get().kat_merge_reduce_tile())


def merge_reduce_plain(table_keys: torch.Tensor, table_counts: torch.Tensor,
                       fresh_keys: torch.Tensor, out_size: int):
    """Plain PyTorch version: K2's plain merge, then K3's plain reduce."""
    return reduce_by_key_plain(
        *merge_sorted_plain(table_keys, table_counts, fresh_keys), out_size)


def merge_reduce(table_keys: torch.Tensor, table_counts: torch.Tensor,
                 fresh_keys: torch.Tensor, out_size: int):
    """Reduce the stable merge of a sorted table (int64 keys, int32 counts)
    with sorted fresh int64 keys, each weighing (key != SENTINEL), to its
    runs: what `reduce_by_key(*merge_sorted(...), out_size)` returns.

    Returns (keys int64 [out_size], counts int32 [out_size], n_unique): each
    non-sentinel run's key and summed weight (mod 2^32) in key order, padded
    with SENTINEL / 0, and the true number of such runs (a 0-d int64
    tensor) even past out_size; writes at or past out_size are dropped.
    Takes fewer than 2^30 keys in all."""
    _cuda.require(table_keys, "table_keys", torch.int64)
    dev = table_keys.device
    _cuda.require(table_counts, "table_counts", torch.int32, dev)
    _cuda.require(fresh_keys, "fresh_keys", torch.int64, dev)
    if table_counts.numel() != table_keys.numel():
        raise ValueError("table_keys and table_counts differ in length")
    if out_size < 0:
        raise ValueError(f"out_size={out_size} < 0")
    na, nb = table_keys.numel(), fresh_keys.numel()
    if na + nb >= MAX_N:
        raise ValueError(f"merge_reduce: na + nb = {na + nb} must be < 2^30")
    if not _cuda.on_cuda(table_keys, "merge_reduce"):
        return merge_reduce_plain(table_keys, table_counts, fresh_keys,
                                  out_size)
    out_keys = torch.empty(out_size, dtype=torch.int64, device=dev)
    out_counts = torch.empty(out_size, dtype=torch.int32, device=dev)
    n_unique = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(_cuda.scratch_len("kat_merge_reduce_scratch",
                                            na + nb),
                          dtype=torch.int64, device=dev)
    _cuda.launch("kat_merge_reduce", dev, table_keys.data_ptr(),
                 table_counts.data_ptr(), na, fresh_keys.data_ptr(), nb,
                 out_keys.data_ptr(), out_counts.data_ptr(), out_size,
                 scratch.data_ptr(), n_unique.data_ptr())
    merge_reduce.launches += 1
    return out_keys, out_counts, n_unique[0]


merge_reduce.launches = 0  # kernel launches, read by chip_smoke.py
