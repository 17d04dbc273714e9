"""Narrow k-mer extraction (k <= 31): every k-window of a batch of base
codes as its int64 key (`extract_keys`), in one pass.

Replaces no TPU kernel: kat_tpu extracts with jnp
(kat_tpu/core/kmers.py::extract_kmers), which XLA fuses on the TPU.  On a
CUDA tensor `extract_keys` launches the kernel of csrc/extract.cu, which
reads each code once and writes each key once (its bound: 11.0 us for a
[4096, 1024] batch at k = 27 at 3.35 TB/s), cutting every window from
codes packed 2 bits a base in shared memory; on a CPU tensor it takes the
plain version, core/kmers.extract_keys_plain (k rounds of elementwise
kernels over int64 buffers).
"""

from __future__ import annotations

import torch

from ..core.kmers import extract_keys_plain, windows_of
from . import _cuda


def extract_keys(codes: torch.Tensor, k: int,
                 canonical: bool = True) -> torch.Tensor:
    """The key of every k-window of [..., L] uint8 codes, 1 <= k <= 31:
    int64 [..., L - k + 1] on the device of `codes`.  A key is min(forward,
    reverse complement) when `canonical`, else the forward key, packed as
    jellyfish packs it; a window holding a code >= 4 gets SENTINEL.  Any
    leading batch shape and any strides are taken (a CUDA batch is made
    contiguous first); the card's kernel takes rows of fewer than
    2^31 - 4096 codes."""
    n_win = windows_of(codes, k)
    if not _cuda.on_cuda(codes, "extract_keys"):
        return extract_keys_plain(codes, k, canonical)
    if codes.dtype != torch.uint8:
        raise TypeError(f"extract_keys: expected torch.uint8 codes, got "
                        f"{codes.dtype}")
    L = codes.shape[-1]
    flat = codes.reshape(-1, L).contiguous()
    dev = codes.device
    out = torch.empty(codes.shape[:-1] + (n_win,), dtype=torch.int64,
                      device=dev)
    if out.numel():
        _cuda.launch("kat_extract_kmers", dev, flat.data_ptr(),
                     flat.shape[0], L, k, int(canonical), out.data_ptr())
        extract_keys.launches += 1
    return out


extract_keys.launches = 0  # kernel launches, read by tests and chip_smoke.py
