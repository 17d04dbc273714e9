"""2-bit k-mer encoding and vectorized sliding-window extraction (k <= 31).

Port of kat_tpu/core/kmers.py, narrow half.  A k-mer is ONE int64 value
instead of kat_tpu's (hi, lo) uint32 pair: at k <= 31 it fits in the low 62
bits, and this torch rejects `>>`, `<`, `bincount`, `searchsorted` and
`scatter_add_` on unsigned tensors.

Packing convention (identical to jellyfish so .jf files round-trip):
  base codes A=0, C=1, G=2, T=3; the FIRST character of the k-mer occupies
  the MOST significant bit pair, i.e. ``value = sum(code[i] << 2*(k-1-i))``.
Canonical k-mer = min(forward, reverse-complement)
(mer_dna.hpp:436 `get_canonical`).

Invalid windows (containing a non-ACGT base, or padding) get the sentinel
key INT64_MAX, which sorts after every real k-mer.  kat_tpu's all-ones
(hi, lo) sentinel would be -1 in int64 and sort FIRST; `to_planes` /
`from_planes` convert between the two conventions.
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel key marking invalid / padding windows.  Bit 2k of it is set and
# no real key (< 2^(2k)) has that bit, which the radix sort relies on.
SENTINEL = (1 << 63) - 1

MAX_K = 31  # the packed int64 path

# 256-entry ASCII -> 2-bit code table; 4 = invalid (mirrors mer_dna::code
# returning -1 for non-ACGT, mer_dna.hpp:382).
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _ch, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_LUT[ord(_ch)] = _c
    _CODE_LUT[ord(_ch.lower())] = _c


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> 2-bit codes (0..3) with 4 marking invalid."""
    return _CODE_LUT[buf]


def spec_valid(k: int) -> None:
    if not (1 <= k <= MAX_K):
        raise ValueError(
            f"k={k} out of supported range [1, {MAX_K}] for the packed "
            "int64 k-mer path")


def key_mask(k: int) -> int:
    """Mask covering the 2k used bits of a packed key."""
    spec_valid(k)
    return (1 << (2 * k)) - 1


def extract_kmers(codes: torch.Tensor, k: int, canonical: bool = True):
    """Extract all k-length windows from a batch of encoded sequences.

    Args:
      codes: [..., L] uint8 tensor of 2-bit base codes (>=4 marks invalid /
        padding).  Any leading batch shape is preserved.
      k: k-mer length (1..31).
      canonical: if True return min(fwd, revcomp) per window
        (mer_iterator.hpp:82-87 semantics); else the forward k-mer.

    Returns:
      (keys, valid): int64 / bool tensors of shape [..., L-k+1] on the
      device of `codes`.  Invalid windows carry SENTINEL.
    """
    spec_valid(k)
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")

    c = codes.to(torch.int64)
    shape = codes.shape[:-1] + (W,)
    fwd = torch.zeros(shape, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros(shape, dtype=torch.bool, device=codes.device)
    # k strided views; the accumulators are updated in place so a batch
    # holds three [.., W] buffers however large k is.
    for j in range(k):
        cj = c[..., j:j + W]
        bad |= cj >= 4
        cc = cj & 3
        fwd |= cc << (2 * (k - 1 - j))
        rc |= (cc ^ 3) << (2 * j)
    keys = torch.minimum(fwd, rc) if canonical else fwd
    keys.masked_fill_(bad, SENTINEL)  # in place: keys is a fresh buffer
    return keys, ~bad


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 2-bit groups of int64 values.  Every right shift is
    masked, so the arithmetic shift's sign fill never leaks in."""
    x = ((x & 0x3333333333333333) << 2) | ((x >> 2) & 0x3333333333333333)
    x = ((x & 0x0F0F0F0F0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0F)
    x = ((x & 0x00FF00FF00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF00FF00FF)
    x = ((x & 0x0000FFFF0000FFFF) << 16) | ((x >> 16) & 0x0000FFFF0000FFFF)
    return (x << 32) | ((x >> 32) & 0xFFFFFFFF)


def reverse_complement(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse-complement of packed k-mers (mer_dna.hpp:409 semantics)."""
    # After complement + full 2-bit-group reversal the k-mer sits in the
    # top 2k bits; the masked shift brings it down.
    return (_rev2(~keys) >> (64 - 2 * k)) & key_mask(k)


def canonicalize(keys: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp(key)) per element, preserving SENTINEL padding keys
    (whose revcomp would otherwise alias a real k-mer)."""
    c = torch.minimum(keys, reverse_complement(keys, k))
    return torch.where(keys == SENTINEL, keys, c)


def gc_count(keys: torch.Tensor) -> torch.Tensor:
    """Number of G/C bases in packed k-mers (reference str_utils.hpp:151);
    0 for SENTINEL, as kat_tpu's all-ones planes give.

    With codes A=00, C=01, G=10, T=11 a base is G or C iff its two bits
    differ, so GC = popcount((x ^ (x >> 1)) & 0x5555...).  The popcount is
    the usual SWAR byte sum; every intermediate stays non-negative."""
    y = (keys ^ (keys >> 1)) & 0x5555555555555555
    y = (y & 0x3333333333333333) + ((y >> 2) & 0x3333333333333333)
    y = (y + (y >> 4)) & 0x0F0F0F0F0F0F0F0F
    y = y + (y >> 8)
    y = y + (y >> 16)
    y = (y + (y >> 32)) & 0x7F
    return torch.where(keys == SENTINEL, torch.zeros_like(y), y)


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; small data, used by tests/tools)
# ---------------------------------------------------------------------------

def _rev2_u64_np(x: np.ndarray) -> np.ndarray:
    """Reverse the 2-bit groups of uint64 values (vectorized host-side)."""
    m = np.uint64
    x = ((x & m(0x3333333333333333)) << m(2)) | \
        ((x >> m(2)) & m(0x3333333333333333))
    x = ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4)) | \
        ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F))
    x = ((x & m(0x00FF00FF00FF00FF)) << m(8)) | \
        ((x >> m(8)) & m(0x00FF00FF00FF00FF))
    x = ((x & m(0x0000FFFF0000FFFF)) << m(16)) | \
        ((x >> m(16)) & m(0x0000FFFF0000FFFF))
    return (x << m(32)) | (x >> m(32))


def canonical_np(keys: np.ndarray, k: int) -> np.ndarray:
    """min(key, revcomp) for packed u64 keys (mer_dna.hpp:436 semantics),
    vectorized numpy, for host-side paths that must not touch a device."""
    m = np.uint64
    keys = np.asarray(keys, np.uint64)
    rc = _rev2_u64_np(~keys) >> m(64 - 2 * k)
    rc &= m((1 << (2 * k)) - 1)
    return np.minimum(keys, rc)


def pack_string(s: str) -> int:
    """Pack an ACGT string into the 64-bit integer key (host-side)."""
    v = 0
    for ch in s:
        c = int(_CODE_LUT[ord(ch)])
        if c >= 4:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | c
    return v


def unpack_string(v: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append("ACGT"[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def split_u64(v) -> tuple[np.uint32, np.uint32]:
    v = int(v)
    return np.uint32(v >> 32), np.uint32(v & 0xFFFFFFFF)


def join_u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def from_planes(hi, lo) -> np.ndarray:
    """kat_tpu (hi, lo) uint32 planes -> int64 keys; the all-ones sentinel
    pair becomes SENTINEL."""
    u = join_u64(hi, lo)
    out = u.astype(np.int64)
    out[u == np.uint64(0xFFFFFFFFFFFFFFFF)] = SENTINEL
    return out


def to_planes(keys) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys (tensor or array) -> kat_tpu (hi, lo) uint32 planes, with
    SENTINEL mapped to the all-ones pair."""
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    u = np.asarray(keys, np.int64).astype(np.uint64)
    u[np.asarray(keys) == SENTINEL] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
