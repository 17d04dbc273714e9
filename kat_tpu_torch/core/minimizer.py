"""Minimizer-bucketed key transform for the chunked counting flush.

Port of kat_tpu/core/minimizer.py.  If the fresh stream arrives PRE-GROUPED
into buckets that are a prefix of the sort order, each aligned chunk sorts
on its own inside one thread block's shared memory, in ONE pass over device
memory (ops/sort_kernel.sort_chunks): the KMC2 / minimizer super-k-mer
idea.  The variable-length grouping happens on the host (the router of
native/fastxio.cpp, bound in io/native.py); the device only sees a
fixed [chunks, records] geometry.

All k-mers of one bucket share an m-base minimizer, so the key is
re-encoded without its redundant minimizer bases:

    key' = [ mix26(minimizer) | pos | strand | rest ]
           (26 + 5 + 1 + 2(k-m) bits)

  - minimizer: the smallest canonical m-mer (min of substring and its
    reverse complement) over the canonical k-mer's k-m+1 positions.
  - mix26: an INVERTIBLE 26-bit mixer, so the top bits of key' are uniform
    for any genome and finish() can decode the table back to plain keys.
  - pos: leftmost position of the minimizer in the canonical k-mer.
  - strand: 1 iff the canonical m-mer at pos is the reverse complement of
    the k-mer's forward substring there (m is odd, so never both).
  - rest: the other 2(k-m) bits of the k-mer, in order.

key' <-> key is a bijection, so equal counts aggregate identically; the
count table is sorted by key' during counting and re-sorted by key once at
finish().  Buckets = top bits of key' = top bits of mix26(minimizer).

One int64 per key' and one per record, where kat_tpu carries (hi, lo)
uint32 planes.  Everything here is plain elementwise torch, as it is plain
XLA in kat_tpu: no kernel of its own.

**The 64-bit form.**  With m = 13, key' takes 2k + 6 bits: 60 at k = 27,
64 at k = 29.  The port's keys are signed int64 with SENTINEL = INT64_MAX,
and kat_tpu orders key' unsigned.  So where key' takes all 64 bits it is
stored with bit 63 flipped (`keyp_flip`): signed order of the stored form
equals unsigned order of key', and the unsigned all-ones sentinel becomes
INT64_MAX.  (A real key' never has all of its top 32 bits set: pos <= 16.)
The kernels that order key' compare signed int64 and need no special case.

`>>` on int64 is arithmetic: every right shift below is masked.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import (SENTINEL, _rev2, join_u64, key_mask,
                    reverse_complement)

M_DEFAULT = 13
M26 = (1 << 26) - 1
POS_BITS = 5
_POS_MASK = (1 << POS_BITS) - 1
_U32 = 0xFFFFFFFF

# Invertible 26-bit mixer constants (odd multipliers; the xorshift by 13 is
# its own inverse since 13 >= 26/2).  They must match the router's
# (native/fastxio.cpp SMR_MIX_A / SMR_MIX_B).
_MIX_A = 41474379
_MIX_B = 56006713
_MIX_A_INV = pow(_MIX_A, -1, 1 << 26)
_MIX_B_INV = pow(_MIX_B, -1, 1 << 26)


def supports(k: int, m: int = M_DEFAULT) -> bool:
    """Can the bucketed path encode k with this minimizer width?  m must
    be odd (no self-rc m-mers, so the strand bit is unambiguous)."""
    return m < k <= m + 16 and m <= 15 and m % 2 == 1


def _require(k: int, m: int) -> None:
    if not supports(k, m):
        raise ValueError(f"bucketed path unsupported for k={k}, m={m}")


def keyp_bits(k: int, m: int = M_DEFAULT) -> int:
    return 2 * m + POS_BITS + 1 + 2 * (k - m)


def keyp_flip(k: int, m: int = M_DEFAULT) -> int:
    """What a stored key' is XORed with: INT64_MIN where key' takes all 64
    bits (so that signed order is key' order), else 0."""
    return -(1 << 63) if keyp_bits(k, m) == 64 else 0


def _mix(x, a: int, b: int):
    """Works on Python ints and int64 tensors alike (26-bit values: the
    products stay below 2^52)."""
    x = x ^ (x >> 13)
    x = (x * a) & M26
    x = x ^ (x >> 13)
    x = (x * b) & M26
    return x ^ (x >> 13)


def mix26(x):
    """Invertible mixer on 26-bit values (int64 tensors or ints)."""
    return _mix(x, _MIX_A, _MIX_B)


def unmix26(x):
    """Inverse of mix26."""
    return _mix(x, _MIX_B_INV, _MIX_A_INV)


def _pack_cand(cm, pos, strand):
    """(value | pos | strand) in one integer whose min is the smallest
    value at the smallest pos."""
    return (cm << (POS_BITS + 1)) | (pos << 1) | strand


def minimizer_device(keys: torch.Tensor, k: int, m: int = M_DEFAULT):
    """(min_value, leftmost_pos, strand) of the canonical m-mers over packed
    canonical k-mers.  The rc m-mer at canonical pos j is the rc key's m-mer
    at k-m-j, so each position costs two masked shifts and a min."""
    rc = reverse_complement(keys, k)
    mm = key_mask(m)
    best = None
    for j in range(k - m + 1):
        f = (keys >> (2 * (k - j - m))) & mm
        r = (rc >> (2 * j)) & mm
        cand = _pack_cand(torch.minimum(f, r), j, (r < f).to(torch.int64))
        best = cand if best is None else torch.minimum(best, cand)
    return (best >> (POS_BITS + 1), (best >> 1) & _POS_MASK, best & 1)


def _assemble_keyp(c, minval, minpos, strand, k: int, m: int):
    """Stored key' from canonical keys and their minimizer triples."""
    rb = 2 * (k - m)
    # rest = bases [0, pos) ++ bases [pos+m, k)
    bot_bits = 2 * ((k - m) - minpos)           # in [0, rb]
    top = c >> (2 * m + bot_bits)               # c >= 0
    bot = c & ((torch.ones_like(c) << bot_bits) - 1)
    rest = (top << bot_bits) | bot
    head = (((mix26(minval) << POS_BITS) | minpos) << 1) | strand  # 32 bits
    if keyp_flip(k, m):
        # bit 63 flipped = head's top bit flipped: head - 2^31 is the
        # signed top word, and the product cannot overflow
        return ((head - (1 << 31)) * (1 << rb)) | rest
    return (head << rb) | rest


def encode_keys(keys: torch.Tensor, k: int, m: int = M_DEFAULT):
    """Canonical packed int64 keys -> stored key'.  SENTINEL passes through
    and still sorts last."""
    _require(k, m)
    minval, minpos, strand = minimizer_device(keys, k, m)
    keyp = _assemble_keyp(keys, minval, minpos, strand, k, m)
    return torch.where(keys == SENTINEL, keys, keyp)


def decode_keys(keyp: torch.Tensor, k: int, m: int = M_DEFAULT):
    """Inverse of encode_keys (SENTINEL passes through)."""
    _require(k, m)
    rb = 2 * (k - m)
    u = keyp ^ keyp_flip(k, m)
    head = (u >> rb) & _U32
    strand = head & 1
    # a sentinel's pos field reads 31: clamp, its result is discarded
    minpos = ((head >> 1) & _POS_MASK).clamp_max(k - m)
    minval = unmix26((head >> (1 + POS_BITS)) & M26)
    # the k-mer's forward substring at minpos: rc of minval if the
    # canonical m-mer was the rc strand
    sub = torch.where(strand != 0, reverse_complement(minval, m), minval)
    rest = u & ((1 << rb) - 1)
    bot_bits = 2 * ((k - m) - minpos)
    top = rest >> bot_bits                      # rest >= 0
    bot = rest & ((torch.ones_like(rest) << bot_bits) - 1)
    c = (((top << (2 * m)) | sub) << bot_bits) | bot
    return torch.where(keyp == SENTINEL, keyp, c)


# ---------------------------------------------------------------------------
# Supermer records: the host router's on-the-wire format.
#
# One 64-bit word per record: [ len (3 bits, 63..61) | bases (2*(k-1+S)
# bits, LEFT-aligned at bit 2*(k-1+S)-1 .. 0 of the field) ], where
# S = rec_windows(k) is the fixed per-record window budget.  A record holds
# `len` consecutive windows (len in 0..S; 0 = padding record); window j
# spans bases j..j+k-1, i.e. bits [F - 2(k+j), F - 2j) with F = 2*(k-1+S).
# As int64 a record with len >= 4 is negative.
# ---------------------------------------------------------------------------


def rec_windows(k: int) -> int:
    """Windows per 64-bit supermer record: the largest POWER OF TWO S with
    2*(k-1+S) + 3 <= 64 (so chunk_slots = rec_per_chunk * S stays a power
    of two); the len field is 3 bits."""
    s = (64 - 3) // 2 - (k - 1)
    if s < 1:
        raise ValueError(f"k={k} too large for 64-bit supermer records")
    return 4 if s >= 4 else (2 if s >= 2 else 1)


def _min_of(tensors):
    best = None
    for t in tensors:
        best = t if best is None else torch.minimum(best, t)
    return best


def expand_records(rec: torch.Tensor, k: int, m: int = M_DEFAULT,
                   canonical: bool = True):
    """Supermer records -> per-window stored key'.

    The record's reverse complement is computed ONCE, so every window's rc
    and every minimizer candidate's rc strand are masked shifts; candidate
    (value, pos, strand) triples pack into one integer whose min is the
    leftmost minimizer, computed per RECORD position and min-reduced per
    window (the stretch all S windows share is reduced once).

    Args:
      rec: int64 records, ANY shape (kept).
    Returns:
      keyp: [rec_windows(k), *rec.shape] int64 stored key', SENTINEL in
      the slots past a record's length (no valid key' equals it).
      Within-chunk slot ORDER is irrelevant (the chunk sort normalizes
      it), only chunk MEMBERSHIP matters.
    """
    if not canonical:
        raise ValueError("bucketed path requires canonical counting")
    _require(k, m)
    S = rec_windows(k)
    F = 2 * (k - 1 + S)
    ln = (rec >> 61) & 7
    b = rec & ((1 << 61) - 1)
    # rc of the whole record field: complement, reverse the 2-bit groups
    # across 64 bits, realign so the field sits in the low F bits
    g = (_rev2(~b) >> (64 - F)) & ((1 << F) - 1)

    # minimizer candidates per RECORD position t (m-mer over bases
    # t..t+m-1): fwd from the record, rc from the record's rc
    mm = key_mask(m)
    n_cand = (k - m) + S
    cand = []      # pos field t: the min keeps FORWARD-leftmost ties
    cand_rev = []  # pos field n_cand-1-t: keeps FORWARD-RIGHTMOST ties (=
    #                canonical-leftmost when the window canonicalizes to the
    #                rc strand: the tie rule must follow the CANONICAL
    #                orientation, or equal k-mers arriving via opposite
    #                strands would encode different key')
    for t in range(n_cand):
        f = (b >> (F - 2 * (t + m))) & mm
        r = (g >> (2 * t)) & mm
        cm = torch.minimum(f, r)
        strand = (r < f).to(torch.int64)
        cand.append(_pack_cand(cm, t, strand))
        cand_rev.append(_pack_cand(cm, n_cand - 1 - t, strand))
    # the positions every window of the record covers are reduced once
    core = range(S - 1, k - m + 1)
    core_f = [_min_of(cand[t] for t in core)] if core else []
    core_r = [_min_of(cand_rev[t] for t in core)] if core else []

    kmask = key_mask(k)
    keyps = []
    for j in range(S):
        fwd = (b >> (F - 2 * (k + j))) & kmask
        rcw = (g >> (2 * j)) & kmask
        rc_less = rcw < fwd
        c = torch.minimum(fwd, rcw)
        # minimizer of window j = min over candidates t in [j, j+k-m]; the
        # tie orientation follows the window's canonical strand
        own = [t for t in range(j, j + k - m + 1) if t not in core]
        best = torch.where(rc_less,
                           _min_of(core_r + [cand_rev[t] for t in own]),
                           _min_of(core_f + [cand[t] for t in own]))
        minval = best >> (POS_BITS + 1)
        pos_field = (best >> 1) & _POS_MASK
        pos_rec = torch.where(rc_less, (n_cand - 1) - pos_field, pos_field)
        minpos = pos_rec - j            # window-relative, forward strand
        strand = best & 1
        # the candidate scan ran on the FORWARD record; for rc-strand
        # windows mirror the position and flip the strand bit
        minpos = torch.where(rc_less, (k - m) - minpos, minpos)
        strand = torch.where(rc_less, strand ^ 1, strand)
        keyp = _assemble_keyp(c, minval, minpos, strand, k, m)
        keyps.append(torch.where(ln > j, keyp, SENTINEL))
    return torch.stack(keyps)


def bucket_of_keyp(keyp: torch.Tensor, k: int, m: int = M_DEFAULT,
                   bucket_bits: int = 12):
    """Bucket id = top bucket_bits of key' (pure function of the key)."""
    sh = keyp_bits(k, m) - bucket_bits
    return ((keyp ^ keyp_flip(k, m)) >> sh) & ((1 << bucket_bits) - 1)


# ---------------------------------------------------------------------------
# Carried across from kat_tpu (numpy, for the tests that hold both packages)
# ---------------------------------------------------------------------------

def keyp_from_planes(hi, lo, k: int, m: int = M_DEFAULT) -> np.ndarray:
    """kat_tpu's (hi, lo) uint32 key' planes -> stored int64 key'; the
    all-ones pair becomes SENTINEL."""
    u = join_u64(hi, lo)
    out = (u ^ np.uint64(keyp_flip(k, m) & ((1 << 64) - 1))).astype(np.int64)
    out[u == np.uint64(0xFFFFFFFFFFFFFFFF)] = SENTINEL
    return out


def keyp_to_planes(keyp, k: int, m: int = M_DEFAULT):
    """Stored int64 key' (tensor or array) -> kat_tpu's (hi, lo) planes."""
    if isinstance(keyp, torch.Tensor):
        keyp = keyp.cpu().numpy()
    keyp = np.asarray(keyp, np.int64)
    u = keyp.astype(np.uint64) ^ np.uint64(keyp_flip(k, m) & ((1 << 64) - 1))
    u[keyp == SENTINEL] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(_U32)).astype(np.uint32))
