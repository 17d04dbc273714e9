"""2-bit k-mer encoding and vectorized sliding-window extraction.

Port of kat_tpu/core/kmers.py.  A narrow k-mer (k <= 31) is ONE int64 value
instead of kat_tpu's (hi, lo) uint32 pair: it fits in the low 62 bits, and
this torch rejects `>>`, `<`, `bincount`, `searchsorted` and `scatter_add_`
on unsigned tensors.

Packing convention (identical to jellyfish so .jf files round-trip):
  base codes A=0, C=1, G=2, T=3; the FIRST character of the k-mer occupies
  the MOST significant bit pair, i.e. ``value = sum(code[i] << 2*(k-1-i))``.
Canonical k-mer = min(forward, reverse-complement)
(mer_dna.hpp:436 `get_canonical`).

Invalid windows (containing a non-ACGT base, or padding) get the sentinel
key INT64_MAX, which sorts after every real k-mer.  kat_tpu's all-ones
(hi, lo) sentinel would be -1 in int64 and sort FIRST; `to_planes` /
`from_planes` convert between the two conventions.

Wide keys (31 < k <= 255) are W = words_for_k(k) = ceil(k / 31) int64
words of 31 bases (62 bits) each, most significant word first, held as one
[W, ...] tensor.  The key is cut from the bottom, so the top word holds the
first top_bases(k) bases.  SENTINEL is INT64_MAX in every word; a real word
is < 2^62, so signed lexicographic order over the words is the numeric
order of the 2k-bit key, as kat_tpu's big-first uint32 words give it
(kat_tpu uses words_for_k of its own: `from_ref_words` / `to_ref_words`
convert, through each key's integer value).
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel key marking invalid / padding windows.  Bit 2k of it is set and
# no real key (< 2^(2k)) has that bit, which the radix sort relies on.
SENTINEL = (1 << 63) - 1

MAX_K = 31  # the packed int64 path
MAX_K_WIDE = 255  # wide keys: words_for_k(k) int64 words
WORD_BASES = 31  # bases in one int64 word of a wide key
_MASK62 = (1 << 62) - 1

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


def _fwd_rc(codes: torch.Tensor, k: int):
    """(forward keys, reverse-complement keys, bad) of every k-window of
    [..., L] codes, k <= 31; the keys of a bad window are garbage."""
    L = codes.shape[-1]
    W = L - k + 1
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
    return fwd, rc, bad


def windows_of(codes: torch.Tensor, k: int) -> int:
    """The k-windows in each row of [..., L] codes, L - k + 1; raises for
    a k outside 1..31 or rows shorter than k."""
    spec_valid(k)
    L = codes.shape[-1]
    if L - k + 1 <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    return L - k + 1


def extract_keys_plain(codes: torch.Tensor, k: int, canonical: bool = True):
    """Plain PyTorch version of ops/extract_kernel.extract_keys: k rounds
    of elementwise kernels over the windows (`_fwd_rc`)."""
    windows_of(codes, k)
    fwd, rc, bad = _fwd_rc(codes, k)
    keys = torch.minimum(fwd, rc) if canonical else fwd
    keys.masked_fill_(bad, SENTINEL)  # in place: keys is a fresh buffer
    return keys


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
      device of `codes`.  Invalid windows carry SENTINEL; every real key
      is below 2^62, so valid is exactly keys != SENTINEL.
    """
    from ..ops.extract_kernel import extract_keys  # ops imports this module

    keys = extract_keys(codes, k, canonical)
    return keys, keys != SENTINEL


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
# Wide keys: 31 < k <= 255, [W, ...] int64 words of 31 bases, most
# significant first (mer_dna's arrays of 64-bit words, mer_dna.hpp).
# ---------------------------------------------------------------------------

def words_for_k(k: int) -> int:
    """Int64 words of a key: ceil(k / 31), so 1 up to k = 31."""
    if not 1 <= k <= MAX_K_WIDE:
        raise ValueError(f"k={k} out of supported range [1, {MAX_K_WIDE}]")
    return -(-k // WORD_BASES)


def top_bases(k: int) -> int:
    """Bases in the top word of a key: k - 31 (W - 1), in [1, 31]."""
    return k - WORD_BASES * (words_for_k(k) - 1)


def wide_spec_valid(k: int) -> None:
    if not MAX_K < k <= MAX_K_WIDE:
        raise ValueError(f"wide keys need {MAX_K} < k <= {MAX_K_WIDE}, "
                         f"got k={k}")


def extract_kmers_wide(codes: torch.Tensor, k: int, canonical: bool = True):
    """extract_kmers for 31 < k <= 255.

    Returns (words [W, ..., L-k+1] int64, valid [..., L-k+1] bool), W =
    words_for_k(k); invalid windows carry SENTINEL in every word.

    Every word of a window is a narrow key of the same read, so two narrow
    extractions and slices replace k rounds over W words (kat_tpu's
    extract_kmers_wide, kmers.py:192-233): forward word i >= 1 is the
    31-mer at s + top + 31 (i - 1) and the top word the top-mer at s
    (top = top_bases(k)); the reverse complement's word i >= 1 is the narrow
    reverse complement of the 31-mer at s + 31 (W - 1 - i), its top word
    that of the top-mer at s + 31 (W - 1)."""
    wide_spec_valid(k)
    L = codes.shape[-1]
    n = L - k + 1
    if n <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")
    W = words_for_k(k)
    top = top_bases(k)
    f31, r31, bad31 = _fwd_rc(codes, WORD_BASES)
    ft, rt, badt = (f31, r31, bad31) if top == WORD_BASES else \
        _fwd_rc(codes, top)

    def win(x, off):
        return x[..., off:off + n]

    fwd = [win(ft, 0)] + [win(f31, top + WORD_BASES * (i - 1))
                          for i in range(1, W)]
    rc = [win(rt, WORD_BASES * (W - 1))] + [
        win(r31, WORD_BASES * (W - 1 - i)) for i in range(1, W)]
    bad = win(badt, 0).clone()
    for i in range(1, W):
        bad |= win(bad31, top + WORD_BASES * (i - 1))
    words = torch.stack(_lex_min(rc, fwd) if canonical else fwd)
    words.masked_fill_(bad, SENTINEL)
    return words, ~bad


def _lex_min(a, b):
    """Word lists of the element-wise lexicographic minimum of a and b."""
    less = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(less)
    for x, y in zip(a, b):
        less |= eq & (x < y)
        eq &= x == y
    return [torch.where(less, x, y) for x, y in zip(a, b)]


def reverse_complement_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of [W, ...] wide keys (mer_dna.hpp:409).

    Read backwards, the key is the narrow reverse complements of its words
    from the bottom up (31 bases each, the top word's top_bases last); the
    result re-cuts that sequence into a top word and 31-base words."""
    W = words.shape[0]
    top = top_bases(k)
    d = WORD_BASES - top  # bases each output word takes from its upper piece
    r = [reverse_complement(words[W - 1 - j], WORD_BASES)
         for j in range(W - 1)] + [reverse_complement(words[0], top)]
    out = [r[0] >> (2 * d)]
    for j in range(1, W):
        low = r[j] if j == W - 1 else r[j] >> (2 * d)
        out.append(((r[j - 1] & ((1 << (2 * d)) - 1)) << (2 * top)) | low)
    return torch.stack(out)


def canonicalize_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """min(key, revcomp(key)) over [W, ...] wide keys, SENTINEL kept."""
    c = torch.stack(_lex_min(list(reverse_complement_words(words, k)),
                             list(words)))
    return torch.where(words[0] == SENTINEL, words, c)


def gc_count_words(words: torch.Tensor) -> torch.Tensor:
    """G/C bases of [W, ...] wide keys (0 for SENTINEL), int64."""
    return sum(gc_count(w) for w in words)



def ref_words(keys: torch.Tensor, k: int) -> torch.Tensor:
    """kat_tpu's big-first uint32 word layout of keys on their device,
    each word carried in int64 (< 2^32): [2, ...] (hi, lo) for narrow int64
    keys (k <= 31), [ref_words_for_k(k), ...] for [W, ...] wide words.
    SENTINEL becomes all ones in every word, as kat_tpu's sentinel.

    uint32 word j from the bottom holds bits [32 j, 32 j + 32) of the key's
    integer value; it is cut from the one or two int64 words that hold
    those bits.  Every operand of a shift is non-negative and masked first,
    so nothing passes 2^63."""
    if k <= MAX_K:
        spec_valid(k)
        out = torch.stack([keys >> 32, keys & 0xFFFFFFFF])
        return torch.where(keys == SENTINEL, 0xFFFFFFFF, out)
    W = words_for_k(k)
    nw = ref_words_for_k(k)
    out = []
    for j in range(nw):
        b, off = divmod(32 * j, 62)
        if b >= W:
            out.append(torch.zeros_like(keys[0]))
            continue
        v = keys[W - 1 - b] >> off
        if off > 30 and b + 1 < W:  # the word's high bits lie in the next
            nxt = keys[W - 2 - b] & ((1 << (off - 30)) - 1)
            v = v | (nxt << (62 - off))
        out.append(v & 0xFFFFFFFF)
    out = torch.stack(out[::-1])
    return torch.where(keys[0] == SENTINEL, 0xFFFFFFFF, out)

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


def rc_int(v: int, k: int) -> int:
    """Reverse complement of a packed k-mer held as a Python int (any k)."""
    r = 0
    for _ in range(k):
        r = (r << 2) | (3 - (v & 3))
        v >>= 2
    return r


def canonical_int(v: int, k: int) -> int:
    return min(v, rc_int(v, k))


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


# wide keys on the host: python ints, [W, n] int64 words, 64-bit limbs

def words_to_int(row) -> int:
    """One key's W words (most significant first) as its integer value."""
    v = 0
    for w in row:
        v = (v << 62) | int(w)
    return v


def ints_to_words(keys, k: int) -> np.ndarray:
    """Python-int keys (< 4^k) -> [W, n] int64 words."""
    keys = [int(v) for v in keys]
    W = words_for_k(k)
    if any(v < 0 or v >> (2 * k) for v in keys):
        raise ValueError(f"a key does not fit {2 * k} bits")
    return np.stack([np.fromiter(((v >> (62 * (W - 1 - i))) & _MASK62
                                  for v in keys), np.int64, len(keys))
                     for i in range(W)]) if keys else \
        np.zeros((W, 0), np.int64)


def _words_to_limbs(words: np.ndarray, n_limbs: int) -> np.ndarray:
    """[W, n] words -> [n, n_limbs] uint64 limbs of the key, least
    significant limb first."""
    W, n = words.shape
    u = np.asarray(words).astype(np.uint64)
    limbs = np.zeros((n, n_limbs), np.uint64)
    for i in range(W):
        b = W - 1 - i  # the word's place from the bottom: bits 62b..62b+61
        for j in range(n_limbs):
            off = 62 * b - 64 * j
            if 0 <= off < 64:
                limbs[:, j] |= u[i] << np.uint64(off)
            elif -62 < off < 0:
                limbs[:, j] |= u[i] >> np.uint64(-off)
    return limbs


def _limbs_to_words(limbs: np.ndarray, W: int) -> np.ndarray:
    """[n, L] uint64 limbs (least significant first) -> [W, n] int64 words
    of the low 62 W bits."""
    n, L = limbs.shape
    out = np.zeros((W, n), np.int64)
    for i in range(W):
        j, s = divmod(62 * (W - 1 - i), 64)
        v = limbs[:, j] >> np.uint64(s) if j < L else np.zeros(n, np.uint64)
        if s > 2 and j + 1 < L:
            v |= limbs[:, j + 1] << np.uint64(64 - s)
        out[i] = (v & np.uint64(_MASK62)).astype(np.int64)
    return out


def words_to_bytes(words: np.ndarray, n_bytes: int) -> np.ndarray:
    """[W, n] words -> [n, n_bytes] uint8: each key little-endian, as the
    .jf records hold it."""
    n_limbs = -(-n_bytes // 8)
    limbs = _words_to_limbs(words, n_limbs).astype("<u8")
    return limbs.view(np.uint8).reshape(-1, 8 * n_limbs)[:, :n_bytes]


def bytes_to_words(b: np.ndarray, k: int) -> np.ndarray:
    """[n, n_bytes] uint8 little-endian keys -> [W, n] int64 words."""
    n, n_bytes = b.shape
    n_limbs = -(-n_bytes // 8)
    buf = np.zeros((n, 8 * n_limbs), np.uint8)
    buf[:, :n_bytes] = b
    return _limbs_to_words(buf.view("<u8").astype(np.uint64),
                           words_for_k(k))


def words_to_ints(words: np.ndarray) -> list[int]:
    """[W, n] words -> python-int keys."""
    W, n = words.shape
    n_bytes = 8 * -(-62 * W // 64)
    raw = words_to_bytes(words, n_bytes).tobytes()
    return [int.from_bytes(raw[i * n_bytes:(i + 1) * n_bytes], "little")
            for i in range(n)]


def ref_words_for_k(k: int) -> int:
    """kat_tpu's uint32 word count of a key (kat_tpu/core/kmers.py:171):
    3 for k <= 47, 2 (k // 32 + 1) beyond."""
    if not MAX_K < k <= MAX_K_WIDE:
        raise ValueError(f"k={k} is not a wide k")
    return 3 if k <= 47 else 2 * (k // 32 + 1)


def from_ref_words(ref, k: int) -> np.ndarray:
    """kat_tpu's big-first uint32 words ([n, nw] or a sequence of nw [n]
    planes) -> [W, n] int64 words; its all-ones sentinel becomes SENTINEL
    in every word."""
    ref = np.stack([np.asarray(p, np.uint32) for p in ref]) \
        if isinstance(ref, (tuple, list)) else np.asarray(ref, np.uint32).T
    nw, n = ref.shape
    planes = ref.astype(np.uint64)
    if nw % 2:
        planes = np.concatenate([np.zeros((1, n), np.uint64), planes])
    pairs = [(planes[i] << np.uint64(32)) | planes[i + 1]
             for i in range(0, len(planes), 2)]
    limbs = np.stack(pairs[::-1], axis=1)  # least significant first
    out = _limbs_to_words(limbs, words_for_k(k))
    out[:, (ref == np.uint32(0xFFFFFFFF)).all(0)] = SENTINEL
    return out


def to_ref_words(words, k: int) -> np.ndarray:
    """[W, n] int64 words (tensor or array) -> kat_tpu's [n, nw] big-first
    uint32 words, SENTINEL mapped to all ones."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.asarray(words, np.int64)
    nw = ref_words_for_k(k)
    n_limbs = -(-nw // 2)
    limbs = _words_to_limbs(words, n_limbs)
    halves = np.empty((words.shape[1], 2 * n_limbs), np.uint32)
    for j in range(n_limbs):  # big-first: the top limb's high half leads
        halves[:, 2 * (n_limbs - 1 - j)] = (limbs[:, j] >> np.uint64(32))
        halves[:, 2 * (n_limbs - 1 - j) + 1] = limbs[:, j] & np.uint64(
            0xFFFFFFFF)
    out = halves[:, 2 * n_limbs - nw:]
    out[words[0] == SENTINEL] = np.uint32(0xFFFFFFFF)
    return np.ascontiguousarray(out)
