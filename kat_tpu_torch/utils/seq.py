"""Host-side sequence string helpers (reference
lib/include/kat/str_utils.hpp): GC counting, k-mer validity, numeric list
splitting.  A copy of kat_tpu/utils/seq.py.  The device equivalents live
in core/kmers.py; these serve host code paths and tests."""

from __future__ import annotations

GC_BASES = frozenset("GgCc")
VALID_BASES = frozenset("ACGTacgt")


def gc_count(seq: str) -> int:
    """Number of G/C bases (str_utils.hpp:151 gcCount)."""
    return sum(1 for ch in seq if ch in GC_BASES)


def gc_count_n(seq: str) -> tuple[int, int]:
    """(gc, n) counts (str_utils.hpp:169 gcCountN)."""
    gc = 0
    n = 0
    for ch in seq:
        if ch in GC_BASES:
            gc += 1
        elif ch in "Nn":
            n += 1
    return gc, n


def valid_kmer(seq: str) -> bool:
    """True iff every base is ACGT (str_utils.hpp:183 validKmer)."""
    return all(ch in VALID_BASES for ch in seq)


def split_uint(line: str, sep: str = " ") -> list[int]:
    """Split a whitespace row into ints (str_utils.hpp splitUInt64)."""
    return [int(tok) for tok in line.split(sep) if tok]
