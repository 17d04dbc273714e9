"""Jellyfish 2.x `binary/sorted` .jf hash file codec.

Format (verified against tests/data/ecoli.header.jf27 and reference
deps/jellyfish-2.2.0/include/jellyfish/{file_header,binary_dumper}.hpp):

  [9 ASCII digits: header JSON length H][H bytes JSON, NUL-padded so the
  record area starts 8-byte aligned][records]

Each record is `ceil(key_len/8)` bytes of little-endian packed key (2 bits
per base, first base of the k-mer in the most significant bit pair) followed
by `counter_len` little-endian count bytes, the count saturating at
2^(8*counter_len)-1 (binary_dumper.hpp:49).

On load the reference re-inserts every record into a fresh in-memory hash
(jellyfish_helper.cc:168-176), so record order is irrelevant to any KAT
consumer; this writer emits records in ascending key order (deterministic)
while still embedding a syntactically valid random GF(2) hash matrix in the
header for compatibility with readers that expect one.

Copy of kat_tpu/io/jellyfish.py (numpy only), so that files written by the
two packages are byte-identical: the header's "exe_path" and default
"cmdline" keep kat_tpu's strings.  Wide keys (k > 32) are written from
numpy byte planes instead of kat_tpu's Python loop over the records, and
`read_jf_words` reads them straight into the port's [W, n] int64 words.
"""

from __future__ import annotations

import getpass
import json
import os
import socket
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import kmers


@dataclass
class JfHeader:
    key_len: int          # bits = 2k
    counter_len: int = 4  # bytes per on-disk counter
    val_len: int = 7      # bits per in-memory counter field (informational)
    canonical: bool = True
    size: int = 131072
    max_reprobe: int = 126
    fmt: str = "binary/sorted"
    raw: dict = field(default_factory=dict)

    @property
    def mer_len(self) -> int:
        return self.key_len // 2

    @property
    def key_bytes(self) -> int:
        return self.key_len // 8 + (1 if self.key_len % 8 else 0)

    @property
    def record_len(self) -> int:
        return self.key_bytes + self.counter_len


def read_header(path: str) -> tuple[JfHeader, int]:
    """Parse the JSON header; returns (header, data offset)."""
    with open(path, "rb") as f:
        prefix = f.read(9)
        if len(prefix) != 9 or not prefix.isdigit():
            raise ValueError(f"Not a jellyfish hash file: {path}")
        hlen = int(prefix)
        txt = f.read(hlen).rstrip(b"\x00").decode()
    raw = json.loads(txt)
    fmt = raw.get("format", "")
    if fmt == "bloomcounter":
        raise ValueError(
            "KAT does not currently support bloom counted kmer hashes.")
    if fmt == "text/sorted":
        raise ValueError("Text format hashes are not supported.")
    if fmt != "binary/sorted":
        raise ValueError(f"Unknown format '{fmt}'")
    hdr = JfHeader(
        key_len=int(raw["key_len"]),
        counter_len=int(raw.get("counter_len", 4)),
        val_len=int(raw.get("val_len", 7)),
        canonical=bool(raw.get("canonical", False)),
        size=int(raw.get("size", 0)),
        max_reprobe=int(raw.get("max_reprobe", 126)),
        fmt=fmt,
        raw=raw,
    )
    return hdr, 9 + hlen


def _records(path: str):
    """(header, [n, record_len] uint8 records, u32 counts) of a .jf."""
    hdr, off = read_header(path)
    if hdr.key_len > 512:
        raise ValueError(f"key_len {hdr.key_len} > 512 unsupported")
    data = np.fromfile(path, np.uint8, offset=off)
    rec = hdr.record_len
    n = data.size // rec
    if data.size % rec:
        raise ValueError(
            f"Size of database ({data.size}) must be a multiple of the "
            f"length of a record ({rec})")
    mat = data[:n * rec].reshape(n, rec)

    counts = np.zeros(n, np.uint64)
    for b in range(hdr.counter_len):
        counts |= mat[:, hdr.key_bytes + b].astype(np.uint64) << np.uint64(8 * b)
    counts = np.minimum(counts, 0xFFFFFFFF).astype(np.uint32)
    return hdr, mat, counts


def read_jf(path: str) -> tuple[JfHeader, np.ndarray | list, np.ndarray]:
    """Load a .jf file -> (header, keys, u32 counts).

    keys is a np.uint64 array for key_len <= 64 (k <= 32) and a list of
    python ints for wider keys (up to key_len 512, k <= 255 — the wide
    engine path).
    """
    hdr, mat, counts = _records(path)
    n = mat.shape[0]
    if hdr.key_len <= 64:
        keys = np.zeros(n, np.uint64)
        for b in range(hdr.key_bytes):
            keys |= mat[:, b].astype(np.uint64) << np.uint64(8 * b)
        return hdr, keys, counts

    # little-endian key bytes -> python big ints, 8-byte words at a time
    n_words64 = (hdr.key_bytes + 7) // 8
    words = []
    for wi in range(n_words64):
        w = np.zeros(n, np.uint64)
        for b in range(8 * wi, min(8 * (wi + 1), hdr.key_bytes)):
            w |= mat[:, b].astype(np.uint64) << np.uint64(8 * (b - 8 * wi))
        words.append(w)
    keys = []
    for i in range(n):
        v = 0
        for wi in reversed(range(n_words64)):
            v = (v << 64) | int(words[wi][i])
        keys.append(v)
    return hdr, keys, counts


def read_jf_words(path: str) -> tuple[JfHeader, np.ndarray, np.ndarray]:
    """Load a .jf file of wide keys (k > 31) -> (header, [W, n] int64
    words as core/kmers.py lays them out, u32 counts), vectorized."""
    hdr, mat, counts = _records(path)
    kmers.wide_spec_valid(hdr.mer_len)
    return hdr, kmers.bytes_to_words(mat[:, :hdr.key_bytes], hdr.mer_len), \
        counts


def _std_reprobes(max_reprobe: int = 126) -> list[int]:
    # Quadratic reprobe schedule (large_hash_array defaults): 1, then
    # triangular numbers 1, 3, 6, 10, ...
    return [1] + [i * (i + 1) // 2 for i in range(1, max_reprobe + 1)]


def _random_matrix(r: int, c: int, seed: int = 0x5DEECE66) -> list[int]:
    rng = np.random.default_rng(seed)
    cols = rng.integers(1, 1 << r, size=c, dtype=np.int64)
    # Make the trailing r x r block the identity so the matrix has full rank
    # (jellyfish requires an invertible square part for key recovery).
    for i in range(min(r, c)):
        cols[c - 1 - i] = 1 << i
    return [int(x) for x in cols]


def write_jf(path: str, keys, counts: np.ndarray, mer_len: int,
             canonical: bool, counter_len: int = 4,
             cmdline: list[str] | None = None) -> None:
    """Write (keys, counts) as a jellyfish-compatible binary/sorted hash.

    keys: np.uint64 array (k <= 32), a sequence of python ints (wide
    keys, k <= 255), or [W, n] int64 words of wide keys (core/kmers.py's
    layout)."""
    if isinstance(keys, np.ndarray) and keys.ndim == 2:
        return _write_jf_wide(path, keys, counts, mer_len, canonical,
                              counter_len, cmdline)
    wide_keys = not isinstance(keys, np.ndarray) or keys.dtype == object
    if wide_keys:
        return _write_jf_wide(path, kmers.ints_to_words(keys, mer_len),
                              counts, mer_len, canonical, counter_len,
                              cmdline)
    keys = np.asarray(keys, np.uint64)
    counts = np.asarray(counts, np.uint64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    counts = counts[order]

    key_len = 2 * mer_len
    n = len(keys)
    blob = _header_blob(mer_len, canonical, counter_len, n, cmdline)

    key_bytes = key_len // 8 + (1 if key_len % 8 else 0)
    max_val = (1 << (8 * counter_len)) - 1
    counts = np.minimum(counts, max_val)

    rec = np.zeros((n, key_bytes + counter_len), np.uint8)
    for b in range(key_bytes):
        rec[:, b] = ((keys >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)
    for b in range(counter_len):
        rec[:, key_bytes + b] = (
            (counts >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint8)

    with open(path, "wb") as f:
        f.write(blob)
        f.write(rec.tobytes())


def _header_blob(mer_len: int, canonical: bool, counter_len: int, n: int,
                 cmdline: list[str] | None) -> bytes:
    key_len = 2 * mer_len
    lsize = max(1, int(np.ceil(np.log2(max(2 * n, 2)))))
    hdr = {
        "alignment": 8,
        "canonical": bool(canonical),
        "cmdline": cmdline or ["kat_tpu"],
        "counter_len": counter_len,
        "exe_path": "kat_tpu",
        "format": "binary/sorted",
        "hostname": socket.gethostname(),
        "key_len": key_len,
        "matrix1": {"c": key_len,
                    "columns": _random_matrix(lsize, key_len),
                    "r": lsize},
        "max_reprobe": 126,
        "pwd": os.getcwd(),
        "reprobes": _std_reprobes(126),
        "size": 1 << lsize,
        "time": time.ctime(),
        "user": getpass.getuser(),
        "val_len": 7,
    }
    txt = json.dumps(hdr, sort_keys=True, separators=(",", ":")).encode()
    # Pad so records start 8-byte aligned (observed in reference dumps).
    hlen = len(txt)
    pad = (-(9 + hlen)) % 8
    hlen += pad
    return f"{hlen:09d}".encode() + txt + b"\x00" * pad


def _write_jf_wide(path: str, words: np.ndarray, counts, mer_len: int,
                   canonical: bool, counter_len: int,
                   cmdline: list[str] | None) -> None:
    """Write wide keys given as [W, n] int64 words: records in ascending
    (key, count) order, each key little-endian in ceil(2k / 8) bytes and
    its count saturating, as kat_tpu/io/jellyfish.py:251-265 writes them
    one by one; here from numpy byte planes."""
    key_len = 2 * mer_len
    key_bytes = key_len // 8 + (1 if key_len % 8 else 0)
    max_val = (1 << (8 * counter_len)) - 1
    words = np.asarray(words, np.int64)
    counts = np.minimum(np.asarray(counts, np.uint64), np.uint64(max_val))
    if words.shape[0] != kmers.words_for_k(mer_len) or \
            words.shape[1] != counts.size:
        raise ValueError(f"expected [{kmers.words_for_k(mer_len)}, "
                         f"{counts.size}] words, got {words.shape}")
    order = np.lexsort((counts, *words[::-1]))
    rec = np.empty((counts.size, key_bytes + counter_len), np.uint8)
    rec[:, :key_bytes] = kmers.words_to_bytes(words[:, order], key_bytes)
    c = counts[order]
    for b in range(counter_len):
        rec[:, key_bytes + b] = ((c >> np.uint64(8 * b))
                                 & np.uint64(0xFF)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(_header_blob(mer_len, canonical, counter_len, counts.size,
                             cmdline))
        f.write(rec.tobytes())
