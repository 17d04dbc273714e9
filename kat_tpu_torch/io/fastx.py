"""Host-side FASTA/FASTQ/gz record reading and fixed-shape batch encoding.

Plays the role of SeqAn's `SeqFileIn`/`readRecords` plus jellyfish's
`mer_overlap_sequence_parser` (reference:
deps/jellyfish-2.2.0/include/jellyfish/mer_overlap_sequence_parser.hpp) — in
particular the (k-1)-character *seam* copied between consecutive chunks of a
long sequence so no k-window is lost, and per-file 5' trimming
(input_handler.cc:51-95).

Device batches are `[rows, row_len]` uint8 2-bit-code arrays, padded with an
invalid code so windows that touch padding are masked out by
`extract_kmers`.  Row lengths are bucketed so batches share few shapes.

Port of kat_tpu/io/fastx.py (host numpy code, unchanged).
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np

from ..core.kmers import encode_ascii

INVALID = np.uint8(4)  # already-encoded padding code


def is_generator_path(path: str) -> bool:
    """True for `gen:<shell command>` pseudo-paths: each open re-runs the
    command and streams its stdout — the re-openable generator pipes of
    jellyfish's stream_manager (stream_manager.hpp:74+)."""
    return path.startswith("gen:")


def is_stream_path(path: str) -> bool:
    """Paths that cannot be opened twice: generator commands, stdin, and
    named pipes (FIFOs)."""
    if is_generator_path(path) or path in ("-", "/dev/stdin"):
        return True
    try:
        import stat as _stat

        return _stat.S_ISFIFO(os.stat(path).st_mode)
    except OSError:
        return False


class _GenStream(io.RawIOBase):
    """stdout of a `gen:<cmd>` subprocess with a checked lifecycle: close
    reaps the child (no zombie until interpreter exit) and, if the stream
    was consumed to EOF, raises when the command exited non-zero — a
    failing generator (bad path, zcat error) must not silently count as a
    valid-but-short input.  Early abandonment (reader closes before EOF)
    sends the child SIGPIPE by closing its stdout and does NOT raise."""

    def __init__(self, proc, cmd: str):
        self._proc = proc
        self._f = proc.stdout
        self._cmd = cmd
        self._saw_eof = False

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = self._f.readinto(b)
        if n == 0:
            self._saw_eof = True
        return n

    def close(self) -> None:
        if self.closed:
            return
        import subprocess

        try:
            self._f.close()
            try:
                # bounded: a command that blocks without writing never
                # receives SIGPIPE and would hang an unbounded wait
                rc = self._proc.wait(timeout=10 if self._saw_eof else 2)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
                rc = None  # we killed it; not the command's failure
            if self._saw_eof and rc not in (0, None):
                raise RuntimeError(
                    f"generator command failed (exit {rc}): {self._cmd}")
        finally:
            super().close()


class _OwningGzipFile(gzip.GzipFile):
    """GzipFile that CLOSES the fileobj it wraps: the stdlib leaves
    passed-in file objects open, which would skip _GenStream's child
    reaping / exit-status check for gzipped generator streams."""

    def __init__(self, underlying):
        super().__init__(fileobj=underlying)
        self._underlying = underlying

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._underlying.close()


class _PushbackReader(io.RawIOBase):
    """Raw stream serving a consumed prefix first, then the underlying
    stream — the pushback needed because pipes cannot rewind."""

    def __init__(self, prefix: bytes, f):
        self._prefix = prefix
        self._f = f

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._prefix:
            n = min(len(b), len(self._prefix))
            b[:n] = self._prefix[:n]
            self._prefix = self._prefix[n:]
            return n
        data = self._f.read(len(b))
        if not data:
            return 0
        b[:len(data)] = data
        return len(data)

    def close(self) -> None:
        if self.closed:
            return
        try:
            self._f.close()
        finally:
            super().close()


def _read_at_least(f, n: int) -> bytes:
    """Accumulate up to n bytes, looping over short reads (a slow pipe
    writer may deliver 1 byte at a time; a single peek/read is not
    enough to test the 2-byte gzip magic)."""
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _open_raw(path: str):
    if is_generator_path(path):
        import subprocess

        cmd = path[4:]
        proc = subprocess.Popen(["/bin/sh", "-c", cmd],
                                stdout=subprocess.PIPE)
        return _GenStream(proc, cmd)
    if path == "-":
        import sys

        return sys.stdin.buffer.raw  # type: ignore[union-attr]
    return open(path, "rb")


def _open_text(path: str) -> io.BufferedReader:
    raw = _open_raw(path)
    magic = _read_at_least(raw, 2)
    f = io.BufferedReader(_PushbackReader(magic, raw))
    if magic[:2] == b"\x1f\x8b":
        return io.BufferedReader(_OwningGzipFile(f))  # type: ignore
    return f


def _ext_format(path: str) -> str | None:
    base = path[4:] if is_generator_path(path) else path
    if base.lower().endswith(".gz"):
        base = base[:-3]
    ext = os.path.splitext(base)[1].lower()
    if ext in (".fastq", ".fq"):
        return "fastq"
    if ext in (".fasta", ".fa", ".fna", ".fas", ".scafseq"):
        return "fasta"
    return None


def _sniff_stream(path: str, f: io.BufferedReader) -> str:
    fmt = _ext_format(path)
    if fmt:
        return fmt
    ch = f.peek(1)[:1]
    if ch == b">":
        return "fasta"
    if ch == b"@":
        return "fastq"
    raise ValueError(f"Unknown file type: {path}")


def sniff_format(path: str) -> str:
    """'fasta' | 'fastq', mirroring InputHandler::determineSequenceFileType
    (input_handler.cc:318-358): extension first, then first character."""
    fmt = _ext_format(path)
    if fmt:
        return fmt
    with _open_text(path) as f:
        return _sniff_stream(path, f)


def is_sequence_file(path: str) -> bool:
    """True if FASTA/FASTQ(.gz); False for jellyfish hashes etc.

    Mirrors JellyfishHelper::isSequenceFile: a file is a sequence file unless
    it looks like a binary hash (starts with the 9-digit header-length used by
    jellyfish's file_header).  Stream paths (generator pipes, FIFOs, stdin)
    cannot be sniffed non-destructively and are always sequence inputs.
    """
    if is_stream_path(path):
        return True
    try:
        with _open_text(path) as f:
            head = f.read(9)
        if len(head) == 9 and head.isdigit():
            return False
        sniff_format(path)
        return True
    except (ValueError, OSError):
        return False


@dataclass
class Record:
    name: str
    seq: bytes
    qual: bytes | None = None


def read_records(path: str) -> Iterator[Record]:
    """Stream records from a FASTA or FASTQ (optionally gzipped) file,
    FIFO, stdin ("-") or `gen:<command>` generator pipe.  Single open:
    the format sniff peeks the same stream it then reads."""
    with _open_text(path) as f:
        fmt = _sniff_stream(path, f)
        if fmt == "fastq":
            while True:
                h = f.readline()
                if not h:
                    return
                h = h.rstrip(b"\r\n")
                if not h:
                    continue
                if not h.startswith(b"@"):
                    raise ValueError(f"Malformed FASTQ header in {path}: {h!r}")
                seq = f.readline().rstrip(b"\r\n")
                plus = f.readline()
                if not plus.startswith(b"+"):
                    raise ValueError(f"Malformed FASTQ separator in {path}")
                qual = f.readline().rstrip(b"\r\n")
                yield Record(h[1:].decode(), seq, qual)
        else:
            name = None
            chunks: list[bytes] = []
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        yield Record(name, b"".join(chunks))
                    name = line[1:].decode()
                    chunks = []
                elif line:
                    chunks.append(line)
            if name is not None:
                yield Record(name, b"".join(chunks))


def read_records_multi(paths: Sequence[str],
                       trim5: Sequence[int] | None = None
                       ) -> Iterator[Record]:
    """Concatenate records from several files, applying per-file 5' trim."""
    trims = list(trim5) if trim5 else [0] * len(paths)
    if len(trims) == 1 and len(paths) > 1:
        trims = trims * len(paths)
    if len(trims) != len(paths):
        raise ValueError("Inconsistent number of inputs and trimming settings.")
    for p, t in zip(paths, trims):
        for rec in read_records(p):
            if t:
                rec = Record(rec.name, rec.seq[t:],
                             rec.qual[t:] if rec.qual else None)
            yield rec


def _bucket_len(n: int, quantum: int = 64) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def encode_batch_indexed(records: Sequence[Record], k: int,
                         max_row: int = 1 << 16):
    """Encode a fixed batch of records into bucketed code arrays with
    provenance, for tools needing per-sequence window results (sect/cold).

    Long sequences are split into `max_row` chunks overlapping by (k-1)
    bases (the seam of mer_overlap_sequence_parser.hpp:44-52) so window
    streams stitch seamlessly.

    Yields (codes [rows, blen] uint8, meta) pairs where meta is a list of
    (record_index, window_offset, n_windows) per row.
    """
    buckets: dict[int, list[tuple[bytes, int, int, int]]] = {}
    for ri, rec in enumerate(records):
        seq = rec.seq
        if len(seq) < k:
            continue
        if len(seq) <= max_row:
            pieces = [(seq, 0)]
        else:
            step = max_row - (k - 1)
            pieces = [(seq[s:s + max_row], s)
                      for s in range(0, len(seq) - (k - 1), step)]
        for piece, start in pieces:
            blen = _bucket_len(len(piece))
            nw = len(piece) - k + 1
            buckets.setdefault(blen, []).append((piece, ri, start, nw))
    for blen, rows in buckets.items():
        arr = np.full((len(rows), blen), 255, np.uint8)
        meta = []
        for i, (piece, ri, start, nw) in enumerate(rows):
            arr[i, :len(piece)] = np.frombuffer(piece, np.uint8)
            meta.append((ri, start, nw))
        yield encode_ascii(arr), meta


def encode_batches(records: Iterable[Record], k: int,
                   target_codes: int = 1 << 24,
                   max_row: int = 1 << 16) -> Iterator[np.ndarray]:
    """Yield [rows, row_len] uint8 code batches covering every k-window.

    Sequences longer than `max_row` are split into max_row chunks overlapping
    by (k-1) bases (the seam).  Rows within a batch share one bucketed length;
    short rows are padded with the invalid code so their windows mask out.
    """
    buckets: dict[int, list[bytes]] = {}
    sizes: dict[int, int] = {}

    def flush(blen: int) -> np.ndarray:
        rows = buckets.pop(blen)
        sizes.pop(blen)
        arr = np.full((len(rows), blen), 255, np.uint8)
        for i, s in enumerate(rows):
            arr[i, :len(s)] = np.frombuffer(s, np.uint8)
        return encode_ascii(arr)

    for rec in records:
        seq = rec.seq
        if len(seq) < k:
            continue
        pieces = []
        if len(seq) <= max_row:
            pieces.append(seq)
        else:
            step = max_row - (k - 1)
            for start in range(0, len(seq) - (k - 1), step):
                pieces.append(seq[start:start + max_row])
        for piece in pieces:
            blen = _bucket_len(len(piece))
            buckets.setdefault(blen, []).append(piece)
            sizes[blen] = sizes.get(blen, 0) + blen
            if sizes[blen] >= target_codes:
                yield flush(blen)
    for blen in sorted(buckets):
        yield flush(blen)
