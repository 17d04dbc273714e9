"""The inputs of a cell, made from its seed: a genome of uniform random
bases, reads drawn from it, the assembly's contigs, and what the program
is handed (code batches staged on the device).

Reads: uniform start positions, the strand drawn at 50% (a reverse read is
the reverse complement of its span), then uniform substitutions at the
configuration's rate, each to one of the three other bases.  Every draw
comes from `torch.Generator`s on the device, seeded from the run's seed,
in blocks of BLOCK_READS reads: the same seed gives the same reads on the
same kind of device, and the plain reference (reference.py) draws them
again after the window through `read_blocks`.

Staged batches are packed as the port's native reader packs a file
(kat_tpu_torch/native/fastxio.cpp `kat_fastx_next_codes`, one worker):
records back to back, an invalid code (4) after each FASTQ record and
between FASTA records, a row that ends inside a record repeats its last
k - 1 codes at the start of the next row, padding (5) after the end of the
stream, rows of `row_len` codes in batches of `rows` rows, every file a
stream of its own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BLOCK_READS = 1 << 19  # reads drawn per block (fixes the random stream)
SEP, PAD = 4, 5  # the reader's record separator and end padding


def _seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a stream's salt."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (
        1 << 63)


def _generator(dev: torch.device, seed: int, salt: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(_seed(seed, salt))
    return g


def genome(cfg: dict, seed: int, dev: torch.device) -> torch.Tensor:
    """uint8 [genome_len] codes 0..3, uniform."""
    return torch.randint(0, 4, (cfg["genome_len"],), dtype=torch.uint8,
                         device=dev, generator=_generator(dev, seed, 1))


def file_reads(cfg: dict) -> list[int]:
    """Reads in each of the read set's files (the first takes the odd one)."""
    n, f = cfg["n_reads"], cfg["files"]
    return [n // f + (1 if i < n % f else 0) for i in range(f)]


def read_blocks(cfg: dict, seed: int, gen_codes: torch.Tensor, file: int):
    """Yield uint8 [b, read_len] code blocks of file `file`'s reads, in
    order, b <= BLOCK_READS."""
    dev = gen_codes.device
    g = _generator(dev, seed, 2 + file)
    L, G = cfg["read_len"], gen_codes.numel()
    rate = float(cfg["substitution_rate"])
    cols = torch.arange(L, device=dev)
    left = file_reads(cfg)[file]
    while left:
        b = min(BLOCK_READS, left)
        left -= b
        start = torch.randint(0, G - L + 1, (b,), device=dev, generator=g)
        reverse = torch.randint(0, 2, (b, 1), device=dev, generator=g) == 1
        fwd = gen_codes[start[:, None] + cols]
        reads = torch.where(reverse, 3 - fwd.flip(1), fwd)
        hit = torch.rand((b, L), device=dev, generator=g) < rate
        shift = torch.randint(1, 4, (b, L), dtype=torch.uint8, device=dev,
                              generator=g)
        yield torch.where(hit, (reads + shift) & 3, reads)


def contigs(cfg: dict, gen_codes: torch.Tensor) -> list[torch.Tensor]:
    """The assembly: the genome cut into contigs of assembly_contig_len
    bases (the last one shorter), views of `gen_codes`."""
    n = cfg["assembly_contig_len"]
    return list(gen_codes.split(n))


def real_windows(lengths, k: int) -> int:
    """k-windows of records of these lengths (records hold no invalid base)."""
    return int(sum(max(0, int(n) - k + 1) for n in lengths))


# -- staging: the reader's packing -------------------------------------------

def row_starts(is_base, n_codes: int, k: int, row_len: int,
               period: int | None = None) -> np.ndarray:
    """Stream offsets at which the reader's rows start.

    is_base(p): the code at stream offset p is a base (not a separator).
    A row that ends on a base repeats its last k - 1 codes; the rows stop
    once one reaches the end of the stream (a stream that ends on a base
    gets one more row, its seam).  With `period` (records of one length,
    each followed by a separator) the offsets repeat with the row's phase
    in a record, so the loop runs until a phase comes back and the rest is
    that cycle, repeated."""
    starts: list[int] = []
    phase_at: dict[int, int] = {}
    s = 0
    while True:
        if period is not None:
            ph = s % period
            if ph in phase_at:
                i0 = phase_at[ph]
                cyc = np.asarray(starts[i0:], np.int64) - starts[i0]
                stride = s - starts[i0]
                reps = (n_codes - s) // max(stride, 1) + 2
                more = (s + np.arange(reps, dtype=np.int64)[:, None] * stride
                        + cyc[None, :]).reshape(-1)
                allr = np.concatenate([np.asarray(starts, np.int64), more])
                last = allr + row_len - 1
                # the first row that reaches the stream's last code ends it
                # (a stream of records with separators ends on a separator)
                end = int(np.argmax(last >= n_codes - 1))
                return allr[:end + 1]
            phase_at[ph] = len(starts)
        starts.append(s)
        last = s + row_len - 1
        if last > n_codes - 1:
            break
        if last == n_codes - 1:
            if is_base(last):
                starts.append(n_codes - (k - 1))
            break
        s = last + 1 - (k - 1) if is_base(last) else last + 1
    return np.asarray(starts, np.int64)


def pack_rows(stream: torch.Tensor, starts: np.ndarray, rows: int,
              row_len: int) -> list[torch.Tensor]:
    """[<= rows, row_len] uint8 batches of the stream's rows, on its device."""
    dev = stream.device
    n = stream.numel()
    cols = torch.arange(row_len, device=dev)
    st = torch.from_numpy(starts).to(dev)
    out = []
    for r0 in range(0, len(starts), rows):
        idx = st[r0:r0 + rows, None] + cols
        codes = stream[idx.clamp(max=n - 1)]
        out.append(torch.where(idx < n, codes, PAD).to(torch.uint8))
    return out


def stage_reads(cfg: dict, seed: int, gen_codes: torch.Tensor, k: int,
                rows: int, row_len: int) -> list[torch.Tensor]:
    """Every file's reads as the reader's batches, staged on the device."""
    L = cfg["read_len"]
    batches = []
    for f, n in enumerate(file_reads(cfg)):
        stream = torch.full((n, L + 1), SEP, dtype=torch.uint8,
                            device=gen_codes.device)
        at = 0
        for blk in read_blocks(cfg, seed, gen_codes, f):
            stream[at:at + len(blk), :L] = blk
            at += len(blk)
        stream = stream.reshape(-1)
        starts = row_starts(lambda p: p % (L + 1) != L, stream.numel(), k,
                            row_len, period=L + 1)
        batches += pack_rows(stream, starts, rows, row_len)
        del stream
    return batches


def stage_contigs(parts: list[torch.Tensor], k: int, rows: int,
                  row_len: int) -> list[torch.Tensor]:
    """FASTA records (separators between them, none after the last) as the
    reader's batches."""
    dev = parts[0].device
    sep = torch.full((1,), SEP, dtype=torch.uint8, device=dev)
    pieces = []
    for i, p in enumerate(parts):
        if i:
            pieces.append(sep)
        pieces.append(p)
    stream = torch.cat(pieces)
    seps = set(np.cumsum([len(p) + 1 for p in parts[:-1]]) - 1)
    starts = row_starts(lambda p: p not in seps, stream.numel(), k, row_len)
    return pack_rows(stream, starts, rows, row_len)


def scratch_dir() -> str:
    """A directory of this run's own under TMPDIR for its files."""
    import tempfile

    return tempfile.mkdtemp(prefix="katbench-", dir=os.environ.get("TMPDIR"))
