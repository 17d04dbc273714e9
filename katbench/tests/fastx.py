"""The harness's reads and contigs written as the files a user hands `kat`,
for the tests that hold the staged batches against the port's reader."""

from __future__ import annotations

import torch

from katbench import reads

_ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)


def write_fastq(path: str, cfg: dict, seed: int, gen_codes: torch.Tensor,
                file: int) -> None:
    """File `file`'s reads as FASTQ: `@r<10 digits>`, the bases, `+`, a
    constant quality line."""
    dev = gen_codes.device
    L = cfg["read_len"]
    head, width = 12, 2 * L + 17  # "@r" + 10 digits + "\n"
    lut = _ASCII.to(dev)
    powers = 10 ** torch.arange(9, -1, -1, device=dev)
    first = sum(reads.file_reads(cfg)[:file])
    with open(path, "wb") as f:
        for blk in reads.read_blocks(cfg, seed, gen_codes, file):
            b = len(blk)
            rec = torch.empty((b, width), dtype=torch.uint8, device=dev)
            rec[:, 0], rec[:, 1] = ord("@"), ord("r")
            ids = torch.arange(first, first + b, device=dev)
            rec[:, 2:head] = ((ids[:, None] // powers) % 10 + ord("0")).to(
                torch.uint8)
            rec[:, head] = ord("\n")
            rec[:, head + 1:head + 1 + L] = lut[blk.long()]
            rec[:, head + 1 + L:head + 4 + L] = torch.tensor(
                list(b"\n+\n"), dtype=torch.uint8, device=dev)
            rec[:, head + 4 + L:head + 4 + 2 * L] = ord("I")
            rec[:, -1] = ord("\n")
            f.write(rec.cpu().numpy().tobytes())
            first += b


def write_fasta(path: str, parts: list[torch.Tensor], line: int = 80) -> None:
    """The contigs as FASTA, `>c<index>` headers, `line` bases a line."""
    lut = _ASCII.to(parts[0].device)
    with open(path, "wb") as f:
        for i, p in enumerate(parts):
            seq = lut[p.long()].cpu().numpy().tobytes()
            f.write(f">c{i}\n".encode())
            f.write(b"\n".join(seq[j:j + line]
                               for j in range(0, len(seq), line)) + b"\n")
