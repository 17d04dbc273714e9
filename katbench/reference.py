"""The plain reference that decides `correct`: what `kat hist` and `kat
comp` must produce from the reads and the assembly that reads.py made.

Plain PyTorch, in blocks so that it fits beside the program's output:
every k-window of every read (and contig) becomes its 2k-bit key, the
first base in the most significant bits (A=0, C=1, G=2, T=3), canonical
as min(key, reverse complement); keys are sorted per block, split into
4^PARTS_BASES ranges by their leading bases, and each range is counted
with `torch.unique`.  It imports nothing of the program.

`table_mismatch`, `hist_text` and `comp_outputs` are what the program's
outputs are held against; the control (control.py) is the same count
with the forward key only, which breaks the configuration's canonical
guarantee.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

PARTS_BASES = 3  # key ranges by the leading bases: 4^3 = 64 parts


def window_keys(codes: torch.Tensor, k: int, canonical: bool = True):
    """int64 keys of every k-window of uint8 [n, L] codes that holds only
    bases (a code >= 4 makes its windows invalid and they are dropped)."""
    if not 1 <= k <= 31:
        raise ValueError(f"the reference packs k <= 31 into int64, got {k}")
    n, L = codes.shape
    W = L - k + 1
    c = codes.to(torch.int64)
    fwd = torch.zeros((n, W), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        col = c[:, j:j + W]
        fwd = fwd * 4 + (col & 3)
        if canonical:
            rev += (3 - (col & 3)) << (2 * j)
    bad = torch.cat([torch.zeros((n, 1), dtype=torch.int64,
                                 device=codes.device),
                     (c >= 4).to(torch.int64).cumsum(1)], 1)
    ok = (bad[:, k:] - bad[:, :W]) == 0
    keys = torch.minimum(fwd, rev) if canonical else fwd
    return keys[ok]


def count(blocks, k: int, canonical: bool = True) -> list:
    """[(keys, counts)] per key range, ascending, over every window of the
    code blocks (an iterable of uint8 [n, L] tensors on one device)."""
    shift = 2 * k - 2 * PARTS_BASES
    parts: list[list] = [[] for _ in range(4 ** PARTS_BASES)]
    edges = None
    for blk in blocks:
        keys = torch.sort(window_keys(blk, k, canonical)).values
        if edges is None:
            edges = torch.arange(1, len(parts), device=keys.device) << shift
        cuts = [0, *torch.searchsorted(keys, edges).tolist(), len(keys)]
        for p in range(len(parts)):
            if cuts[p + 1] > cuts[p]:
                parts[p].append(keys[cuts[p]:cuts[p + 1]].clone())
        del keys
    out = []
    for p in range(len(parts)):
        if parts[p]:
            keys, counts = torch.unique(torch.cat(parts[p]),
                                        return_counts=True)
            # the card's unique keeps storage of its input's size
            out.append((keys.clone(), counts.clone()))
        else:
            out.append(None)
        parts[p] = None
    return out


def _split(keys: torch.Tensor, counts: torch.Tensor, k: int) -> list:
    """A sorted table cut into the reference's key ranges."""
    shift = 2 * k - 2 * PARTS_BASES
    n = 4 ** PARTS_BASES
    edges = torch.arange(1, n, device=keys.device) << shift
    cuts = [0, *torch.searchsorted(keys, edges).tolist(), len(keys)]
    return [(keys[cuts[p]:cuts[p + 1]], counts[cuts[p]:cuts[p + 1]])
            for p in range(n)]


def _join(ak, ac, bk, bc):
    """(a's counts, b's counts of a's keys with 0 where absent, found)."""
    if len(bk) == 0:
        z = torch.zeros_like(ac)
        return ac, z, z.bool()
    pos = torch.searchsorted(bk, ak).clamp(max=len(bk) - 1)
    found = bk[pos] == ak
    return ac, torch.where(found, bc[pos], 0), found


def table_mismatch(keys: torch.Tensor, counts: torch.Tensor, ref: list,
                   k: int) -> int:
    """Keys whose count differs between a sorted table (the program's real
    entries) and the reference: in one and not the other, or in both with
    other counts."""
    bad = 0
    for (pk, pc), r in zip(_split(keys, counts.to(torch.int64), k), ref):
        rk, rc = r if r is not None else (pk[:0], pc[:0])
        _, got, found = _join(rk, rc, pk, pc)
        nf = int(found.sum())
        bad += (len(rk) - nf) + (len(pk) - nf)
        bad += int((found & (got != rc)).sum())
    return bad


def as_table(parts: list) -> SimpleNamespace:
    """The per-range counts as one sorted table (keys, counts, n_unique),
    as the control hands them in the program's place."""
    live = [p for p in parts if p is not None]
    keys = torch.cat([k for k, _c in live])
    return SimpleNamespace(keys=keys, counts=torch.cat([c for _k, c in live]),
                           n_unique=len(keys))


# -- kat hist -----------------------------------------------------------------

def histogram(ref: list, low: int, high: int, inc: int) -> np.ndarray:
    """KAT's histogram of the counts (histogram.cc): base = low - 1 for
    low > 1 else 1, ceil = high + 1; a count below base goes to the first
    bucket, above ceil to the last, else to (count - base) // inc."""
    base = low - 1 if low > 1 else 1
    ceil = high + 1
    nb = ceil + 1 - base
    h = np.zeros(nb, np.int64)
    for r in ref:
        if r is None:
            continue
        c = r[1].to(torch.int64)
        b = torch.where(c < base, 0, torch.where(c > ceil, nb - 1,
                                                 (c - base) // inc))
        h += torch.bincount(b, minlength=nb).cpu().numpy()
    return h


def hist_text(h: np.ndarray, k: int, low: int, inc: int, file_name: str,
              path_string: str) -> str:
    """The histogram as `kat hist` writes it: KAT's mme header, then one
    `<bucket> <distinct k-mers>` line a bucket."""
    base = low - 1 if low > 1 else 1
    head = (f"# Title:{k}-mer spectra for: {file_name}\n"
            f"# XLabel:{k}-mer frequency\n"
            f"# YLabel:# distinct {k}-mers\n"
            f"# Kmer value:{k}\n"
            f"# Input 1:{path_string}\n"
            "###\n")
    return head + "".join(f"{base + i * inc} {int(v)}\n"
                          for i, v in enumerate(h))


# -- kat comp (two inputs, unit scales) ---------------------------------------

def comp_outputs(reads: list, asm: list, d1_bins: int, d2_bins: int) -> dict:
    """`kat comp reads asm`'s counters, spectra and main matrix
    (comp.cc:366-463, comp_counters.cc): per k-mer of the reads' table its
    count c1 and the assembly's count c2 (0 where absent), the matrix cell
    [min(c1, d1_bins - 1), min(c2, d2_bins - 1)]; the assembly's k-mers
    absent from the reads in row 0; spectra over min(count, bins - 1) with
    bins = min(d1_bins, d2_bins)."""
    dm = min(d1_bins, d2_bins)
    dev = next(r[0].device for r in reads + asm if r is not None)
    mx = torch.zeros(d1_bins * d2_bins, dtype=torch.int64, device=dev)
    sp = {n: torch.zeros(dm, dtype=torch.int64, device=dev)
          for n in ("spectrum1", "spectrum2", "shared_spectrum1",
                    "shared_spectrum2")}
    c = dict.fromkeys(
        ("hash1_total", "hash1_distinct", "hash1_only_total",
         "hash1_only_distinct", "shared_hash1_total", "shared_hash2_total",
         "shared_distinct", "hash2_total", "hash2_distinct",
         "hash2_only_total", "hash2_only_distinct", "hash3_total",
         "hash3_distinct"), 0)
    empty = (torch.zeros(0, dtype=torch.int64, device=dev),) * 2

    def bins(x, n):
        return torch.bincount(x, minlength=n)

    for r, a in zip(reads, asm):
        rk, rc = r if r is not None else empty
        ak, ac = a if a is not None else empty
        h1, h2, shared = _join(rk, rc, ak, ac)
        _, _, in1 = _join(ak, ac, rk, rc)
        c["hash1_total"] += int(h1.sum())
        c["hash1_distinct"] += len(rk)
        c["hash1_only_total"] += int(h1[~shared].sum())
        c["hash1_only_distinct"] += int((~shared).sum())
        c["shared_hash1_total"] += int(h1[shared].sum())
        c["shared_hash2_total"] += int(h2[shared].sum())
        c["shared_distinct"] += int(shared.sum())
        c["hash2_total"] += int(ac.sum())
        c["hash2_distinct"] += len(ak)
        c["hash2_only_total"] += int(ac[~in1].sum())
        c["hash2_only_distinct"] += int((~in1).sum())
        s1 = h1.clamp(max=d1_bins - 1)
        s2 = h2.clamp(max=d2_bins - 1)
        mx += bins(s1 * d2_bins + s2, d1_bins * d2_bins)
        mx[:d2_bins] += bins(ac[~in1].clamp(max=d2_bins - 1), d2_bins)
        sp["spectrum1"] += bins(h1.clamp(max=dm - 1), dm)
        sp["shared_spectrum1"] += bins(h1[shared].clamp(max=dm - 1), dm)
        sp["spectrum2"] += bins(ac.clamp(max=dm - 1), dm)
        sp["shared_spectrum2"] += bins(ac[in1].clamp(max=dm - 1), dm)
    out = {n: v.cpu().numpy() for n, v in sp.items()}
    out["main"] = mx.reshape(d1_bins, d2_bins).cpu().numpy()
    out["counters"] = c
    return out


def parse_matrix(text: str) -> np.ndarray:
    """The rows of an mme matrix file (after its `###` line) as int64."""
    body = text.split("###\n", 1)[1]
    rows = body.strip("\n").split("\n")
    return np.array(" ".join(rows).split(), dtype=np.int64).reshape(
        len(rows), -1)
