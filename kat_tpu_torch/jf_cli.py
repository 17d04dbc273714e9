"""Jellyfish-compatible utility CLI over .jf hash files.

Port of kat_tpu/jf_cli.py.  The reference embeds jellyfish 2.2.0, whose
own sub-commands (deps/jellyfish-2.2.0/sub_commands/{count,histo,dump,
query,merge,stats}_main.cc) are built alongside KAT.  This module provides
the same six utilities, with the same flags and output formats, on top of
the port's counting engine and the bit-compatible .jf codec:

    python -m kat_tpu_torch.jf_cli [--device {cuda,cpu}] count -m 27 \\
        -o out.jf reads.fastq
    python -m kat_tpu_torch.jf_cli histo out.jf
    python -m kat_tpu_torch.jf_cli dump [-c [-t]] [-L low] [-U high] out.jf
    python -m kat_tpu_torch.jf_cli query out.jf AGCT... [...]
    python -m kat_tpu_torch.jf_cli merge -o merged.jf a.jf b.jf
    python -m kat_tpu_torch.jf_cli stats out.jf

`count` runs on the first NVIDIA card (the flush kernels K1/K2/K3) unless
`--device cpu` is given before the command; without a card `--device
cuda` raises before any input is read.  The other five commands are host
numpy over the file and touch no device.

Output formats match the jellyfish binaries (histo "col count" lines
skipping empty buckets unless --full, histo_main.cc:88-90; dump fasta-style
">count\\nkmer" or column mode, dump_main.cc:38-51; stats
Unique/Distinct/Total/Max_count block, stats_main.cc:76-79; query
"kmer count" lines, query_main.cc:49-50).

Where kat_tpu's utilities fail, these refuse with a ValueError naming the
limit instead: `count` takes k <= 31 (kat_tpu's dies writing a wider
table), `dump` and `query` read .jf files of k <= 31 (kat_tpu's die on the
list of wide keys).  `histo`, `stats` and `merge` take any k, as kat_tpu's
do.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .core.kmers import MAX_K, canonical_int, pack_string, unpack_string
from .io import jellyfish
from .tools.common import Input, glob_files


def _load(path: str):
    return jellyfish.read_jf(path)


def _narrow_only(cmd: str, k: int, what: str) -> None:
    if k > MAX_K:
        raise ValueError(f"kat_jellyfish {cmd}: {what} k = {k}; it takes "
                         f"k <= {MAX_K} only")


def _device(args):
    """The device `count` counts on: the first card, or the CPU when asked
    for.  Without a card `--device cuda` raises at once."""
    import torch

    from .tools.common import default_device

    return torch.device("cpu") if args.device == "cpu" else default_device()


def cmd_count(args) -> int:
    device = _device(args)
    _narrow_only("count", args.mer_len, "-m asks for")
    inp = Input(paths=glob_files(args.files), index=1)
    inp.device = device
    inp.mer_len = args.mer_len
    inp.canonical = args.canonical
    inp.hash_size = args.size
    inp.validate()
    inp.count(quiet=not args.verbose)
    from .core.counting import table_to_numpy

    keys, counts = table_to_numpy(inp.host_table())
    jellyfish.write_jf(args.output, keys, counts, args.mer_len,
                       args.canonical, cmdline=sys.argv)
    return 0


def cmd_histo(args) -> int:
    if args.high < args.low:
        print("High count value must be >= to low count value",
              file=sys.stderr)
        return 1
    _hdr, _keys, counts = _load(args.db)
    inc = args.increment
    base = 0 if inc >= args.low else args.low - inc
    ceil = args.high + inc
    nb = (ceil + inc - base) // inc
    histo = np.zeros(nb, np.uint64)
    c = counts.astype(np.int64)
    bucket = np.where(c < base, 0,
                      np.where(c > ceil, nb - 1, (c - base) // inc))
    np.add.at(histo, bucket, 1)
    out = open(args.output, "w") if args.output else sys.stdout
    col = base
    for i in range(nb):
        if histo[i] > 0 or args.full:
            out.write(f"{col} {int(histo[i])}\n")
        col += inc
    if args.output:
        out.close()
    return 0


def cmd_dump(args) -> int:
    hdr, keys, counts = _load(args.db)
    k = hdr.mer_len
    _narrow_only("dump", k, f"{args.db} holds")
    out = open(args.output, "w") if args.output else sys.stdout
    spacer = "\t" if args.tab else " "
    for key, val in zip(keys.tolist(), counts.tolist()):
        if val < args.lower_count or val > args.upper_count:
            continue
        mer = unpack_string(key, k)
        if args.column:
            out.write(f"{mer}{spacer}{val}\n")
        else:
            out.write(f">{val}\n{mer}\n")
    if args.output:
        out.close()
    return 0


def cmd_query(args) -> int:
    hdr, keys, counts = _load(args.db)
    k = hdr.mer_len
    _narrow_only("query", k, f"{args.db} holds")
    table = dict(zip(keys.tolist(), counts.tolist()))
    for mer in args.mers:
        if len(mer) != k:
            print(f"Invalid mer {mer} (length {len(mer)} != {k})",
                  file=sys.stderr)
            return 1
        key = pack_string(mer)
        if hdr.canonical:
            key = canonical_int(key, k)
        print(f"{mer} {table.get(key, 0)}")
    return 0


def cmd_merge(args) -> int:
    all_keys = []
    all_counts = []
    k = None
    canonical = None
    for path in args.files:
        hdr, keys, counts = _load(path)
        if k is None:
            k, canonical = hdr.mer_len, hdr.canonical
        elif hdr.mer_len != k:
            print(f"Can't merge hashes with different k ({hdr.mer_len} vs "
                  f"{k})", file=sys.stderr)
            return 1
        all_keys.append(keys)
        all_counts.append(counts.astype(np.uint64))
    keys = np.concatenate(all_keys)
    counts = np.concatenate(all_counts)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    counts = counts[order]
    uniq, idx = np.unique(keys, return_index=True)
    summed = np.add.reduceat(counts, idx)
    jellyfish.write_jf(args.output, uniq, summed, k, canonical,
                       cmdline=sys.argv)
    return 0


def cmd_stats(args) -> int:
    _hdr, _keys, counts = _load(args.db)
    c = counts.astype(np.uint64)
    mask = (c >= args.lower_count) & (c <= args.upper_count)
    c = c[mask]
    uniq = int((c == 1).sum())
    distinct = len(c)
    total = int(c.sum())
    mx = int(c.max()) if len(c) else 0
    out = open(args.output, "w") if args.output else sys.stdout
    out.write(f"Unique:    {uniq}\n")
    out.write(f"Distinct:  {distinct}\n")
    out.write(f"Total:     {total}\n")
    out.write(f"Max_count: {mx}\n")
    if args.output:
        out.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kat_tpu_torch.jf_cli",
        description="Jellyfish-compatible .jf utilities on the PyTorch/CUDA "
                    "engine.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where `count` counts: the first NVIDIA card "
                        "(default; an error without one) or the CPU.  The "
                        "other commands read files on the host.")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("count")
    c.add_argument("-m", "--mer-len", type=int, required=True)
    c.add_argument("-s", "--size", type=int, default=10_000_000)
    c.add_argument("-t", "--threads", type=int, default=1)
    c.add_argument("-C", "--canonical", action="store_true")
    c.add_argument("-o", "--output", default="mer_counts.jf")
    c.add_argument("-v", "--verbose", action="store_true")
    c.add_argument("files", nargs="+")
    c.set_defaults(func=cmd_count)

    h = sub.add_parser("histo", add_help=False)
    h.add_argument("--help", action="help")
    h.add_argument("-l", "--low", type=int, default=1)
    h.add_argument("-h", "--high", type=int, default=10000)
    h.add_argument("-i", "--increment", type=int, default=1)
    h.add_argument("-f", "--full", action="store_true")
    h.add_argument("-o", "--output")
    h.add_argument("db")
    h.set_defaults(func=cmd_histo)

    d = sub.add_parser("dump")
    d.add_argument("-c", "--column", action="store_true")
    d.add_argument("-t", "--tab", action="store_true")
    d.add_argument("-L", "--lower-count", type=int, default=0)
    d.add_argument("-U", "--upper-count", type=int,
                   default=(1 << 64) - 1)
    d.add_argument("-o", "--output")
    d.add_argument("db")
    d.set_defaults(func=cmd_dump)

    q = sub.add_parser("query")
    q.add_argument("db")
    q.add_argument("mers", nargs="+")
    q.set_defaults(func=cmd_query)

    m = sub.add_parser("merge")
    m.add_argument("-o", "--output", default="merged.jf")
    m.add_argument("files", nargs="+")
    m.set_defaults(func=cmd_merge)

    s = sub.add_parser("stats")
    s.add_argument("-L", "--lower-count", type=int, default=0)
    s.add_argument("-U", "--upper-count", type=int,
                   default=(1 << 64) - 1)
    s.add_argument("-o", "--output")
    s.add_argument("db")
    s.set_defaults(func=cmd_stats)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
