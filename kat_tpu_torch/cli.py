"""`kat`-compatible command line (reference src/kat.cc mode dispatch).

Port of kat_tpu/cli.py with the `hist` and `sect` modes, same flags and
defaults, plus a top-level `--device` (the card unless the CPU is asked for)
and `--flush` (the classic counting flush unless the minimizer-bucketed one
is asked for: the counterpart of kat_tpu's KAT_TPU_MINIMIZER switch).
Usage: python -m kat_tpu_torch [--device {cuda,cpu}]
       [--flush {classic,bucketed}] <mode> [options] ...
"""

from __future__ import annotations

import argparse
import io
import sys

from . import DEFAULT_HASH_SIZE, DEFAULT_MER_LEN, __version__
from .utils.timer import total


def _common_count_flags(p: argparse.ArgumentParser, prefix_default: str):
    p.add_argument("-o", "--output_prefix", default=prefix_default,
                   help="Path prefix for files generated by this program.")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="The number of threads to use")
    p.add_argument("--5ptrim", dest="trim5", default="0",
                   help="Ignore the first X bases from reads (comma-separated "
                        "per-file list).")
    p.add_argument("-N", "--non_canonical", action="store_true",
                   help="Store explicit kmers as found instead of canonical.")
    p.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN,
                   help="The kmer length to use in the kmer hashes.")
    p.add_argument("-H", "--hash_size", type=int, default=DEFAULT_HASH_SIZE,
                   help="Initial hash size for counting.")
    p.add_argument("-d", "--dump_hash", action="store_true",
                   help="Dump counted hashes to disk.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print extra information.")


def _add_hist(sub):
    p = sub.add_parser(
        "hist", add_help=False,
        description="Create an histogram of k-mer occurrences from the "
                    "input, which can be a jellyfish hash or FastA/FastQ "
                    "files.")
    p.add_argument("--help", action="help")
    _common_count_flags(p, "kat.hist")
    p.add_argument("-l", "--low", type=int, default=1,
                   help="Low count value of histogram")
    p.add_argument("-h", "--high", type=int, default=10000,
                   help="High count value of histogram")
    p.add_argument("-i", "--inc", type=int, default=1,
                   help="Increment for each bin")
    p.add_argument("-p", "--output_type", default="png",
                   help="The plot file type to create: png, ps, pdf.")
    p.add_argument("inputs", nargs="+",
                   help="Path to the input file(s) to process.")
    p.set_defaults(func=_run_hist)


def _device(args):
    """The device every Input of this run uses: the first card, or the CPU
    when asked for.  Without a card `--device cuda` raises at once."""
    import torch

    from .tools.common import default_device

    return torch.device("cpu") if args.device == "cpu" else default_device()


def _run_hist(args) -> int:
    from .tools.common import glob_files, parse_trim_list
    from .tools.hist import Histogram

    print("Running KAT in HIST mode")
    print("------------------------")
    print()
    with total("KAT HIST"):
        h = Histogram(glob_files(args.inputs), args.low, args.high, args.inc)
        h.output_prefix = args.output_prefix
        h.input.device = _device(args)
        h.input.flush = args.flush
        h.input.trim5 = parse_trim_list(args.trim5)
        h.input.canonical = not args.non_canonical
        h.input.mer_len = args.mer_len
        h.input.hash_size = args.hash_size
        h.input.dump_hash = args.dump_hash
        h.verbose = args.verbose
        h.execute()
        h.save()
        print("Plot and peak analysis skipped: not ported yet "
              "(ROADMAP.md §1 item 11).")
    return 0


def _add_sect(sub):
    p = sub.add_parser(
        "sect", add_help=True,
        description="SEquence Coverage estimator Tool: estimates the "
                    "coverage of each sequence in a file using k-mers from "
                    "another input.")
    p.add_argument("-o", "--output_prefix", default="kat-sect")
    p.add_argument("-x", "--gc_bins", type=int, default=1001)
    p.add_argument("-y", "--cvg_bins", type=int, default=1001)
    p.add_argument("-l", "--cvg_logscale", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--5ptrim", dest="trim5", default="0")
    p.add_argument("-N", "--non_canonical", action="store_true")
    p.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN)
    p.add_argument("-H", "--hash_size", type=int, default=DEFAULT_HASH_SIZE)
    p.add_argument("-n", "--no_count_stats", action="store_true")
    p.add_argument("-g", "--output_gc_stats", action="store_true")
    p.add_argument("-E", "--extract_nr", action="store_true")
    p.add_argument("-F", "--extract_r", action="store_true")
    p.add_argument("-M", "--min_repeat", type=int, default=2)
    p.add_argument("-G", "--max_repeat", type=int, default=0)
    p.add_argument("-d", "--dump_hash", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("seq_file")
    p.add_argument("counts_files", nargs="+")
    p.set_defaults(func=_run_sect)


def _run_sect(args) -> int:
    from .tools.common import glob_files, parse_trim_list
    from .tools.sect import Sect

    print("Running KAT in SECT mode")
    print("------------------------")
    print()
    with total("KAT SECT"):
        s = Sect(glob_files(args.counts_files), args.seq_file)
        s.output_prefix = args.output_prefix
        s.input.device = _device(args)
        s.input.flush = args.flush
        s.gc_bins = args.gc_bins
        s.cvg_bins = args.cvg_bins
        s.cvg_logscale = args.cvg_logscale
        s.input.trim5 = parse_trim_list(args.trim5)
        s.input.canonical = not args.non_canonical
        s.input.mer_len = args.mer_len
        s.input.hash_size = args.hash_size
        s.no_count_stats = args.no_count_stats
        s.output_gc_stats = args.output_gc_stats
        s.extract_nr = args.extract_nr
        s.extract_r = args.extract_r
        s.min_repeat = args.min_repeat
        s.max_repeat = args.max_repeat
        s.input.dump_hash = args.dump_hash
        s.verbose = args.verbose
        s.execute()
        s.save()
    return 0


def main(argv: list[str] | None = None) -> int:
    # Fatal-signal backtraces, the analogue of the reference's SIGSEGV
    # handler (src/kat.cc:158-170 prints a backtrace and aborts).
    import faulthandler

    try:
        faulthandler.enable()
    except (OSError, ValueError, io.UnsupportedOperation):
        pass  # stderr has no fileno (e.g. captured by a test harness)
    parser = argparse.ArgumentParser(
        prog="kat", add_help=False,
        description="The K-mer Analysis Toolkit (KAT), PyTorch/CUDA port. "
                    "The first argument should be the tool/mode you wish to "
                    "use: hist, sect.")
    parser.add_argument("--version", action="version",
                        version=f"kat {__version__} (kat_tpu_torch)")
    parser.add_argument("--help", action="help")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where tables live and kernels run: the first "
                             "NVIDIA card (default; an error without one) "
                             "or the CPU.")
    parser.add_argument("--flush", choices=("classic", "bucketed"),
                        default="classic",
                        help="How sequence files are counted: sort, merge "
                             "and reduce of the extracted windows (default) "
                             "or the minimizer-bucketed chunk flush "
                             "(canonical, 13 < k <= 29, files only; an "
                             "error otherwise).")
    sub = parser.add_subparsers(dest="mode")
    _add_hist(sub)
    _add_sect(sub)
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help()
        return 1
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
