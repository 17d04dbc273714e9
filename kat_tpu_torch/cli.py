"""`kat`-compatible command line (reference src/kat.cc mode dispatch).

Port of kat_tpu/cli.py with every mode (`hist`, `gcp`, `comp`, `sect`,
`cold`, `filter {kmer,seq}` and `plot`), the same flags, defaults, plots
and peak analysis, plus a top-level `--device` (the card unless the CPU is
asked for; `plot` touches no device), `--shards N` (count on a mesh of N
shards: the counterpart of kat_tpu's KAT_TPU_SHARD=1 on an N-device mesh)
`--flush` (the classic counting flush unless the minimizer-bucketed
one is asked for: the counterpart of kat_tpu's KAT_TPU_MINIMIZER switch)
and `--profile DIR` (a torch.profiler trace of the run, kat_tpu's
KAT_TPU_PROFILE; utils/profiling.py).  In a multi-process run, started by
parallel/distributed.init_distributed before `main`, every count shards
over every process's shards, and each process leaves the group through
parallel/distributed.shutdown after `main` returns: `run` is `main` and
then that.
Usage: python -m kat_tpu_torch [--device {cuda,cpu}] [--shards N]
       [--flush {classic,bucketed}] [--profile DIR] <mode> [options] ...
"""

from __future__ import annotations

import argparse
import io
import sys

from . import DEFAULT_HASH_SIZE, DEFAULT_MER_LEN, __version__
from .utils.timer import stage, total


def _plot(mode: str, argv: list[str], quiet: bool = False) -> None:
    """Run a plot module, tolerating plotting errors like the reference's
    embedded-python path (failures print but don't kill the tool run): a
    host without matplotlib prints `Plotting failed: ...` and goes on."""
    from .plot import run_plot

    try:
        with stage("Creating plot", quiet=quiet):
            run_plot(mode, argv)
    except Exception as e:  # noqa: BLE001
        print(f"Plotting failed: {e}", file=sys.stderr)


def _analyse_peaks(input_file: str, output_prefix: str, banner: str,
                   verbose: bool = False) -> None:
    """Run distribution analysis on a tool artifact (the reference shells
    into kat/distanalysis.py via the embedded interpreter,
    e.g. histogram.cc:201-231)."""
    from .analysis import distanalysis

    print(banner)
    print("-" * len(banner))
    argv = []
    if verbose:
        argv.append("--verbose")
    argv += ["--from_kat", f"--output_prefix={output_prefix}", input_file]
    try:
        distanalysis.main(argv)
    except Exception as e:  # noqa: BLE001
        print(f"Peak analysis failed: {e}", file=sys.stderr)
    print()


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
        h.input.n_shards = args.shards
        h.input.trim5 = parse_trim_list(args.trim5)
        h.input.canonical = not args.non_canonical
        h.input.mer_len = args.mer_len
        h.input.hash_size = args.hash_size
        h.input.dump_hash = args.dump_hash
        h.verbose = args.verbose
        h.execute()
        h.save()
        _plot("spectra-hist",
              [f"--output={args.output_prefix}.{args.output_type}",
               args.output_prefix])
        _analyse_peaks(args.output_prefix, args.output_prefix,
                       "Analysing peaks", args.verbose)
    return 0


def _add_gcp(sub):
    p = sub.add_parser(
        "gcp", add_help=True,
        description="K-mer GC Processor: matrix of GC count x k-mer "
                    "frequency over all distinct k-mers.")
    _common_count_flags(p, "kat-gcp")
    p.add_argument("-x", "--cvg_scale", type=float, default=1.0,
                   help="Scaling factor for coverage bins.")
    p.add_argument("-y", "--cvg_bins", type=int, default=1000,
                   help="Number of bins for the cvg data.")
    p.add_argument("-p", "--output_type", default="png")
    p.add_argument("inputs", nargs="+")
    p.set_defaults(func=_run_gcp)


def _run_gcp(args) -> int:
    from .tools.common import glob_files, parse_trim_list
    from .tools.gcp import Gcp

    print("Running KAT in GCP mode")
    print("------------------------")
    print()
    with total("KAT GCP"):
        g = Gcp(glob_files(args.inputs))
        g.output_prefix = args.output_prefix
        g.input.device = _device(args)
        g.input.flush = args.flush
        g.input.n_shards = args.shards
        g.cvg_scale = args.cvg_scale
        g.cvg_bins = args.cvg_bins
        g.input.trim5 = parse_trim_list(args.trim5)
        g.input.canonical = not args.non_canonical
        g.input.mer_len = args.mer_len
        g.input.hash_size = args.hash_size
        g.input.dump_hash = args.dump_hash
        g.execute()
        g.save()
        _plot("density",
              [f"--output={args.output_prefix}.mx.{args.output_type}",
               f"{args.output_prefix}.mx"])
        _analyse_peaks(f"{args.output_prefix}.mx", args.output_prefix,
                       "Analysing peaks", args.verbose)
    return 0


def _add_comp(sub):
    p = sub.add_parser(
        "comp", add_help=False,
        description="K-mer comparison tool: shared k-mer matrix between two "
                    "(or three) inputs.")
    p.add_argument("--help", action="help")
    p.add_argument("-o", "--output_prefix", default="kat-comp")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-x", "--d1_scale", type=float, default=1.0)
    p.add_argument("-y", "--d2_scale", type=float, default=1.0)
    p.add_argument("-i", "--d1_bins", type=int, default=1001)
    p.add_argument("-j", "--d2_bins", type=int, default=1001)
    p.add_argument("--d1_5ptrim", default="0")
    p.add_argument("--d2_5ptrim", default="0")
    p.add_argument("-N", "--non_canonical_1", action="store_true")
    p.add_argument("-O", "--non_canonical_2", action="store_true")
    p.add_argument("-P", "--non_canonical_3", action="store_true")
    p.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN)
    p.add_argument("-H", "--hash_size_1", type=int, default=DEFAULT_HASH_SIZE)
    p.add_argument("-I", "--hash_size_2", type=int, default=DEFAULT_HASH_SIZE)
    p.add_argument("-J", "--hash_size_3", type=int, default=DEFAULT_HASH_SIZE)
    p.add_argument("-d", "--dump_hashes", action="store_true")
    p.add_argument("-g", "--disable_hash_grow", action="store_true")
    p.add_argument("-n", "--density_plot", action="store_true")
    p.add_argument("-p", "--output_type", default="png")
    p.add_argument("-h", "--output_hists", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("input_1")
    p.add_argument("input_2")
    p.add_argument("input_3", nargs="?", default=None)
    p.set_defaults(func=_run_comp)


def _run_comp(args) -> int:
    from .tools.comp import Comp
    from .tools.common import glob_files, parse_trim_list

    print("Running KAT in COMP mode")
    print("------------------------")
    print()
    with total("KAT COMP"):
        c = Comp(glob_files(args.input_1), glob_files(args.input_2))
        if args.input_3:
            c.set_third_input(glob_files(args.input_3))
        device = _device(args)
        for inp in c.inputs:
            inp.device = device
            inp.flush = args.flush
            inp.n_shards = args.shards
        c.output_prefix = args.output_prefix
        c.d1_scale = args.d1_scale
        c.d2_scale = args.d2_scale
        c.d1_bins = args.d1_bins
        c.d2_bins = args.d2_bins
        c.inputs[0].trim5 = parse_trim_list(args.d1_5ptrim)
        c.inputs[1].trim5 = parse_trim_list(args.d2_5ptrim)
        c.set_mer_len(args.mer_len)
        c.inputs[0].canonical = not args.non_canonical_1
        c.inputs[1].canonical = not args.non_canonical_2
        c.inputs[2].canonical = not args.non_canonical_3
        c.inputs[0].hash_size = args.hash_size_1
        c.inputs[1].hash_size = args.hash_size_2
        c.inputs[2].hash_size = args.hash_size_3
        c.dump_hashes = args.dump_hashes
        c.disable_hash_grow = args.disable_hash_grow
        c.output_hists = args.output_hists
        c.verbose = args.verbose
        c.execute()
        c.save()
        print()
        print("Summary statistics")
        print("------------------")
        print()
        c.print_counters(sys.stdout)

        main_mx = f"{args.output_prefix}-main.mx"
        if args.density_plot:
            _plot("density",
                  [f"--output={main_mx}.density.{args.output_type}",
                   main_mx])
        else:
            _plot("spectra-cn",
                  [f"--output={main_mx}.spectra-cn.{args.output_type}",
                   main_mx])
        if args.density_plot and args.output_hists:
            _analyse_peaks(f"{args.output_prefix}.1.hist",
                           f"{args.output_prefix}.1",
                           "Analysing peaks for dataset 1", args.verbose)
            _analyse_peaks(f"{args.output_prefix}.2.hist",
                           f"{args.output_prefix}.2",
                           "Analysing peaks for dataset 2", args.verbose)
        elif not args.density_plot:
            _analyse_peaks(main_mx, args.output_prefix,
                           "Analysing peaks for spectra copy number matrix",
                           args.verbose)
        else:
            print("Current configuration does not support peak analysis.")
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
        s.input.n_shards = args.shards
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


def _add_cold(sub):
    p = sub.add_parser(
        "cold", add_help=True,
        description="Given reads and an assembly, calculates read and "
                    "assembly k-mer coverage plus GC%% per sequence.")
    p.add_argument("-o", "--output_prefix", default="kat-cold")
    p.add_argument("-x", "--gc_bins", type=int, default=1001)
    p.add_argument("-y", "--cvg_bins", type=int, default=1001)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--5ptrim", dest="trim5", default="0")
    p.add_argument("-N", "--non_canonical", action="store_true")
    p.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN)
    p.add_argument("-H", "--hash_size", type=int, default=DEFAULT_HASH_SIZE)
    p.add_argument("-g", "--disable_hash_grow", action="store_true")
    p.add_argument("-d", "--dump_hashes", action="store_true")
    p.add_argument("-p", "--output_type", default="png")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("asm_file")
    p.add_argument("reads_files", nargs="+")
    p.set_defaults(func=_run_cold)


def _run_cold(args) -> int:
    from .tools.cold import Cold
    from .tools.common import glob_files, parse_trim_list

    print("Running KAT in COLD mode")
    print("------------------------")
    print()
    with total("KAT COLD"):
        c = Cold(glob_files(args.reads_files), args.asm_file)
        c.output_prefix = args.output_prefix
        device = _device(args)
        for inp in (c.reads, c.assembly):
            inp.device = device
            inp.flush = args.flush
            inp.n_shards = args.shards
            inp.disable_grow = args.disable_hash_grow
            inp.mer_len = args.mer_len
        c.gc_bins = args.gc_bins
        c.cvg_bins = args.cvg_bins
        c.reads.trim5 = parse_trim_list(args.trim5)
        c.reads.canonical = not args.non_canonical
        c.reads.hash_size = args.hash_size
        c.dump_hashes = args.dump_hashes
        c.verbose = args.verbose
        c.execute()
        _plot("cold", [f"--output={args.output_prefix}.{args.output_type}",
                       f"{args.output_prefix}-stats.tsv"])
    return 0


def _add_filter(sub):
    p = sub.add_parser("filter", add_help=True,
                       description="Filtering tools for k-mers and sequences.")
    fsub = p.add_subparsers(dest="filter_mode", required=True)

    fk = fsub.add_parser("kmer", add_help=False)
    fk.add_argument("--help", action="help")
    fk.add_argument("-o", "--output_prefix", default="kat.filter-kmer")
    fk.add_argument("-t", "--threads", type=int, default=1)
    fk.add_argument("--low_count", "-c", type=int, default=0)
    fk.add_argument("--high_count", "-d", type=int, default=10000)
    fk.add_argument("--low_gc", "-g", type=int, default=0)
    fk.add_argument("--high_gc", "-h", type=int, default=31)
    fk.add_argument("-i", "--invert", action="store_true")
    fk.add_argument("-s", "--separate", action="store_true")
    fk.add_argument("-N", "--non_canonical", action="store_true")
    fk.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN)
    fk.add_argument("-H", "--hash_size", type=int, default=DEFAULT_HASH_SIZE)
    fk.add_argument("-v", "--verbose", action="store_true")
    fk.add_argument("inputs", nargs="+")
    fk.set_defaults(func=_run_filter_kmer)

    fs = fsub.add_parser("seq", add_help=True)
    fs.add_argument("-o", "--output_prefix", default="kat.filter.seq")
    fs.add_argument("-t", "--threads", type=int, default=1)
    fs.add_argument("-T", "--threshold", type=float, default=0.1)
    fs.add_argument("-f", "--frequency", type=float, default=0.0)
    fs.add_argument("-i", "--invert", action="store_true")
    fs.add_argument("-s", "--separate", action="store_true")
    fs.add_argument("--stats", action="store_true")
    fs.add_argument("-N", "--non_canonical", action="store_true")
    fs.add_argument("-m", "--mer_len", type=int, default=DEFAULT_MER_LEN)
    fs.add_argument("-H", "--hash_size", type=int, default=DEFAULT_HASH_SIZE)
    fs.add_argument("-v", "--verbose", action="store_true")
    fs.add_argument("--seq", required=True, help="Sequence file to filter.")
    fs.add_argument("--seq2", default=None,
                    help="Second sequence file for paired mode.")
    fs.add_argument("inputs", nargs="+")
    fs.set_defaults(func=_run_filter_seq)


def _run_filter_kmer(args) -> int:
    from .tools.common import glob_files
    from .tools.filter_kmer import FilterKmer

    print("Running KAT in filter kmer mode")
    print("-------------------------------")
    print()
    with total("KAT filter kmer"):
        f = FilterKmer(glob_files(args.inputs))
        f.output_prefix = args.output_prefix
        f.input.device = _device(args)
        f.input.flush = args.flush
        f.input.n_shards = args.shards
        f.low_count = args.low_count
        f.high_count = args.high_count
        f.low_gc = args.low_gc
        f.high_gc = args.high_gc
        f.invert = args.invert
        f.separate = args.separate
        f.input.canonical = not args.non_canonical
        f.input.mer_len = args.mer_len
        f.input.hash_size = args.hash_size
        f.execute()
    return 0


def _run_filter_seq(args) -> int:
    from .tools.common import glob_files
    from .tools.filter_seq import FilterSeq

    print("Running KAT in filter sequences mode")
    print("------------------------------------")
    print()
    with total("KAT filter seq"):
        f = FilterSeq(args.seq, args.seq2, glob_files(args.inputs))
        f.output_prefix = args.output_prefix
        f.input.device = _device(args)
        f.input.flush = args.flush
        f.input.n_shards = args.shards
        f.threshold = args.threshold
        f.frequency = args.frequency
        f.invert = args.invert
        f.separate = args.separate
        f.do_stats = args.stats
        f.input.canonical = not args.non_canonical
        f.input.mer_len = args.mer_len
        f.input.hash_size = args.hash_size
        f.execute()
    return 0


def _add_plot(sub):
    p = sub.add_parser("plot", add_help=True,
                       description="Plotting tools: density, profile, "
                                   "spectra-cn, spectra-hist, spectra-mx, "
                                   "cold.")
    p.add_argument("plot_mode",
                   choices=["density", "profile", "spectra-cn",
                            "spectra-hist", "spectra-mx", "cold"])
    p.add_argument("args", nargs=argparse.REMAINDER)
    p.set_defaults(func=_run_plot)


def _run_plot(args) -> int:
    """Host work on the artifacts alone: --device and --shards do not
    apply."""
    from .plot import run_plot
    return run_plot(args.plot_mode, args.args)


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
                    "use: hist, gcp, comp, sect, cold, filter, plot.")
    parser.add_argument("--version", action="version",
                        version=f"kat {__version__} (kat_tpu_torch)")
    parser.add_argument("--help", action="help")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where tables live and kernels run: the first "
                             "NVIDIA card (default; an error without one) "
                             "or the CPU.")
    parser.add_argument("--shards", type=int, default=None, metavar="N",
                        help="Count on a mesh of N shards, the tables "
                             "staying on their shards for the analysis "
                             "(round-robin over the visible cards; all on "
                             "the CPU with --device cpu).  Default: a mesh "
                             "over every card when more than one is "
                             "visible, else one device.")
    parser.add_argument("--flush", choices=("classic", "bucketed"),
                        default="classic",
                        help="How sequence files are counted: sort, merge "
                             "and reduce of the extracted windows (default) "
                             "or the minimizer-bucketed chunk flush "
                             "(canonical, 13 < k <= 29, files only; an "
                             "error otherwise).")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="Write a torch.profiler trace of the run to "
                             "DIR (kat_tpu's KAT_TPU_PROFILE).")
    sub = parser.add_subparsers(dest="mode")
    for adder in (_add_hist, _add_gcp, _add_comp, _add_sect, _add_cold,
                  _add_filter, _add_plot):
        adder(sub)
    args = parser.parse_args(argv)
    if args.mode is None:
        parser.print_help()
        return 1
    from .utils.profiling import maybe_trace

    with maybe_trace(args.profile):
        return args.func(args)


def run(argv: list[str] | None = None) -> int:
    """`main`, then, in a multi-process run, leave the group before the
    process exits (parallel/distributed.shutdown).  A run that never
    loaded torch.distributed has no group to leave (`plot` loads no
    torch)."""
    code = main(argv)
    if "torch.distributed" in sys.modules:
        from .parallel.distributed import shutdown

        shutdown()
    return code


if __name__ == "__main__":
    sys.exit(main())
