#!/usr/bin/env python3
"""Drive kat_tpu_torch once on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   kat_tpu_torch/csrc and prints the build time;
2. checks each kernel (K1 sort, K2 merge, K3 reduce of the counting path;
   K4 compact, K1 with a value and K2 with payload planes of the lookup
   path; K5 chunk sort and K6 run merge of the bucketed flush; K7's round
   classes; the binned sums of hist, gcp and comp) against its plain
   PyTorch version on the card at its path's shapes, exactly (integer
   keys and counts: tolerance 0), with its time, the plain version's, its
   bound and, where one PyTorch call computes the same function, that
   call's time.  K1, alone and with a value, is also
   held against its plain version on the inputs that strain its look-back
   (all keys equal, all SENTINEL, 90% one key, sorted, and lengths around
   its tile), its full-size sort is run five times with equal outputs, the
   kernels and memsets of one sort are counted by torch.profiler, and
   it is timed at 2^16, 2^20 and 2^23 pairs beside torch.sort.  K3 and both
   forms of K2 are held against their plain versions on the inputs that
   strain a single pass (one run across every tile, 2^26 equal keys, all
   SENTINEL, a count of 2^31 - 1, interior sentinel runs, overflow, no
   slots, n = 1, an empty side, every key tied, one side before the other,
   lengths around the tile), each is run five times at the path's shapes
   with equal outputs, and the kernels and memsets inside one call of
   each are counted by torch.profiler;
2b. checks the W-word forms of K1, K2 and K3 (wide keys, 31 < k <= 255)
   against their plain versions at the wide flush's shapes (k = 41, W = 2:
   2^26 fresh keys, a 2^24-slot table, their 83.9M-element merge), timed,
   five runs each with equal outputs, and on strain inputs (random, equal
   top words, all SENTINEL, one run) at k = 33, 62, 63, 93, 94, 124, 125
   and 255 (W = 2..9); their kernels and memsets inside one call are
   counted in the same profiled window as the others;
2c. checks the binned-sums kernel (csrc/binned.cu, the binned form of
   kat_tpu's K1 + K3) against its plain version and the window kernel it
   replaced (benchmarks/earlier/, timed beside it) at the main path's
   shapes: 2^24 slots binned into the histogram's 10,001 bins, gcp's
   28,028, and comp's 1,002,001 with three masks at the
   reads-against-assembly skew and uniform; and K2 with two payload planes
   and the two K4 compactions
   of the fused dual probe at its shape (two 2^24-slot tables), the probe
   as a whole against two binary searches; each timed beside its library
   call, five runs with equal outputs, counted in the same profiled
   window;
2d. checks the wide join's two kernel forms: K1 W-word carrying a
   value (2^23 pairs at W = 2 and 4) and K2 W-word with one payload plane
   a side (a 2^24-slot table + 2^23 sorted queries) and two (two 2^24-slot
   tables, the wide dual probe, also held as a whole against two
   searches), five runs each, both forms also timed at `filter seq -m
   41`'s batch (1,007,616 queries against the 2^24-slot table), then on
   strain inputs at W = 2..9 and at lengths around their tiles; counted
   in the same profiled window;
2e. checks K6, the k-way run merge (csrc/merge_runs.cu), one-word and
   over W words, at the sharded flush's arrival shapes (8 runs of 2^22
   slots, a quarter of each real keys, the rest SENTINEL: k = 27, one
   word, and k = 41, W = 2), five runs each with equal outputs, timed
   beside the tree of pairwise merges it replaced
   (benchmarks/earlier_kernels.py) and its plain version, with both its
   bounds (every byte once; the real keys read and every output
   written); then at W = 2..9 on 8 runs of 2^18 slots, 3/4 SENTINEL, and
   on strain inputs; its kernels inside one call (also at the bucketed
   flush's group of 128 chunk runs) counted in the same profiled window;
2f. checks the matrix text writer (core/matrix.format_rows) on the card
   against the per-cell loop it replaced at chr14.comp's 1001 x 1001
   shape, both orientations, timed beside the same call on the CPU and
   the loop;
3. drives the counting path at bench.py's scale: k=27 canonical reads
   from an 8.4 Mbp random genome, 48 batches of 4096 x 1024 codes (196M
   windows, 3 flushes of 2^26 windows), table grown from 2^20 to 2^24
   slots; the table and histogram must equal torch.unique over the same
   windows (extracted by the plain version), and each counting kernel
   must have been launched by that run, the extraction kernel once a
   batch (checked and timed at one such batch before the profiled
   window, beside its bound and its plain version);
4. drives the lookup path at full width against that table: the k=27
   windows of the same genome, 128 rows of 65,562 codes (2^23 windows,
   1% of bases substituted, a few invalid), through
   coverage.window_counts, by the policy's route (the binary search for a
   narrow table) and by the sort-merge join, whose three kernels must each
   have been launched by that run; both equal a reference built from
   torch.unique's table;
4a. runs gcp_matrix over that table (against the plain binned sum of
   torch.unique's table) and comp of that reads table against the
   genome's own k = 27 k-mers, and with a third input, a second read draw
   of 24 batches (Comp.compare_tables, default bins and scales, the dual
   probe engaged), cold and warm, held against numpy over the tables' keys
   and counts; the binned-sums, K2-with-payload and K4 launches of each
   run are read; the packed form of the binned sums (`packed_sums`) is
   then held against its plain version and the window kernel on the
   inputs comp pass 1 and pass 2 gave it over that table, and timed;
4b. drives wide-key counting through WideCodeStreamingCounter on the main
   path's reads at k = 41 (193,462,272 windows, table grown from 2^20 to
   2^24 slots, W = 2) and on 8 of its batches at k = 95 (W = 4, a top word
   of 4 bits), cold and warm; tables and histograms must equal a reference
   built by the plain W-word sort and reduce over the same windows, and
   each W-word kernel must have been launched by each run; then prints the
   k = 41 path's device time by kernel (benchmarks/profile_main.py --k 41
   in a process of its own);
4c. runs `cold` of the genome as 1024 contigs of 8192 bases
   against that table (tools.cold.Cold), and `filter kmer -c 5 -d 100`
   over it (tools.filter_kmer.FilterKmer), against numpy; then, after the
   wide path below, the same at k = 41, the k = 41 lookup path (2^23
   windows through the wide join, whose three kernels must each launch
   once, equal to the search) and `comp -m 41` through the wide dual probe
   (Comp.compare_tables against numpy);
4d. drives the mesh-sharded paths (parallel/sharded.py, analysis.py,
   longseq.py) with every shard on the card: the main path's 48 batches
   at k = 27 counted on meshes of 8 and of 1 shards and 24 of them at
   k = 41 on 8 (workloads.sharded_counter), each shard against the
   one-device table (the keys the owner hash gives it, their counts) and
   finish() against it, on the card, beside the one-device rate of the
   same batches in this call (the sharded/single ratio); hist, gcp and
   comp (two and three inputs, the dual probe per shard) over the 8
   shards against the one-device results; the lookup path's 2^23 windows
   through routed lookups (analysis.window_counts_routed) against the
   one-table counts; then `--shards 8 sect` of the genome as one
   8,389,632-base contig (the halo path) through cli.main, its artifacts
   byte-identical to the one-device sect's.  K1, K6 (one-word and
   W-word), K2 and K3 must each have been launched by the counting runs,
   which are read between a reset and their end (K6 is held against its
   plain version at these runs' arrival shapes in step 2e);
5. runs `python -m kat_tpu_torch` on synthetic files (200,000 reads of
   150 bases from a 2^20-base genome): `hist -d` (held against numpy) and
   `hist` from the dumped .jf (same histogram), and `hist --flush
   bucketed` through cli.main.  hist, gcp, comp and cold here and in 6b
   plot and analyse peaks as kat_tpu's default runs do: every plot and
   the analysis's figure is a PNG, or, where matplotlib is not installed,
   `Plotting failed: ...` is on stderr once per plot (kat_tpu's contract
   for the optional library; the first CLI line says which libraries are
   installed); every `.dist_analysis.json` names a homozygous peak within
   PEAK_TOLERANCE of the read model's k-mer coverage; the seconds the
   plots and analysis add are printed per mode;
6. runs `sect` of 200 contigs against those reads through the command
   line's entry point (kat_tpu_torch.cli.main) inside this process, so
   that the tool's own launches can be read: the six counts are set to 0
   just before and read just after, every kernel must have been launched,
   the lookup kernels once per length bucket that the join policy takes,
   and those buckets must hold most of the windows; the artifacts are held
   against numpy; then `gcp`, `comp` of the reads against the contigs
   (with `-d`), with a third read set, and of the two dumped .jf through
   cli.main, every artifact against numpy;
   `cold` (of the contigs that hold a k-mer), `filter kmer -c 5 -d 100`
   and `filter seq --stats` through cli.main against numpy;
6a. runs `python -m kat_tpu_torch.jf_cli` (kat_jellyfish) on those reads:
   `count -m 27 -C` in a process of its own (file to .jf, against
   numpy), `count` of each half of the reads in this process with K1/K2/K3's
   launches read around it, `merge` of the halves (the count of all),
   `histo`, `stats`, `query` and `dump -c -L 40` against numpy;
6b. the same at k = 41 (200,000 reads): `hist -m 41 -d` as a process and
   `hist` of its .jf through cli.main, `sect -m 41` through cli.main with
   the W-word kernels' and the wide join's launch counts read around it
   (the wide join once per length bucket the policy takes), `gcp -m 41`,
   `comp -m 41`, `cold`, `filter kmer` and `filter seq`; every artifact
   against numpy.

7. drives the minimizer-bucketed flush at full width: the main path's read
   model (k=27 canonical, 196,608 reads of 1024 bases from the 2^23-base
   genome) plus 2% low-complexity reads, written as FASTA and counted twice
   through tools.common.Input, flush="classic" and flush="bucketed".  The
   two tables must be equal; K5, K6, K3, K2 with counts and sort_pairs must
   each have been launched by the bucketed run, K6 once per hot group the
   router reported.  Prints both file-to-table times, the router's host
   windows/s, the device k-mers/s of both flushes over staged input, the
   record fill and the groups per flush; then checks and times K5 at one
   flush's shape (uniform 60-bit keys, and that run's first flush, whose
   chunks' keys share their high bits), beside the bitonic kernel it
   replaced, and K6 at the largest hot group that run saw (beside the tree
   it replaced); then runs
   K7's microbenchmark (kat_tpu's benchmarks/profile_roll.py: every class
   at R = 0, 1 and 7 against its plain version, timed at R = 512, 0 and
   256, and t(512) - t(0) twice t(256) - t(0) within 10%), whose
   costliest class is also held against its plain version at R = 512.
   Then `filter seq --stats -s` of that FASTA against its genome's k-mers
   at k = 27 and 41 (tools.filter_seq.FilterSeq): the .stats file's bases
   and k-mers for every read, its hits for all low-complexity reads and
   every 64th other one against numpy, the kept and discarded counts
   against the ratios and the records written;
7b. starts two processes on the one card (this script with
   `--two-process-worker`), one shard each, in one torch.distributed gloo
   group over a file:// store (they share the card, which NCCL refuses):
   each reads its slice of a shard:// group of the CLI phase's 200,000
   reads split into two FASTQs of 120,000 and 80,000 reads, and runs `hist
   -m 27`, `hist -m 41`, `comp -m 27` (against step 6's contigs) and `sect
   -m 27` through cli.main; every artifact of each process must equal one
   process's `--shards 2` run on the card byte for byte, and each
   process's counting flushes must launch K1, K6, K2 and K3 (read around
   each run, as the sharded phases' are).  A worker that fails or outlives
   WORKER_TIMEOUT fails the run.  Their counter, saved by
   save_sharded_counter, is loaded here on a mesh of 2 shards and must
   equal the live table; a checkpoint at k = 33 whose manifest says
   key_words 4 (k = 33 needs 3) must be refused by load_table,
   load_sharded_counter and load_shard with a ValueError; then ops/verify.verify_kernels and
   verify_kernels_wide (4, 8 and 16 of kat_tpu's words) must pass on the
   card.  Each step's seconds are printed with the card's name and limit;
8. the route sweep (benchmarks/sweep_lookup.route_table: join
   against search for 1, 2 and 4 words, 2^20 and 2^24 slots, 2^16-2^23
   queries, and the dual probe), and one count past 2^30 distinct keys:
   2^30 + 2^26 keys of an affine bijection, each fed twice in flushes of
   2^26 through StreamingCounter (the merged stream reduced in pieces);
   n_unique, every count 2, ascending keys and the keys' sum checked.

Any failure raises (exit code != 0).  Without a CUDA device it fails at
once and prints no result.  The last two lines are the kernels' JSON and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 42
# the whole script's last lap on an H100 80GB HBM3 at 700 W before
# _library_merge_ms and refused_checkpoint, printed beside this run's
EARLIER_LAP_S = 549.7
TOLERANCE = 0  # exact: keys and counts are integers
ALU_OPS_PER_S = 67e12      # H100 SXM, published float32 rate outside the
#                            tensor cores: the stand-in for integer
#                            compares and adds, which have no published rate


SPIN_CYCLES = 50_000_000  # ~25 ms of the card's clock


def _timed_ms(fn, reps: int) -> float:
    """ms of one call of fn on the card: CUDA events around `reps` calls
    after a warm-up, queued behind a spin kernel so that the events time
    the card's work, not the host's launches (a packed_sums call takes
    0.04-0.1 ms of host time, its kernels 0.06 ms at comp pass 2)."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    if err > TOLERANCE:
        raise AssertionError(f"max_abs_err {err} > {TOLERANCE}")
    return err


def _bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the memory rate, or the function's
    compares and adds at the ALU rate, whichever is larger."""
    from kat_tpu_torch.benchmarks.workloads import HBM_BYTES_PER_S

    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ALU_OPS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _same(got, want) -> int:
    """max_abs_err over matching tuples of tensors."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs != {len(want)}")
    return max(_max_abs_err(g, w) for g, w in zip(got, want))


def _library_merge_ms(a_keys, a_planes, b_keys, b_planes, want) -> float:
    """library_ms of a narrow K2: one stable torch.sort of the two sides'
    keys, each plane gathered through its permutation.  Its output is
    checked against the kernel's (`want`: keys, then the planes) before
    it is timed."""
    import torch

    def call():
        keys, perm = torch.sort(torch.cat([a_keys, b_keys]), stable=True)
        return (keys, *(torch.cat([pa, pb])[perm]
                        for pa, pb in zip(a_planes, b_planes)))

    _same(call(), want)
    return _timed_ms(call, 3)


def _report(entry: dict, what: str) -> dict:
    lib = entry["library_ms"]
    print(f"{what}: exact, kernel {entry['ms']:.3f} ms, plain "
          f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms by "
          f"{entry['bound_by']} (the kernel reaches "
          f"{entry['bound_ms'] / entry['ms']:.1%} of it), library "
          + (f"{lib:.3f} ms" if lib is not None else "none")
          + (f"; {entry['passes']} passes of tile {entry['tile']}, the "
             f"passes' floor {entry['floor_ms']:.3f} ms"
             if "floor_ms" in entry else
             f"; tile {entry['tile']}" if "tile" in entry else ""))
    return entry


KEY_BITS = 55  # k = 27: what counting and the join pass to K1


def _k1_extras(with_values: bool, n: int) -> dict:
    """What the K1 entries say beside the common keys: the pass structure
    and its own floor (one read for the histograms, one read and one write
    per digit), which the one-read-one-write bound cannot reach."""
    from kat_tpu_torch.benchmarks.workloads import HBM_BYTES_PER_S
    from kat_tpu_torch.ops import sort_kernel

    return dict(
        passes=(KEY_BITS + 7) // 8,
        tile=sort_kernel.tile_len(with_values),
        floor_ms=sort_kernel.pass_floor_bytes(n, with_values, KEY_BITS)
        / HBM_BYTES_PER_S * 1e3)


def _k1_sort(keys, with_values: bool):
    """(kernel outputs, plain outputs) of K1 on `keys`; with a value every
    key carries its position, so a pass that is not stable shows."""
    import torch

    from kat_tpu_torch.ops import sort_kernel

    if not with_values:
        return ((sort_kernel.sort_keys(keys, KEY_BITS),),
                (sort_kernel.sort_keys_plain(keys),))
    pos = torch.arange(keys.numel(), dtype=torch.int32, device=keys.device)
    return (sort_kernel.sort_pairs(keys, pos, KEY_BITS),
            sort_kernel.sort_pairs_plain(keys, pos))


def check_sort_shapes(dev, gen, with_values: bool, n: int, keys) -> None:
    """K1 exact against its plain version where a look-back can go wrong:
    one digit chain carrying everything or nearly everything, input that is
    already sorted, and lengths around the tile; then the sort of `keys`
    (the full-size random case) five times over with equal outputs, since a
    race between tiles shows as a difference between runs."""
    import torch

    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import sort_kernel

    def random_keys(m):
        k = torch.randint(0, 1 << 54, (m,), dtype=torch.int64, device=dev,
                          generator=gen)
        k[torch.rand(m, device=dev, generator=gen) < 0.1] = SENTINEL
        return k

    tile = sort_kernel.tile_len(with_values)
    hot = random_keys(n)
    hot[torch.rand(n, device=dev, generator=gen) < 0.9] = 0x2AAAAAAAAAAAAA
    cases = [("all equal", torch.full((n,), 12345, dtype=torch.int64,
                                      device=dev)),
             ("all SENTINEL", torch.full((n,), SENTINEL, dtype=torch.int64,
                                         device=dev)),
             ("90% one key", hot),
             ("sorted", torch.sort(random_keys(n)).values)]
    cases += [(f"n = {m}", random_keys(m))
              for m in (1, tile - 1, tile, tile + 1, 3 * tile + 17)]
    for _name, k in cases:
        _same(*_k1_sort(k, with_values))
    first, _ = _k1_sort(keys, with_values)
    for _ in range(4):
        again, _ = _k1_sort(keys, with_values)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError("two runs of K1 on the same input differ")
    print(f"K1{' with a value' if with_values else ''}: exact on "
          + ", ".join(name for name, _ in cases[:4]) + f" (2^"
          f"{n.bit_length() - 1} each) and at "
          + ", ".join(name for name, _ in cases[4:])
          + f" (tile {tile}); five sorts of 2^{keys.numel().bit_length() - 1}"
          " agree")


def time_small_sorts(dev, gen) -> None:
    """K1 with a value at the sizes sect's length buckets give the join."""
    import torch

    from kat_tpu_torch.ops import sort_kernel

    parts = []
    for lg in (16, 20, 23):
        k = torch.randint(0, 1 << 54, (1 << lg,), dtype=torch.int64,
                          device=dev, generator=gen)
        pos = torch.arange(1 << lg, dtype=torch.int32, device=dev)
        ms = _timed_ms(lambda: sort_kernel.sort_pairs(k, pos, KEY_BITS), 20)
        lib = _timed_ms(lambda: torch.sort(k, stable=True), 20)
        parts.append(f"2^{lg} pairs {ms:.4f} ms (torch.sort(stable=True) "
                     f"{lib:.4f} ms)")
    print("K1 with a value: " + "; ".join(parts))


def check_flush_shapes(dev, gen, shapes) -> None:
    """K3 and both forms of K2 exact against their plain versions where a
    single pass can go wrong (workloads.reduce_strain / merge_strain: one
    run across every tile, 2^26 equal keys, all SENTINEL, a count of
    2^31 - 1, interior sentinel runs, overflow, no slots, n = 1, one side
    empty, every key tied, one side before the other, lengths around the
    tile), then five runs of each at the path's shapes with equal
    outputs, since a race between tiles shows as a difference between
    runs."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel

    for name in workloads.REDUCE_STRAIN:
        k, w, out_size = workloads.reduce_strain(
            name, reduce_kernel.tile_len(), dev, gen)
        got = reduce_kernel.reduce_by_key(k, w, out_size)
        want = reduce_kernel.reduce_by_key_plain(k, w, out_size)
        if int(got[2]) != int(want[2]):
            raise AssertionError(f"K3 n_unique {int(got[2])} != "
                                 f"{int(want[2])} ({name})")
        _same(got[:2], want[:2])
    del k, w, got, want
    for name in workloads.MERGE_STRAIN:
        a, ac, b = workloads.merge_strain(name, merge_kernel.tile_len(), dev,
                                          gen)
        _same(merge_kernel.merge_sorted(a, ac, b),
              merge_kernel.merge_sorted_plain(a, ac, b))
        bp = (torch.arange(b.numel(), dtype=torch.int32, device=dev),)
        mk, mp = merge_kernel.merge_sorted_payload(a, (ac,), b, bp)
        pk, pp = merge_kernel.merge_sorted_payload_plain(a, (ac,), b, bp)
        _same((mk, *mp), (pk, *pp))
    t_keys, t_counts, fresh, mk, mw, q = shapes
    ap = (torch.full((t_keys.numel(),), -1, dtype=torch.int32, device=dev),)
    bp = (torch.arange(q.numel(), dtype=torch.int32, device=dev),)
    for what, fn in (
            ("K3", lambda: reduce_kernel.reduce_by_key(mk, mw, 1 << 24)),
            ("K2", lambda: merge_kernel.merge_sorted(t_keys, t_counts,
                                                     fresh)),
            ("K2 with a payload", lambda: (lambda k, p: (k, *p))(
                *merge_kernel.merge_sorted_payload(t_keys, ap, q, bp)))):
        first = fn()
        for _ in range(4):
            if not all(torch.equal(x, y) for x, y in zip(first, fn())):
                raise AssertionError(f"two runs of {what} on the same input "
                                     "differ")
    print("K3 and K2 (both forms): exact on "
          + ", ".join(workloads.REDUCE_STRAIN) + " (K3; tile "
          f"{reduce_kernel.tile_len()}) and "
          + ", ".join(workloads.MERGE_STRAIN) + " (K2; tile "
          f"{merge_kernel.tile_len()}); five runs of each at the path's "
          "shapes agree")


def check_extract_kernel(dev, gen):
    """The extraction kernel (csrc/extract.cu) against its plain version
    at the main path's batch, [4096, 1024] codes at k = 27 with 0.1%
    invalid, canonical and forward keys, timed over 10 launches beside
    its bound (each code read once, each key written once).  Returns the
    entry and its (entry, call) pair for count_inside."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core.kmers import extract_keys_plain
    from kat_tpu_torch.ops.extract_kernel import extract_keys

    k, rows, length = (workloads.MAIN_K, workloads.MAIN_ROWS,
                       workloads.MAIN_LENGTH)
    codes = torch.randint(0, 4, (rows, length), dtype=torch.uint8,
                          device=dev, generator=gen)
    codes[torch.rand(codes.shape, device=dev, generator=gen) < 1e-3] = 4
    err = max(_max_abs_err(extract_keys(codes, k, c),
                           extract_keys_plain(codes, k, c))
              for c in (True, False))
    got = extract_keys(codes, k)
    entry = _report(dict(
        name="kmer_windows", route="cuda",
        source="kat_tpu_torch/csrc/extract.cu",
        replaces="none (kat_tpu/core/kmers.py::extract_kmers is jnp that "
                 "XLA fuses)", max_abs_err=err,
        ms=_timed_ms(lambda: extract_keys(codes, k), 10),
        plain_ms=_timed_ms(lambda: extract_keys_plain(codes, k), 5),
        **_bound(_nbytes(codes, got), 0),
        # no one PyTorch call extracts windows
        library_ms=None), f"extraction [{rows}, {length}] k={k}")
    return entry, (entry, lambda: extract_keys(codes, k))


def check_matrix_format(dev, smi: str) -> None:
    """The matrix text writer (kat_tpu_torch/core/matrix.format_rows) on the
    card against the per-cell loop it replaced, at chr14.comp's 1001 x 1001
    shape (workloads.comp_matrix) in both orientations, byte for byte; each
    timed on the host's clock from the call to the bytes (the card's
    passes, its three reads and the copy; median of 5), beside the same
    call on a CPU tensor and the loop."""
    import statistics

    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core.matrix import format_rows

    def host_ms(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    mx = workloads.comp_matrix(SEED)
    on_host = torch.from_numpy(mx)
    on_card = on_host.to(dev)
    for transpose in (False, True):
        t0 = time.perf_counter()
        want = "".join(" ".join(str(int(v)) for v in row) + "\n"
                       for row in (mx.T if transpose else mx)).encode()
        loop_ms = 1e3 * (time.perf_counter() - t0)
        if format_rows(on_card, transpose) != want:
            raise AssertionError("format_rows on the card differs from the "
                                 f"per-cell loop (transpose={transpose})")
        card_ms = host_ms(lambda: format_rows(on_card, transpose), 5)
        cpu_ms = host_ms(lambda: format_rows(on_host, transpose), 3)
        print(f"matrix text 1001 x 1001{' transposed' if transpose else ''}"
              f" ({len(want)} bytes, largest cell {mx.max()}): exact, card "
              f"{card_ms:.3f} ms, the CPU {cpu_ms:.1f} ms, the per-cell loop "
              f"{loop_ms:.1f} ms ({smi})")


def check_kernels(dev, gen):
    """Every kernel against its plain version: K1-K3 at the flush's shapes
    here, the lookup path's three in check_lookup_kernels.  Returns the
    entries and the (entry, call) pairs whose kernels count_inside
    counts."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    n_fresh, cap = 1 << 26, 1 << 24
    results = []

    # K1: 2^26 random 54-bit keys, 10% sentinels
    keys = torch.randint(0, 1 << 54, (n_fresh,), dtype=torch.int64,
                         device=dev, generator=gen)
    keys[torch.rand(n_fresh, device=dev, generator=gen) < 0.1] = SENTINEL
    got = sort_kernel.sort_keys(keys, KEY_BITS)
    err = _max_abs_err(got, sort_kernel.sort_keys_plain(keys))
    results.append(_report(dict(
        name="radix_sort", route="cuda", source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_keys(keys, KEY_BITS), 5),
        plain_ms=_timed_ms(lambda: sort_kernel.sort_keys_plain(keys), 5),
        **_bound(_nbytes(keys, got), n_fresh * int(math.log2(n_fresh))),
        library_ms=_timed_ms(lambda: torch.sort(keys), 5),
        **_k1_extras(False, n_fresh)), "K1 sort 2^26 keys"))
    counted = [(results[-1], lambda: sort_kernel.sort_keys(keys, KEY_BITS))]
    del got
    check_sort_shapes(dev, gen, False, 1 << 24, keys)

    # K2: a 2^24-slot table (~2^23 real keys) with 2^26 sorted fresh keys
    # drawn from a 1.5 x 2^23 key universe (10% sentinels)
    shapes = workloads.flush_shapes(dev, gen)
    t_keys, t_counts, fresh, pk, pw, _q = shapes
    mk, mw = merge_kernel.merge_sorted(t_keys, t_counts, fresh)
    err = max(_max_abs_err(mk, pk), _max_abs_err(mw, pw))
    del pk, pw
    # the library's form of this merge: the fresh keys' weights as a plane
    fresh_w = (fresh != SENTINEL).to(torch.int32)
    library_ms = _library_merge_ms(t_keys, (t_counts,), fresh, (fresh_w,),
                                   (mk, mw))
    del fresh_w
    results.append(_report(dict(
        name="merge_path", route="cuda", source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted(
            t_keys, t_counts, fresh), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_plain(
            t_keys, t_counts, fresh), 3),
        **_bound(_nbytes(t_keys, t_counts, fresh, mk, mw), mk.numel()),
        library_ms=library_ms, tile=merge_kernel.tile_len()),
        "K2 merge 2^24 table + 2^26 fresh"))
    counted.append((results[-1], lambda: merge_kernel.merge_sorted(
        t_keys, t_counts, fresh)))

    # K3: that merged stream reduced to cap 2^24, and to 2^20 (overflow:
    # the true n_unique must come back)
    errs = []
    for out_size in (cap, 1 << 20):
        gk, gc, gn = reduce_kernel.reduce_by_key(mk, mw, out_size)
        wk, wc, wn = reduce_kernel.reduce_by_key_plain(mk, mw, out_size)
        if int(gn) != int(wn):
            raise AssertionError(f"K3 n_unique {int(gn)} != {int(wn)}")
        errs += [_max_abs_err(gk, wk), _max_abs_err(gc, wc)]
        print(f"K3 reduce to {out_size}: n_unique {int(gn)} exact")
    del gk, gc, wk, wc
    results.append(_report(dict(
        name="reduce_by_key", route="cuda",
        source="kat_tpu_torch/csrc/reduce.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:147", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.reduce_by_key(mk, mw, cap), 5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.reduce_by_key_plain(mk, mw, cap), 3),
        **_bound(_nbytes(mk, mw) + cap * 12, 2 * mk.numel()),
        # no one call: unique_consecutive(return_counts=True) sums weights
        # of 1 only, and with index_add_ it is two calls
        library_ms=None, tile=reduce_kernel.tile_len()),
        f"K3 reduce {mk.numel()} -> 2^24"))
    counted.append((results[-1],
                    lambda: reduce_kernel.reduce_by_key(mk, mw, cap)))
    check_flush_shapes(dev, gen, shapes)
    fused, fused_counted = check_merge_reduce(dev, gen, shapes)
    lookup, lookup_counted = check_lookup_kernels(dev, gen, t_keys, t_counts)
    return (results + lookup, counted + fused_counted + lookup_counted,
            fused)


def check_merge_reduce(dev, gen, shapes):
    """The fused K2 + K3 (csrc/reduce.cu, merge_reduce_kernel) against its
    plain version (K2's and K3's in a row), timed beside its bound (the
    table and the fresh keys read once, every output slot written once)
    and beside K2 then K3 on the same inputs (split_ms): at K2's row's
    shapes (the 2^24-slot table's real prefix + 2^26 fresh keys, into 2^24
    slots and, overflowing, 2^20) and at hist's last flushes (2^28 slots).
    Returns the entries and the first one's (entry, call) pair."""
    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel
    from kat_tpu_torch.ops import merge_reduce_kernel as mrk

    def entry(name, what, a, ac, b, cap):
        errs = []
        for out_size in (cap, cap >> 4):
            got = mrk.merge_reduce(a, ac, b, out_size)
            want = mrk.merge_reduce_plain(a, ac, b, out_size)
            if int(got[2]) != int(want[2]):
                raise AssertionError(f"merge_reduce n_unique {int(got[2])} "
                                     f"!= {int(want[2])} ({what})")
            errs.append(_same(got[:2], want[:2]))
            runs = int(got[2])
            del got, want
        na, nb = a.numel(), b.numel()
        e = _report(dict(
            name=name, route="cuda", source="kat_tpu_torch/csrc/reduce.cu",
            replaces="kat_tpu/ops/merge_kernel.py:73 + "
                     "kat_tpu/ops/reduce_kernel.py:147 (K2 then K3)",
            max_abs_err=max(errs), table_real=na, fresh=nb, runs=runs,
            out_size=cap,
            ms=_timed_ms(lambda: mrk.merge_reduce(a, ac, b, cap), 5),
            split_ms=_timed_ms(lambda: reduce_kernel.reduce_by_key(
                *merge_kernel.merge_sorted(a, ac, b), cap), 5),
            plain_ms=_timed_ms(lambda: mrk.merge_reduce_plain(a, ac, b, cap),
                               2),
            **_bound(12 * na + 8 * nb + 12 * cap + 8, 3 * (na + nb)),
            # no one call: as K2's and K3's rows
            library_ms=None, tile=mrk.tile_len()),
            f"K2 + K3 fused, {what} -> {cap} slots")
        print(f"  K2 then K3 on the same inputs {e['split_ms']:.3f} ms: the "
              f"fused kernel takes {e['ms'] / e['split_ms']:.1%} of it")
        return e

    t_keys, t_counts, fresh = shapes[:3]
    n = int((t_keys != SENTINEL).sum())
    a, ac = t_keys[:n], t_counts[:n]
    entries = [entry("merge_reduce", "2^24 table + 2^26 fresh", a, ac, fresh,
                     1 << 24)]
    cap, n_real, n_fresh, _sent = workloads.HIST_FLUSH
    hist = workloads.table_and_fresh(*workloads.HIST_FLUSH, dev, gen)
    entries.append(entry(
        "merge_reduce[hist]", f"hist's last flush: 2^28 table ({n_real} "
        f"real) + {n_fresh} fresh", *hist, cap))
    del hist
    for name in workloads.MERGE_REDUCE_STRAIN:
        sa, sac, sb, out_size = workloads.merge_reduce_strain(
            name, mrk.tile_len(), dev, gen)
        got = mrk.merge_reduce(sa, sac, sb, out_size)
        want = mrk.merge_reduce_plain(sa, sac, sb, out_size)
        if int(got[2]) != int(want[2]):
            raise AssertionError(f"merge_reduce n_unique {int(got[2])} != "
                                 f"{int(want[2])} ({name})")
        _same(got[:2], want[:2])
    _repeat_equal("merge_reduce", lambda: mrk.merge_reduce(a, ac, fresh,
                                                           1 << 24))
    print("K2 + K3 fused: exact on " + ", ".join(
        workloads.MERGE_REDUCE_STRAIN) + f" (tile {mrk.tile_len()}); five "
        "runs at the path's shapes agree")
    return entries, [(entries[0],
                      lambda: mrk.merge_reduce(a, ac, fresh, 1 << 24))]


def count_inside(counted) -> None:
    """launches_inside of each (entry, call): the kernels and memsets that
    one call ran on the card, as torch.profiler counted them, all calls in
    one profiled window."""
    from kat_tpu_torch.benchmarks.workloads import device_event_groups

    groups = device_event_groups([fn for _entry, fn in counted])
    for (entry, _fn), events in zip(counted, groups):
        entry["launches_inside"] = len(events)
    print("kernels and memsets inside one call (torch.profiler, one "
          "window): " + ", ".join(f"{entry['name']} {len(events)}"
                                  for (entry, _fn), events
                                  in zip(counted, groups)))


def check_lookup_kernels(dev, gen, t_keys, t_counts):
    """K4 and the payload forms of K1 and K2 against their plain versions
    at the shapes of a 2^23-query join against a 2^24-slot table."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    cap, m = t_keys.numel(), 1 << 23
    results = []

    # K1 with a value: 2^23 random 54-bit keys, 10% sentinels, each
    # carrying its position (what the join sorts)
    q = torch.randint(0, 1 << 54, (m,), dtype=torch.int64, device=dev,
                      generator=gen)
    q[::3] = t_keys[torch.randint(0, cap // 2, (len(q[::3]),), device=dev,
                                  generator=gen)]  # a third hit the table
    q[torch.rand(m, device=dev, generator=gen) < 0.1] = SENTINEL
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    got = sort_kernel.sort_pairs(q, idx, KEY_BITS)
    err = _same(got, sort_kernel.sort_pairs_plain(q, idx))
    results.append(_report(dict(
        name="radix_sort_pairs", route="cuda",
        source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_pairs(q, idx, KEY_BITS), 5),
        plain_ms=_timed_ms(lambda: sort_kernel.sort_pairs_plain(q, idx), 5),
        **_bound(_nbytes(q, idx, *got), m * int(math.log2(m))),
        # the values are positions, so the stable sort's indices ARE them
        library_ms=_timed_ms(lambda: torch.sort(q, stable=True), 5),
        **_k1_extras(True, m)), "K1 sort 2^23 (key, value) pairs"))
    counted = [(results[-1], lambda: sort_kernel.sort_pairs(q, idx, KEY_BITS))]
    sq, sidx = got
    del got
    check_sort_shapes(dev, gen, True, 1 << 22, q)
    time_small_sorts(dev, gen)

    # K2 with a payload: the table carrying -1 and the sorted queries
    # their positions, as the join merges them
    a_planes = (torch.full((cap,), -1, dtype=torch.int32, device=dev),)
    b_planes = (sidx,)
    mk, mp = merge_kernel.merge_sorted_payload(t_keys, a_planes, sq, b_planes)
    pk, pp = merge_kernel.merge_sorted_payload_plain(t_keys, a_planes, sq,
                                                     b_planes)
    err = _same((mk, *mp), (pk, *pp))
    del pk, pp
    library_ms = _library_merge_ms(t_keys, a_planes, sq, b_planes, (mk, *mp))
    results.append(_report(dict(
        name="merge_path_payload", route="cuda",
        source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_payload(
            t_keys, a_planes, sq, b_planes), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_payload_plain(
            t_keys, a_planes, sq, b_planes), 3),
        **_bound(_nbytes(t_keys, *a_planes, sq, *b_planes, mk, *mp),
                 mk.numel()),
        library_ms=library_ms, tile=merge_kernel.tile_len()),
        "K2 merge 2^24 table + 2^23 queries, 1 plane"))
    counted.append((results[-1], lambda: merge_kernel.merge_sorted_payload(
        t_keys, a_planes, sq, b_planes)))

    # K4: the query rows (a third of the merged stream) pulled out of the
    # position plane and a count plane; then every row, no row, and an
    # output too short
    n = mk.numel()
    flag = mp[0] >= 0
    mp = (mp[0], torch.randint(0, 1000, (n,), dtype=torch.int32, device=dev,
                               generator=gen))
    errs = []
    for what, fl, out_size in (("the queries", flag, m),
                               ("all flagged", torch.ones_like(flag), n),
                               ("none flagged", torch.zeros_like(flag), m),
                               ("out_size below the count", flag, m // 2)):
        got = reduce_kernel.compact_flagged(mp, fl, out_size)
        want = reduce_kernel.compact_flagged_plain(mp, fl, out_size)
        if int(got[-1]) != int(want[-1]):
            raise AssertionError(f"K4 n_kept {int(got[-1])} != "
                                 f"{int(want[-1])} ({what})")
        errs.append(_same(got[:-1], want[:-1]))
        print(f"K4 compact {n}, {what}: n_kept {int(got[-1])} into "
              f"{out_size} exact")
    errs.append(_same(earlier_kernels.compact_flagged(mp, flag, m),
                      reduce_kernel.compact_flagged(mp, flag, m)))
    results.append(_report(dict(
        name="compact_flagged", route="cuda",
        source="kat_tpu_torch/csrc/compact.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:285", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.compact_flagged(mp, flag, m), 5),
        earlier_ms=_timed_ms(
            lambda: earlier_kernels.compact_flagged(mp, flag, m), 5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.compact_flagged_plain(mp, flag, m), 5),
        **_bound(_nbytes(*mp, flag) + 2 * m * 4, n),
        # one call per plane: masked_select takes one tensor
        library_ms=_timed_ms(
            lambda: [torch.masked_select(p, flag) for p in mp], 5)),
        f"K4 compact {n} x 2 planes -> 2^23"))
    return results, counted


BINNED_REPLACES = ("kat_tpu/ops/sort_kernel.py:182 + "
                   "kat_tpu/ops/reduce_kernel.py:147")


def check_binned_kernels(dev, gen):
    """The binned-sums kernel against its plain version at the main path's
    shapes (workloads.binned_inputs: the histogram's 10,001 bins, gcp's
    28,028, comp's 1,002,001 with three masks at the reads-against-assembly
    skew and uniform), five runs of each with equal outputs.  Returns the
    entries and their (entry, call) pairs."""
    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels, workloads
    from kat_tpu_torch.ops import binned_kernel as bk

    results, counted = [], []
    for shape in workloads.BINNED_SHAPES:
        bins, masks, total = workloads.binned_inputs(shape, dev, gen)
        got = bk.binned_sums(bins, masks, total)
        err = max(_max_abs_err(got, bk.binned_sums_plain(bins, masks, total)),
                  _max_abs_err(got, earlier_kernels.binned_sums(bins, masks,
                                                                total)))
        _repeat_equal(f"binned sums ({shape})",
                      lambda: (bk.binned_sums(bins, masks, total),))
        # the library call per mask: torch.bincount of the masked bins
        lib_bins = [torch.where(m, bins.to(torch.int64), total)
                    for m in masks]
        m_planes = masks.shape[0]
        results.append(_report(dict(
            name=f"binned_sums[{shape}]", route="cuda",
            source="kat_tpu_torch/csrc/binned.cu", replaces=BINNED_REPLACES,
            max_abs_err=err,
            ms=_timed_ms(lambda: bk.binned_sums(bins, masks, total), 10),
            earlier_ms=_timed_ms(
                lambda: earlier_kernels.binned_sums(bins, masks, total), 10),
            plain_ms=_timed_ms(
                lambda: bk.binned_sums_plain(bins, masks, total), 5),
            # one add per set mask element; a read of the bins and masks,
            # a write of every bin
            **_bound(_nbytes(bins, masks, got), int(masks.sum())),
            library_ms=_timed_ms(lambda: [
                torch.bincount(b, minlength=total + 1) for b in lib_bins],
                5),
            bins=total, masks=m_planes,
            # the skew: the share of the adds that the 32 fullest bins take
            top32_share=float(got.flatten().topk(32).values.sum()
                              / max(1, int(masks.sum())))),
            f"binned sums [{shape}] 2^24 x {m_planes} mask(s) -> {total} "
            "bins"))
        counted.append((results[-1],
                        lambda bins=bins, masks=masks, total=total:
                        bk.binned_sums(bins, masks, total)))
        del got, lib_bins
    print(f"binned sums: a block holds {bk.window_len()} counters of the "
          f"one-pass groups; the window kernel they replaced took "
          + ", ".join(f"{e['earlier_ms']:.3f}" for e in results) + " ms")
    return results, counted


def check_packed_sums(dev, captured):
    """The binned-sums kernel's packed form (`packed_sums`) against its
    plain version and the window kernel it replaced on the inputs comp
    pass 1 and pass 2 gave it over the main table (captured in
    comp_path), five runs each with equal outputs, timed beside one
    `torch.bincount` per request.  Returns the entries; each entry's
    launches are the calls one two-input comp made with that request
    set."""
    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels
    from kat_tpu_torch.ops import binned_kernel as bk

    results = []
    for what, (packed, masks, reqs) in zip(("comp pass 1", "comp pass 2"),
                                           captured, strict=True):
        got = bk.packed_sums(packed, masks, reqs)
        err = max(_same(got, bk.packed_sums_plain(packed, masks, reqs)),
                  _same(got, earlier_kernels.packed_sums(packed, masks,
                                                         reqs)))
        _repeat_equal(f"packed sums ({what})",
                      lambda: bk.packed_sums(packed, masks, reqs))
        lib_in = [torch.where(masks[mi], (packed.to(torch.int64) // d) % m,
                              m) for d, m, mi in reqs]
        results.append(_report(dict(
            name=f"packed_sums[{what}]", route="cuda",
            source="kat_tpu_torch/csrc/binned.cu", replaces=BINNED_REPLACES,
            max_abs_err=err,
            ms=_timed_ms(lambda: bk.packed_sums(packed, masks, reqs), 10),
            earlier_ms=_timed_ms(lambda: earlier_kernels.packed_sums(
                packed, masks, reqs), 10),
            plain_ms=_timed_ms(
                lambda: bk.packed_sums_plain(packed, masks, reqs), 5),
            # one add per request whose mask is set; a read of the keys and
            # the masks, a write of every request's bins
            **_bound(_nbytes(packed, masks, *got),
                     sum(int(masks[mi].sum()) for _d, _m, mi in reqs)),
            library_ms=_timed_ms(lambda: [
                torch.bincount(b, minlength=m + 1)
                for b, (_d, m, _i) in zip(lib_in, reqs)], 5),
            requests=[list(r) for r in reqs], shape=[*masks.shape],
            launches=sum(c[2] == reqs for c in captured)),
            f"packed sums [{what}] {packed.numel()} keys, requests {reqs}"))
        del got, lib_in
    return results


def later_rows_inside(dev, gen):
    """(entry, call) pairs for count_inside of the rows checked after the
    profiled window (a later one traced nothing once), on inputs of their
    shapes: the packed sums at comp pass 1's and pass 2's request sets on
    a table of the main path's size (workloads.packed_inputs), and K5 on
    one flush of uniform keys.  The entries are named as those rows and
    carry the request sets and shapes counted, which main holds against
    the rows' own (what a call launches depends on nothing else)."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import bucketed
    from kat_tpu_torch.ops import binned_kernel as bk
    from kat_tpu_torch.ops import sort_kernel

    pairs = []
    for what, shape in zip(("comp pass 1", "comp pass 2"),
                           workloads.PACKED_SHAPES):
        packed, masks, reqs = workloads.packed_inputs(shape, dev, gen)
        pairs.append((dict(name=f"packed_sums[{what}]",
                           requests=[list(r) for r in reqs],
                           shape=[*masks.shape]),
                      lambda packed=packed, masks=masks, reqs=reqs:
                      bk.packed_sums(packed, masks, reqs)))
    chunk = 1 << bucketed.SLOTS_LOG
    keys = torch.randint(0, 1 << 60, (bucketed.MAX_CHUNKS * chunk,),
                         dtype=torch.int64, device=dev, generator=gen)
    pairs.append((dict(name="chunk_sort", shape=[keys.numel(), chunk]),
                  lambda: sort_kernel.sort_chunks(keys, chunk)))
    return pairs


def check_dual_probe_kernels(dev, gen):
    """K2 with two payload planes and the two K4 compactions of the fused
    dual probe (ops/join.counts_join_dual) against their plain versions at
    its shape: two 2^24-slot tables (workloads.dual_probe_shapes); the
    probe as a whole against two binary searches.  Returns the entries
    and their (entry, call) pairs."""
    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels, workloads
    from kat_tpu_torch.core import counting
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import join, merge_kernel, reduce_kernel

    a, ap, b, bp = workloads.dual_probe_shapes(dev, gen)
    na, nb = a.numel(), b.numel()
    mk, mp = merge_kernel.merge_sorted_payload(a, ap, b, bp)
    pk, pp = merge_kernel.merge_sorted_payload_plain(a, ap, b, bp)
    err = _same((mk, *mp), (pk, *pp))
    del pk, pp
    library_ms = _library_merge_ms(a, ap, b, bp, (mk, *mp))
    _repeat_equal("K2 with two planes", lambda: (lambda k, p: (k, *p))(
        *merge_kernel.merge_sorted_payload(a, ap, b, bp)))
    results = [_report(dict(
        name="merge_path_payload[dual]", route="cuda",
        source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_payload(a, ap, b, bp),
                     5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_payload_plain(
            a, ap, b, bp), 3),
        **_bound(_nbytes(a, *ap, b, *bp, mk, *mp), mk.numel()),
        library_ms=library_ms, tile=merge_kernel.tile_len()),
        "K2 merge 2^24 + 2^24 slots, 2 planes (the dual probe)")]
    counted = [(results[-1], lambda: merge_kernel.merge_sorted_payload(
        a, ap, b, bp))]

    # the two compactions as counts_join_dual drives them
    mcnt, msrc = mp
    same_next = torch.zeros(na + nb, dtype=torch.bool, device=dev)
    same_next[:-1] = mk[1:] == mk[:-1]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    from_next = torch.where(same_next, mcnt.roll(-1), zero)
    from_prev = torch.where(same_next.roll(1), mcnt.roll(1), zero)
    fa, fb = msrc == 1, msrc == 2

    def both(fn):
        return (*fn((from_next,), fa, na), *fn((from_prev,), fb, nb))

    got = both(reduce_kernel.compact_flagged)
    err = max(_same(got, both(reduce_kernel.compact_flagged_plain)),
              _same(got, both(earlier_kernels.compact_flagged)))
    results.append(_report(dict(
        name="compact_flagged[dual]", route="cuda",
        source="kat_tpu_torch/csrc/compact.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:285", max_abs_err=err,
        ms=_timed_ms(lambda: both(reduce_kernel.compact_flagged), 5),
        earlier_ms=_timed_ms(lambda: both(earlier_kernels.compact_flagged),
                             5),
        plain_ms=_timed_ms(lambda: both(reduce_kernel.compact_flagged_plain),
                           5),
        **_bound(2 * _nbytes(from_next, fa) + (na + nb) * 4, 2 * (na + nb)),
        library_ms=_timed_ms(lambda: (torch.masked_select(from_next, fa),
                                      torch.masked_select(from_prev, fb)), 5)),
        "K4 the dual probe's two compactions of 2^25 -> 2^24"))
    counted.append((results[-1], lambda: both(reduce_kernel.compact_flagged)))

    ta = counting.CountTable(a, ap[0], int((a != SENTINEL).sum()))
    tb = counting.CountTable(b, bp[0], int((b != SENTINEL).sum()))
    got_a, got_b = join.counts_join_dual(a, ap[0], b, bp[0])
    if not (torch.equal(got_a, counting.lookup(tb, a))
            and torch.equal(got_b, counting.lookup(ta, b))):
        raise AssertionError("the dual probe differs from two searches")
    n_shared = int((got_a > 0).sum())
    print(f"dual probe: {n_shared} keys shared of {ta.n_unique} and "
          f"{tb.n_unique}; equal to two binary searches")
    return results, counted


def check_bucketed_kernels(dev, gen, group_chunks: int, k5_real):
    """K5 and K6 against their plain versions at the bucketed flush's
    shapes: one flush of MAX_CHUNKS chunks of 2^SLOTS_LOG key' slots (60-bit
    uniform keys, and the bucketed path's first flush, `k5_real`, whose
    chunks' keys share their high bits), K5 beside the bitonic kernel it
    replaced; and one hot group of `group_chunks` chunk runs, the largest
    group the router reported to the bucketed path.  Returns the entries
    (K5 uniform, K5 on the real flush, K6)."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels
    from kat_tpu_torch.core import bucketed
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import sort_kernel

    chunk = 1 << bucketed.SLOTS_LOG
    n = bucketed.MAX_CHUNKS * chunk
    results = []

    # K5: 60-bit key' (k=27), 30% empty slots, as a flush's record fill;
    # then a real flush's key' stream
    keys = torch.randint(0, 1 << 60, (n,), dtype=torch.int64, device=dev,
                         generator=gen)
    keys[torch.rand(n, device=dev, generator=gen) < 0.3] = SENTINEL
    for what, (k5, c5) in (("uniform", (keys, chunk)),
                           ("a real flush", k5_real)):
        got = sort_kernel.sort_chunks(k5, c5)
        err = max(_max_abs_err(got, sort_kernel.sort_chunks_plain(k5, c5)),
                  _max_abs_err(got, earlier_kernels.sort_chunks(k5, c5)))
        plain_ms = _timed_ms(lambda: sort_kernel.sort_chunks_plain(k5, c5),
                             3)
        results.append(_report(dict(
            name="chunk_sort" + ("" if what == "uniform" else "[real]"),
            route="cuda", source="kat_tpu_torch/csrc/chunk_sort.cu",
            replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
            ms=_timed_ms(lambda: sort_kernel.sort_chunks(k5, c5), 5),
            earlier_ms=_timed_ms(lambda: earlier_kernels.sort_chunks(k5, c5),
                                 5),
            plain_ms=plain_ms,
            **_bound(_nbytes(k5, got), k5.numel() * int(math.log2(c5))),
            # the plain version IS the one library call (a row-wise sort)
            library_ms=plain_ms, shape=[k5.numel(), c5],
            sentinel_share=float((k5 == SENTINEL).float().mean())),
            f"K5 chunk sort {k5.numel() // c5} x {c5} keys, {what} (the "
            "bitonic kernel it replaced: earlier_ms)"))
        del got

    # K6: the path's largest hot group of chunk runs out of the uniform
    # stream (compared and timed beside the tree it replaced), and a pair
    # of runs (compared)
    got = sort_kernel.sort_chunks(keys, chunk)
    errs = []
    for g in (2, group_chunks):
        runs = got[:g * chunk].clone()
        merged = sort_kernel.merge_runs(runs, chunk)
        errs += [_max_abs_err(merged,
                              sort_kernel.merge_runs_plain(runs, chunk)),
                 _max_abs_err(merged,
                              earlier_kernels.merge_runs(runs, chunk))]
    plain_ms = _timed_ms(lambda: sort_kernel.merge_runs_plain(runs, chunk), 5)
    n_real = int((runs != SENTINEL).sum())
    results.append(_report(dict(
        name="merge_runs", route="cuda",
        source="kat_tpu_torch/csrc/merge_runs.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=max(errs),
        ms=_timed_ms(lambda: sort_kernel.merge_runs(runs, chunk), 5),
        earlier_ms=_timed_ms(lambda: earlier_kernels.merge_runs(runs, chunk),
                             5),
        plain_ms=plain_ms,
        # one compare per key and level of a binary merge tree
        **_bound(_nbytes(runs, merged),
                 runs.numel() * max(1, math.ceil(math.log2(group_chunks)))),
        touch_bound_ms=_touch_ms(n_real, runs.numel(), 1),
        real_keys=n_real,
        passes=len(sort_kernel.merge_passes(runs.numel(), chunk)),
        tile=sort_kernel.merge_runs_tile(1),
        library_ms=plain_ms),  # torch.sort: no library call merges runs
        f"K6 merge {group_chunks} runs of 2^{bucketed.SLOTS_LOG} keys"))
    print(f"  the tree it replaced: {results[-1]['earlier_ms']:.3f} ms; the "
          f"real keys' bound {results[-1]['touch_bound_ms']:.3f} ms")
    return results


def check_rounds_kernel(dev):
    """K7: every class of kat_tpu's benchmarks/profile_roll.py against its
    plain version at R = 0, 1 and 7 (at 2^24 keys and at a count with a
    partial last block), then timed at R = 512, 0 and 256, and copy at
    2048 and 1024 too; inside profile_rounds.run, which fails unless
    t(L) - t(0) is twice t(L/2) - t(0) within 10% (L = 512, copy 2048:
    the loop runs every round) and each kernel's round loop in the SASS
    holds the instructions of all its rounds (none folded).  Then the
    costliest class against its plain version at R = 512."""
    from kat_tpu_torch.benchmarks import profile_rounds as pr

    pr.profile_rounds.launches = 0
    res = pr.run()
    launches = pr.profile_rounds.launches
    print("K7 rounds: " + json.dumps(res))
    n, rounds, modes = res["n"], res["rounds"], res["modes"]
    for m, row in modes.items():
        lin = row["linearity_rounds"]
        print(f"  K7 {m}: " + ", ".join(
            f"{t:.3f} ms at R = {r}" for r, t in row["ms_at"].items())
            + f"; linearity in R: t({lin}) - t(0) = {row['linearity']:.3f}"
            f" x 2 (t({lin // 2}) - t(0))")
    for loop in res["sass"]:
        print(f"  K7 {loop['kernel']} round loop: {loop['work']} "
              f"instructions for {loop['pair_rounds']} pair-rounds (at "
              f"least {loop['need']}): {json.dumps(loop['opcodes'])}")
    mode = max(modes, key=lambda m: modes[m]["ms"])
    keys = pr.random_keys(n, dev, seed=1)
    got = pr.profile_rounds(keys, mode, rounds)
    err = _max_abs_err(got, pr.profile_rounds_plain(keys, mode, rounds))
    entry = _report(dict(
        name="profile_rounds", route="cuda",
        source="kat_tpu_torch/csrc/rounds.cu",
        replaces="benchmarks/profile_roll.py:41", max_abs_err=err,
        ms=_timed_ms(lambda: pr.profile_rounds(keys, mode, rounds), 3),
        plain_ms=_timed_ms(
            lambda: pr.profile_rounds_plain(keys, mode, rounds), 1),
        # a round is one compare and one select per key
        **_bound(_nbytes(keys, got), 2 * n * rounds),
        # no library call runs fixed-stride compare-exchange rounds
        library_ms=None, launches=launches, mode=mode,
        modes_ms={m: row["ms"] for m, row in modes.items()}),
        f"K7 {rounds} {mode} rounds on 2^24 keys")
    return entry


def _repeat_equal(what: str, fn) -> None:
    """Four more runs of fn equal its first: a race between tiles shows as
    a difference between runs."""
    import torch

    first = fn()
    for _ in range(4):
        if not all(torch.equal(x, y) for x, y in zip(first, fn())):
            raise AssertionError(f"two runs of {what} on the same input "
                                 "differ")


def _bucket_stats(keys, top_bits: int) -> str:
    """The W-word sort's buckets for `keys`: the largest and how many hold
    more keys than one block sorts (those take the fallback passes)."""
    import torch

    from kat_tpu_torch.ops import sort_kernel

    b = sort_kernel.bucket_of(keys, top_bits)
    counts = torch.bincount(b, minlength=sort_kernel.SENTINEL_BUCKET + 1)
    real = counts[:sort_kernel.SENTINEL_BUCKET]
    return (f"largest bucket {int(real.max())} keys, "
            f"{int((real > sort_kernel.BUCKET_CAP).sum())} oversize (past "
            f"{sort_kernel.BUCKET_CAP}), {int(counts[-1])} sentinels")


def check_wide_kernels(dev, gen):
    """K1, K2 and K3 W-word against their plain versions: at the wide
    flush's shapes (k = 41, W = 2: 2^26 fresh keys, a 2^24-slot table,
    their 83.9M-element merge), timed and five runs each with equal
    outputs; then on workloads.WIDE_STRAIN at the boundary k of every
    W = 2..9.  Returns the entries and their (entry, call) pairs."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels, workloads
    from kat_tpu_torch.benchmarks.workloads import HBM_BYTES_PER_S
    from kat_tpu_torch.core.kmers import top_bases
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k = workloads.WIDE_K
    tb = 2 * top_bases(k) + 1
    n_fresh, cap = 1 << 26, 1 << 24
    results, counted = [], []

    # K1 W-word: 2^26 random 41-mers, 10% SENTINEL
    keys = workloads.wide_keys(k, n_fresh, dev, gen)
    W = keys.shape[0]
    reads = sort_kernel.sort_words.host_reads
    got = sort_kernel.sort_words(keys, tb)
    reads = sort_kernel.sort_words.host_reads - reads
    err = max(_max_abs_err(got, sort_kernel.sort_words_plain(keys)),
              _max_abs_err(got, earlier_kernels.sort_words(keys, tb)))
    print(f"K1 W-word: {reads} host read(s) a call; "
          + _bucket_stats(keys, tb))
    results.append(_report(dict(
        name="radix_sort_words", route="cuda",
        source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_words(keys, tb), 5),
        earlier_ms=_timed_ms(lambda: earlier_kernels.sort_words(keys, tb),
                             5),
        host_reads_per_call=reads,
        # the W chained stable torch.sort calls with their gathers: no one
        # PyTorch call sorts W-word keys
        plain_ms=_timed_ms(lambda: sort_kernel.sort_words_plain(keys), 3),
        **_bound(_nbytes(keys, got), n_fresh * int(math.log2(n_fresh))),
        # no library call: torch.sort orders no multi-word key
        library_ms=None, passes=sort_kernel.words_passes(W, tb),
        tile=sort_kernel.words_tile_len(W),
        floor_ms=sort_kernel.words_pass_floor_bytes(n_fresh, W, tb)
        / HBM_BYTES_PER_S * 1e3), f"K1 W-word sort 2^26 keys, k={k} (W={W})"))
    counted.append((results[-1], lambda: sort_kernel.sort_words(keys, tb)))
    del got
    _repeat_equal("K1 W-word", lambda: (sort_kernel.sort_words(keys, tb),))

    # K2 W-word: a 2^24-slot table (~2^23 real keys) with 2^26 sorted
    # fresh keys from a 1.5 x 2^23 key universe (10% SENTINEL)
    t_keys, t_counts, fresh, pk, pw = workloads.wide_flush_shapes(k, dev,
                                                                  gen)
    mk, mw = merge_kernel.merge_sorted_words(t_keys, t_counts, fresh)
    err = _same((mk, mw), (pk, pw))
    del pk, pw
    results.append(_report(dict(
        name="merge_path_words", route="cuda",
        source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_words(
            t_keys, t_counts, fresh), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_plain(
            t_keys, t_counts, fresh), 3),
        **_bound(_nbytes(t_keys, t_counts, fresh, mk, mw),
                 W * mk.shape[1]),
        # no library call: torch.sort orders no multi-word key
        library_ms=None, tile=merge_kernel.words_tile_len(W)),
        f"K2 W-word merge 2^24 table + 2^26 fresh (W={W})"))
    counted.append((results[-1], lambda: merge_kernel.merge_sorted_words(
        t_keys, t_counts, fresh)))
    _repeat_equal("K2 W-word", lambda: merge_kernel.merge_sorted_words(
        t_keys, t_counts, fresh))

    # K3 W-word: that merged stream reduced to 2^24, and to 2^20 (the
    # true n_unique must come back)
    errs = []
    for out_size in (cap, 1 << 20):
        g = reduce_kernel.reduce_by_key_words(mk, mw, out_size)
        w = reduce_kernel.reduce_by_key_words_plain(mk, mw, out_size)
        if int(g[2]) != int(w[2]):
            raise AssertionError(f"K3 W-word n_unique {int(g[2])} != "
                                 f"{int(w[2])}")
        errs += [_max_abs_err(g[0], w[0]), _max_abs_err(g[1], w[1])]
        print(f"K3 W-word reduce to {out_size}: n_unique {int(g[2])} exact")
    del g, w
    results.append(_report(dict(
        name="reduce_by_key_words", route="cuda",
        source="kat_tpu_torch/csrc/reduce.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:147", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.reduce_by_key_words(mk, mw, cap),
                     5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.reduce_by_key_words_plain(mk, mw, cap), 3),
        **_bound(_nbytes(mk, mw) + cap * (8 * W + 4), 2 * W * mk.shape[1]),
        # no one call, as for K3: unique_consecutive, then index_add_
        library_ms=None, tile=reduce_kernel.tile_len()),
        f"K3 W-word reduce {mk.shape[1]} -> 2^24 (W={W})"))
    counted.append((results[-1], lambda: reduce_kernel.reduce_by_key_words(
        mk, mw, cap)))
    _repeat_equal("K3 W-word", lambda: reduce_kernel.reduce_by_key_words(
        mk, mw, cap))

    # strain: W = 2..9 at boundary k, around every kernel's tile; the sort
    # also on the keys that skew its prefix split
    n = 3 * sort_kernel.words_tile_len(2) + 17
    for sk in workloads.WIDE_STRAIN_K:
        stb = 2 * top_bases(sk) + 1
        for name in workloads.WIDE_STRAIN + workloads.WIDE_SKEW:
            # (not `keys`: the K1 call counted above reads that name)
            skeys = workloads.wide_strain(name, sk, n, dev, gen)
            _same((sort_kernel.sort_words(skeys, stb),),
                  (sort_kernel.sort_words_plain(skeys),))
            if name in workloads.WIDE_SKEW:
                continue
            a, ac, b = workloads.wide_merge_inputs(skeys, gen)
            _same(merge_kernel.merge_sorted_words(a, ac, b),
                  merge_kernel.merge_sorted_words_plain(a, ac, b))
            rk, rw = workloads.wide_reduce_inputs(skeys, gen)
            for out_size in (n, 100):
                g = reduce_kernel.reduce_by_key_words(rk, rw, out_size)
                w = reduce_kernel.reduce_by_key_words_plain(rk, rw, out_size)
                if int(g[2]) != int(w[2]):
                    raise AssertionError(f"K3 W-word n_unique at k={sk} "
                                         f"({name})")
                _same(g[:2], w[:2])
    # lengths around every tile at W = 2 (k = 41)
    lengths = sorted({1, 2, *[t + d for t in (
        sort_kernel.words_tile_len(2), merge_kernel.words_tile_len(2),
        reduce_kernel.tile_len()) for d in (-1, 0, 1)]})
    for m in lengths:
        skeys = workloads.wide_keys(k, m, dev, gen)
        _same((sort_kernel.sort_words(skeys, tb),),
              (sort_kernel.sort_words_plain(skeys),))
        a, ac, b = workloads.wide_merge_inputs(torch.cat(
            [skeys, workloads.wide_keys(k, 2 * m, dev, gen)], dim=1), gen)
        _same(merge_kernel.merge_sorted_words(a, ac, b),
              merge_kernel.merge_sorted_words_plain(a, ac, b))
        rk, rw = workloads.wide_reduce_inputs(skeys, gen)
        g = reduce_kernel.reduce_by_key_words(rk, rw, m)
        w = reduce_kernel.reduce_by_key_words_plain(rk, rw, m)
        if int(g[2]) != int(w[2]):
            raise AssertionError(f"K3 W-word n_unique at n = {m}")
        _same(g[:2], w[:2])
    print("K1/K2/K3 W-word: exact on " + ", ".join(workloads.WIDE_STRAIN)
          + " (K1 also on " + ", ".join(workloads.WIDE_SKEW)
          + f"; {n} keys) at k = "
          + ", ".join(map(str, workloads.WIDE_STRAIN_K))
          + " (W = 2..9), and at n = " + ", ".join(map(str, lengths))
          + f" (k = {k}); five runs of each at the path's shapes agree")
    return results, counted


def _wide_table_keys(k: int, cap: int, universe, n_real: int, dev, gen):
    """[W, cap] sorted distinct keys (SENTINEL padding) of n_real keys
    drawn from `universe` ([W, n] words), their counts 1-99, and the
    number of real slots; built by the plain W-word sort and reduce."""
    import torch

    from kat_tpu_torch.ops import reduce_kernel, sort_kernel

    pick = torch.randperm(universe.shape[1], device=dev,
                          generator=gen)[:n_real]
    real = sort_kernel.sort_words_plain(universe[:, pick])
    keys, _c, nu = reduce_kernel.reduce_by_key_words_plain(
        real, torch.ones(real.shape[1], dtype=torch.int32, device=dev), cap)
    nu = int(nu)
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    counts[:nu] = torch.randint(1, 100, (nu,), dtype=torch.int32, device=dev,
                                generator=gen)
    return keys, counts, nu


def check_wide_join_kernels(dev, gen, m: int = 1 << 23, cap: int = 1 << 24):
    """K1 W-word with a value and K2 W-word with payload planes, the wide
    join's two new kernel forms, against their plain versions at the
    join's shapes: the query sort of 2^23 wide keys at W = 2 (k = 41) and
    W = 4 (k = 95), each carrying its position, a third of them keys of the
    table, 10% SENTINEL; the merge of a 2^24-slot table (~2^23 real keys)
    with those sorted queries, one plane a side (the join, W = 2); the
    merge of two such tables sharing about half their keys, two planes a
    side (the dual probe, W = 2), and the dual probe as a whole against two
    binary searches.  Five runs of each with equal outputs; the first two
    forms also timed at `filter seq -m 41`'s batch (1,007,616 queries);
    then every form on workloads.WIDE_STRAIN at the boundary k of W = 2..9
    and at lengths around the tiles.  Returns the entries and their
    (entry, call) pairs."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels, workloads
    from kat_tpu_torch.benchmarks.workloads import HBM_BYTES_PER_S
    from kat_tpu_torch.core import wide
    from kat_tpu_torch.core.kmers import top_bases
    from kat_tpu_torch.ops import join, merge_kernel, sort_kernel

    results, counted = [], []
    universe = workloads.wide_keys(41, 3 * cap // 4, dev, gen, sent=0.0)
    t_keys, t_counts, n_real = _wide_table_keys(41, cap, universe, cap // 2,
                                                dev, gen)
    joined = None
    for k in (41, 95):
        tb = 2 * top_bases(k) + 1
        q = workloads.wide_keys(k, m, dev, gen)
        W = q.shape[0]
        if k == 41:  # a third of the queries hit the table
            hit = torch.randint(0, n_real, (len(range(0, m, 3)),),
                                device=dev, generator=gen)
            q[:, ::3] = t_keys[:, hit]
        idx = torch.arange(m, dtype=torch.int32, device=dev)
        got = sort_kernel.sort_words_pairs(q, idx, tb)
        err = max(_same(got, sort_kernel.sort_words_pairs_plain(q, idx)),
                  _same(got, earlier_kernels.sort_words(q, tb, idx)))
        _repeat_equal(f"K1 W-word with a value (W={W})",
                      lambda q=q, idx=idx, tb=tb:
                      sort_kernel.sort_words_pairs(q, idx, tb))
        entry = _report(dict(
            name=f"radix_sort_words_pairs[W={W}]", route="cuda",
            source="kat_tpu_torch/csrc/sort.cu",
            replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
            ms=_timed_ms(lambda q=q, idx=idx, tb=tb:
                         sort_kernel.sort_words_pairs(q, idx, tb), 5),
            earlier_ms=_timed_ms(lambda q=q, idx=idx, tb=tb:
                                 earlier_kernels.sort_words(q, tb, idx), 5),
            # chained stable torch.sort calls and gathers: no one PyTorch
            # call sorts W-word keys
            plain_ms=_timed_ms(lambda q=q, idx=idx:
                               sort_kernel.sort_words_pairs_plain(q, idx), 3),
            **_bound(_nbytes(q, idx, *got), m * int(math.log2(m))),
            # no library call: torch.sort orders no multi-word key
            library_ms=None, passes=sort_kernel.words_passes(W, tb),
            tile=sort_kernel.words_tile_len(W),
            floor_ms=sort_kernel.words_pass_floor_bytes(m, W, tb, True)
            / HBM_BYTES_PER_S * 1e3),
            f"K1 W-word sort 2^{m.bit_length() - 1} (key, value) pairs, "
            f"k={k} (W={W})")
        counted.append((entry, lambda q=q, idx=idx, tb=tb:
                        sort_kernel.sort_words_pairs(q, idx, tb)))
        if k == 41:  # the kernel's entry; W = 4 rides in it
            entry["name"] = "radix_sort_words_pairs"
            results.append(entry)
            joined = got
        else:
            results[0]["w4"] = entry
        del got, q, idx

    # K2 W-word, one plane: the table carrying -1, the sorted queries
    # their positions, as the wide join merges them
    sq, sidx = joined
    ap = (torch.full((cap,), -1, dtype=torch.int32, device=dev),)
    bp = (sidx,)
    mk, mp = merge_kernel.merge_sorted_words_payload(t_keys, ap, sq, bp)
    err = _same((mk, *mp), (lambda k_, p_: (k_, *p_))(
        *merge_kernel.merge_sorted_words_payload_plain(t_keys, ap, sq, bp)))
    _repeat_equal("K2 W-word with a plane", lambda: (lambda k_, p_: (
        k_, *p_))(*merge_kernel.merge_sorted_words_payload(t_keys, ap, sq,
                                                           bp)))
    W = t_keys.shape[0]
    results.append(_report(dict(
        name="merge_path_words_payload", route="cuda",
        source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_payload(
            t_keys, ap, sq, bp), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_payload_plain(
            t_keys, ap, sq, bp), 3),
        **_bound(_nbytes(t_keys, *ap, sq, *bp, mk, *mp), W * mk.shape[1]),
        # no library call: torch.sort orders no multi-word key
        library_ms=None, tile=merge_kernel.words_tile_len(W)),
        f"K2 W-word merge 2^{cap.bit_length() - 1} table + "
        f"2^{m.bit_length() - 1} queries, 1 plane (W=2)"))
    counted.append((results[-1], lambda a_=t_keys, ap_=ap, b_=sq, bp_=bp:
                    merge_kernel.merge_sorted_words_payload(a_, ap_, b_,
                                                            bp_)))
    del mk, mp, joined

    # both forms at `filter seq -m 41`'s batch (each launched once a batch
    # there): 1024 reads of 1024 bases, 1,007,616 windows, a third of them
    # the table's, against the 2^24-slot table
    m_fs = 1024 * (1024 - 41 + 1)
    q = workloads.wide_keys(41, m_fs, dev, gen)
    q[:, ::3] = t_keys[:, torch.randint(0, n_real, (len(range(0, m_fs, 3)),),
                                        device=dev, generator=gen)]
    idx = torch.arange(m_fs, dtype=torch.int32, device=dev)
    got = sort_kernel.sort_words_pairs(q, idx, 21)
    _same(got, sort_kernel.sort_words_pairs_plain(q, idx))
    results[0]["filter_seq_batch"] = dict(
        pairs=m_fs,
        ms=_timed_ms(lambda: sort_kernel.sort_words_pairs(q, idx, 21), 5),
        plain_ms=_timed_ms(
            lambda: sort_kernel.sort_words_pairs_plain(q, idx), 3),
        **_bound(_nbytes(q, idx, *got), m_fs * int(math.log2(m_fs))))
    bp = (got[1],)
    mk, mp = merge_kernel.merge_sorted_words_payload(t_keys, ap, got[0], bp)
    _same((mk, *mp), (lambda k_, p_: (k_, *p_))(
        *merge_kernel.merge_sorted_words_payload_plain(t_keys, ap, got[0],
                                                       bp)))
    results[1]["filter_seq_batch"] = dict(
        queries=m_fs,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_payload(
            t_keys, ap, got[0], bp), 5),
        plain_ms=_timed_ms(
            lambda: merge_kernel.merge_sorted_words_payload_plain(
                t_keys, ap, got[0], bp), 3),
        **_bound(_nbytes(t_keys, *ap, got[0], *bp, mk, *mp),
                 W * mk.shape[1]))
    for entry, what in ((results[0], "K1 W-word with a value"),
                        (results[1], "K2 W-word with a plane")):
        fs = entry["filter_seq_batch"]
        print(f"{what} at filter seq -m 41's batch ({m_fs} windows): exact, "
              f"kernel {fs['ms']:.3f} ms, plain {fs['plain_ms']:.3f} ms, "
              f"bound {fs['bound_ms']:.3f} ms by {fs['bound_by']}")
    del q, idx, got, mk, mp

    # K2 W-word, two planes: two tables, each carrying its counts and its
    # source, as the wide dual probe merges them
    b_keys, b_counts, _nb = _wide_table_keys(41, cap, universe, cap // 2,
                                             dev, gen)
    del universe
    ap = (t_counts, torch.full((cap,), 1, dtype=torch.int32, device=dev))
    bp = (b_counts, torch.full((cap,), 2, dtype=torch.int32, device=dev))
    mk, mp = merge_kernel.merge_sorted_words_payload(t_keys, ap, b_keys, bp)
    err = _same((mk, *mp), (lambda k_, p_: (k_, *p_))(
        *merge_kernel.merge_sorted_words_payload_plain(t_keys, ap, b_keys,
                                                       bp)))
    _repeat_equal("K2 W-word with two planes", lambda: (lambda k_, p_: (
        k_, *p_))(*merge_kernel.merge_sorted_words_payload(t_keys, ap, b_keys,
                                                           bp)))
    results.append(_report(dict(
        name="merge_path_words_payload[dual]", route="cuda",
        source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_payload(
            t_keys, ap, b_keys, bp), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_words_payload_plain(
            t_keys, ap, b_keys, bp), 3),
        **_bound(_nbytes(t_keys, *ap, b_keys, *bp, mk, *mp),
                 W * mk.shape[1]),
        # no library call: torch.sort orders no multi-word key
        library_ms=None, tile=merge_kernel.words_tile_len(W)),
        f"K2 W-word merge 2^{cap.bit_length() - 1} + 2^{cap.bit_length() - 1}"
        " slots, 2 planes (the wide dual probe)"))
    counted.append((results[-1], lambda a_=t_keys, ap_=ap, b_=b_keys, bp_=bp:
                    merge_kernel.merge_sorted_words_payload(a_, ap_, b_,
                                                            bp_)))
    del mk, mp
    ta = wide.WideTable(t_keys, t_counts, n_real)
    tb_ = wide.WideTable(b_keys, b_counts, _nb)
    got_a, got_b = join.counts_join_dual(t_keys, t_counts, b_keys, b_counts)
    if not (torch.equal(got_a, wide.lookup_wide(tb_, t_keys))
            and torch.equal(got_b, wide.lookup_wide(ta, b_keys))):
        raise AssertionError("the wide dual probe differs from two searches")
    print(f"wide dual probe: {int((got_a > 0).sum())} keys shared of "
          f"{n_real} and {_nb}; equal to two binary searches")
    del ta, tb_, got_a, got_b

    # strain: W = 2..9 at boundary k, around every tile
    n = 3 * sort_kernel.words_tile_len(2) + 17
    for sk in workloads.WIDE_STRAIN_K:
        stb = 2 * top_bases(sk) + 1
        for name in workloads.WIDE_STRAIN + workloads.WIDE_SKEW:
            skeys = workloads.wide_strain(name, sk, n, dev, gen)
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            _same(sort_kernel.sort_words_pairs(skeys, pos, stb),
                  sort_kernel.sort_words_pairs_plain(skeys, pos))
            if name in workloads.WIDE_SKEW:
                continue
            a, _ac, b = workloads.wide_merge_inputs(skeys, gen)
            pa = (torch.arange(a.shape[1], dtype=torch.int32, device=dev),
                  -torch.arange(a.shape[1], dtype=torch.int32, device=dev))
            pb = (torch.arange(b.shape[1], dtype=torch.int32, device=dev),
                  torch.full((b.shape[1],), 2, dtype=torch.int32,
                             device=dev))
            for p_a, p_b in ((pa[:1], pb[:1]), (pa, pb)):
                g = merge_kernel.merge_sorted_words_payload(a, p_a, b, p_b)
                w = merge_kernel.merge_sorted_words_payload_plain(a, p_a, b,
                                                                  p_b)
                _same((g[0], *g[1]), (w[0], *w[1]))
    lengths = sorted({1, 2, *[t + d for t in (
        sort_kernel.words_tile_len(2), merge_kernel.words_tile_len(2),
        merge_kernel.words_tile_len(4), merge_kernel.words_tile_len(9))
        for d in (-1, 0, 1)]})
    for m_ in lengths:
        skeys = workloads.wide_keys(41, m_, dev, gen)
        pos = torch.arange(m_, dtype=torch.int32, device=dev)
        _same(sort_kernel.sort_words_pairs(skeys, pos, 21),
              sort_kernel.sort_words_pairs_plain(skeys, pos))
        a, _ac, b = workloads.wide_merge_inputs(torch.cat(
            [skeys, workloads.wide_keys(41, 2 * m_, dev, gen)], dim=1), gen)
        pa = (torch.arange(a.shape[1], dtype=torch.int32, device=dev),)
        pb = (torch.arange(b.shape[1], dtype=torch.int32, device=dev),)
        g = merge_kernel.merge_sorted_words_payload(a, pa, b, pb)
        w = merge_kernel.merge_sorted_words_payload_plain(a, pa, b, pb)
        _same((g[0], *g[1]), (w[0], *w[1]))
    print("K1 W-word with a value and K2 W-word with 1-2 planes: exact on "
          + ", ".join(workloads.WIDE_STRAIN) + " (K1 also on "
          + ", ".join(workloads.WIDE_SKEW) + f"; {n} keys) at k = "
          + ", ".join(map(str, workloads.WIDE_STRAIN_K))
          + " (W = 2..9), and at n = " + ", ".join(map(str, lengths))
          + " (k = 41); five runs of each at the join's shapes agree")
    return results, counted


def route_sweep(dev, smi: str) -> list:
    """The join against the search (benchmarks/sweep_lookup.route_table):
    one-word, W = 2 and W = 4 lookups of 2^16, 2^20 and 2^23 queries
    against 2^20- and 2^24-slot tables, and the dual probe against two
    searches at two 2^24-slot tables; the policy's pick beside each."""
    import torch

    from kat_tpu_torch.benchmarks import sweep_lookup

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    t0 = time.perf_counter()
    rows = sweep_lookup.route_table(
        dev, gen, report=lambda line: print(f"route sweep: {line}"))
    agree = sum((r["policy"] == "join") == (r["join_ms"] < r["search_ms"])
                for r in rows)
    print(f"route sweep ({smi}): kind words capacity queries order join_ms "
          f"search_ms join/search policy; the join is faster in "
          f"{sum(r['join_ms'] < r['search_ms'] for r in rows)} of "
          f"{len(rows)} cells, the policy picks the faster route in "
          f"{agree}; {time.perf_counter() - t0:.1f} s")
    return rows


def main_path(dev):
    """Counting at bench.py's scale through CodeStreamingCounter."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import counting, stats
    from kat_tpu_torch.core.kmers import SENTINEL, extract_keys_plain
    from kat_tpu_torch.ops import (binned_kernel, extract_kernel,
                                   merge_kernel, merge_reduce_kernel,
                                   reduce_kernel, sort_kernel)

    k, rows, length, n_batches = (workloads.MAIN_K, workloads.MAIN_ROWS,
                                  workloads.MAIN_LENGTH,
                                  workloads.MAIN_BATCHES)
    genome, batches = workloads.main_path_batches(dev, SEED)  # on the card

    warm = counting.CodeStreamingCounter(k, device=dev, flush_batches=2)
    for b in batches[:2]:
        warm.add_codes(b)
    warm.finish()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    kernels = (sort_kernel.sort_keys, merge_kernel.merge_sorted,
               reduce_kernel.reduce_by_key, binned_kernel.binned_sums)
    extract = extract_kernel.extract_keys
    fused = merge_reduce_kernel.merge_reduce
    for fn in (*kernels, extract, fused):
        fn.launches = 0
    t0 = time.perf_counter()
    sc = workloads.main_path_counter(dev)
    for b in batches:
        sc.add_codes(b)
    table = sc.finish()
    hist = stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    n_extract, n_fused = extract.launches, fused.launches
    peak = torch.cuda.max_memory_allocated(dev)

    n_windows = n_batches * rows * (length - k + 1)
    print(f"main path: {n_windows} windows k={k} in {dt:.4f} s = "
          f"{n_windows / dt:.1f} k-mers/s; table {table.n_unique} distinct, "
          f"capacity {sc.capacity}; launches sort/merge/reduce/binned "
          f"{launches}, K2 + K3 fused {n_fused}, extraction {n_extract}; "
          f"peak memory {peak} B")
    # every merge of the path is far below MAX_STREAM: all fused
    if min(launches[0], launches[3], n_fused) < 1 or launches[1:3] != [0, 0]:
        raise AssertionError(f"launches sort/merge/reduce/binned {launches},"
                             f" fused {n_fused}: the flush's merges must all "
                             "take the fused kernel")
    if n_extract != n_batches:
        raise AssertionError(f"{n_extract} extraction launches for "
                             f"{n_batches} batches")
    if sc.capacity != 1 << 24:
        raise AssertionError(f"capacity {sc.capacity}, expected 2^24")

    # reference: torch.unique over the same windows, extracted by the plain
    # version (the counter ran the kernel)
    allk = torch.cat([extract_keys_plain(b, k).reshape(-1) for b in batches])
    ref_keys, ref_counts = torch.unique(allk[allk != SENTINEL],
                                        return_counts=True)
    del allk
    n = table.n_unique
    if n != ref_keys.numel():
        raise AssertionError(f"n_unique {n} != reference {ref_keys.numel()}")
    if not (torch.equal(table.keys[:n], ref_keys)
            and torch.equal(table.counts[:n].to(torch.int64), ref_counts)
            and bool((table.keys[n:] == SENTINEL).all())):
        raise AssertionError("table differs from the reference")
    ref_hist = stats.hist_from_counts(ref_counts, 1, 10001, 1, 10001)
    if not torch.equal(hist, ref_hist):
        raise AssertionError("histogram differs from the reference")
    print("main path: table and histogram equal the reference")
    return launches, n_extract, n_fused, table, genome, ref_keys, ref_counts


def _lookup_codes(dev, genome, k: int, rows: int, row_w: int, seed: int):
    """The lookup paths' queries: `rows` rows of the genome of row_w
    windows each, 1% of bases substituted, a few invalid."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    codes = genome.unfold(0, row_w + k - 1, row_w)[:rows].clone()
    sub = torch.rand(codes.shape, device=dev, generator=gen) < 0.01
    codes[sub] = (codes[sub] + 1 + (torch.rand(int(sub.sum()), device=dev,
                  generator=gen) * 3).to(torch.uint8)) & 3
    codes[torch.rand(codes.shape, device=dev, generator=gen) < 1e-5] = 4
    return codes


def lookup_path(dev, table, genome, ref_keys, ref_counts):
    """The k=27 windows of the counted genome looked up in the table
    main_path built, through coverage.window_counts: by the policy's route
    (the search, for a narrow table) and by the join, whose three kernels'
    launches are read around that run."""
    import torch

    from kat_tpu_torch.core import coverage, tables
    from kat_tpu_torch.core.kmers import canonicalize, extract_kmers
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k, rows, row_w = 27, 128, 1 << 16
    codes = _lookup_codes(dev, genome, k, rows, row_w, SEED + 2)
    m = rows * row_w
    table = tables.compact(table)
    if tables._join_policy(m, table.capacity, table.keys.device):
        raise AssertionError("the policy sends a narrow lookup to the join")

    coverage.window_counts(table, codes[:2], k, True, method="join")  # warm
    torch.cuda.synchronize()
    kernels = (sort_kernel.sort_pairs, merge_kernel.merge_sorted_payload,
               reduce_kernel.compact_flagged)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    counts, gc, valid = coverage.window_counts(table, codes, k, True,
                                               method="join")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    if launches != [1, 1, 1]:
        raise AssertionError(f"the join launched {launches}")

    # the same windows by the policy's route (the binary search), and by a
    # search of torch.unique's table with GC from a running sum of the
    # codes
    for fn in kernels:
        fn.launches = 0
    s_counts, s_gc, s_valid = coverage.window_counts(table, codes, k, True)
    if any(fn.launches for fn in kernels):
        raise AssertionError("the policy's route launched the join")
    if not (torch.equal(counts, s_counts) and torch.equal(gc, s_gc)
            and torch.equal(valid, s_valid)):
        raise AssertionError("join and search routes differ")
    fwd, ok = extract_kmers(codes, k, canonical=False)
    q = canonicalize(fwd, k)
    pos = torch.searchsorted(ref_keys, q).clamp_max(ref_keys.numel() - 1)
    want = torch.where(ok & (ref_keys[pos] == q), ref_counts[pos], 0)
    is_gc = ((codes == 1) | (codes == 2)).to(torch.int32)
    run = torch.nn.functional.pad(is_gc.cumsum(1), (1, 0))
    want_gc = torch.where(ok, run[:, k:] - run[:, :-k], -1)
    if not (torch.equal(counts.to(torch.int64), want)
            and torch.equal(gc, want_gc.to(torch.int32))
            and torch.equal(valid, ok)):
        raise AssertionError("window_counts differs from the reference")
    n_hit = int((counts > 0).sum())
    n_bad = int((~valid).sum())
    if not 0 < n_hit < m - n_bad or n_bad == 0:
        raise AssertionError(f"degenerate queries: {n_hit} hits, {n_bad} "
                             f"invalid of {m}")

    wc_ms = _timed_ms(lambda: coverage.window_counts(table, codes, k, True),
                      3)
    wcj_ms = _timed_ms(lambda: coverage.window_counts(table, codes, k, True,
                                                      method="join"), 3)
    join_ms = _timed_ms(lambda: tables.lookup(
        table, q, method="join", key_bits=2 * k + 1), 5)
    search_ms = _timed_ms(lambda: tables.lookup(table, q, method="search"),
                          5)
    print(f"lookup path: {m} windows k={k} against {table.n_unique} keys at "
          f"capacity {table.capacity}, by the join in {dt:.4f} s cold; "
          f"{n_hit} present, {n_bad} invalid; join, search (the policy's "
          f"route) and reference agree; launches of the join "
          f"sort_pairs/merge_payload/compact {launches}")
    print(f"lookup path: window_counts {wc_ms:.3f} ms by the policy's route "
          f"= {m / wc_ms * 1e3:.1f} windows/s, {wcj_ms:.3f} ms by the join; "
          f"join {join_ms:.3f} ms = "
          f"{join_ms * 1e6 / m:.4f} ns/query; search {search_ms:.3f} ms = "
          f"{search_ms * 1e6 / m:.4f} ns/query")
    return launches


def gcp_path(dev, table, ref_keys, ref_counts):
    """stats.gcp_matrix over the table main_path built (k = 27, 2^24
    slots), against the plain binned sum over torch.unique's table on the
    same card.  Returns the binned-sums kernel's launches in that call."""
    import torch

    from kat_tpu_torch.core import stats
    from kat_tpu_torch.core.kmers import gc_count
    from kat_tpu_torch.ops import binned_kernel

    k, cvg_bins = 27, 1000
    binned_kernel.binned_sums.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = stats.gcp_matrix(table, k, cvg_bins)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = binned_kernel.binned_sums.launches
    flat = gc_count(ref_keys) * (cvg_bins + 1) + ref_counts.clamp_max(
        cvg_bins)
    want = binned_kernel.binned_sums_plain(
        flat.to(torch.int32), torch.ones((1, flat.numel()), dtype=torch.bool,
                                         device=dev),
        (k + 1) * (cvg_bins + 1)).reshape(k + 1, cvg_bins + 1)
    _max_abs_err(got, want)
    if launches != 1:
        raise AssertionError(f"gcp_matrix launched the binned-sums kernel "
                             f"{launches} times")
    ms = _timed_ms(lambda: stats.gcp_matrix(table, k, cvg_bins), 5)
    print(f"gcp path: {table.n_unique} distinct k-mers at capacity "
          f"{table.capacity} in {dt:.4f} s cold, {ms:.3f} ms warm = "
          f"{table.capacity / ms * 1e3:.1f} slots/s; equal to the plain "
          f"binned sum of torch.unique's table; the fullest cell holds "
          f"{int(got.max())}")
    return launches


def _numpy_lookup(keys: np.ndarray, counts: np.ndarray, q: np.ndarray):
    """counts of sorted unique `keys` at the queries, 0 where absent."""
    if keys.size == 0:
        return np.zeros(q.shape, np.int64)
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    return np.where(keys[pos] == q, counts[pos], 0).astype(np.int64)


def _numpy_comp(k1, c1, k2, c2, k3=None, c3=None, bins: int = 1001):
    """kat comp's counters, spectra and matrices at unit scales and
    bins x bins, with numpy alone, from canonical tables' sorted keys and
    counts (the cross probes need no canonicalization then)."""
    h2 = _numpy_lookup(k2, c2, k1)
    h1b = _numpy_lookup(k1, c1, k2)
    c1, c2 = c1.astype(np.int64), c2.astype(np.int64)
    top = bins - 1
    s1, s2, sb = (np.minimum(x, top) for x in (c1, h2, c2))
    shared = h2 > 0
    only2 = h1b == 0

    def count(b, mask=None, size=bins):
        return np.bincount(b if mask is None else b[mask],
                           minlength=size).astype(np.uint64)

    out = dict(counters=dict(
        hash1_total=int(c1.sum()), hash1_distinct=int(c1.size),
        hash1_only_total=int(c1[~shared].sum()),
        hash1_only_distinct=int((~shared).sum()),
        shared_hash1_total=int(c1[shared].sum()),
        shared_hash2_total=int(h2[shared].sum()),
        shared_distinct=int(shared.sum()),
        hash2_total=int(c2.sum()), hash2_distinct=int(c2.size),
        hash2_only_total=int(c2[only2].sum()),
        hash2_only_distinct=int(only2.sum())))
    main = count(s1 * bins + s2, size=bins * bins).reshape(bins, bins)
    main[0] += count(sb, only2)
    out.update(main=main, spectrum1=count(s1),
               shared_spectrum1=count(s1, shared), spectrum2=count(sb),
               shared_spectrum2=count(s2, shared))
    if k3 is not None:
        h3 = _numpy_lookup(k3, c3, k1)
        s3 = np.minimum(h3, top)
        flat = s1 * bins + s3
        for name, m in (("ends", s2 == s3), ("mixed", (s2 != s3) & (h3 > 0)),
                        ("middle", (s2 != s3) & (h3 == 0))):
            out[name] = count(flat, m, bins * bins).reshape(bins, bins)
        out["counters"].update(hash3_total=int(c3.astype(np.int64).sum()),
                               hash3_distinct=int(c3.size))
    else:
        out["counters"].update(hash3_total=0, hash3_distinct=0)
    return out


def _check_comp(c, want: dict, what: str) -> None:
    """A Comp's results against _numpy_comp's."""
    if c.counters != want["counters"]:
        raise AssertionError(f"{what}: counters {c.counters} != numpy's "
                             f"{want['counters']}")
    got = dict(main=c.main_mx.data, spectrum1=c.spectrum1,
               shared_spectrum1=c.shared_spectrum1, spectrum2=c.spectrum2,
               shared_spectrum2=c.shared_spectrum2)
    if c.three_inputs:
        got.update(ends=c.ends_mx.data, mixed=c.mixed_mx.data,
                   middle=c.middle_mx.data)
    for name, g in got.items():
        if not np.array_equal(g, want[name]):
            raise AssertionError(f"{what}: {name} differs from numpy's")


def comp_path(dev, table, genome, smi: str):
    """kat comp of reads against an assembly, how most users run it (the
    spectra-cn check): hash1 the main path's reads table, hash2 the
    genome's own k = 27 k-mers (its first 2^23 windows cut into rows as the
    sequence encoder cuts a contig), and with three inputs hash3 a second
    read draw of 24 batches at another seed; default bins and scales, so
    the fused dual probe engages.  Through Comp.compare_tables (what
    `execute` runs once the inputs are counted), timed cold and warm, held
    against numpy over the tables' keys and counts.  Returns the launches
    of the binned-sums kernel, K2 with payload planes and K4 in the
    two-input and the three-input run."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import counting, tables
    from kat_tpu_torch.ops import binned_kernel, merge_kernel, reduce_kernel
    from kat_tpu_torch.tools.comp import Comp

    k = workloads.MAIN_K
    sc = counting.CodeStreamingCounter(k, initial_capacity=1 << 20,
                                       flush_windows=1 << 26, device=dev)
    sc.add_codes(workloads.contig_rows(genome, k))
    t2 = sc.finish()
    sc = workloads.main_path_counter(dev)
    for b in workloads.read_draw(genome, SEED + 5,
                                 workloads.COMP_THIRD_BATCHES):
        sc.add_codes(b)
    t3 = sc.finish()
    del sc
    t1c, t2c = tables.compact(table), tables.compact(t2)
    if not (tables._join_policy(t1c.capacity, t2c.capacity, dev, 1, True)
            and tables._join_policy(t2c.capacity, t1c.capacity, dev, 1,
                                    True)):
        raise AssertionError("the dual probe's join policy did not engage")

    kernels = (binned_kernel.binned_sums, merge_kernel.merge_sorted_payload,
               reduce_kernel.compact_flagged)

    def run(three: bool):
        c = Comp([], [])
        c.quiet = True
        c.set_mer_len(k)
        if three:
            c.set_third_input([])
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.compare_tables(table, t2, t3 if three else None)
        torch.cuda.synchronize()
        return c, time.perf_counter() - t0, [fn.launches for fn in kernels]

    host = [counting.table_to_numpy(t) for t in (table, t2, t3)]
    host = [(keys.astype(np.int64), counts) for keys, counts in host]
    launches = {}
    for three in (False, True):
        what = "three inputs" if three else "two inputs"
        c, cold, n = run(three)
        _c, warm, _n = run(three)
        launches[what] = n
        want = _numpy_comp(*host[0], *host[1],
                           *(host[2] if three else (None, None)))
        _check_comp(c, want, f"comp path, {what}")
        n_kmers = table.n_unique + t2.n_unique + (t3.n_unique if three
                                                  else 0)
        print(f"comp path, {what}: {n_kmers} distinct k-mers compared "
              f"(hash1 {table.n_unique}, hash2 {t2.n_unique}"
              + (f", hash3 {t3.n_unique}" if three else "")
              + f") in {cold:.4f} s cold = {n_kmers / cold:.1f} k-mers/s, "
              f"{warm:.4f} s warm = {n_kmers / warm:.1f} k-mers/s ({smi}); "
              f"{c.counters['shared_distinct']} shared; launches "
              f"binned/merge_payload/compact {n}; equal to numpy's")
    two, three = launches["two inputs"], launches["three inputs"]
    # two inputs: pass 1 and pass 2 bin once each, the dual probe merges
    # once and compacts twice; three: pass 1 also bins the three matrices
    # and looks hash3 up by the search (a narrow single lookup)
    if two != [2, 1, 2] or three != [3, 1, 2]:
        raise AssertionError(f"comp launched binned/merge_payload/compact "
                             f"{two} (two inputs), {three} (three)")
    # the packed sums' inputs of one more two-input run, for their check
    captured, packed_sums = [], binned_kernel.packed_sums

    def capture(packed, masks, requests):
        captured.append((packed.clone(), masks.clone(),
                         tuple(tuple(r) for r in requests)))
        return packed_sums(packed, masks, requests)

    binned_kernel.packed_sums = capture
    try:
        run(False)
    finally:
        binned_kernel.packed_sums = packed_sums
    if len(captured) != 2:
        raise AssertionError(f"comp made {len(captured)} packed sums, not "
                             "pass 1's and pass 2's")
    launches["packed"] = captured
    return launches


def _word_ids(*sets):
    """Integer names of wide keys, with numpy alone: each argument is a
    list of W uint64/int64 word arrays (word 0 most significant); returns
    one int64 array per argument, equal keys named alike and the names
    ordered as the keys are (lexicographically), so that sorted unique
    keys get sorted names."""
    sizes = [s_[0].size for s_ in sets]
    words = [np.concatenate([np.asarray(s_[w], np.int64) for s_ in sets])
             for w in range(len(sets[0]))]
    order = np.lexsort(words[::-1])
    new = np.zeros(order.size, bool)
    new[:1] = True
    for w in words:
        sw = w[order]
        new[1:] |= sw[1:] != sw[:-1]
    names = np.empty(order.size, np.int64)
    names[order] = np.cumsum(new) - 1
    return np.split(names, np.cumsum(sizes)[:-1])


def wide_lookup_path(dev, wtable, genome, rows: int = 128,
                     row_w: int = 1 << 16):
    """The k = 41 windows of the genome looked up in the wide path's table
    (8.4M distinct, 2^24 slots) through coverage.window_counts, as
    lookup_path at k = 27: 128 rows of 65,576 codes (2^23 windows, 1%
    substituted, a few invalid).  The policy takes the wide join; its three
    kernels' launches are read around that run, and its counts must equal
    the binary search's.  Returns those launches."""
    import torch

    from kat_tpu_torch.core import coverage, tables
    from kat_tpu_torch.core.kmers import canonicalize_words, extract_kmers_wide
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k = 41
    codes = _lookup_codes(dev, genome, k, rows, row_w, SEED + 6)
    m = rows * row_w
    table = tables.compact(wtable)
    if not tables._join_policy(m, table.capacity, dev, table.n_words):
        raise AssertionError("the policy did not send the wide lookup to "
                             "the join")
    coverage.window_counts(table, codes[:2], k, True)  # warm
    torch.cuda.synchronize()
    kernels = (sort_kernel.sort_words_pairs,
               merge_kernel.merge_sorted_words_payload,
               reduce_kernel.compact_flagged)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    counts, gc, valid = coverage.window_counts(table, codes, k, True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    if launches != [1, 1, 1]:
        raise AssertionError(f"the wide lookup launched {launches}")
    s_counts, s_gc, s_valid = coverage.window_counts(table, codes, k, True,
                                                     method="search")
    if not (torch.equal(counts, s_counts) and torch.equal(gc, s_gc)
            and torch.equal(valid, s_valid)):
        raise AssertionError("wide join and search routes differ")
    n_hit = int((counts > 0).sum())
    n_bad = int((~valid).sum())
    if not 0 < n_hit < m - n_bad or n_bad == 0:
        raise AssertionError(f"degenerate wide queries: {n_hit} hits, "
                             f"{n_bad} invalid of {m}")
    fwd, _ok = extract_kmers_wide(codes, k, canonical=False)
    q = canonicalize_words(fwd, k)
    del fwd
    wc_ms = _timed_ms(lambda: coverage.window_counts(table, codes, k, True),
                      3)
    join_ms = _timed_ms(lambda: tables.lookup(
        table, q, method="join", key_bits=2 * k + 1), 5)
    search_ms = _timed_ms(lambda: tables.lookup(table, q, method="search"),
                          3)
    print(f"wide lookup path: {m} windows k={k} against {table.n_unique} "
          f"keys at capacity {table.capacity} by the wide join in {dt:.4f} s "
          f"cold; {n_hit} present, {n_bad} invalid; join and search agree; "
          f"launches sort_words_pairs/merge_words_payload/compact "
          f"{launches}")
    print(f"wide lookup path: window_counts {wc_ms:.3f} ms = "
          f"{m / wc_ms * 1e3:.1f} windows/s; join {join_ms:.3f} ms = "
          f"{join_ms * 1e6 / m:.4f} ns/query; search {search_ms:.3f} ms = "
          f"{search_ms * 1e6 / m:.4f} ns/query")
    return launches


def wide_comp_path(dev, wtable, genome, smi: str):
    """`comp -m 41` at the comp path's scale through the wide dual probe:
    hash1 the wide path's k = 41 reads table, hash2 the genome's own
    41-mers (its first 2^23 windows as one contig), default bins and
    scales; Comp.compare_tables timed cold and warm and held against numpy
    over the tables' keys (named by _word_ids) and counts.  Returns the
    launches of the binned sums, K2 W-word with payload planes and K4."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import tables, wide
    from kat_tpu_torch.ops import binned_kernel, merge_kernel, reduce_kernel
    from kat_tpu_torch.tools.comp import Comp

    k = 41
    sc = workloads.wide_counter(k, dev)
    sc.add_codes(workloads.contig_rows(genome, k))
    t2 = sc.finish()
    del sc
    t1c, t2c = tables.compact(wtable), tables.compact(t2)
    if not (tables._join_policy(t1c.capacity, t2c.capacity, dev, 2, True)
            and tables._join_policy(t2c.capacity, t1c.capacity, dev, 2,
                                    True)):
        raise AssertionError("the wide dual probe's policy did not engage")
    del t1c, t2c
    kernels = (binned_kernel.binned_sums,
               merge_kernel.merge_sorted_words_payload,
               reduce_kernel.compact_flagged)

    def run():
        c = Comp([], [])
        c.quiet = True
        c.set_mer_len(k)
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.compare_tables(wtable, t2)
        torch.cuda.synchronize()
        return c, time.perf_counter() - t0, [fn.launches for fn in kernels]

    c, cold, launches = run()
    _c, warm, _n = run()
    (w1, c1), (w2, c2) = (wide.table_words_to_numpy(t) for t in (wtable, t2))
    n1, n2 = _word_ids(list(w1), list(w2))
    _check_comp(c, _numpy_comp(n1, c1, n2, c2), "wide comp path")
    n_kmers = wtable.n_unique + t2.n_unique
    print(f"wide comp path, k={k}: {n_kmers} distinct k-mers compared "
          f"(hash1 {wtable.n_unique}, hash2 {t2.n_unique}) in {cold:.4f} s "
          f"cold = {n_kmers / cold:.1f} k-mers/s, {warm:.4f} s warm = "
          f"{n_kmers / warm:.1f} k-mers/s ({smi}); "
          f"{c.counters['shared_distinct']} shared; launches binned/"
          f"merge_words_payload/compact {launches}; equal to numpy's")
    if launches != [2, 1, 2]:
        raise AssertionError(f"comp -m 41 launched binned/merge_words_payload"
                             f"/compact {launches}")
    return launches


COLD_CONTIGS, COLD_LEN = 1024, 8192  # the 2^23-base genome as contigs


def write_cold_contigs(path: str, genome) -> np.ndarray:
    """The main path's genome (its first 2^23 bases) as 1024 contigs of
    8192 bases in FASTA, every 97th contig with three Ns; returns them as
    an ASCII array [1024, 8192]."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    asm = acgt[genome[:COLD_CONTIGS * COLD_LEN].cpu().numpy()].reshape(
        COLD_CONTIGS, COLD_LEN)
    rng = np.random.default_rng(SEED + 7)
    for i in range(0, COLD_CONTIGS, 97):
        asm[i, rng.integers(0, COLD_LEN, 3)] = ord("N")
    with open(path, "wb") as f:
        for i in range(COLD_CONTIGS):
            f.write(b">c%d\n%s\n" % (i, asm[i].tobytes()))
    return asm


def _numpy_counts_of(tkeys, tcounts, qkeys, valid):
    """Counts of a table at the queries' valid windows, 0 elsewhere, with
    numpy alone: narrow keys as uint64 arrays, wide ones as lists of W word
    arrays (named by _word_ids)."""
    if isinstance(qkeys, list):
        names_t, names_q = _word_ids(list(tkeys), [w[valid] for w in qkeys])
        out = np.zeros(valid.shape, np.int64)
        out[valid] = _numpy_lookup(names_t, tcounts, names_q)
        return out
    return np.where(valid, _numpy_lookup(tkeys, tcounts, qkeys), 0)


def _numpy_windows_any(seqs: np.ndarray, k: int):
    """(keys, valid): uint64 keys for k <= 31, a list of W word arrays
    beyond."""
    if k <= 31:
        return _numpy_windows(seqs, k)
    return _numpy_wide_windows(seqs, k)


def _self_counts(keys, valid):
    """Each valid window's count among the valid windows themselves."""
    if isinstance(keys, list):
        (names,) = _word_ids([w[valid] for w in keys])
    else:
        names = keys[valid]
    uk, uc = np.unique(names, return_counts=True)
    out = np.zeros(valid.shape, np.int64)
    out[valid] = _numpy_lookup(uk, uc, names)
    return out


def cold_path(dev, tmp: str, k: int, table, host, fa: str, asm: np.ndarray,
              smi: str):
    """`kat cold` of the genome's 1024 contigs against the main path's
    reads table at k (tools.cold.Cold: the assembly counted from its
    FASTA, the reads table given), its stats TSV held against numpy's.  The
    join kernels' launches are read around the lookups.  Returns them."""
    import contextlib
    import io

    import torch

    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel
    from kat_tpu_torch.tools.cold import STATS_HEADER, Cold

    c = Cold([], fa)
    c.output_prefix = os.path.join(tmp, f"cold{k}")
    c.quiet = True
    c.reads.table = table
    for inp in (c.reads, c.assembly):
        inp.mer_len, inp.device = k, dev
    t0 = time.perf_counter()
    c.assembly.count(quiet=True)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    kernels = ((sort_kernel.sort_words_pairs,
                merge_kernel.merge_sorted_words_payload) if k > 31
               else (sort_kernel.sort_pairs,
                     merge_kernel.merge_sorted_payload)) + (
        reduce_kernel.compact_flagged,)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        c.write_stats()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]

    keys, valid = _numpy_windows_any(asm, k)
    rc = _numpy_counts_of(*host, keys, valid)
    ac = _self_counts(keys, valid)
    nb = COLD_LEN - k + 1
    med = np.sort(rc, axis=1)[:, nb // 2]
    acn = np.sort(ac, axis=1)[:, nb // 2]
    lines = [STATS_HEADER]
    for i in range(COLD_CONTIGS):
        seq = asm[i]
        n_inv = int((~valid[i]).sum())
        n_nz = int((rc[i] != 0).sum())
        mean = float(rc[i].sum(dtype=np.float64)) / nb
        gcs = int(((seq == ord("G")) | (seq == ord("C"))).sum())
        ns = int((seq == ord("N")).sum())
        lines.append(
            f"c{i}\t{int(med[i])}\t{mean:.5f}\t{int(acn[i])}\t"
            f"{gcs / (COLD_LEN - ns):.5f}\t{COLD_LEN}\t{nb}\t{n_inv}\t"
            f"{(n_inv / nb * 100.0 if n_inv else 0.0):.5f}\t{n_nz}\t"
            f"{(n_nz / nb * 100.0 if n_nz else 0.0):.5f}\t"
            f"{(n_nz / (nb - n_inv) * 100.0 if n_nz else 0.0):.5f}")
    if _read(f"{c.output_prefix}-stats.tsv") != "\n".join(lines) + "\n":
        raise AssertionError(f"cold k={k}: stats.tsv differs from numpy's")
    n_win = COLD_CONTIGS * nb
    print(f"cold path k={k}: {COLD_CONTIGS} contigs of {COLD_LEN} bases "
          f"against {table.n_unique} read k-mers, stats equal numpy's; "
          f"assembly counted in {t_count:.4f} s, coverage in {dt:.4f} s = "
          f"{n_win / dt:.1f} windows/s ({smi}); join launches "
          f"sort/merge/compact {launches}")
    return launches


def filter_kmer_path(dev, tmp: str, k: int, table, host):
    """`kat filter kmer -c 5 -d 100` over the main path's table at k
    (tools.filter_kmer.FilterKmer, the table given): the kept .jf, read
    back, and the summary against numpy."""
    import contextlib
    import io

    import torch

    from kat_tpu_torch.tools.filter_kmer import FilterKmer

    f = FilterKmer([])
    f.output_prefix = os.path.join(tmp, f"fk{k}")
    f.quiet = True
    f.input.table = table
    f.input.mer_len, f.input.device = k, dev
    f.low_count, f.high_count = 5, 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        f.filter_table()
    dt = time.perf_counter() - t0
    keys, counts = host
    c = counts.astype(np.int64)
    if k > 31:
        gc = sum(_numpy_gc(np.asarray(w).astype(np.uint64)) for w in keys)
    else:
        gc = _numpy_gc(keys.astype(np.uint64))
    keep = (c >= 5) & (c <= 100) & (gc <= 31)
    if (f.counters["all"] != (c.size, int(c.sum()))
            or f.counters["in"] != (int(keep.sum()), int(c[keep].sum()))):
        raise AssertionError(f"filter kmer k={k}: summary {f.counters}")
    path = f"{f.output_prefix}-in.jf{k}"
    _check_kept_jf(path, keys, counts, keep, k)
    print(f"filter kmer path k={k}: {int(keep.sum())} of {c.size} k-mers "
          f"kept by -c 5 -d 100 in {dt:.4f} s ({os.path.getsize(path)} "
          f"bytes of .jf), equal to numpy's")


def _read_fasta_rows(path: str, length: int) -> np.ndarray:
    """The sequences of a FASTA file of one-line records of `length` bases
    as an ASCII array."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return np.frombuffer(b"".join(lines[1::2]), np.uint8).reshape(-1, length)


def filter_seq_path(dev, tmp: str, k: int, fa: str, reads: np.ndarray,
                    gtable, ghost, smi: str):
    """`kat filter seq --stats -s` of the bucketed phase's FASTA (200,540
    reads of 1024 bases, 2% of them low-complexity) against the k-mers of
    the genome it was drawn from (tools.filter_seq.FilterSeq, the table
    given).  The .stats file's bases and k-mers for every read, and its
    hits for all low-complexity reads and every 64th other one, against
    numpy; the kept and discarded counts against the .stats file's ratios
    and the .in/.out files' records.  Returns the join kernels' launches
    around the filter."""
    import contextlib
    import io

    import torch

    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel
    from kat_tpu_torch.tools.filter_seq import FilterSeq

    f = FilterSeq(fa, None, [])
    f.output_prefix = os.path.join(tmp, f"fs{k}")
    f.quiet, f.do_stats, f.separate = True, True, True
    f.input.table = gtable
    f.input.mer_len, f.input.device = k, dev
    kernels = ((sort_kernel.sort_words_pairs,
                merge_kernel.merge_sorted_words_payload) if k > 31
               else (sort_kernel.sort_pairs,
                     merge_kernel.merge_sorted_payload)) + (
        reduce_kernel.compact_flagged,)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        f.filter_records()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]

    rows = [ln.split("\t") for ln in
            _read(f"{f.output_prefix}.stats").splitlines()[1:]]
    n, length = reads.shape
    nb = length - k + 1  # invalid windows stay in the denominator
    if (len(rows) != n or [int(r[0]) for r in rows] != list(range(n))
            or any(int(r[1]) != length for r in rows)
            or not np.array_equal([int(r[2]) for r in rows],
                                  np.full(n, nb))):
        raise AssertionError(f"filter seq k={k}: .stats index/bases/k-mers")
    hits = np.array([int(r[3]) for r in rows])
    sample = np.unique(np.concatenate([np.arange(0, n, 64),
                                       np.arange(n - n // 51, n)]))
    keys, valid = _numpy_windows_any(reads[sample], k)
    want = (_numpy_counts_of(*ghost, keys, valid) > 0).sum(1)
    if not np.array_equal(hits[sample], want):
        raise AssertionError(f"filter seq k={k}: hits differ from numpy's "
                             "on the sample")
    ratio = hits / nb
    if any(r[4] != f"{x:g}" for r, x in zip(rows, ratio)):
        raise AssertionError(f"filter seq k={k}: .stats ratios")
    kept = int((ratio >= f.threshold).sum())
    n_in = _read(f"{f.output_prefix}.in.fa").count(">")
    n_out = _read(f"{f.output_prefix}.out.fa").count(">")
    if (f.keepers, f.total, n_in, n_out) != (kept, n, kept, n - kept):
        raise AssertionError(f"filter seq k={k}: kept {f.keepers} of "
                             f"{f.total}, files {n_in} + {n_out}, numpy "
                             f"{kept}")
    n_win = n * nb
    print(f"filter seq path k={k}: {n} reads of {length} bases against "
          f"{gtable.n_unique} genome k-mers in {dt:.4f} s = "
          f"{n_win / dt:.1f} windows/s ({smi}); kept {kept}, discarded "
          f"{n - kept}; .stats equal numpy's ({sample.size} reads' hits "
          f"checked); join launches sort/merge/compact {launches}")
    return launches


def big_flush_path(dev, smi: str, n: int = (1 << 30) + (1 << 26),
                   flush: int = 1 << 26) -> None:
    """One narrow count past 2^30 distinct keys: N = 2^30 + 2^26 distinct
    62-bit keys (an affine bijection of 0..N-1, a * i + b mod 2^62 with a
    odd), each fed twice, in flushes of 2^26 keys through
    StreamingCounter; the table must hold n_unique == N, every count 2,
    keys strictly ascending, and the keys' sum (mod 2^64) that of the
    keys fed once.  Each flush past 2^30 merged keys reduces in pieces
    (counting.reduce_stream), where the counter raised TableFullError
    before."""
    import torch

    from kat_tpu_torch.core import counting
    from kat_tpu_torch.ops import reduce_kernel

    a, b, mask = 0x5851F42D4C957F2D, 0x14057B7EF767814F, (1 << 62) - 1
    cap = 1 << (n - 1).bit_length()  # 2^31
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sc = counting.StreamingCounter(initial_capacity=min(flush, cap),
                                   max_capacity=cap, flush_windows=flush,
                                   key_bits=63, device=dev)
    want_sum = torch.zeros((), dtype=torch.int64, device=dev)
    reduce_kernel.reduce_by_key.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for rnd in range(2):
        for start in range(0, n, flush):
            i = torch.arange(start, min(start + flush, n), dtype=torch.int64,
                             device=dev)
            keys = (i * a + b) & mask  # int64 products wrap: mod 2^64
            if rnd == 0:
                want_sum += keys.sum()
            sc.add(keys)
    table = sc.finish()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    nu = table.n_unique
    ok = (nu == n and sc.capacity == cap
          and bool((table.counts[:nu] == 2).all())
          and bool((table.keys[1:nu] > table.keys[:nu - 1]).all())
          and int(table.keys[:nu].sum()) == int(want_sum)
          and bool((table.counts[nu:] == 0).all()))
    launches = reduce_kernel.reduce_by_key.launches
    print(f"big flush: {2 * n} keys ({n} distinct, each twice) in flushes "
          f"of {flush} in {dt:.4f} s ({smi}); table {nu} distinct at "
          f"capacity {sc.capacity}; K3 launches {launches} (pieces of fewer "
          f"than {counting.MAX_STREAM} keys); peak memory {peak} B")
    if not ok:
        raise AssertionError("the table past 2^30 keys is wrong")
    print("big flush: n_unique = N, every count 2, keys ascending, key sum "
          "equal")


def wide_path(dev, k: int, n_batches: int, smi: str):
    """Counting of the main path's reads at k > 31 through
    WideCodeStreamingCounter (the first n_batches of workloads'
    batches), cold and warm, against a reference over the same windows
    that never touches the kernels or the counter: the plain W-word sort
    (chained torch.sort) and reduce.  Returns the W-word kernels' launches
    in the cold run and the table."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import stats
    from kat_tpu_torch.core.kmers import SENTINEL, extract_kmers_wide
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    _genome, batches = workloads.main_path_batches(dev, SEED)
    batches = batches[:n_batches]
    kernels = (sort_kernel.sort_words, merge_kernel.merge_sorted_words,
               reduce_kernel.reduce_by_key_words)

    def run():
        sc = workloads.wide_counter(k, dev)
        for b in batches:
            sc.add_codes(b)
        table = sc.finish()
        hist = stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
        torch.cuda.synchronize()
        return sc.capacity, table, hist

    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    cap, table, hist = run()
    cold = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    t0 = time.perf_counter()
    run()
    warm = time.perf_counter() - t0
    n_windows = n_batches * workloads.MAIN_ROWS * (workloads.MAIN_LENGTH
                                                   - k + 1)
    W = table.n_words
    print(f"wide path k={k} (W={W}): {n_windows} windows, cold {cold:.4f} s "
          f"= {n_windows / cold:.1f} k-mers/s, warm {warm:.4f} s = "
          f"{n_windows / warm:.1f} k-mers/s ({smi}); table "
          f"{table.n_unique} distinct, capacity {cap}; launches "
          f"sort/merge/reduce W-word {launches}")
    if min(launches) < 1:
        raise AssertionError(f"a W-word kernel was not launched: {launches}")

    words = torch.cat([extract_kmers_wide(b, k)[0].reshape(W, -1)
                       for b in batches], dim=1)
    words = sort_kernel.sort_words_plain(words)
    ref_keys, ref_counts, ref_n = reduce_kernel.reduce_by_key_words_plain(
        words, (words[0] != SENTINEL).to(torch.int32), table.capacity)
    del words
    n = table.n_unique
    if n != int(ref_n):
        raise AssertionError(f"n_unique {n} != reference {int(ref_n)}")
    if not (torch.equal(table.keys, ref_keys)
            and torch.equal(table.counts, ref_counts)):
        raise AssertionError(f"the k={k} table differs from the reference")
    if not torch.equal(hist, stats.hist_from_counts(ref_counts, 1, 10001, 1,
                                                    10001)):
        raise AssertionError(f"the k={k} histogram differs from the "
                             "reference")
    print(f"wide path k={k}: table and histogram equal the reference")
    if k == workloads.WIDE_K:
        time_real_flush(batches, k, smi)
    return launches, table


def time_real_flush(batches, k: int, smi: str) -> None:
    """K1 W-word on the fresh windows of the wide path's first flush (its
    batches' canonical windows, SENTINEL where invalid, in arrival order):
    a k-mer's copies and the canonical form's skew, which uniform keys do
    not show; against the LSD sort it replaced (benchmarks/earlier/) and
    the plain sort."""
    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels
    from kat_tpu_torch.core.kmers import extract_kmers_wide, top_bases
    from kat_tpu_torch.ops import sort_kernel

    W = (k + 30) // 31
    # workloads.wide_counter flushes every 2^26 // (windows a batch) batches
    batches = batches[:(1 << 26) // (batches[0].shape[0]
                                      * (batches[0].shape[1] - k + 1))]
    fresh = torch.cat([extract_kmers_wide(b, k)[0].reshape(W, -1)
                       for b in batches], dim=1)
    tb = 2 * top_bases(k) + 1
    reads = sort_kernel.sort_words.host_reads
    got = sort_kernel.sort_words(fresh, tb)
    reads = sort_kernel.sort_words.host_reads - reads
    _max_abs_err(got, sort_kernel.sort_words_plain(fresh))
    _max_abs_err(got, earlier_kernels.sort_words(fresh, tb))
    del got
    ms = _timed_ms(lambda: sort_kernel.sort_words(fresh, tb), 5)
    earlier = _timed_ms(lambda: earlier_kernels.sort_words(fresh, tb), 5)
    print(f"K1 W-word on the k={k} path's first flush ({fresh.shape[1]} "
          f"fresh windows): exact, {ms:.3f} ms (the replaced LSD sort "
          f"{earlier:.3f} ms), {reads} host read(s) a call; "
          + _bucket_stats(fresh, tb)
          + f" ({smi})")


def profile_wide(k: int) -> None:
    """The wide path's device time by kernel: benchmarks/profile_main.py
    in a process of its own (its own torch.profiler window)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m",
                           "kat_tpu_torch.benchmarks.profile_main", "--k",
                           str(k)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"profile_main --k {k} failed:\n{proc.stdout}"
                             f"\n{proc.stderr}")
    for line in proc.stdout.splitlines():
        print(f"wide path profile: {line}")


def bucketed_path(dev, tmp: str, n_reads: int = 196_608,
                  genome_len: int = 1 << 23):
    """The bucketed flush against the classic one on the same FASTA file
    (written into `tmp`), through tools.common.Input; then both over staged
    input.  Returns the launches of the bucketed run, the largest hot
    group's chunks, the FASTA's path, the genome's codes and K5's input in
    the first flush (the key' stream and its chunk length)."""
    import torch

    from kat_tpu_torch.benchmarks.sweep_bucketed import write_reads
    from kat_tpu_torch.core import bucketed, counting, minimizer
    from kat_tpu_torch.io import native
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel
    from kat_tpu_torch.tools.common import Input

    k, length = 27, 1024
    rng = np.random.default_rng(SEED + 3)
    genome = rng.integers(0, 4, genome_len + length, dtype=np.uint8)
    kernels = (sort_kernel.sort_chunks, sort_kernel.merge_runs,
               reduce_kernel.reduce_by_key, merge_kernel.merge_sorted_payload,
               sort_kernel.sort_pairs)
    fa = os.path.join(tmp, "reads.fa")
    n_all = write_reads(fa, genome, n_reads, length, rng)
    n_windows = n_all * (length - k + 1)
    print(f"bucketed path: {n_all} reads of {length} bases, "
          f"{os.path.getsize(fa)} bytes of FASTA, {n_windows} windows")

    def count(flush):
        inp = Input([fa], mer_len=k, device=dev,
                    flush=flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp.count(quiet=True)
        torch.cuda.synchronize()
        return inp, time.perf_counter() - t0

    classic, dt_classic = count("classic")
    for fn in kernels:
        fn.launches = 0
    buck, dt_buck = count("bucketed")
    launches = [fn.launches for fn in kernels]
    st = buck.flush_stats
    n = classic.table.n_unique
    if not (buck.table.n_unique == n
            and torch.equal(buck.table.keys[:n], classic.table.keys[:n])
            and torch.equal(buck.table.counts[:n],
                            classic.table.counts[:n])):
        raise AssertionError("the bucketed table differs from the "
                             "classic one")
    if int(classic.table.counts[:n].sum()) != n_windows \
            or st["windows"] != n_windows:
        raise AssertionError(f"window totals: table "
                             f"{int(classic.table.counts[:n].sum())}, "
                             f"router {st['windows']}, file {n_windows}")
    if min(launches) < 1 or st["groups"] < 1 \
            or launches[1] != st["groups"]:
        raise AssertionError(
            f"bucketed run launched chunk_sort/merge_runs/reduce/"
            f"merge_payload/sort_pairs {launches}; the router reported "
            f"{st['groups']} hot groups")
    fill = st["windows"] / st["slots"]
    print(f"bucketed path: tables equal ({n} distinct); file to table "
          f"classic {dt_classic:.4f} s = {n_windows / dt_classic:.1f} "
          f"k-mers/s, bucketed {dt_buck:.4f} s = "
          f"{n_windows / dt_buck:.1f} k-mers/s; launches chunk_sort/"
          f"merge_runs/reduce/merge_payload/sort_pairs {launches}; "
          f"{st['flushes']} flushes, {st['chunks']} chunks, "
          f"{st['groups'] / st['flushes']:.2f} groups per flush, record "
          f"fill {fill:.4f} of the slots")
    del classic, buck

    # device rates over staged input (the recipe of bench.py:194-292):
    # route with ONE router (timed: the host rate), stage every flush
    rpc, bits = bucketed.geometry(k)
    t0 = time.perf_counter()
    staged = []
    for chunks, groups, _nw in native.route_flushes(
            [fa], k, minimizer.M_DEFAULT, bits, bucketed.MAX_CHUNKS, rpc,
            threads=1):
        staged.append((bucketed.pad_flush(chunks, bucketed.MAX_CHUNKS),
                       groups))
    route_dt = time.perf_counter() - t0
    group_chunks = max(1 << int(lg) for _c, g in staged for _s, lg in g)
    staged = [(torch.from_numpy(c.view(np.int64)).to(dev), g)
              for c, g in staged]
    # K5's input in the first flush, as _sorted_stream hands it over
    rec = staged[0][0]
    k5_real = (minimizer.expand_records(rec, k, minimizer.M_DEFAULT)
               .transpose(0, 1).reshape(-1),
               rec.shape[1] * minimizer.rec_windows(k))
    batches = [torch.from_numpy(b).to(dev)
               for b in native.stream_code_batches([fa], k)]

    def run_bucketed():
        sc = bucketed.BucketedCodeCounter(k, initial_capacity=1 << 24,
                                          device=dev)
        for rec, groups in staged:
            sc.add_flush(rec, groups)
        return sc.finish()

    def run_classic():
        sc = counting.CodeStreamingCounter(
            k, initial_capacity=1 << 24, flush_windows=1 << 26, device=dev)
        for b in batches:
            sc.add_codes(b)
        return sc.finish()

    rates = {}
    for name, fn in (("bucketed", run_bucketed), ("classic", run_classic),
                     ("classic again", run_classic),
                     ("bucketed again", run_bucketed)):
        if "again" not in name:
            fn()  # warm
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        if table.n_unique != n:
            raise AssertionError(f"staged {name}: {table.n_unique} distinct")
        rates[name] = n_windows / best
    print(f"bucketed path, staged input: bucketed "
          f"{rates['bucketed']:.1f} and {rates['bucketed again']:.1f} "
          f"k-mers/s, classic {rates['classic']:.1f} and "
          f"{rates['classic again']:.1f} k-mers/s; router (one thread) "
          f"{n_windows / route_dt:.1f} host windows/s; the largest hot group "
          f"holds {group_chunks} chunks")
    return launches, group_chunks, fa, genome, k5_real


def _numpy_windows(seq: np.ndarray, k: int):
    """(canonical keys u64, valid) per k-window of an ASCII array [.., L],
    with numpy alone."""
    from kat_tpu_torch.core.kmers import canonical_np, encode_ascii

    codes = encode_ascii(seq).astype(np.uint64)
    w = seq.shape[-1] - k + 1
    fwd = np.zeros(seq.shape[:-1] + (w,), np.uint64)
    bad = np.zeros(fwd.shape, bool)
    for j in range(k):
        c = codes[..., j:j + w]
        bad |= c >= 4
        fwd |= (c & np.uint64(3)) << np.uint64(2 * (k - 1 - j))
    return canonical_np(fwd, k), ~bad


def _numpy_hist_text(counts: np.ndarray, k: int, path: str) -> str:
    """The hist artifact for the distinct k-mers' counts."""
    base, ceil = 1, 10001
    nb = ceil + 1 - base
    bucket = np.where(counts < base, 0,
                      np.where(counts > ceil, nb - 1, (counts - base)))
    data = np.bincount(bucket, minlength=nb)
    lines = [f"# Title:{k}-mer spectra for: {os.path.basename(path)}",
             f"# XLabel:{k}-mer frequency", f"# YLabel:# distinct {k}-mers",
             f"# Kmer value:{k}", f"# Input 1:{path}", "###"]
    lines += [f"{base + i} {int(v)}" for i, v in enumerate(data)]
    return "\n".join(lines) + "\n"


def _run_cli(args: list[str], module: str = "kat_tpu_torch"):
    """`python -m <module> <args>` on the card; returns its seconds and its
    standard error."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {args[0]} failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return dt, proc.stderr


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _write_contigs(path: str, genome: np.ndarray, rng) -> list:
    """200 contigs cut from the genome: lengths from below k to above the
    65,536-base row of the window encoder (so some cross its seam), a few
    with Ns; lines wrapped at 80 columns.  sect looks a batch up one
    64-base length bucket at a time, so most contigs share two lengths'
    buckets (as the scaffolds of one size class do) and those lookups are
    large enough for the join; the scattered rest are small lookups."""
    lengths = [5, 26, 27, 28, 64, 65_536, 65_537, 70_000, 140_000]
    lengths += [int(v) for v in rng.integers(4033, 4097, 120)]
    lengths += [int(v) for v in rng.integers(19_969, 20_033, 40)]
    lengths += [int(v) for v in rng.integers(100, 6000, 31)]
    contigs = []
    with open(path, "wb") as f:
        for i, n in enumerate(lengths):
            start = int(rng.integers(0, genome.size - n))
            seq = genome[start:start + n].copy()
            if i % 7 == 3:
                seq[rng.integers(0, n, 1 + n // 2000)] = ord("N")
            contigs.append((f"contig{i}", seq))
            f.write(b">contig%d\n" % i)
            for o in range(0, n, 80):
                f.write(seq[o:o + 80].tobytes() + b"\n")
    return contigs


def _join_share(contigs, k: int, n_keys: int, dev, n_words: int = 1):
    """(buckets, windows in them, all windows) of sect's lookups that the
    join policy takes, for one batch of contigs against a table of n_keys
    distinct keys of n_words words."""
    from kat_tpu_torch.core import tables
    from kat_tpu_torch.io import fastx

    # the capacity tables.compact leaves: the power of two that holds the
    # keys, at least 2^17
    cap = max(1 << 17, 1 << (n_keys - 1).bit_length())
    records = [fastx.Record(name, seq.tobytes(), None)
               for name, seq in contigs]
    n_join = w_join = w_all = 0
    for codes, _meta in fastx.encode_batch_indexed(records, k):
        m = codes.shape[0] * (codes.shape[1] - k + 1)
        w_all += m
        if tables._join_policy(m, cap, dev, n_words):
            n_join += 1
            w_join += m
    return n_join, w_join, w_all


CLI_READ_LEN = 150


def cli_reads(n_reads: int, genome_len: int):
    """The CLI phases' read model: a random genome of genome_len bases and
    n_reads reads of CLI_READ_LEN bases from it, 1% of them with one N.
    Returns (genome letters, reads [n_reads, CLI_READ_LEN] letters, the
    generator after these draws: the contigs come from it next)."""
    rng = np.random.default_rng(SEED + 1)
    genome = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, genome_len)]
    off = rng.integers(0, genome.size - CLI_READ_LEN, n_reads)
    seqs = genome[off[:, None] + np.arange(CLI_READ_LEN)]
    noisy = rng.random(n_reads) < 0.01
    seqs[noisy, rng.integers(0, CLI_READ_LEN, noisy.sum())] = ord("N")
    return genome, seqs, rng


def cli_run(dev, smi: str, n_reads: int = 200_000,
            genome_len: int = 1 << 20):
    """`python -m kat_tpu_torch` end to end on synthetic files: `hist -d`
    and `hist` from the dumped .jf in processes of their own, then `sect`
    through the same entry point inside this process, between a reset and a
    reading of every kernel's launch count; then the other modes and the
    jellyfish utilities.  hist, gcp, comp and cold plot and analyse peaks
    as kat_tpu's do (_check_extras).  Returns sect's six counts and the
    K1/K2/K3 launches of `kat_jellyfish count` in this process."""
    import contextlib
    import io

    from kat_tpu_torch import cli
    from kat_tpu_torch.ops import (merge_kernel, merge_reduce_kernel,
                                   reduce_kernel, sort_kernel)

    from kat_tpu_torch.io import native

    if not native.available():  # build the reader outside the timed run
        raise AssertionError("native FASTX reader did not build")
    k, read_len = 27, CLI_READ_LEN
    genome, seqs, rng = cli_reads(n_reads, genome_len)
    cov = read_model_coverage(n_reads, read_len, genome.size, k)
    libs = {m: (__import__(m).__version__ if _have(m) else "not installed")
            for m in ("matplotlib", "tabulate")}
    print(f"CLI: host libraries of the plots and peak analysis: matplotlib "
          f"{libs['matplotlib']}, tabulate {libs['tabulate']}")
    keys, valid = _numpy_windows(seqs, k)
    n_kmers = int(valid.sum())
    uniq, ucounts = np.unique(keys[valid], return_counts=True)
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        with open(fq, "wb") as f:
            qual = b"I" * read_len
            for i in range(n_reads):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))

        out = os.path.join(tmp, "out.hist")
        dt, err = _run_cli(["hist", "-d", "-m", str(k), "-o", out, fq])
        got = _read(out)
        if got != _numpy_hist_text(ucounts, k, fq):
            raise AssertionError("CLI hist differs from the numpy histogram")
        print(f"CLI: hist -d of {n_reads} x {read_len} bp reads equals "
              f"numpy's; {n_kmers} k-mers file-to-artifact in {dt:.4f} s = "
              f"{n_kmers / dt:.1f} k-mers/s (process start, plots and peak "
              f"analysis included); "
              f"{_check_extras('hist -d', err, coverage=cov, **_hist_extras(out))}")

        jf = f"{out}-hash.jf{k}"
        out2 = os.path.join(tmp, "from_jf.hist")
        dt, err = _run_cli(["hist", "-o", out2, jf])
        if _read(out2).split("###")[1] != got.split("###")[1]:
            raise AssertionError("hist of the dumped .jf differs from the "
                                 "hist of the reads")
        print(f"CLI: hist of the dumped .jf ({os.path.getsize(jf)} bytes, "
              f"{uniq.size} records) equals the first, in {dt:.4f} s; "
              f"{_check_extras('hist of .jf', err, coverage=cov, **_hist_extras(out2))}")

        out3 = os.path.join(tmp, "bucketed.hist")
        run = _cli_in_process(["--flush", "bucketed", "hist", "-m", str(k),
                               "-o", out3, fq], "hist --flush bucketed")
        if _read(out3) != got:
            raise AssertionError("CLI hist --flush bucketed differs from "
                                 "the numpy histogram")
        print("CLI: hist --flush bucketed (in-process) equals numpy's too")
        _extras_line(f"hist -m {k} --flush bucketed", run, _check_extras(
            "hist --flush bucketed", run["err"], coverage=cov,
            **_hist_extras(out3)), smi)

        fa = os.path.join(tmp, "asm.fa")
        contigs = _write_contigs(fa, genome, rng)
        prefix = os.path.join(tmp, "sect")
        kernels = (sort_kernel.sort_keys, merge_kernel.merge_sorted,
                   reduce_kernel.reduce_by_key, sort_kernel.sort_pairs,
                   merge_kernel.merge_sorted_payload,
                   reduce_kernel.compact_flagged,
                   merge_reduce_kernel.merge_reduce)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as banner:
            rc = cli.main(["sect", "-m", str(k), "-o", prefix, fa, fq])
        dt = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        if rc != 0 or "Running KAT in SECT mode" not in banner.getvalue():
            raise AssertionError(f"sect returned {rc}:\n{banner.getvalue()}")
        # a narrow table's lookups take the search (the policy); the reads'
        # flushes take the fused K2 + K3
        n_join, w_join, w_all = _join_share(contigs, k, uniq.size, dev)
        if min(launches[0], launches[6]) < 1 or launches[1] != 0 \
                or launches[3:6] != [n_join] * 3:
            raise AssertionError(
                f"sect launched sort/merge/reduce/sort_pairs/merge_payload/"
                f"compact/merge_reduce {launches}; {n_join} buckets take the "
                "join")
        cvg, stats = [], {}
        for name, seq in contigs:
            cvg.append(f">{name}\n")
            if seq.size < k:
                cvg.append("0\n")
                stats[name] = ("0", "0.00000")
                continue
            ck, cv = _numpy_windows(seq, k)
            pos = np.minimum(np.searchsorted(uniq, ck), uniq.size - 1)
            c = np.where(cv & (uniq[pos] == ck), ucounts[pos], 0)
            cvg.append(" ".join(map(str, c.tolist())) + "\n")
            stats[name] = (str(int(np.sort(c)[c.size // 2])),
                           f"{c.sum() / c.size:.5f}")
        if _read(f"{prefix}-counts.cvg") != "".join(cvg):
            raise AssertionError("sect counts.cvg differs from numpy's")
        rows = [ln.split("\t") for ln in
                _read(f"{prefix}-stats.tsv").splitlines()[1:]]
        if ({r[0]: (r[1], r[2]) for r in rows} != stats
                or len(rows) != len(contigs)):
            raise AssertionError("sect stats.tsv median/mean differ from "
                                 "numpy's")
        if not os.path.getsize(f"{prefix}-contamination.mx"):
            raise AssertionError("sect wrote no contamination matrix")
        cli_gcp_comp(tmp, fq, fa, contigs, genome, uniq, ucounts, k, rng,
                     cov, smi)
        cli_cold_filter(tmp, fq, fa, contigs, stats, (keys, valid),
                        (uniq, ucounts), k, smi)
        jf_launches = jellyfish_cli(tmp, fq, seqs, uniq, ucounts, k, smi)
    n_bases = sum(seq.size for _, seq in contigs)
    print(f"CLI: sect of {len(contigs)} contigs ({n_bases} bases, longest "
          f"{max(s.size for _, s in contigs)}) against the reads equals "
          f"numpy's counts, medians and means, in {dt:.4f} s = "
          f"{n_bases / dt:.1f} bases/s (counting included); launches "
          f"sort/merge/reduce/sort_pairs/merge_payload/compact/merge_reduce "
          f"{launches}; {n_join} buckets with {w_join} of {w_all} windows "
          "took the join")
    return launches, jf_launches


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits per uint64 (SWAR), with numpy alone."""
    u = np.uint64
    x = x - ((x >> u(1)) & u(0x5555555555555555))
    x = (x & u(0x3333333333333333)) + ((x >> u(2)) & u(0x3333333333333333))
    x = (x + (x >> u(4))) & u(0x0F0F0F0F0F0F0F0F)
    return ((x * u(0x0101010101010101)) >> u(56)).astype(np.int64)


def _numpy_gc(word: np.ndarray) -> np.ndarray:
    """G/C bases of 2-bit packed words (C = 01, G = 10: the bits differ)."""
    return _popcount((word ^ (word >> np.uint64(1)))
                     & np.uint64(0x5555555555555555))


def _numpy_gcp(gc: np.ndarray, counts: np.ndarray, k: int,
               cvg_bins: int = 1000) -> np.ndarray:
    """The printed rows (GC 0..k-1) of gcp's matrix at unit scale."""
    cols = np.minimum(counts.astype(np.int64), cvg_bins)
    mx = np.bincount(gc * (cvg_bins + 1) + cols,
                     minlength=(k + 1) * (cvg_bins + 1))
    return mx.reshape(k + 1, cvg_bins + 1)[:k]


def _read_mx(path: str) -> np.ndarray:
    """The matrix rows of a .mx artifact."""
    rows = [ln.split(" ") for ln in _read(path).splitlines()
            if ln and not ln.startswith("#")]
    return np.array(rows, np.int64)


def _read_counters(path: str, three: bool) -> dict:
    """The counters a comp .stats artifact prints, by name."""
    import re

    text = _read(path).split("Distance between")[0]
    vals = [int(v) for v in re.findall(r"^ - [^\n]*?: (\d+)$", text,
                                       re.M)]
    names = ["hash1_total", "hash2_total"] + (["hash3_total"] if three
                                              else [])
    names += ["hash1_distinct", "hash2_distinct"] + (
        ["hash3_distinct"] if three else [])
    names += ["hash1_only_total", "hash2_only_total", "hash1_only_distinct",
              "hash2_only_distinct", "shared_hash1_total",
              "shared_hash2_total", "shared_distinct"]
    if len(vals) != len(names):
        raise AssertionError(f"{path}: {len(vals)} counters, expected "
                             f"{len(names)}")
    return dict(zip(names, vals))


def _check_comp_files(prefix: str, want: dict, three: bool,
                      what: str) -> None:
    """comp's artifacts against _numpy_comp's results."""
    counters = dict(want["counters"])
    if not three:
        del counters["hash3_total"], counters["hash3_distinct"]
    if _read_counters(f"{prefix}.stats", three) != counters:
        raise AssertionError(f"{what}: .stats counters differ from numpy's")
    for name in ("main", "ends", "mixed", "middle") if three else ("main",):
        if not np.array_equal(_read_mx(f"{prefix}-{name}.mx"),
                              want[name].astype(np.int64)):
            raise AssertionError(f"{what}: -{name}.mx differs from numpy's")


def _write_fastq(path: str, seqs: np.ndarray) -> None:
    with open(path, "wb") as f:
        qual = b"I" * seqs.shape[1]
        for i in range(seqs.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))


# The plots and the peak analysis import matplotlib (and, verbose, tabulate)
# inside their functions, as kat_tpu's do.  Where matplotlib is absent the
# CLI prints PLOT_FAILED on stderr for each plot and goes on, and the
# analysis still writes its JSON (its own figures fail inside it): kat_tpu's
# contract for an optional host library, which _check_extras holds the
# port to on this machine.
PLOT_FAILED = "Plotting failed: "
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# The homozygous peak's fitted mean against the read model's k-mer
# coverage: hist and comp report it on the spectrum's list index, one below
# the frequency, gcp on the frequency itself, and the Gaussian fit to
# Poisson counts sits ~0.25 below the mean (CPU, 12,500 reads of a 64 kbp
# genome: 22.42-23.47 against 23.71 at k = 27, 19.71-20.77 against 21.03
# at k = 41).  At ~10x and no error tail the analysis finds no peak at
# all, so both CLI read sets are 200,000 reads (~24x and ~21x).
PEAK_TOLERANCE = 0.10  # of the coverage


def _have(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


def read_model_coverage(n_reads: int, read_len: int, genome_len: int,
                        k: int) -> float:
    """The mean count of a genome k-mer when n_reads reads of read_len
    bases start at uniform offsets in [0, genome_len - read_len)."""
    return n_reads * (read_len - k + 1) / (genome_len - read_len)


def _check_extras(what: str, err: str, plots=(), analyses=(),
                  coverage: float | None = None) -> str:
    """What a mode's default run writes beside its text artifacts, held to
    kat_tpu's behaviour.  plots: the files `_plot` writes; analyses:
    (JSON path, the figure the analysis draws of its fitted peaks, the key
    of the k-mer spectrum's stats or None).  With matplotlib every plot
    and figure is a PNG; without, stderr holds PLOT_FAILED once per plot
    and no figure exists.  Each JSON parses, names a homozygous peak, and
    that peak's mean lies within PEAK_TOLERANCE of coverage.  Returns what
    was found, for the mode's line."""
    mpl = _have("matplotlib")
    if mpl and PLOT_FAILED in err:
        raise AssertionError(f"{what}: a plot failed:\n{err}")
    figures = list(plots) + [fig for _j, fig, _key in analyses]
    for path in figures:
        if mpl:
            with open(path, "rb") as f:
                if f.read(8) != PNG_MAGIC:
                    raise AssertionError(f"{what}: {path} is no PNG")
        elif os.path.exists(path):
            raise AssertionError(f"{what}: {path} without matplotlib")
    if not mpl and err.count(PLOT_FAILED) != len(plots):
        raise AssertionError(f"{what}: {len(plots)} plots without "
                             f"matplotlib, stderr says:\n{err}")
    found = [f"{len(figures)} PNGs" if mpl else
             f"{PLOT_FAILED.strip()} (matplotlib absent) x {len(plots)}"]
    for path, _fig, key in analyses:
        with open(path) as f:
            stats = json.load(f)
        stats = stats[key] if key else stats
        i = stats["hom_peak"]["index"]
        if i < 1:
            raise AssertionError(f"{what}: {path} names no homozygous "
                                 f"peak: {stats}")
        mean = stats["peaks"][i - 1]["mean_freq"]
        if abs(mean - coverage) > PEAK_TOLERANCE * coverage:
            raise AssertionError(f"{what}: homozygous peak at {mean:.3f}x, "
                                 f"the read model's coverage is "
                                 f"{coverage:.3f}x")
        found.append(f"{os.path.basename(path)}: homozygous peak "
                     f"{mean:.3f}x of {stats['nb_peaks']} (read model "
                     f"{coverage:.3f}x, tolerance "
                     f"{PEAK_TOLERANCE * 100:.0f}%)")
    return "; ".join(found)


def _hist_extras(prefix: str) -> dict:
    """hist's plot and analysis files (kat_tpu/cli.py:108-112)."""
    return dict(plots=[f"{prefix}.png"], analyses=[(
        f"{prefix}.dist_analysis.json",
        f"{prefix}.kmerfreq_distributions.png", None)])


def _comp_extras(prefix: str) -> dict:
    """comp's spectra-cn plot and the analysis of its main matrix (the
    default branch of kat_tpu/cli.py:228-249)."""
    return dict(plots=[f"{prefix}-main.mx.spectra-cn.png"], analyses=[(
        f"{prefix}.dist_analysis.json", f"{prefix}.kmerfreq_general.png",
        "main_dist")])


def _cli_in_process(args: list[str], what: str) -> dict:
    """cli.main(args) on the card, its banner and stderr swallowed, its
    plots and peak analysis timed.  Returns the run's seconds (`s`),
    those of its plots and analysis (`extras_s`) and its stderr
    (`err`)."""
    import contextlib
    import io

    from kat_tpu_torch import cli

    spent = [0.0]
    real = {name: getattr(cli, name) for name in ("_plot", "_analyse_peaks")}

    def timed(fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[0] += time.perf_counter() - t
        return run

    for name, fn in real.items():
        setattr(cli, name, timed(fn))
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                contextlib.redirect_stderr(io.StringIO()) as err:
            rc = cli.main(args)
    finally:
        for name, fn in real.items():
            setattr(cli, name, fn)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{what} returned {rc}:\n{out.getvalue()}\n"
                             f"{err.getvalue()}")
    return dict(s=dt, extras_s=spent[0], err=err.getvalue())


def _extras_line(what: str, run: dict, found: str, smi: str) -> None:
    print(f"CLI: {what}: plots and peak analysis took "
          f"{run['extras_s']:.4f} s of the run's {run['s']:.4f} s; {found} "
          f"({smi})")


def cli_cold_filter(tmp, fq, fa, contigs, sect_stats: dict, windows, host,
                    k: int, smi: str) -> None:
    """`cold`, `filter kmer -c 5 -d 100` and `filter seq --stats` of the CLI
    read set and contigs through cli.main, against numpy: cold's read
    median and mean against sect's (held to numpy already) and its copy
    number against the contigs' own k-mer counts; the kept .jf; every
    read's hits against the contigs' k-mers.  windows: (keys, valid) of
    the reads, as _numpy_windows_any gives them; host: the reads' table
    (keys, counts), narrow or as word lists."""
    # the contigs' own k-mers: the assembly hash of cold, the hash that
    # filter seq profiles against
    per = [(_numpy_windows_any(seq[None], k) if seq.size >= k else None)
           for _name, seq in contigs]
    if k > 31:
        words = [np.concatenate([p[0][w][p[1]] for p in per if p])
                 for w in range(len(next(p for p in per if p)[0]))]
        (names,) = _word_ids(words)
        _u, first, ccounts = np.unique(names, return_index=True,
                                       return_counts=True)
        ckeys = [w[first] for w in words]
    else:
        ckeys, ccounts = np.unique(np.concatenate(
            [p[0][p[1]] for p in per if p]), return_counts=True)

    # cold of the contigs whose copy number is 1 or more: kat_tpu's cold
    # plot refuses a copy number of 0 (kat_tpu/plot/cold.py), which a
    # contig shorter than k, or one whose windows mostly hold an N, gets
    want = {}
    for (name, seq), p in zip(contigs, per):
        if p is not None:
            ac = _numpy_counts_of(ckeys, ccounts, p[0], p[1])[0]
            cn = int(np.sort(ac)[ac.size // 2])
            if cn:
                want[name] = (*sect_stats[name], str(cn))
    cp = os.path.join(tmp, f"cold{k}")
    fa_cold = os.path.join(tmp, f"asm_cold{k}.fa")
    with open(fa_cold, "wb") as f:
        for name, seq in contigs:
            if name in want:
                f.write(b">%s\n" % name.encode())
                for o in range(0, seq.size, 80):
                    f.write(seq[o:o + 80].tobytes() + b"\n")
    run = _cli_in_process(["cold", "-m", str(k), "-o", cp, fa_cold, fq],
                          f"cold -m {k}")
    rows = [ln.split("\t") for ln in _read(f"{cp}-stats.tsv").splitlines()[1:]]
    if {r[0]: (r[1], r[2], r[3]) for r in rows} != want \
            or len(rows) != len(want):
        raise AssertionError(f"CLI cold -m {k}: read median/mean or copy "
                             "number differ from numpy's")
    print(f"CLI: cold -m {k} of the {len(want)} contigs of copy number 1 "
          f"or more against the reads equals numpy's in {run['s']:.4f} s "
          f"(counting included; {smi})")
    _extras_line(f"cold -m {k}", run, _check_extras(
        f"cold -m {k}", run["err"], plots=[f"{cp}.png"]), smi)

    fk = os.path.join(tmp, f"fk{k}")
    dt = _cli_in_process(["filter", "kmer", "-m", str(k), "-c", "5", "-d",
                          "100", "-o", fk, fq], f"filter kmer -m {k}")["s"]
    keys, counts = host
    c = np.asarray(counts, np.int64)
    gc = (sum(_numpy_gc(np.asarray(w).astype(np.uint64)) for w in keys)
          if k > 31 else _numpy_gc(np.asarray(keys).astype(np.uint64)))
    keep = (c >= 5) & (c <= 100) & (gc <= 31)
    _check_kept_jf(f"{fk}-in.jf{k}", keys, c, keep, k)
    print(f"CLI: filter kmer -m {k} -c 5 -d 100 kept {int(keep.sum())} of "
          f"{c.size} k-mers, equal to numpy's, in {dt:.4f} s (counting "
          f"included; {smi})")

    fs = os.path.join(tmp, f"fs{k}")
    dt = _cli_in_process(["filter", "seq", "-m", str(k), "--stats", "--seq",
                          fq, "-o", fs, fa], f"filter seq -m {k}")["s"]
    rkeys, rvalid = windows
    hits = (_numpy_counts_of(ckeys, ccounts, rkeys, rvalid) > 0).sum(-1)
    nb = rvalid.shape[-1]
    length = nb + k - 1
    text = "index\tnb_bases\tnb_kmers\tnb_hits\tratio\n" + "".join(
        f"{i}\t{length}\t{nb}\t{h}\t{h / nb:g}\n"
        for i, h in enumerate(hits.tolist()))
    if _read(f"{fs}.stats") != text:
        raise AssertionError(f"CLI filter seq -m {k}: .stats differs from "
                             "numpy's")
    kept = int((hits / nb >= 0.1).sum())
    if _read(f"{fs}.in.fq").count("\n@") + 1 != kept:
        raise AssertionError(f"CLI filter seq -m {k}: .in.fq holds another "
                             f"number of reads than {kept}")
    print(f"CLI: filter seq -m {k} --stats of {hits.size} reads against the "
          f"contigs kept {kept}, equal to numpy's, in {dt:.4f} s (counting "
          f"included; {smi})")


def _check_kept_jf(path: str, keys, counts, keep, k: int) -> None:
    """A kept .jf, read back, holds exactly the kept keys and counts
    (narrow keys sorted, or wide ones as word lists in table order)."""
    from kat_tpu_torch.io import jellyfish

    counts = np.asarray(counts)
    if k > 31:
        _hdr, words, got_c = jellyfish.read_jf_words(path)
        want = np.stack([np.asarray(w, np.int64) for w in keys])[:, keep]
        order = np.lexsort(words[::-1])
        wo = np.lexsort(want[::-1])
        same = (np.array_equal(words[:, order], want[:, wo])
                and np.array_equal(got_c[order].astype(np.int64),
                                   counts[keep][wo].astype(np.int64)))
    else:
        _hdr, got_k, got_c = jellyfish.read_jf(path)
        order = np.argsort(got_k)
        want = np.asarray(keys, np.uint64)[keep]
        same = (np.array_equal(got_k[order], np.sort(want))
                and np.array_equal(got_c[order].astype(np.int64),
                                   counts[keep][np.argsort(want)]
                                   .astype(np.int64)))
    if not same:
        raise AssertionError(f"{path}: the kept k-mers differ from numpy's")



JF_DUMP_LOW = 40  # dump -c -L: the k-mers well past the read coverage


def jellyfish_cli(tmp: str, fq: str, seqs: np.ndarray, uniq: np.ndarray,
                  ucounts: np.ndarray, k: int, smi: str) -> list:
    """`python -m kat_tpu_torch.jf_cli` (the `kat_jellyfish` utilities) on
    the CLI read set, each against numpy (uniq, ucounts: the reads'
    canonical k-mers and counts): `count -m k -C` of all reads in a process
    of its own (the entry point; file to .jf), then in this process
    `count` of each half of the reads, between a reset and a reading of
    K1/K2/K3's and the fused K2 + K3's launch counts, `merge` of the
    halves (the count of all
    reads), `histo` (the histogram of _numpy_hist_text), `stats`, `query`
    of k-mers present (either strand) and absent, and `dump -c -L
    JF_DUMP_LOW` of the merged table.  Returns the halves' launches."""
    import contextlib
    import io

    from kat_tpu_torch import jf_cli
    from kat_tpu_torch.core.kmers import canonical_np, rc_int, unpack_string
    from kat_tpu_torch.io import jellyfish
    from kat_tpu_torch.ops import (merge_kernel, merge_reduce_kernel,
                                   reduce_kernel, sort_kernel)

    def run(args):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = jf_cli.main(args)
        if rc != 0:
            raise AssertionError(f"jf_cli {args[0]} returned {rc}")
        return out.getvalue()

    def same_table(path, what):
        _hdr, keys, counts = jellyfish.read_jf(path)
        if not (np.array_equal(keys, uniq)
                and np.array_equal(counts.astype(np.int64), ucounts)):
            raise AssertionError(f"jf_cli {what}: the .jf holds other keys "
                                 "or counts than numpy's")

    all_jf = os.path.join(tmp, "all.jf")
    dt, _err = _run_cli(["count", "-m", str(k), "-C", "-o", all_jf, fq],
                        module="kat_tpu_torch.jf_cli")
    same_table(all_jf, "count")
    print(f"jf CLI: count -m {k} -C of {seqs.shape[0]} reads equals numpy's "
          f"{uniq.size} keys and counts; file to .jf in {dt:.4f} s (process "
          f"start included; {smi})")

    half = seqs.shape[0] // 2
    fqs = [os.path.join(tmp, f"half{i}.fq") for i in range(2)]
    _write_fastq(fqs[0], seqs[:half])
    _write_fastq(fqs[1], seqs[half:])
    jfs = [os.path.join(tmp, f"half{i}.jf") for i in range(2)]
    kernels = (sort_kernel.sort_keys, merge_kernel.merge_sorted,
               reduce_kernel.reduce_by_key, merge_reduce_kernel.merge_reduce)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for src, dst in zip(fqs, jfs):
        run(["count", "-m", str(k), "-C", "-o", dst, src])
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    if min(launches[0], launches[3]) < 1 or launches[1] != 0:
        raise AssertionError(f"jf_cli count of two halves launched "
                             f"K1/K2/K3/K2 + K3 fused {launches}")
    merged = os.path.join(tmp, "merged.jf")
    run(["merge", "-o", merged, *jfs])
    same_table(merged, "merge of the halves")

    data = _numpy_hist_text(ucounts, k, fq).split("###\n")[1]
    want = "".join(f"{ln}\n" for ln in data.splitlines()
                   if ln.split()[1] != "0")
    if run(["histo", merged]) != want:
        raise AssertionError("jf_cli histo differs from numpy's histogram")
    want = (f"Unique:    {int((ucounts == 1).sum())}\n"
            f"Distinct:  {uniq.size}\nTotal:     {int(ucounts.sum())}\n"
            f"Max_count: {int(ucounts.max())}\n")
    if run(["stats", merged]) != want:
        raise AssertionError("jf_cli stats differ from numpy's")

    rng = np.random.default_rng(SEED + 7)
    present = [int(v) for v in uniq[rng.choice(uniq.size, 24,
                                                replace=False)]]
    present[::2] = [rc_int(v, k) for v in present[::2]]  # either strand
    absent = rng.integers(0, 1 << (2 * k), 24, dtype=np.uint64)
    query = np.array(present, np.uint64).tolist() + absent.tolist()
    canon = canonical_np(np.array(query, np.uint64), k)
    pos = np.minimum(np.searchsorted(uniq, canon), uniq.size - 1)
    hits = np.where(uniq[pos] == canon, ucounts[pos], 0)
    mers = [unpack_string(int(v), k) for v in query]
    want = "".join(f"{m} {int(c)}\n" for m, c in zip(mers, hits))
    if run(["query", merged, *mers]) != want:
        raise AssertionError("jf_cli query differs from numpy's counts")

    high = ucounts >= JF_DUMP_LOW
    want = "".join(f"{unpack_string(int(v), k)} {int(c)}\n"
                   for v, c in zip(uniq[high], ucounts[high]))
    if run(["dump", "-c", "-L", str(JF_DUMP_LOW), merged]) != want:
        raise AssertionError("jf_cli dump -c -L differs from numpy's")
    print(f"jf CLI: count of each half in this process in {dt:.4f} s, "
          f"launches K1/K2/K3/K2 + K3 fused {launches}; merge of the "
          f"halves equals the "
          f"count of all; histo, stats, query of {len(mers)} k-mers "
          f"({int((hits > 0).sum())} present) and dump -c -L {JF_DUMP_LOW} "
          f"({int(high.sum())} k-mers) equal numpy's ({smi})")
    return launches


def _gcp_extras(prefix: str) -> dict:
    """gcp's density plot and the analysis of its matrix
    (kat_tpu/cli.py:150-155)."""
    return dict(plots=[f"{prefix}.mx.png"], analyses=[(
        f"{prefix}.dist_analysis.json",
        f"{prefix}.kmerfreq_distributions.png", "coverage")])


def cli_gcp_comp(tmp, fq, fa, contigs, genome, uniq, ucounts, k, rng,
                 cov: float, smi: str):
    """`gcp` and `comp` (two inputs, three, and of the two .jf that `comp
    -d` dumps) of the CLI read set through cli.main, every artifact against
    numpy, the plots and peak analysis checked (cov: the read model's
    k-mer coverage); the binned-sums kernel's launches read around each
    run."""
    from kat_tpu_torch.ops import binned_kernel

    kernel = binned_kernel.binned_sums
    kernel.launches = 0
    gp = os.path.join(tmp, "gcp")
    run = _cli_in_process(["gcp", "-m", str(k), "-o", gp, fq], "gcp")
    if not np.array_equal(_read_mx(f"{gp}.mx"),
                          _numpy_gcp(_numpy_gc(uniq), ucounts, k)):
        raise AssertionError("CLI gcp differs from numpy's matrix")
    print(f"CLI: gcp of the reads equals numpy's in {run['s']:.4f} s "
          f"(counting included); binned-sums launches {kernel.launches}")
    _extras_line(f"gcp -m {k}", run, _check_extras(
        "gcp", run["err"], coverage=cov, **_gcp_extras(gp)), smi)

    ckeys = np.concatenate([w[v] for w, v in (
        _numpy_windows(seq, k) for _n, seq in contigs if seq.size >= k)])
    k2, c2 = np.unique(ckeys, return_counts=True)
    off = rng.integers(0, genome.size - 150, 60_000)
    fq3 = os.path.join(tmp, "reads3.fq")
    seqs3 = genome[off[:, None] + np.arange(150)]
    _write_fastq(fq3, seqs3)
    w3, v3 = _numpy_windows(seqs3, k)
    k3, c3 = np.unique(w3[v3], return_counts=True)
    for three in (False, True):
        what = "three inputs" if three else "two inputs"
        cp = os.path.join(tmp, f"comp{int(three)}")
        kernel.launches = 0
        run = _cli_in_process(["comp", "-m", str(k), "-o", cp, fq, fa]
                              + ([fq3] if three else ["-d"]),
                              f"comp, {what}")
        launches = kernel.launches
        _check_comp_files(cp, _numpy_comp(uniq, ucounts, k2, c2,
                                          *((k3, c3) if three
                                            else (None, None))),
                          three, f"CLI comp, {what}")
        print(f"CLI: comp of the reads against the contigs, {what}, "
              f"equals numpy's in {run['s']:.4f} s (counting included); "
              f"binned-sums launches {launches}")
        _extras_line(f"comp -m {k}, {what}", run, _check_extras(
            f"comp, {what}", run["err"], coverage=cov, **_comp_extras(cp)),
            smi)
        if launches < 2 + three:
            raise AssertionError(f"comp, {what}: {launches} binned-sums "
                                 "launches")
    cp = os.path.join(tmp, "comp0")
    cj = os.path.join(tmp, "comp_jf")
    run = _cli_in_process(["comp", "-o", cj, f"{cp}-hash1.jf{k}",
                           f"{cp}-hash2.jf{k}"], "comp of two .jf")
    if (_read(f"{cj}-main.mx").split("###")[1]
            != _read(f"{cp}-main.mx").split("###")[1]
            or _read(f"{cj}.stats").split("Total K-mers in")[1]
            != _read(f"{cp}.stats").split("Total K-mers in")[1]):
        raise AssertionError("comp of the dumped .jf differs from comp of "
                             "the reads")
    print(f"CLI: comp of the two dumped .jf equals comp of the files, in "
          f"{run['s']:.4f} s")
    _extras_line("comp of two .jf", run, _check_extras(
        "comp of two .jf", run["err"], coverage=cov, **_comp_extras(cj)),
        smi)


def _numpy_wide_windows(seq: np.ndarray, k: int):
    """(canonical keys as W uint64 word arrays, valid) per k-window of an
    ASCII array [.., L], with numpy alone: k rounds of a shift register
    over the words (the forward key shifts left, the reverse complement
    right), the port's word layout (31 bases a word, the top word the
    rest)."""
    from kat_tpu_torch.core.kmers import encode_ascii, top_bases, words_for_k

    u = np.uint64
    codes = encode_ascii(seq).astype(np.uint64)
    n = seq.shape[-1] - k + 1
    W, top = words_for_k(k), top_bases(k)
    masks = [u((1 << (2 * top)) - 1)] + [u((1 << 62) - 1)] * (W - 1)
    shape = seq.shape[:-1] + (n,)
    fwd = [np.zeros(shape, np.uint64) for _ in range(W)]
    rc = [np.zeros(shape, np.uint64) for _ in range(W)]
    bad = np.zeros(shape, bool)
    for j in range(k):
        c = codes[..., j:j + n]
        bad |= c >= 4
        c = c & u(3)
        for i in range(W):  # carry each word's top base into the next up
            carry = fwd[i + 1] >> u(60) if i + 1 < W else c
            fwd[i] = ((fwd[i] << u(2)) | carry) & masks[i]
        for i in reversed(range(W)):  # and each word's low base down
            carry = (rc[i - 1] & u(3)) << u(60) if i else \
                (u(3) - c) << u(2 * (top - 1))
            rc[i] = (rc[i] >> u(2)) | carry
    less = np.zeros(shape, bool)
    eq = np.ones(shape, bool)
    for f, r in zip(fwd, rc):
        less |= eq & (r < f)
        eq &= r == f
    return [np.where(less, r, f) for f, r in zip(fwd, rc)], ~bad


def wide_cli_run(dev, smi: str, n_reads: int = 200_000,
                 genome_len: int = 1 << 20):
    """`python -m kat_tpu_torch hist -m 41 -d` in a process of its own and
    `hist` of its .jf through cli.main, then `sect -m 41` through cli.main
    inside this process between a reset and a reading of the W-word
    kernels' launch counts; then gcp, comp, cold and filter at k = 41;
    every artifact held against numpy, the plots and peak analysis
    checked (_check_extras).  Returns those counts."""
    import contextlib
    import io

    from kat_tpu_torch import cli
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k, read_len = 41, 150
    rng = np.random.default_rng(SEED + 4)
    genome = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, genome_len)]
    cov = read_model_coverage(n_reads, read_len, genome.size, k)
    off = rng.integers(0, genome.size - read_len, n_reads)
    seqs = genome[off[:, None] + np.arange(read_len)]
    noisy = rng.random(n_reads) < 0.01
    seqs[noisy, rng.integers(0, read_len, noisy.sum())] = ord("N")
    words, valid = _numpy_wide_windows(seqs, k)
    flat = [w[valid] for w in words]
    order = np.lexsort(flat[::-1])
    flat = [w[order] for w in flat]
    new = np.zeros(order.size, bool)
    new[:1] = True
    for w in flat:
        new[1:] |= w[1:] != w[:-1]
    starts = np.flatnonzero(new)
    ucounts = np.diff(np.append(starts, order.size))
    table = dict(zip(zip(*[w[starts].tolist() for w in flat]),
                     ucounts.tolist()))
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        with open(fq, "wb") as f:
            qual = b"I" * read_len
            for i in range(n_reads):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))
        out = os.path.join(tmp, "out.hist")
        dt, err = _run_cli(["hist", "-d", "-m", str(k), "-o", out, fq])
        got = _read(out)
        if got != _numpy_hist_text(ucounts, k, fq):
            raise AssertionError("CLI hist -m 41 differs from numpy's")
        print(f"wide CLI: hist -d -m {k} of {n_reads} x {read_len} bp reads "
              f"equals numpy's; {int(valid.sum())} k-mers file-to-artifact "
              f"in {dt:.4f} s (process start, plots and peak analysis "
              f"included); "
              f"{_check_extras('hist -d -m 41', err, coverage=cov, **_hist_extras(out))}")
        jf = f"{out}-hash.jf{k}"
        out2 = os.path.join(tmp, "from_jf.hist")
        run = _cli_in_process(["hist", "-o", out2, jf], "hist of the k=41 .jf")
        if _read(out2).split("###")[1] != got.split("###")[1]:
            raise AssertionError("hist of the dumped k=41 .jf differs")
        print(f"wide CLI: hist of the dumped .jf ({os.path.getsize(jf)} "
              f"bytes, {len(table)} records) equals the first, in "
              f"{run['s']:.4f} s (in-process)")
        _extras_line(f"hist of the k={k} .jf", run, _check_extras(
            "hist of the k=41 .jf", run["err"], coverage=cov,
            **_hist_extras(out2)), smi)

        fa = os.path.join(tmp, "asm.fa")
        contigs = _write_contigs(fa, genome, rng)
        prefix = os.path.join(tmp, "sect")
        kernels = (sort_kernel.sort_words, merge_kernel.merge_sorted_words,
                   reduce_kernel.reduce_by_key_words,
                   sort_kernel.sort_words_pairs,
                   merge_kernel.merge_sorted_words_payload,
                   reduce_kernel.compact_flagged)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as banner:
            rc = cli.main(["sect", "-m", str(k), "-o", prefix, fa, fq])
        dt = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        # the wide lookups of the large length buckets take the wide join
        n_join, w_join, w_all = _join_share(contigs, k, len(table), dev, 2)
        if rc != 0 or min(launches[:3]) < 1 \
                or launches[3:] != [n_join] * 3 or n_join < 1:
            raise AssertionError(f"sect -m {k} returned {rc}, launched "
                                 f"W-word sort/merge/reduce/sort_pairs/"
                                 f"merge_payload/compact {launches}; "
                                 f"{n_join} buckets take the join:\n"
                                 f"{banner.getvalue()}")
        if w_join < 0.9 * w_all:
            raise AssertionError(f"only {w_join} of {w_all} windows are in "
                                 "buckets that take the wide join")
        cvg, stats = [], {}
        for name, seq in contigs:
            cvg.append(f">{name}\n")
            if seq.size < k:
                cvg.append("0\n")
                stats[name] = ("0", "0.00000")
                continue
            cw, cv = _numpy_wide_windows(seq, k)
            c = np.array([table.get(key, 0) if ok else 0 for key, ok in zip(
                zip(*[w.tolist() for w in cw]), cv.tolist())], np.int64)
            cvg.append(" ".join(map(str, c.tolist())) + "\n")
            stats[name] = (str(int(np.sort(c)[c.size // 2])),
                           f"{c.sum() / c.size:.5f}")
        if _read(f"{prefix}-counts.cvg") != "".join(cvg):
            raise AssertionError("sect -m 41 counts.cvg differs from numpy's")
        rows = [ln.split("\t") for ln in
                _read(f"{prefix}-stats.tsv").splitlines()[1:]]
        if ({r[0]: (r[1], r[2]) for r in rows} != stats
                or len(rows) != len(contigs)):
            raise AssertionError("sect -m 41 stats.tsv differs from numpy's")
        wide_cli_gcp_comp(tmp, fq, fa, contigs, table, k, cov, smi)
        host = (list(np.array(list(table)).T),
                np.array(list(table.values()), np.int64))
        cli_cold_filter(tmp, fq, fa, contigs, stats, (words, valid), host, k,
                        smi)
    print(f"wide CLI: sect -m {k} of {len(contigs)} contigs equals numpy's "
          f"counts, medians and means, in {dt:.4f} s (counting included); "
          f"launches W-word sort/merge/reduce/sort_pairs/merge_payload/"
          f"compact {launches}; {n_join} buckets with {w_join} of {w_all} "
          "windows took the wide join")
    return launches


def wide_cli_gcp_comp(tmp, fq, fa, contigs, table: dict, k: int, cov: float,
                      smi: str):
    """`gcp -m 41` and `comp -m 41` of the reads against the contigs through
    cli.main, against numpy over the k-mers as word tuples (`table`: the
    reads' counts by key); their plots and peak analysis checked (cov:
    the read model's k-mer coverage)."""
    from kat_tpu_torch.ops import binned_kernel

    kernel = binned_kernel.binned_sums
    keys = list(table)
    counts = np.array([table[t] for t in keys], np.int64)
    gc = sum(_numpy_gc(np.array(w, np.uint64)) for w in zip(*keys))
    kernel.launches = 0
    gp = os.path.join(tmp, "gcp")
    run = _cli_in_process(["gcp", "-m", str(k), "-o", gp, fq], "gcp -m 41")
    if not np.array_equal(_read_mx(f"{gp}.mx"), _numpy_gcp(gc, counts, k)):
        raise AssertionError("CLI gcp -m 41 differs from numpy's matrix")
    print(f"wide CLI: gcp -m {k} equals numpy's in {run['s']:.4f} s "
          f"(counting included); binned-sums launches {kernel.launches}")
    _extras_line(f"gcp -m {k}", run, _check_extras(
        "gcp -m 41", run["err"], coverage=cov, **_gcp_extras(gp)), smi)

    cont = {}
    for _name, seq in contigs:
        if seq.size < k:
            continue
        cw, cv = _numpy_wide_windows(seq, k)
        for key, ok in zip(zip(*[w.tolist() for w in cw]), cv.tolist()):
            if ok:
                cont[key] = cont.get(key, 0) + 1
    ids: dict = {}  # a key tuple's integer name: one order for both tables

    def side(d):
        kid = np.array([ids.setdefault(t, len(ids)) for t in d], np.int64)
        c = np.array(list(d.values()), np.int64)
        order = np.argsort(kid)
        return kid[order], c[order]

    want = _numpy_comp(*side(table), *side(cont))
    cp = os.path.join(tmp, "comp")
    kernel.launches = 0
    run = _cli_in_process(["comp", "-m", str(k), "-o", cp, fq, fa],
                          "comp -m 41")
    _check_comp_files(cp, want, False, "CLI comp -m 41")
    print(f"wide CLI: comp -m {k} of the reads against the contigs equals "
          f"numpy's in {run['s']:.4f} s (counting included); binned-sums "
          f"launches {kernel.launches}")
    _extras_line(f"comp -m {k}", run, _check_extras(
        "comp -m 41", run["err"], coverage=cov, **_comp_extras(cp)), smi)
    if kernel.launches < 2:
        raise AssertionError("comp -m 41 did not run the binned-sums kernel")


# -- the sharded phases: parallel/sharded.py, analysis.py, longseq.py --------

# a kernel entry's name -> the wrapper whose launches it counts
SHARDED_WRAPPER = dict(
    radix_sort="sort_keys", radix_sort_words="sort_words",
    merge_runs="merge_runs", merge_runs_words="merge_runs_words",
    merge_path="merge_sorted", merge_path_words="merge_sorted_words",
    merge_path_payload="merge_sorted_payload",
    reduce_by_key="reduce_by_key", reduce_by_key_words="reduce_by_key_words",
    compact_flagged="compact_flagged", radix_sort_pairs="sort_pairs",
    binned_sums="binned_sums")

def _kernel_fns():
    """Every kernel wrapper of the sharded paths, by name."""
    from kat_tpu_torch.ops import (binned_kernel, merge_kernel,
                                   reduce_kernel, sort_kernel)

    return dict(
        sort_keys=sort_kernel.sort_keys, sort_words=sort_kernel.sort_words,
        merge_runs=sort_kernel.merge_runs,
        merge_runs_words=sort_kernel.merge_runs_words,
        merge_sorted=merge_kernel.merge_sorted,
        merge_sorted_words=merge_kernel.merge_sorted_words,
        merge_sorted_payload=merge_kernel.merge_sorted_payload,
        reduce_by_key=reduce_kernel.reduce_by_key,
        reduce_by_key_words=reduce_kernel.reduce_by_key_words,
        compact_flagged=reduce_kernel.compact_flagged,
        sort_pairs=sort_kernel.sort_pairs,
        binned_sums=binned_kernel.binned_sums)


def _zero_launches() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_launches(what: str, need: tuple) -> dict:
    """Every wrapper's count since _zero_launches; raises if a kernel in
    `need` was launched no time."""
    got = {name: fn.launches for name, fn in _kernel_fns().items()}
    missing = [name for name in need if got[name] < 1]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({got})")
    return {name: n for name, n in got.items() if n}


def _touch_ms(n_real: int, n: int, n_words: int) -> float:
    """K6's second bound: the bytes its design must touch, the real keys
    read once and every output slot written once, at the memory rate."""
    from kat_tpu_torch.benchmarks.workloads import HBM_BYTES_PER_S

    return 8 * n_words * (n_real + n) / HBM_BYTES_PER_S * 1e3


def check_merge_runs(dev, gen):
    """K6, one-word and over W words, against its plain version and the
    tree of pairwise merges it replaced (benchmarks/earlier/, timed beside
    it), at the sharded flush's arrival shapes: 8 runs of 2^22 slots, each
    a quarter of sorted real keys then SENTINEL (one shard's arrivals in
    the main path's flush on 8 shards: k = 27, one word; k = 41, W = 2),
    five runs with equal outputs; then at a scaled arrival shape (8 runs
    of 2^18 slots, 3/4 SENTINEL) at the boundary k of every W = 2..9, and
    on workloads.RUNS_WORDS_STRAIN there.  Each entry has two bounds:
    every input byte read and every output byte written once (bound_ms),
    and what the design must touch, the real keys read and every output
    written (touch_bound_ms).  Returns the two entries, their (entry,
    call) pairs, and a call at the bucketed flush's largest group shape
    (128 chunk runs of 2^14 keys, 30% SENTINEL) for the profiled
    window."""
    import math

    import torch

    from kat_tpu_torch.benchmarks import earlier_kernels, workloads
    from kat_tpu_torch.core import bucketed
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import sort_kernel

    rl, R = workloads.SHARDED_ROUTE_CAP, workloads.SHARDED_RUNS
    results, counted = [], []
    for k, fn, plain, tree in (
            (27, sort_kernel.merge_runs, sort_kernel.merge_runs_plain,
             earlier_kernels.merge_runs),
            (41, sort_kernel.merge_runs_words,
             sort_kernel.merge_runs_words_plain,
             earlier_kernels.merge_runs_words)):
        keys = workloads.sharded_runs(k, dev, gen)
        W, n = (keys.shape[0] if keys.dim() == 2 else 1), keys.shape[-1]
        got = fn(keys, rl)
        err = max(_max_abs_err(got, plain(keys, rl)),
                  _max_abs_err(got, tree(keys, rl)))
        _repeat_equal(f"K6 (W={W})", lambda fn=fn, keys=keys: (
            fn(keys, rl),))
        plain_ms = _timed_ms(lambda plain=plain, keys=keys: plain(keys, rl),
                             3)
        n_real = R * workloads.sharded_run_real(k)
        entry = _report(dict(
            name="merge_runs[sharded]" if W == 1 else "merge_runs_words",
            route="cuda", source="kat_tpu_torch/csrc/merge_runs.cu",
            replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
            ms=_timed_ms(lambda fn=fn, keys=keys: fn(keys, rl), 5),
            earlier_ms=_timed_ms(lambda tree=tree, keys=keys: tree(keys, rl),
                                 5),
            plain_ms=plain_ms,
            # W word compares per key and level of a binary merge tree
            **_bound(_nbytes(keys, got), n * W * int(math.log2(R))),
            touch_bound_ms=_touch_ms(n_real, n, W), real_keys=n_real,
            passes=len(sort_kernel.merge_passes(n, rl)),
            tile=sort_kernel.merge_runs_tile(W),
            # torch.sort computes the one-word merge; no one PyTorch call
            # merges W-word runs
            library_ms=plain_ms if W == 1 else None),
            f"K6 merge of {R} runs of 2^22 slots, {n_real} real keys, "
            f"k={k} (W={W})")
        print(f"  the tree it replaced: {entry['earlier_ms']:.3f} ms; the "
              f"real keys' bound {entry['touch_bound_ms']:.3f} ms")
        results.append(entry)
        counted.append((entry, lambda fn=fn, keys=keys: fn(keys, rl)))
        del got

    errs = []
    for k in workloads.WIDE_STRAIN_K:
        keys = workloads.sharded_runs(k, dev, gen, run_len=1 << 18,
                                      real=1 << 16)
        errs.append(_max_abs_err(
            sort_kernel.merge_runs_words(keys, 1 << 18),
            sort_kernel.merge_runs_words_plain(keys, 1 << 18)))
        for name in workloads.RUNS_WORDS_STRAIN:
            keys, run_len = workloads.runs_words_strain(name, k, dev, gen)
            errs.append(_max_abs_err(
                sort_kernel.merge_runs_words(keys, run_len),
                sort_kernel.merge_runs_words_plain(keys, run_len)))
    torch.cuda.synchronize()
    print(f"K6 W-word: equal to its plain version on {len(errs)} inputs: 8 "
          "runs of 2^18 slots, 3/4 SENTINEL, and the strain inputs, at "
          "W = 2..9")

    chunk = 1 << bucketed.SLOTS_LOG
    group = torch.randint(0, 1 << 60, (128 * chunk,), dtype=torch.int64,
                          device=dev, generator=gen)
    group[torch.rand(group.numel(), device=dev, generator=gen) < 0.3] = \
        SENTINEL
    group = sort_kernel.sort_chunks_plain(group, chunk)
    return results, counted, lambda: sort_kernel.merge_runs(group, chunk)


def _check_shards(sc, table, what: str) -> None:
    """A sharded count against the one-device table, on the card: shard s
    holds exactly the table's keys that the owner hash gives it, with
    their counts, a SENTINEL tail after them; finish() merges the shards
    back into the table."""
    import torch

    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.parallel import sharded

    n = table.n_unique
    keys, counts = table.keys[..., :n], table.counts[:n]
    owner = sharded.owner_shard(keys, sc.k, sc.n)
    for s, t in enumerate(sc.tables):
        mine = owner == s
        nu = t.n_unique
        if not (nu == int(mine.sum())
                and torch.equal(t.keys[..., :nu], keys[..., mine])
                and torch.equal(t.counts[:nu], counts[mine])
                and bool((t.keys[..., nu:] == SENTINEL).all())):
            raise AssertionError(f"{what}: shard {s} differs from the "
                                 "one-device table")
    merged = sc.finish()
    if not (merged.n_unique == n and torch.equal(merged.keys[..., :n], keys)
            and torch.equal(merged.counts[:n], counts)):
        raise AssertionError(f"{what}: finish() differs from the one-device "
                             "table")


def _count_timed(counter, batches, end: str):
    """(what counter.<end>() returns, seconds) of counting `batches`."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        counter.add_codes(b)
    out = getattr(counter, end)()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_path(dev, smi: str, table, genome) -> dict:
    """The mesh-sharded paths on the card, all shards on it: the main
    path's 48 batches at k = 27 counted on meshes of 8 and 1 shards and 24
    of them at k = 41 on 8, each shard against the one-device table and
    finish() against it, with the one-device rate of the same batches in
    this call; hist, gcp and comp (two and three inputs) over the shards
    against the one-device results; the lookup path's 2^23 windows through
    routed lookups against the one-table counts.  Each run's launches are
    read between a reset and its end.  Returns them by run."""
    import torch

    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import coverage, stats, tables
    from kat_tpu_torch.parallel import analysis, sharded
    from kat_tpu_torch.tools.comp import Comp

    k = workloads.MAIN_K
    _g, batches = workloads.main_path_batches(dev, SEED)
    del _g
    per_batch = workloads.MAIN_ROWS * (workloads.MAIN_LENGTH - k + 1)
    mesh8, mesh1 = sharded.make_mesh(8), sharded.make_mesh(1)
    if mesh8.devices != (dev,) * 8:
        raise AssertionError(f"make_mesh(8) placed {mesh8.devices}")
    warm = workloads.sharded_counter(k, mesh8)  # touch every launch shape
    for b in batches[:2]:
        warm.add_codes(b)
    warm.check()
    del warm
    launches = {}

    one, dt_one = _count_timed(workloads.main_path_counter(dev), batches,
                               "finish")
    del one
    rate_one = len(batches) * per_batch / dt_one
    print(f"sharded path: the one-device count of the same {len(batches)} "
          f"batches in {dt_one:.4f} s = {rate_one:.1f} k-mers/s ({smi})")
    counters = {}
    for mesh in (mesh8, mesh1):
        sc = workloads.sharded_counter(k, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_launches()
        _none, dt = _count_timed(sc, batches, "check")
        what = f"sharded count k={k} on {mesh.n} shards"
        launches[what] = _read_launches(what, (
            "sort_keys", "merge_runs", "merge_sorted", "reduce_by_key"))
        peak = torch.cuda.max_memory_allocated(dev)
        _check_shards(sc, table, what)
        rate = len(batches) * per_batch / dt
        print(f"{what}: {len(batches) * per_batch} windows in {dt:.4f} s = "
              f"{rate:.1f} k-mers/s, {rate / rate_one:.4f} x the one-device "
              f"rate; shard capacity {sc.shard_capacity}, route slack "
              f"{sc.route_slack}, n_unique per shard "
              f"{sc.n_unique.tolist()}; peak memory {peak} B; launches "
              f"{launches[what]}; each shard and finish() equal the "
              f"one-device table ({smi})")
        counters[mesh.n] = sc
    del counters[1]
    sc8 = counters.pop(8)

    # hist, gcp and comp over the shards of the mesh of 8
    _zero_launches()
    t0 = time.perf_counter()
    h = analysis.hist_sharded(sc8, 1, 10001, 1, 10001)
    g = analysis.gcp_sharded(sc8, k, 1000)
    dt = time.perf_counter() - t0
    launches["hist and gcp on 8 shards"] = _read_launches(
        "hist and gcp on 8 shards", ("binned_sums",))
    want_h = stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
    want_g = stats.gcp_matrix(table, k, 1000)
    if not (np.array_equal(h, want_h.cpu().numpy().astype(np.uint64))
            and np.array_equal(g, want_g.cpu().numpy().astype(np.uint64))):
        raise AssertionError("hist or gcp over the shards differs from the "
                             "one-device table's")
    print(f"sharded hist and gcp: equal to the one-device table's, "
          f"{dt:.4f} s for both over 8 shards")
    asm = workloads.contig_rows(genome, k)
    one2 = workloads.main_path_counter(dev)
    one2.add_codes(asm)
    t2 = one2.finish()
    third = workloads.read_draw(genome, SEED + 5,
                                workloads.COMP_THIRD_BATCHES)
    one3 = workloads.main_path_counter(dev)
    for b in third:
        one3.add_codes(b)
    t3 = one3.finish()
    c2, c3 = (workloads.sharded_counter(k, mesh8) for _ in range(2))
    c2.add_codes(asm)
    for b in third:
        c3.add_codes(b)
    c2.check()
    c3.check()
    del one2, one3
    for three in (False, True):
        what = f"sharded comp, {'three' if three else 'two'} inputs"
        comps = []
        for on_mesh in (True, False):
            c = Comp([], [])
            c.quiet = True
            c.set_mer_len(k)
            if three:
                c.set_third_input([])
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if on_mesh:
                for inp, sc in zip(c.inputs, (sc8, c2, c3)):
                    inp.shards = sc
                c._compare_sharded()
            else:
                c.compare_tables(table, t2, t3 if three else None)
            torch.cuda.synchronize()
            comps.append((c, time.perf_counter() - t0))
            if on_mesh:  # the dual probe per shard: K2 payload, K4
                launches[what] = _read_launches(what, (
                    "binned_sums", "merge_sorted_payload",
                    "compact_flagged"))
        (cs, dts), (c1, dt1) = comps
        got = [cs.counters, cs.main_mx.data, cs.spectrum1, cs.spectrum2,
               cs.shared_spectrum1, cs.shared_spectrum2]
        want = [c1.counters, c1.main_mx.data, c1.spectrum1, c1.spectrum2,
                c1.shared_spectrum1, c1.shared_spectrum2]
        if three:
            got += [cs.ends_mx.data, cs.mixed_mx.data, cs.middle_mx.data]
            want += [c1.ends_mx.data, c1.mixed_mx.data, c1.middle_mx.data]
        if not (got[0] == want[0] and all(
                np.array_equal(a, b) for a, b in zip(got[1:], want[1:]))):
            raise AssertionError(f"{what} differs from the one-device comp")
        print(f"{what}: equal to the one-device comp; {dts:.4f} s over 8 "
              f"shards, {dt1:.4f} s on one table (cold); launches "
              f"{launches[what]}")
    del c2, c3, t2, t3, asm, third

    # routed lookups: the lookup path's windows against the shards
    codes = _lookup_codes(dev, genome, k, 128, 1 << 16, SEED + 2)
    svc = analysis.ShardedLookup(sc8)
    analysis.window_counts_routed(svc, codes[:2], k, True)  # warm
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = analysis.window_counts_routed(svc, codes, k, True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["routed lookups"] = _read_launches("routed lookups", ())
    compact = tables.compact(table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = coverage.window_counts(compact, codes, k, True)
    torch.cuda.synchronize()
    dt1 = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("routed window counts differ from the "
                             "one-table window counts")
    m = codes.shape[0] * (codes.shape[1] - k + 1)
    print(f"sharded lookups: {m} windows routed to 8 shards in {dt:.4f} s "
          f"= {m / dt:.1f} windows/s (the host plan included), one table "
          f"{dt1:.4f} s; equal")
    del svc, sc8, got, want, compact

    # k = 41 on the mesh of 8: 24 batches, K6 over W words
    wb = batches[:24]
    one41, dt_one = _count_timed(workloads.wide_counter(41, dev), wb,
                                 "finish")
    sc = workloads.sharded_counter(41, mesh8)
    _zero_launches()
    _none, dt = _count_timed(sc, wb, "check")
    what = "sharded count k=41 on 8 shards"
    launches[what] = _read_launches(what, (
        "sort_words", "merge_runs_words", "merge_sorted_words",
        "reduce_by_key_words"))
    _check_shards(sc, one41, what)
    n41 = len(wb) * workloads.MAIN_ROWS * (workloads.MAIN_LENGTH - 40)
    print(f"{what}: {n41} windows in {dt:.4f} s = {n41 / dt:.1f} k-mers/s, "
          f"{dt_one / dt:.4f} x the one-device rate ({dt_one:.4f} s); "
          f"launches {launches[what]}; each shard and finish() equal the "
          f"one-device table ({smi})")
    return launches


def sharded_sect(dev, smi: str, genome) -> dict:
    """`sect --shards 8` of the main genome as one 8,389,632-base contig
    (three Ns in it) against 100,000 reads of 150 bases from it, through
    cli.main: the contig takes the halo path (routed lookups), its
    artifacts must equal the one-device sect's byte for byte.  Returns the
    sharded run's launches."""
    import contextlib
    import io

    from kat_tpu_torch import cli
    from kat_tpu_torch.parallel import longseq

    rng = np.random.default_rng(SEED + 7)
    letters = np.frombuffer(b"ACGT", np.uint8)[genome.cpu().numpy()]
    contig = letters.copy()
    contig[rng.integers(0, contig.size, 3)] = ord("N")
    n_reads, read_len = 100_000, 150
    off = rng.integers(0, letters.size - read_len, n_reads)
    with tempfile.TemporaryDirectory() as tmp:
        fa, fq = os.path.join(tmp, "genome.fa"), os.path.join(tmp, "r.fq")
        with open(fa, "wb") as f:
            f.write(b">genome\n")
            for o in range(0, contig.size, 80):
                f.write(contig[o:o + 80].tobytes() + b"\n")
        with open(fq, "wb") as f:
            qual = b"I" * read_len
            for i, o in enumerate(off):
                f.write(b"@r%d\n%s\n+\n%s\n" % (
                    i, letters[o:o + read_len].tobytes(), qual))
        halo = []
        real = longseq.sharded_window_profile_routed
        longseq.sharded_window_profile_routed = \
            lambda *a: halo.append(1) or real(*a)
        times = {}
        try:
            for shards in (["--shards", "8"], []):
                _zero_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = cli.main([*shards, "sect", "-o",
                                   os.path.join(tmp, f"s{len(shards)}"), fa,
                                   fq])
                times[len(shards)] = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"sect {shards} returned {rc}")
                if shards:
                    launches = _read_launches("sect --shards 8", (
                        "sort_keys", "merge_runs", "merge_sorted",
                        "reduce_by_key"))
        finally:
            longseq.sharded_window_profile_routed = real
        if halo != [1]:
            raise AssertionError(f"the halo path ran {len(halo)} times")
        for suffix in ("-counts.cvg", "-stats.tsv", "-contamination.mx"):
            with open(os.path.join(tmp, f"s2{suffix}"), "rb") as a, \
                    open(os.path.join(tmp, f"s0{suffix}"), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"sect --shards 8 {suffix} differs "
                                         "from the one-device sect's")
    print(f"sharded sect: one {contig.size}-base contig on the halo path "
          f"(8 spans, routed lookups) against {n_reads} reads in "
          f"{times[2]:.4f} s, one device {times[0]:.4f} s (counting and "
          f"writing included); artifacts byte-identical; launches "
          f"{launches} ({smi})")
    return launches


# -- two processes on one card: parallel/distributed.py -------------------

# (name, the mode's arguments, k): {reads} is the shard:// group, {fa} the
# contigs; every process and the one-process reference run each in turn
TWO_PROC_MODES = (
    ("hist27", ["hist", "-m", "27", "{reads}"], 27),
    ("hist41", ["hist", "-m", "41", "{reads}"], 41),
    ("comp27", ["comp", "-m", "27", "{reads}", "{fa}"], 27),
    ("sect27", ["sect", "-m", "27", "{fa}", "{reads}"], 27),
)
# the counting flush's kernels by k: K1, K6, K2, K3
FLUSH_KERNELS = {
    27: ("sort_keys", "merge_runs", "merge_sorted", "reduce_by_key"),
    41: ("sort_words", "merge_runs_words", "merge_sorted_words",
         "reduce_by_key_words")}
TWO_PROC_SPLIT = (120_000, 80_000)  # reads of r1.fq and r2.fq
WORKER_TIMEOUT = 600  # seconds a worker may take, start to end


def _mode_args(args: list[str], out: str, reads: str, fa: str) -> list[str]:
    """A mode's arguments with `-o out` after the mode's name."""
    filled = [a.format(reads=reads, fa=fa) for a in args]
    return [filled[0], "-o", out, *filled[1:]]


def _artifacts(d: str) -> dict:
    """{file name: bytes} of every file in d."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def two_process_worker(rank: int, tmp: str, device: str) -> int:
    """One of two processes of one gloo group on the card: init_distributed
    over a file:// store in tmp, then every mode of TWO_PROC_MODES through
    cli.main on the shard:// group (its artifacts into tmp/p<rank>), the
    counting flush's K1, K6, K2 and K3 launches read around each, then the
    reads counted once more through Input and saved by
    save_sharded_counter (tmp/ckpt; process 0 also writes the live finished
    table to tmp/live.npz).  Writes tmp/worker<rank>.json."""
    import torch

    sys.path.insert(0, ROOT)
    from kat_tpu_torch.io import checkpoint
    from kat_tpu_torch.parallel import distributed
    from kat_tpu_torch.tools.common import Input, glob_files

    started = time.time()
    backend = distributed.init_distributed(
        f"file://{tmp}/store", 2, rank,
        device="cpu" if device == "cpu" else None)
    if backend != "gloo":
        raise AssertionError(f"two processes on one card took {backend}")
    ready = time.time()
    reads, fa = f"shard://{tmp}/r{{1,2}}.fq", os.path.join(tmp, "asm.fa")
    out_dir = os.path.join(tmp, f"p{rank}")
    os.makedirs(out_dir)
    pre = ["--device", "cpu"] if device == "cpu" else []
    runs = {}
    for name, args, k in TWO_PROC_MODES:
        _zero_launches()
        run = _cli_in_process(
            pre + _mode_args(args, os.path.join(out_dir, name), reads, fa),
            f"process {rank}: {name}")
        runs[name] = dict(s=run["s"], launches=_read_launches(
            f"process {rank}: {name}", FLUSH_KERNELS[k]))
    t0 = time.perf_counter()
    inp = Input(paths=glob_files(reads), mer_len=27,
                device=torch.device(device if device == "cpu" else "cuda:0"))
    inp.validate()
    inp.count(quiet=True)
    checkpoint.save_sharded_counter(os.path.join(tmp, "ckpt"), inp.shards)
    live = inp.shards.finish()
    if rank == 0:
        n = live.n_unique
        np.savez(os.path.join(tmp, "live.npz"),
                 keys=live.keys[:n].cpu().numpy(),
                 counts=live.counts[:n].cpu().numpy())
    distributed.barrier()
    with open(os.path.join(tmp, f"worker{rank}.json"), "w") as f:
        json.dump(dict(started=started, ready=ready, runs=runs,
                       checkpoint_s=time.perf_counter() - t0,
                       shards=[inp.shards.mesh.first,
                               inp.shards.mesh.n_local, inp.shards.n],
                       ended=time.time()), f)
    distributed.shutdown()
    return 0


def _run_workers(tmp: str, device: str) -> list[dict]:
    """Both workers, started together; each must end with code 0 within
    WORKER_TIMEOUT seconds, or both are killed and this raises with the
    failing worker's log."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--two-process-worker", str(r), tmp, device], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + WORKER_TIMEOUT
    bad = None
    try:
        while any(p.poll() is None for p in procs):
            bad = next((r for r, p in enumerate(procs)
                        if p.poll() not in (None, 0)), None)
            if bad is not None or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            why = ("failed" if bad == r or p.returncode > 0 else
                   f"did not end within {WORKER_TIMEOUT} s")
            raise AssertionError(f"two-process worker {r} {why} "
                                 f"({p.returncode}):\n{texts[r][-6000:]}")
    out = []
    for r in range(2):
        with open(os.path.join(tmp, f"worker{r}.json")) as f:
            out.append(json.load(f))
    return out


def refused_checkpoint(dev, tmp: str) -> None:
    """A checkpoint at k = 33 whose manifest says `key_words` 4 (what
    older kat_tpu wrote at 32 < k <= 47; k = 33 needs 3), its 3 keys of 4
    words each: every loader must refuse it with a ValueError that names
    key_words before it reads a shard, tables on `dev`."""
    from kat_tpu_torch.io import checkpoint
    from kat_tpu_torch.parallel.sharded import make_mesh

    path = os.path.join(tmp, "ckpt_k33_w4")
    os.makedirs(path)
    np.savez_compressed(os.path.join(path, "shard_00000.npz"),
                        keys=np.arange(12, dtype=np.uint32).reshape(3, 4),
                        counts=np.ones(3, np.uint32))
    with open(os.path.join(path, checkpoint.MANIFEST), "w") as f:
        json.dump({"format": checkpoint.FORMAT, "version": checkpoint.VERSION,
                   "k": 33, "canonical": True, "n_shards": 1,
                   "shard_hash": checkpoint.SHARD_HASH_ID, "key_words": 4,
                   "n_unique": 3, "total": 3}, f)
    for name, load in (
            ("load_table", lambda: checkpoint.load_table(path, device=dev)),
            ("load_sharded_counter", lambda: checkpoint.load_sharded_counter(
                path, make_mesh(1, devices=[dev]))),
            ("load_shard", lambda: checkpoint.load_shard(path, 0))):
        try:
            load()
        except ValueError as e:
            if "key_words" not in str(e):
                raise AssertionError(f"{name}: {e}") from e
            print(f"checkpoint: {name} refused a 4-word manifest at k = 33 "
                  f"on {dev}: {e}")
        else:
            raise AssertionError(f"{name} loaded a 4-word manifest at k = 33")


def two_process_path(dev, smi: str, n_reads: int = 200_000,
                     genome_len: int = 1 << 20) -> dict:
    """Two processes on the one card, one shard each on it, over gloo (they
    share the card): the CLI phases' reads as a shard:// group of two
    FASTQs of 120,000 and 80,000 reads (the slices are uneven), `hist -m
    27`, `hist -m 41`, `comp -m 27` (reads against the contigs) and `sect
    -m 27` through cli.main in each (two_process_worker).  Every artifact
    of each process must equal, byte for byte, one process's `--shards 2`
    run of the same mode on the card; each process's counting flushes must
    launch K1, K6, K2 and K3.  The checkpoint the two processes saved is
    loaded in this process on a mesh of 2 shards and must equal the live
    table, and a checkpoint whose key_words disagrees with its k must be
    refused (refused_checkpoint).  Then verify_kernels and
    verify_kernels_wide on the card.
    Returns each run's launches, by run."""
    import torch

    from kat_tpu_torch.io import checkpoint
    from kat_tpu_torch.ops import verify
    from kat_tpu_torch.parallel.sharded import make_mesh

    device = dev.type
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    genome, seqs, rng = cli_reads(n_reads, genome_len)
    split = [n_reads * p // sum(TWO_PROC_SPLIT) for p in TWO_PROC_SPLIT]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        _write_fastq(os.path.join(tmp, "r1.fq"), seqs[:split[0]])
        _write_fastq(os.path.join(tmp, "r2.fq"), seqs[split[0]:])
        fa = os.path.join(tmp, "asm.fa")
        _write_contigs(fa, genome, rng)
        t0 = time.time()
        workers = _run_workers(tmp, device)
        two_s = time.time() - t0
        start_s = max(w["ready"] for w in workers) - t0
        print(f"two processes: both workers ran in {two_s:.4f} s, "
              f"{start_s:.4f} s of it to start (interpreter, torch, the "
              f"card and the gloo group; {start_s / two_s:.1%}) ({smi})")
        if sorted(tuple(w["shards"]) for w in workers) != [(0, 1, 2),
                                                           (1, 1, 2)]:
            raise AssertionError(f"shards: {[w['shards'] for w in workers]}")
        reads = f"shard://{tmp}/r{{1,2}}.fq"
        one_dir = os.path.join(tmp, "one")
        os.makedirs(one_dir)
        pre = ["--device", "cpu"] if device == "cpu" else []
        for name, args, k in TWO_PROC_MODES:
            _zero_launches()
            run = _cli_in_process(
                pre + ["--shards", "2"]
                + _mode_args(args, os.path.join(one_dir, name), reads, fa),
                f"one process --shards 2 {name}")
            launches[f"one process --shards 2 {name}"] = _read_launches(
                name, FLUSH_KERNELS[k])
            for r, w in enumerate(workers):
                launches[f"2 processes {name} (process {r})"] = \
                    w["runs"][name]["launches"]
            print(f"two processes: {name}: "
                  + ", ".join(f"process {r} {w['runs'][name]['s']:.4f} s"
                              for r, w in enumerate(workers))
                  + f"; one process --shards 2 {run['s']:.4f} s ({smi})")
        want = {n: b for n, b in _artifacts(one_dir).items()}
        for r in range(2):
            got = _artifacts(os.path.join(tmp, f"p{r}"))
            if set(got) != set(want):
                raise AssertionError(f"process {r} wrote {sorted(got)}, one "
                                     f"process {sorted(want)}")
            for n, b in want.items():
                if got[n] != b:
                    raise AssertionError(f"process {r}'s {n} differs from "
                                         "one process's --shards 2")
        print(f"two processes: {len(want)} artifacts of each process equal "
              f"one process's --shards 2, byte for byte: "
              f"{', '.join(sorted(want))}")
        t1 = time.perf_counter()
        sc = checkpoint.load_sharded_counter(
            os.path.join(tmp, "ckpt"),
            make_mesh(2, devices=[dev]))
        got = sc.finish()
        live = np.load(os.path.join(tmp, "live.npz"))
        n = got.n_unique
        if (n != live["counts"].size
                or not np.array_equal(got.keys[:n].cpu().numpy(),
                                      live["keys"])
                or not np.array_equal(got.counts[:n].cpu().numpy(),
                                      live["counts"])):
            raise AssertionError("the two processes' checkpoint, loaded on "
                                 "2 shards, differs from their live table")
        print(f"two processes: the checkpoint of their counter "
              f"(save_sharded_counter, {n} k-mers) loaded on a mesh of 2 "
              f"shards equals the live table; saved in "
              f"{max(w['checkpoint_s'] for w in workers):.4f} s (counting "
              f"included), loaded and finished in "
              f"{time.perf_counter() - t1:.4f} s ({smi})")
        refused_checkpoint(dev, tmp)
    t2 = time.perf_counter()
    v = verify.verify_kernels(device=dev)
    vw = [verify.verify_kernels_wide(n_words=w, device=dev)
          for w in (4, 8, 16)]
    for res in (v, *vw):
        if {res[c] for c in ("sort", "merge", "reduce")} != {"PASS"}:
            raise AssertionError(f"kernel attestation failed: {res}")
    print(f"verify_kernels {v}; verify_kernels_wide "
          f"{[{c: r[c] for c in ('n_words', 'sort', 'merge', 'reduce')} for r in vw]} "
          f"in {time.perf_counter() - t2:.4f} s ({smi})")
    return launches


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--two-process-worker"]:
        return two_process_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kat_tpu_torch.benchmarks import workloads
    from kat_tpu_torch.core import counting
    from kat_tpu_torch.core import wide as wide_mod
    from kat_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    _cuda.LIBRARY.get()
    print(f"kernels built by nvcc for sm_90a in "
          f"{_cuda.LIBRARY.build_seconds:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def lap(what: str) -> None:
        print(f"chip_smoke: {what} done at "
              f"{time.perf_counter() - t_start:.1f} s")

    extract, extract_counted = check_extract_kernel(dev, gen)
    kernels, counted, fused = check_kernels(dev, gen)
    counted.append(extract_counted)
    wide, wide_counted = check_wide_kernels(dev, gen)
    binned, binned_counted = check_binned_kernels(dev, gen)
    dual, dual_counted = check_dual_probe_kernels(dev, gen)
    wjoin, wjoin_counted = check_wide_join_kernels(dev, gen)
    k6s, k6_counted, k6_group_call = check_merge_runs(dev, gen)
    k6_group = dict(name="merge_runs[128 runs]")
    late = later_rows_inside(dev, gen)
    count_inside(counted + wide_counted + binned_counted + dual_counted
                 + wjoin_counted + k6_counted + [(k6_group, k6_group_call)]
                 + late)
    late_inside = {e["name"]: e for e, _fn in late}
    del counted, wide_counted, binned_counted, dual_counted, wjoin_counted
    del k6_counted, k6_group_call, late
    lap("the kernel checks")
    check_matrix_format(dev, smi)
    (launches, extract["launches"], fused[0]["launches"], table, genome,
     ref_keys, ref_counts) = main_path(dev)
    binned[0]["launches"] = launches.pop()  # hist_from_counts
    launches += lookup_path(dev, table, genome, ref_keys, ref_counts)
    binned[1]["launches"] = gcp_path(dev, table, ref_keys, ref_counts)
    host27 = (ref_keys.cpu().numpy().astype(np.uint64),
              ref_counts.cpu().numpy())
    del ref_keys, ref_counts
    comp = comp_path(dev, table, genome, smi)
    packed = check_packed_sums(dev, comp.pop("packed"))
    for entry in binned[2:]:
        entry["launches"] = comp["three inputs"][0]
    for entry, n in zip(dual, comp["two inputs"][1:], strict=True):
        entry["launches"] = n
    for entry, n in zip(kernels, launches, strict=True):
        entry["launches"] = n
    lap("the main, lookup, gcp and comp paths")
    sharded = sharded_path(dev, smi, table, genome)
    sharded["sect --shards 8"] = sharded_sect(dev, smi, genome)
    k6s[0]["launches"] = sharded["sharded count k=27 on 8 shards"][
        "merge_runs"]
    k6s[1]["launches"] = sharded["sharded count k=41 on 8 shards"][
        "merge_runs_words"]
    lap("the sharded paths")
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "asm.fa")
        asm = write_cold_contigs(fa, genome)
        cold27 = cold_path(dev, tmp, 27, table, host27, fa, asm, smi)
        filter_kmer_path(dev, tmp, 27, table, host27)
        del table, host27
        lap("cold and filter kmer at k=27")
        w41, wtable = wide_path(dev, 41, 48, smi)
        w95, _t95 = wide_path(dev, 95, 8, smi)
        del _t95
        lap("the wide paths")
        for entry, n, n95 in zip(wide, w41, w95, strict=True):
            entry["launches"], entry["launches_k95"] = n, n95
        words, wcounts = wide_mod.table_words_to_numpy(wtable)
        host41 = (list(words), wcounts)
        del words
        wl = wide_lookup_path(dev, wtable, genome)
        cold41 = cold_path(dev, tmp, 41, wtable, host41, fa, asm, smi)
        filter_kmer_path(dev, tmp, 41, wtable, host41)
        wcomp = wide_comp_path(dev, wtable, genome, smi)
        del wtable, host41, asm, genome
        lap("the wide lookup, cold, filter kmer and comp at k=41")
    # the wide join's forms: launches of the wide lookup path; then of
    # cold -m 41 and comp -m 41
    wjoin[0]["launches"], wjoin[1]["launches"] = wl[0], wl[1]
    wjoin[0]["launches_cold"], wjoin[1]["launches_cold"] = cold41[:2]
    wjoin[2]["launches"] = wcomp[1]
    kernels[5]["launches_wide"] = wl[2]
    kernels[5]["launches_cold"] = [cold27[2], cold41[2]]
    profile_wide(41)
    lap("the k=41 profile")
    sect_launches, jf_launches = cli_run(dev, smi)
    for entry, n in zip([*kernels, fused[0]], sect_launches, strict=True):
        entry["launches_sect"] = n
    for entry, n in zip([*kernels[:3], fused[0]], jf_launches, strict=True):
        entry["launches_jf_count"] = n
    wide_sect = wide_cli_run(dev, smi)
    for entry, n in zip(wide, wide_sect[:3], strict=True):
        entry["launches_sect"] = n
    wjoin[0]["launches_sect"], wjoin[1]["launches_sect"] = wide_sect[3:5]
    kernels += wide
    lap("the CLI phases")

    with tempfile.TemporaryDirectory() as tmp:
        b_launches, group_chunks, fa, bgenome, k5_real = bucketed_path(
            dev, tmp)
        reads = _read_fasta_rows(fa, 1024)
        codes = torch.from_numpy(bgenome).to(dev)
        del bgenome
        fs = {}
        for k in (27, 41):
            sc = (workloads.wide_counter(k, dev) if k > 31 else
                  counting.CodeStreamingCounter(
                      k, initial_capacity=1 << 20, flush_windows=1 << 26,
                      device=dev))
            sc.add_codes(workloads.contig_rows(codes, k))
            gt = sc.finish()
            del sc
            if k > 31:
                words, gcounts = wide_mod.table_words_to_numpy(gt)
                ghost = (list(words), gcounts)
            else:
                ghost = counting.table_to_numpy(gt)
            fs[k] = filter_seq_path(dev, tmp, k, fa, reads, gt, ghost, smi)
            del gt, ghost
        del reads, codes
    lap("the bucketed and filter seq paths")
    wjoin[0]["launches_filter_seq"], wjoin[1]["launches_filter_seq"] = \
        fs[41][:2]
    kernels[3]["launches_filter_seq"] = fs[27][0]
    k5, k5r, k6 = check_bucketed_kernels(dev, gen, group_chunks, k5_real)
    del k5_real
    k5["launches"] = k5r["launches"] = b_launches[0]
    k6["launches"] = b_launches[1]
    # the kernels inside one call, counted in the one profiled window on
    # inputs of the same shapes
    for entry in (*packed, k5, k5r):
        on = late_inside[entry["name"].split("[real")[0]]
        for key in ("requests", "shape"):
            if key in on and on[key] != entry[key]:
                raise AssertionError(f"{entry['name']}: its launches inside "
                                     f"one call were counted at {key} "
                                     f"{on[key]}, its call has {entry[key]}")
        entry["launches_inside"] = on["launches_inside"]
    # the inside count at 128 runs, the largest group the path reports
    k6["launches_inside"] = k6_group["launches_inside"]
    # K3, K2 with payload planes and K1 with a value also carry this path
    for i, n in ((2, b_launches[2]), (4, b_launches[3]), (3, b_launches[4])):
        kernels[i]["launches_bucketed"] = n
    kernels += [k5, k5r, k6, check_rounds_kernel(dev), *binned, *packed,
                *dual, *wjoin, *k6s, extract, *fused]
    lap("K5, K6 and K7")
    sharded.update(two_process_path(dev, smi))
    lap("the two-process phase")
    for entry in kernels:  # the sharded and two-process runs' launches
        fn = SHARDED_WRAPPER.get(entry["name"].split("[")[0])
        runs = {run: n[fn] for run, n in sharded.items() if n.get(fn)}
        if runs:
            entry["launches_sharded"] = runs
    route_sweep(dev, smi)
    big_flush_path(dev, smi)

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s ({smi}); the lap was "
          f"{EARLIER_LAP_S} s before the K2 library timings and the "
          "refused checkpoint")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
