#!/usr/bin/env python3
"""Drive kat_tpu_torch once on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   kat_tpu_torch/csrc and prints the build time;
2. checks each kernel (K1 sort, K2 merge, K3 reduce of the counting path;
   K4 compact, K1 with a value and K2 with payload planes of the lookup
   path; K5 chunk sort and K6 run merge of the bucketed flush; K7's round
   classes) against its plain PyTorch version on the card at its path's
   shapes, exactly (integer keys and counts: tolerance 0), with its time,
   the plain version's, its bound and, where one PyTorch call computes the
   same function, that call's time;
3. drives the counting path at bench.py's scale: k=27 canonical reads
   from an 8.4 Mbp random genome, 48 batches of 4096 x 1024 codes (196M
   windows, 3 flushes of 2^26 windows), table grown from 2^20 to 2^24
   slots; the table and histogram must equal torch.unique over the same
   windows, and each counting kernel must have been launched by that run;
4. drives the lookup path at full width against that table: the k=27
   windows of the same genome, 128 rows of 65,562 codes (2^23 windows,
   1% of bases substituted, a few invalid), through
   coverage.window_counts; the counts must come from the sort-merge join,
   equal the binary-search route and a reference built from torch.unique's
   table, and each lookup kernel must have been launched by that run;
5. runs `python -m kat_tpu_torch` on synthetic files: `hist -d` (held
   against numpy) and `hist` from the dumped .jf (same histogram);
6. runs `sect` of 200 contigs against those reads through the command
   line's entry point (kat_tpu_torch.cli.main) inside this process, so
   that the tool's own launches can be read: the six counts are set to 0
   just before and read just after, every kernel must have been launched,
   the lookup kernels once per length bucket that the join policy takes,
   and those buckets must hold most of the windows; the artifacts are held
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
   flush's shape and K6 at the largest hot group that run saw, and runs
   K7's microbenchmark, whose costliest class is also held against its
   plain version at the full round count.

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
TOLERANCE = 0  # exact: keys and counts are integers
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
ALU_OPS_PER_S = 67e12      # H100 SXM, published float32 rate outside the
#                            tensor cores: the stand-in for integer
#                            compares and adds, which have no published rate


def _timed_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def _report(entry: dict, what: str) -> dict:
    lib = entry["library_ms"]
    print(f"{what}: exact, kernel {entry['ms']:.3f} ms, plain "
          f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.3f} ms by "
          f"{entry['bound_by']}, library "
          + (f"{lib:.3f} ms" if lib is not None else "none"))
    return entry


def check_kernels(dev, gen):
    """Every kernel against its plain version: K1-K3 at the flush's shapes
    here, the lookup path's three in check_lookup_kernels."""
    import math

    import torch

    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    n_fresh, cap = 1 << 26, 1 << 24
    results = []

    # K1: 2^26 random 54-bit keys, 10% sentinels
    keys = torch.randint(0, 1 << 54, (n_fresh,), dtype=torch.int64,
                         device=dev, generator=gen)
    keys[torch.rand(n_fresh, device=dev, generator=gen) < 0.1] = SENTINEL
    got = sort_kernel.sort_keys(keys, 55)
    err = _max_abs_err(got, sort_kernel.sort_keys_plain(keys))
    results.append(_report(dict(
        name="radix_sort", route="cuda", source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_keys(keys, 55), 5),
        plain_ms=_timed_ms(lambda: sort_kernel.sort_keys_plain(keys), 5),
        **_bound(_nbytes(keys, got), n_fresh * int(math.log2(n_fresh))),
        library_ms=_timed_ms(lambda: torch.sort(keys), 5)),
        "K1 sort 2^26 keys"))
    del keys, got

    # K2: a 2^24-slot table (~2^23 real keys) with 2^26 sorted fresh keys
    # drawn from a 1.5 x 2^23 key universe (10% sentinels)
    universe = torch.randint(0, 1 << 54, (3 << 22,), dtype=torch.int64,
                             device=dev, generator=gen)
    real = torch.unique(universe[:1 << 23])
    t_keys = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
    t_keys[:real.numel()] = real
    t_counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    t_counts[:real.numel()] = torch.randint(
        1, 100, (real.numel(),), dtype=torch.int32, device=dev,
        generator=gen)
    pick = torch.randint(0, universe.numel(), (n_fresh,), device=dev,
                         generator=gen)
    fresh = universe[pick]
    fresh[torch.rand(n_fresh, device=dev, generator=gen) < 0.1] = SENTINEL
    fresh = sort_kernel.sort_keys_plain(fresh)
    mk, mw = merge_kernel.merge_sorted(t_keys, t_counts, fresh)
    pk, pw = merge_kernel.merge_sorted_plain(t_keys, t_counts, fresh)
    err = max(_max_abs_err(mk, pk), _max_abs_err(mw, pw))
    del pk, pw
    results.append(_report(dict(
        name="merge_path", route="cuda", source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted(
            t_keys, t_counts, fresh), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_plain(
            t_keys, t_counts, fresh), 3),
        **_bound(_nbytes(t_keys, t_counts, fresh, mk, mw), mk.numel()),
        library_ms=None), "K2 merge 2^24 table + 2^26 fresh"))

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
    results.append(_report(dict(
        name="reduce_by_key", route="cuda",
        source="kat_tpu_torch/csrc/reduce.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:147", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.reduce_by_key(mk, mw, cap), 5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.reduce_by_key_plain(mk, mw, cap), 3),
        **_bound(_nbytes(mk, mw) + cap * 12, 2 * mk.numel()),
        library_ms=None), f"K3 reduce {mk.numel()} -> 2^24"))
    del mk, mw, fresh, universe, pick
    return results + check_lookup_kernels(dev, gen, t_keys, t_counts)


def check_lookup_kernels(dev, gen, t_keys, t_counts):
    """K4 and the payload forms of K1 and K2 against their plain versions
    at the shapes of a 2^23-query join against a 2^24-slot table."""
    import math

    import torch

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
    got = sort_kernel.sort_pairs(q, idx, 55)
    err = _same(got, sort_kernel.sort_pairs_plain(q, idx))
    results.append(_report(dict(
        name="radix_sort_pairs", route="cuda",
        source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_pairs(q, idx, 55), 5),
        plain_ms=_timed_ms(lambda: sort_kernel.sort_pairs_plain(q, idx), 5),
        **_bound(_nbytes(q, idx, *got), m * int(math.log2(m))),
        # the values are positions, so the stable sort's indices ARE them
        library_ms=_timed_ms(lambda: torch.sort(q, stable=True), 5)),
        "K1 sort 2^23 (key, value) pairs"))
    sq, sidx = got
    del q, got

    # K2 with a payload: the table carrying -1 and the sorted queries
    # their positions, as the join merges them
    a_planes = (torch.full((cap,), -1, dtype=torch.int32, device=dev),)
    b_planes = (sidx,)
    mk, mp = merge_kernel.merge_sorted_payload(t_keys, a_planes, sq, b_planes)
    pk, pp = merge_kernel.merge_sorted_payload_plain(t_keys, a_planes, sq,
                                                     b_planes)
    err = _same((mk, *mp), (pk, *pp))
    del pk, pp
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
        library_ms=None), "K2 merge 2^24 table + 2^23 queries, 1 plane"))

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
    results.append(_report(dict(
        name="compact_flagged", route="cuda",
        source="kat_tpu_torch/csrc/compact.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:285", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.compact_flagged(mp, flag, m), 5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.compact_flagged_plain(mp, flag, m), 5),
        **_bound(_nbytes(*mp, flag) + 2 * m * 4, n),
        # one call per plane: masked_select takes one tensor
        library_ms=_timed_ms(
            lambda: [torch.masked_select(p, flag) for p in mp], 5)),
        f"K4 compact {n} x 2 planes -> 2^23"))
    return results


def check_bucketed_kernels(dev, gen, group_chunks: int):
    """K5 and K6 against their plain versions at the bucketed flush's
    shapes: one flush of MAX_CHUNKS chunks of 2^SLOTS_LOG key' slots, and
    one hot group of `group_chunks` chunk runs, the largest group the
    router reported to the bucketed path."""
    import math

    import torch

    from kat_tpu_torch.core import bucketed
    from kat_tpu_torch.core.kmers import SENTINEL
    from kat_tpu_torch.ops import sort_kernel

    chunk = 1 << bucketed.SLOTS_LOG
    n = bucketed.MAX_CHUNKS * chunk
    results = []

    # K5: 60-bit key' (k=27), 30% empty slots, as a flush's record fill
    keys = torch.randint(0, 1 << 60, (n,), dtype=torch.int64, device=dev,
                         generator=gen)
    keys[torch.rand(n, device=dev, generator=gen) < 0.3] = SENTINEL
    got = sort_kernel.sort_chunks(keys, chunk)
    err = _max_abs_err(got, sort_kernel.sort_chunks_plain(keys, chunk))
    plain_ms = _timed_ms(lambda: sort_kernel.sort_chunks_plain(keys, chunk), 3)
    results.append(_report(dict(
        name="chunk_sort", route="cuda",
        source="kat_tpu_torch/csrc/chunk_sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_chunks(keys, chunk), 5),
        plain_ms=plain_ms,
        **_bound(_nbytes(keys, got), n * int(math.log2(chunk))),
        # the plain version IS the one library call (a row-wise sort)
        library_ms=plain_ms),
        f"K5 chunk sort {bucketed.MAX_CHUNKS} x 2^{bucketed.SLOTS_LOG} keys"))

    # K6: the path's largest hot group of chunk runs out of that stream
    # (compared and timed), and a pair of runs (compared)
    errs = []
    for g in (2, group_chunks):
        runs = got[:g * chunk].clone()
        merged = sort_kernel.merge_runs(runs, chunk)
        errs.append(_max_abs_err(merged,
                                 sort_kernel.merge_runs_plain(runs, chunk)))
    plain_ms = _timed_ms(lambda: sort_kernel.merge_runs_plain(runs, chunk), 5)
    results.append(_report(dict(
        name="merge_runs", route="cuda",
        source="kat_tpu_torch/csrc/merge_runs.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=max(errs),
        ms=_timed_ms(lambda: sort_kernel.merge_runs(runs, chunk), 5),
        plain_ms=plain_ms,
        # one compare per key and level of the merge tree
        **_bound(_nbytes(runs, merged),
                 runs.numel() * max(1, math.ceil(math.log2(group_chunks)))),
        library_ms=plain_ms),  # torch.sort: no library call merges runs
        f"K6 merge {group_chunks} runs of 2^{bucketed.SLOTS_LOG} keys"))
    return results


def check_rounds_kernel(dev):
    """K7: every round class against its plain version at a few rounds
    (inside profile_rounds.run), then the costliest class against its plain
    version at the full round count, both timed there."""
    import torch

    from kat_tpu_torch.benchmarks import profile_rounds as pr

    pr.profile_rounds.launches = 0
    res = pr.run()
    launches = pr.profile_rounds.launches
    print("K7 rounds: " + json.dumps(res))
    n, rounds, mode = res["n"], res["rounds"], "smem-1024"
    keys = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64,
                         device=dev)
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
        library_ms=None, launches=launches),
        f"K7 {rounds} {mode} rounds on 2^24 keys")
    return entry


def main_path(dev):
    """Counting at bench.py's scale through CodeStreamingCounter."""
    import torch

    from kat_tpu_torch.core import counting, stats
    from kat_tpu_torch.core.kmers import SENTINEL, extract_kmers
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k, rows, length, n_batches = 27, 4096, 1024, 48
    genome_len = 1 << 23
    rng = np.random.default_rng(SEED)
    genome = torch.from_numpy(
        rng.integers(0, 4, genome_len + length, dtype=np.uint8)).to(dev)
    reads = genome.unfold(0, length, 1)  # [genome_len + 1, length] view
    offsets = torch.from_numpy(
        rng.integers(0, genome_len, (n_batches, rows))).to(dev)
    batches = [reads[offsets[i]] for i in range(n_batches)]  # on the card

    warm = counting.CodeStreamingCounter(k, device=dev, flush_batches=2)
    for b in batches[:2]:
        warm.add_codes(b)
    warm.finish()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    kernels = (sort_kernel.sort_keys, merge_kernel.merge_sorted,
               reduce_kernel.reduce_by_key)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    sc = counting.CodeStreamingCounter(
        k, canonical=True, initial_capacity=1 << 20,
        flush_windows=1 << 26, device=dev)
    for b in batches:
        sc.add_codes(b)
    table = sc.finish()
    hist = stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    peak = torch.cuda.max_memory_allocated(dev)

    n_windows = n_batches * rows * (length - k + 1)
    print(f"main path: {n_windows} windows k={k} in {dt:.4f} s = "
          f"{n_windows / dt:.1f} k-mers/s; table {table.n_unique} distinct, "
          f"capacity {sc.capacity}; launches sort/merge/reduce {launches}; "
          f"peak memory {peak} B")
    if min(launches) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if sc.capacity != 1 << 24:
        raise AssertionError(f"capacity {sc.capacity}, expected 2^24")

    # reference: torch.unique over the same windows
    allk = torch.cat([extract_kmers(b, k)[0].reshape(-1) for b in batches])
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
    return launches, table, genome, ref_keys, ref_counts


def lookup_path(dev, table, genome, ref_keys, ref_counts):
    """The k=27 windows of the counted genome looked up in the table
    main_path built, through coverage.window_counts."""
    import torch

    from kat_tpu_torch.core import coverage, tables
    from kat_tpu_torch.core.kmers import canonicalize, extract_kmers
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    k, rows, row_w = 27, 128, 1 << 16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    codes = genome.unfold(0, row_w + k - 1, row_w)[:rows].clone()
    sub = torch.rand(codes.shape, device=dev, generator=gen) < 0.01
    codes[sub] = (codes[sub] + 1 + (torch.rand(int(sub.sum()), device=dev,
                  generator=gen) * 3).to(torch.uint8)) & 3
    codes[torch.rand(codes.shape, device=dev, generator=gen) < 1e-5] = 4
    m = rows * row_w
    table = tables.compact(table)
    if not tables._join_policy(m, table.capacity, table.keys.device):
        raise AssertionError("the join policy did not pick the join")

    coverage.window_counts(table, codes[:2], k, True, method="join")  # warm
    torch.cuda.synchronize()
    kernels = (sort_kernel.sort_pairs, merge_kernel.merge_sorted_payload,
               reduce_kernel.compact_flagged)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    counts, gc, valid = coverage.window_counts(table, codes, k, True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in kernels]
    if min(launches) < 1:
        raise AssertionError(f"a lookup kernel was not launched: {launches}")

    # the same windows by the binary search, and by a search of
    # torch.unique's table with GC from a running sum of the codes
    s_counts, s_gc, s_valid = coverage.window_counts(table, codes, k, True,
                                                     method="search")
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
    join_ms = _timed_ms(lambda: tables.lookup(
        table, q, method="join", key_bits=2 * k + 1), 5)
    search_ms = _timed_ms(lambda: tables.lookup(table, q, method="search"),
                          5)
    print(f"lookup path: {m} windows k={k} against {table.n_unique} keys at "
          f"capacity {table.capacity} in {dt:.4f} s; {n_hit} present, "
          f"{n_bad} invalid; join, search and reference agree; launches "
          f"sort_pairs/merge_payload/compact {launches}")
    print(f"lookup path: window_counts {wc_ms:.3f} ms = "
          f"{m / wc_ms * 1e3:.1f} windows/s; join {join_ms:.3f} ms = "
          f"{join_ms * 1e6 / m:.4f} ns/query; search {search_ms:.3f} ms = "
          f"{search_ms * 1e6 / m:.4f} ns/query")
    return launches


def bucketed_path(dev, n_reads: int = 196_608, genome_len: int = 1 << 23):
    """The bucketed flush against the classic one on the same FASTA file,
    through tools.common.Input; then both over staged input."""
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
    with tempfile.TemporaryDirectory() as tmp:
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
    return launches, group_chunks


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


def _run_cli(args: list[str]) -> float:
    """`python -m kat_tpu_torch <args>` on the card; returns its seconds."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "kat_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"CLI {args[0]} failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return dt


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


def _join_share(contigs, k: int, n_keys: int, dev):
    """(buckets, windows in them, all windows) of sect's lookups that the
    join policy takes, for one batch of contigs against a table of n_keys
    distinct keys."""
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
        if tables._join_policy(m, cap, dev):
            n_join += 1
            w_join += m
    return n_join, w_join, w_all


def cli_run(dev):
    """`python -m kat_tpu_torch` end to end on synthetic files: `hist -d`
    and `hist` from the dumped .jf in processes of their own, then `sect`
    through the same entry point inside this process, between a reset and a
    reading of every kernel's launch count.  Returns those six counts."""
    import contextlib
    import io

    from kat_tpu_torch import cli
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    from kat_tpu_torch.io import native

    if not native.available():  # build the reader outside the timed run
        raise AssertionError("native FASTX reader did not build")
    k, n_reads, read_len = 27, 200_000, 150
    rng = np.random.default_rng(SEED + 1)
    genome = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, 1 << 20)]
    off = rng.integers(0, genome.size - read_len, n_reads)
    seqs = genome[off[:, None] + np.arange(read_len)]
    noisy = rng.random(n_reads) < 0.01
    seqs[noisy, rng.integers(0, read_len, noisy.sum())] = ord("N")
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
        dt = _run_cli(["hist", "-d", "-m", str(k), "-o", out, fq])
        got = _read(out)
        if got != _numpy_hist_text(ucounts, k, fq):
            raise AssertionError("CLI hist differs from the numpy histogram")
        print(f"CLI: hist -d of {n_reads} x {read_len} bp reads equals "
              f"numpy's; {n_kmers} k-mers file-to-artifact in {dt:.4f} s = "
              f"{n_kmers / dt:.1f} k-mers/s (process start included)")

        jf = f"{out}-hash.jf{k}"
        out2 = os.path.join(tmp, "from_jf.hist")
        dt = _run_cli(["hist", "-o", out2, jf])
        if _read(out2).split("###")[1] != got.split("###")[1]:
            raise AssertionError("hist of the dumped .jf differs from the "
                                 "hist of the reads")
        print(f"CLI: hist of the dumped .jf ({os.path.getsize(jf)} bytes, "
              f"{uniq.size} records) equals the first, in {dt:.4f} s")

        out3 = os.path.join(tmp, "bucketed.hist")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["--flush", "bucketed", "hist", "-m", str(k), "-o",
                           out3, fq])
        if rc != 0 or _read(out3) != got:
            raise AssertionError("CLI hist --flush bucketed differs from "
                                 "the numpy histogram")
        print("CLI: hist --flush bucketed (in-process) equals numpy's too")

        fa = os.path.join(tmp, "asm.fa")
        contigs = _write_contigs(fa, genome, rng)
        prefix = os.path.join(tmp, "sect")
        kernels = (sort_kernel.sort_keys, merge_kernel.merge_sorted,
                   reduce_kernel.reduce_by_key, sort_kernel.sort_pairs,
                   merge_kernel.merge_sorted_payload,
                   reduce_kernel.compact_flagged)
        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as banner:
            rc = cli.main(["sect", "-m", str(k), "-o", prefix, fa, fq])
        dt = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        if rc != 0 or "Running KAT in SECT mode" not in banner.getvalue():
            raise AssertionError(f"sect returned {rc}:\n{banner.getvalue()}")
        n_join, w_join, w_all = _join_share(contigs, k, uniq.size, dev)
        if min(launches) < 1 or launches[3:] != [n_join] * 3:
            raise AssertionError(
                f"sect launched sort/merge/reduce/sort_pairs/merge_payload/"
                f"compact {launches}; {n_join} buckets take the join")
        if w_join < 0.9 * w_all:
            raise AssertionError(f"only {w_join} of {w_all} windows are in "
                                 "buckets that take the join")
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
    n_bases = sum(seq.size for _, seq in contigs)
    print(f"CLI: sect of {len(contigs)} contigs ({n_bases} bases, longest "
          f"{max(s.size for _, s in contigs)}) against the reads equals "
          f"numpy's counts, medians and means, in {dt:.4f} s = "
          f"{n_bases / dt:.1f} bases/s (counting included); launches "
          f"sort/merge/reduce/sort_pairs/merge_payload/compact {launches}; "
          f"{n_join} buckets with {w_join} of {w_all} windows took the join")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kat_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    _cuda.LIBRARY.get()
    print(f"kernels built by nvcc for sm_90a in "
          f"{_cuda.LIBRARY.build_seconds:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    kernels = check_kernels(dev, gen)
    launches, table, genome, ref_keys, ref_counts = main_path(dev)
    launches += lookup_path(dev, table, genome, ref_keys, ref_counts)
    del table, genome, ref_keys, ref_counts
    for entry, n in zip(kernels, launches, strict=True):
        entry["launches"] = n
    sect_launches = cli_run(dev)
    for entry, n in zip(kernels, sect_launches, strict=True):
        entry["launches_sect"] = n

    b_launches, group_chunks = bucketed_path(dev)
    k5, k6 = check_bucketed_kernels(dev, gen, group_chunks)
    k5["launches"], k6["launches"] = b_launches[:2]
    # K3, K2 with payload planes and K1 with a value also carry this path
    for i, n in ((2, b_launches[2]), (4, b_launches[3]), (3, b_launches[4])):
        kernels[i]["launches_bucketed"] = n
    kernels += [k5, k6, check_rounds_kernel(dev)]

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
