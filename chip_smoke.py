#!/usr/bin/env python3
"""Drive kat_tpu_torch once on one NVIDIA card, end to end.

    python3 chip_smoke.py

1. prints the card's name and power limit, builds the CUDA kernels from
   kat_tpu_torch/csrc and prints the build time;
2. checks each kernel of the counting path (K1 sort, K2 merge, K3 reduce)
   against its plain PyTorch version on the card at the main path's
   shapes, exactly (integer keys and counts: tolerance 0), with times;
3. drives the device main path at bench.py's scale: k=27 canonical reads
   from an 8.4 Mbp random genome, 48 batches of 4096 x 1024 codes (196M
   windows, 3 flushes of 2^26 windows), table grown from 2^20 to 2^24
   slots; the table and histogram must equal torch.unique over the same
   windows, and each kernel must have been launched by that run;
4. runs `python -m kat_tpu_torch hist` on a synthetic FASTQ and holds the
   hist file against one built with numpy alone.

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


def check_kernels(dev, gen):
    """K1-K3 against their plain versions at the flush's shapes."""
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
    results.append(dict(
        name="radix_sort", route="cuda", source="kat_tpu_torch/csrc/sort.cu",
        replaces="kat_tpu/ops/sort_kernel.py:182", max_abs_err=err,
        ms=_timed_ms(lambda: sort_kernel.sort_keys(keys, 55), 5),
        plain_ms=_timed_ms(lambda: sort_kernel.sort_keys_plain(keys), 5)))
    print(f"K1 sort 2^26 keys: exact, kernel {results[-1]['ms']:.3f} ms, "
          f"plain {results[-1]['plain_ms']:.3f} ms")
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
    results.append(dict(
        name="merge_path", route="cuda", source="kat_tpu_torch/csrc/merge.cu",
        replaces="kat_tpu/ops/merge_kernel.py:73", max_abs_err=err,
        ms=_timed_ms(lambda: merge_kernel.merge_sorted(
            t_keys, t_counts, fresh), 5),
        plain_ms=_timed_ms(lambda: merge_kernel.merge_sorted_plain(
            t_keys, t_counts, fresh), 3)))
    print(f"K2 merge 2^24 table + 2^26 fresh: exact, kernel "
          f"{results[-1]['ms']:.3f} ms, plain {results[-1]['plain_ms']:.3f} ms")

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
    results.append(dict(
        name="reduce_by_key", route="cuda",
        source="kat_tpu_torch/csrc/reduce.cu",
        replaces="kat_tpu/ops/reduce_kernel.py:147", max_abs_err=max(errs),
        ms=_timed_ms(lambda: reduce_kernel.reduce_by_key(mk, mw, cap), 5),
        plain_ms=_timed_ms(
            lambda: reduce_kernel.reduce_by_key_plain(mk, mw, cap), 3)))
    print(f"K3 reduce {mk.numel()} -> 2^24: kernel {results[-1]['ms']:.3f} "
          f"ms, plain {results[-1]['plain_ms']:.3f} ms")
    return results


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
    return launches, n_windows / dt


def _numpy_hist_text(seqs: np.ndarray, k: int, path: str) -> tuple[str, int]:
    """The hist artifact for [n, L] ASCII reads, built with numpy alone."""
    from kat_tpu_torch.core.kmers import canonical_np, encode_ascii

    codes = encode_ascii(seqs).astype(np.uint64)
    w = seqs.shape[1] - k + 1
    fwd = np.zeros((seqs.shape[0], w), np.uint64)
    bad = np.zeros((seqs.shape[0], w), bool)
    for j in range(k):
        c = codes[:, j:j + w]
        bad |= c >= 4
        fwd |= (c & np.uint64(3)) << np.uint64(2 * (k - 1 - j))
    keys = canonical_np(fwd[~bad], k)
    _, counts = np.unique(keys, return_counts=True)
    base, ceil = 1, 10001
    nb = ceil + 1 - base
    bucket = np.where(counts < base, 0,
                      np.where(counts > ceil, nb - 1, (counts - base)))
    data = np.bincount(bucket, minlength=nb)
    lines = [f"# Title:{k}-mer spectra for: {os.path.basename(path)}",
             f"# XLabel:{k}-mer frequency", f"# YLabel:# distinct {k}-mers",
             f"# Kmer value:{k}", f"# Input 1:{path}", "###"]
    lines += [f"{base + i} {int(v)}" for i, v in enumerate(data)]
    return "\n".join(lines) + "\n", int(len(keys))


def cli_run():
    """`python -m kat_tpu_torch hist` on a synthetic FASTQ."""
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
    with tempfile.TemporaryDirectory() as tmp:
        fq = os.path.join(tmp, "reads.fq")
        with open(fq, "wb") as f:
            qual = b"I" * read_len
            for i in range(n_reads):
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), qual))
        out = os.path.join(tmp, "out.hist")
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kat_tpu_torch", "hist", "-m", str(k),
             "-o", out, fq], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=600)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI failed ({proc.returncode}):\n"
                                 f"{proc.stdout}\n{proc.stderr}")
        with open(out) as f:
            got = f.read()
        want, n_kmers = _numpy_hist_text(seqs, k, fq)
    if got != want:
        raise AssertionError("CLI hist differs from the numpy histogram")
    print(f"CLI: hist of {n_reads} x {read_len} bp reads equals numpy's; "
          f"{n_kmers} k-mers file-to-artifact in {dt:.4f} s = "
          f"{n_kmers / dt:.1f} k-mers/s (process start included)")


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
    launches, _rate = main_path(dev)
    for entry, n in zip(kernels, launches):
        entry["launches"] = n
    cli_run()

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
