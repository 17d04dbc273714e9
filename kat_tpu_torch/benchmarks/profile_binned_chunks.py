"""The binned sums (csrc/binned.cu) and K5, the chunk sort
(csrc/chunk_sort.cu), on the card: by form, beside the kernels they
replaced, and by kernel.

    python -m kat_tpu_torch.benchmarks.profile_binned_chunks [out.json]

The binned sums at chip_smoke.py's shapes (workloads.binned_inputs: hist,
gcp, comp skewed and uniform; workloads.packed_inputs: comp pass 1's and
pass 2's request sets), and a histogram whose count-1 k-mers fill 70% of
the table (sequencing errors), each held against its plain version and
the window kernel it replaced (benchmarks/earlier/), then timed (CUDA
events over 10 calls after a warm-up, queued behind a spin kernel): the
kernel, the replaced kernel, and builds of benchmarks/probes/ (copies of
the two sources with build knobs and timing probes, one library each):
the kernel built with two stages a block at most (-DKAT_BN_MAX_STAGES=2:
one tile in flight while one is counted, as the first design had; held
against the plain version too), the timing probes of the first pass
(-DKAT_BN_PROBE=1: its counters added to without atomics; 2: not added
to; 3: its tiles only staged; their counts are wrong and not checked),
one `torch.bincount` per mask or request, and the plain version; with
the bound (every input byte read once, every output byte written once at
3.35 TB/s) and each kernel and memset of one call (torch.profiler).  K5
at the bucketed flush's shape (2048 chunks of 2^14 keys, 30%
SENTINEL) on uniform 60-bit keys and on chunks whose keys share their
high bits (8 buckets a chunk), then on 2^25 keys in chunks of 2^5..2^13,
beside the bitonic kernel it replaced, the row-wise `torch.sort`, the
kernel built without its L2 prefetch of the next tile
(-DKAT_CS_PREFETCH=0) and its timing probes (-DKAT_CS_PROBE=1: no merge
levels; 2: each merge step's read from the thread's own slots, free of
bank conflicts; their output is wrong and not checked).  Needs an NVIDIA
card; the first line names it with its power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

PROBES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probes")


def _ms(fn, reps: int = 10) -> float:
    """ms of one call on the card, the calls queued behind a spin kernel
    (~25 ms) so that the events time the card's work, not the host's
    launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _with_library(lib, fn):
    """fn() with the kernel wrappers pointed at another build."""
    from ..ops import _cuda

    saved = _cuda.LIBRARY
    _cuda.LIBRARY = lib
    try:
        return fn()
    finally:
        _cuda.LIBRARY = saved


def binned_forms(dev, gen):
    """(what, keys, masks, requests) of every form timed."""
    from . import workloads

    for shape in workloads.BINNED_SHAPES:
        bins, masks, total = workloads.binned_inputs(shape, dev, gen)
        yield shape, bins, masks, [(1, total, m)
                                   for m in range(masks.shape[0])]
    for shape in workloads.PACKED_SHAPES:
        yield (shape, *workloads.packed_inputs(shape, dev, gen))
    bins, masks, total = workloads.binned_inputs("hist", dev, gen)
    ones = torch.rand(bins.numel(), device=dev, generator=gen) < 0.7
    yield ("hist_errors", torch.where(masks[0] & ones, 0, bins), masks,
           [(1, total, 0)])


def chunk_inputs(dev, gen):
    """(what, keys, chunk) of every K5 shape timed."""
    from ..core import bucketed
    from ..core.kmers import SENTINEL

    chunk = 1 << bucketed.SLOTS_LOG
    n = bucketed.MAX_CHUNKS * chunk
    keys = torch.randint(0, 1 << 60, (n,), dtype=torch.int64, device=dev,
                         generator=gen)
    sent = torch.rand(n, device=dev, generator=gen) < 0.3
    yield "uniform 60-bit", torch.where(sent, SENTINEL, keys), chunk
    # 8 router buckets a chunk: the top bits of key' barely vary
    bucket = (torch.arange(n, device=dev) // chunk) * 8 + torch.randint(
        0, 8, (n,), device=dev, generator=gen)
    shared = (bucket << 40) | (keys & ((1 << 40) - 1))
    yield "8 buckets a chunk", torch.where(sent, SENTINEL, shared), chunk
    for log_c in range(5, 14):
        yield f"chunks of 2^{log_c}", keys[:1 << 25], 1 << log_c


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_binned_chunks: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    from ..ops import _cuda, binned_kernel as bk, sort_kernel
    from . import earlier_kernels, workloads

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    signatures = {name: args for name, args in _cuda._SIGNATURES.items()
                  if name.startswith(("kat_binned_sums", "kat_sort_chunks"))}

    def variant(flag):
        return _cuda.KernelLibrary((flag,), csrc=PROBES,
                                   signatures=signatures)

    two_stages = variant("-DKAT_BN_MAX_STAGES=2")
    no_prefetch = variant("-DKAT_CS_PREFETCH=0")
    probes = {f"{name}_ms": variant(flag) for name, flag in (
        ("bn_plain_add", "-DKAT_BN_PROBE=1"),
        ("bn_no_add", "-DKAT_BN_PROBE=2"),
        ("bn_staging_only", "-DKAT_BN_PROBE=3"),
        ("cs_no_levels", "-DKAT_CS_PROBE=1"),
        ("cs_conflict_free", "-DKAT_CS_PROBE=2"))}

    rate = workloads.HBM_BYTES_PER_S
    rows, calls = [], []
    for what, keys, masks, reqs in binned_forms(dev, gen):
        got = bk.packed_sums(keys, masks, reqs)
        want = bk.packed_sums_plain(keys, masks, reqs)
        old = earlier_kernels.packed_sums(keys, masks, reqs)
        var = _with_library(two_stages, lambda: bk.packed_sums(keys, masks,
                                                               reqs))
        for g, w, o, v in zip(got, want, old, var, strict=True):
            if not (torch.equal(g, w) and torch.equal(o, w)
                    and torch.equal(v, w)):
                raise AssertionError(f"{what}: a kernel differs from the "
                                     "plain version")
        lib_in = [torch.where(masks[mi], (keys.to(torch.int64) // d) % m, m)
                  for d, m, mi in reqs]
        out_bytes = 8 * sum(m for _d, m, _i in reqs)
        rows.append(dict(
            form=what, n=keys.numel(), masks=masks.shape[0],
            requests=reqs, ms=_ms(lambda: bk.packed_sums(keys, masks, reqs)),
            earlier_ms=_ms(lambda: earlier_kernels.packed_sums(
                keys, masks, reqs)),
            two_stages_ms=_with_library(two_stages, lambda: _ms(
                lambda: bk.packed_sums(keys, masks, reqs))),
            **{name: _with_library(lib, lambda: _ms(
                lambda: bk.packed_sums(keys, masks, reqs)))
               for name, lib in probes.items() if name.startswith("bn_")},
            library_ms=_ms(lambda: [torch.bincount(b, minlength=m + 1)
                                    for b, (_d, m, _i) in zip(lib_in, reqs)],
                           5),
            plain_ms=_ms(lambda: bk.packed_sums_plain(keys, masks, reqs), 3),
            bound_ms=(keys.numel() * (4 + masks.shape[0]) + out_bytes)
            / rate * 1e3))
        calls.append(lambda keys=keys, masks=masks, reqs=reqs:
                     bk.packed_sums(keys, masks, reqs))
        del got, want, old, var, lib_in
    for row, events in zip(rows, workloads.device_event_groups(calls)):
        row["inside_us"] = [(name.split("(")[0].split("<")[0], us)
                            for name, us in events]
        print(json.dumps(row))
    del calls

    for what, keys, chunk in chunk_inputs(dev, gen):
        got = sort_kernel.sort_chunks(keys, chunk)
        if not (torch.equal(got, sort_kernel.sort_chunks_plain(keys, chunk))
                and torch.equal(got, earlier_kernels.sort_chunks(keys,
                                                                 chunk))):
            raise AssertionError(f"K5 {what}: differs from the plain "
                                 "version or the bitonic kernel")
        row = dict(
            form=f"K5 {what}", n=keys.numel(), chunk=chunk,
            ms=_ms(lambda: sort_kernel.sort_chunks(keys, chunk)),
            earlier_ms=_ms(lambda: earlier_kernels.sort_chunks(keys, chunk)),
            no_prefetch_ms=_with_library(no_prefetch, lambda: _ms(
                lambda: sort_kernel.sort_chunks(keys, chunk))),
            **{name: _with_library(lib, lambda: _ms(
                lambda: sort_kernel.sort_chunks(keys, chunk)))
               for name, lib in probes.items() if name.startswith("cs_")},
            library_ms=_ms(lambda: sort_kernel.sort_chunks_plain(keys, chunk),
                           3),
            bound_ms=16 * keys.numel() / rate * 1e3)
        rows.append(row)
        print(json.dumps(row))
        del keys, got
    print(f"build: {_cuda.LIBRARY.build_seconds:.1f} s ({smi})")
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(dict(device=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
