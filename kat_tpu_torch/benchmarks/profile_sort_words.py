"""Where the time of the W-word sort (K1 over W words) goes on the card,
beside the sort it replaced.

    python -m kat_tpu_torch.benchmarks.profile_sort_words [out.json]

Sorts, with `sort_kernel.sort_words` / `sort_words_pairs`:
- 2^26 random 41-mers, 10% SENTINEL (W = 2);
- the k = 41 main path's first flush: the canonical windows of
  workloads' first 16 batches in arrival order (~7.7 copies of each k-mer);
- 2^26 keys made of eight copies each of 2^23 random 41-mers, shuffled;
- 2^23 (key, position) pairs at k = 41 (W = 2) and k = 95 (W = 4).

For each it prints the sort's time and that of the LSD sort it replaced
(benchmarks/earlier_kernels.py) by CUDA events over 5 launches after a
warm-up, the device time of one call by kernel (torch.profiler), the
largest bucket and the buckets past what one block sorts, and checks the
two sorts agree.  Needs an NVIDIA card; the first line names it with its
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def _timed_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _by_kernel(fn) -> dict:
    """Device ms of one call of fn by kernel (and memset, memcpy) name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0]: e.device_time_total
        / 1e3 for e in prof.key_averages() if e.device_time_total > 0}


def _inputs(dev, gen):
    from ..core.kmers import extract_kmers_wide
    from . import workloads

    yield "2^26 uniform, k=41", workloads.wide_keys(41, 1 << 26, dev, gen), \
        21, None
    _genome, batches = workloads.main_path_batches(dev, 42)
    fresh = torch.cat([extract_kmers_wide(b, 41)[0].reshape(2, -1)
                       for b in batches[:16]], dim=1)
    del _genome, batches
    yield "the k=41 path's first flush", fresh, 21, None
    del fresh
    u = workloads.wide_keys(41, 1 << 23, dev, gen)
    yield "2^23 keys x 8 copies, k=41", u.repeat(1, 8)[:, torch.randperm(
        1 << 26, device=dev, generator=gen)], 21, None
    del u
    for k, tb in ((41, 21), (95, 5)):
        yield f"2^23 pairs, k={k}", workloads.wide_keys(
            k, 1 << 23, dev, gen), tb, torch.arange(
            1 << 23, dtype=torch.int32, device=dev)


def main(argv: list[str]) -> int:
    from ..ops import sort_kernel
    from . import earlier_kernels

    if not torch.cuda.is_available():
        print("profile_sort_words: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows = []
    for what, keys, tb, vals in _inputs(dev, gen):
        if vals is None:
            def new(keys=keys, tb=tb):
                return (sort_kernel.sort_words(keys, tb),)

            def old(keys=keys, tb=tb):
                return (earlier_kernels.sort_words(keys, tb),)
        else:
            def new(keys=keys, tb=tb, vals=vals):
                return sort_kernel.sort_words_pairs(keys, vals, tb)

            def old(keys=keys, tb=tb, vals=vals):
                return earlier_kernels.sort_words(keys, tb, vals)
        if not all(torch.equal(a, b) for a, b in zip(new(), old())):
            raise AssertionError(f"{what}: the two sorts differ")
        b = sort_kernel.bucket_of(keys, tb)
        counts = torch.bincount(b, minlength=sort_kernel.SENTINEL_BUCKET + 1)
        real = counts[:sort_kernel.SENTINEL_BUCKET]
        row = dict(what=what, n=keys.shape[1], words=keys.shape[0],
                   ms=_timed_ms(new), earlier_ms=_timed_ms(old),
                   largest_bucket=int(real.max()),
                   oversize=int((real > sort_kernel.BUCKET_CAP).sum()),
                   by_kernel=_by_kernel(new))
        rows.append(row)
        print(f"{what}: {row['ms']:.3f} ms (the replaced LSD sort "
              f"{row['earlier_ms']:.3f}); largest bucket "
              f"{row['largest_bucket']}, {row['oversize']} oversize; by "
              "kernel: " + ", ".join(f"{name} {ms:.3f}" for name, ms
                                     in row["by_kernel"].items()))
        del keys, vals
    if argv:
        with open(argv[0], "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
