"""Where the time of one bulk lookup goes on the card.

    python -m kat_tpu_torch.benchmarks.profile_join

Builds a 2^24-slot table holding about 2^23 random 54-bit keys and 2^23
queries (half present, 1% SENTINEL), checks that the sort-merge join and
the binary search agree, and prints
- the time of both routes, for queries in random order and already sorted
  (CUDA events, 5 launches after a warm-up);
- the time of `torch.cummax` and of `torch.cumsum` over the merged
  stream's length, the two ways to find the table row that leads a run
  (ops/join.py takes the second);
- `torch.profiler`'s device time by kernel for one join.
Needs an NVIDIA card; the first line names it with its power limit.
"""

from __future__ import annotations

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


def main() -> int:
    from torch.profiler import ProfilerActivity, profile

    from ..core import counting, tables
    from ..core.kmers import SENTINEL

    if not torch.cuda.is_available():
        print("profile_join: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cap, m, key_bits = 1 << 24, 1 << 23, 55

    real = torch.unique(torch.randint(0, 1 << 54, (1 << 23,), device=dev,
                                      generator=gen))
    keys = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
    keys[:real.numel()] = real
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    counts[:real.numel()] = torch.randint(
        1, 1000, (real.numel(),), dtype=torch.int32, device=dev,
        generator=gen)
    table = counting.CountTable(keys, counts, real.numel())
    q = torch.randint(0, 1 << 54, (m,), device=dev, generator=gen)
    q[::2] = real[torch.randint(0, real.numel(), (m // 2,), device=dev,
                                generator=gen)]
    q[torch.rand(m, device=dev, generator=gen) < 0.01] = SENTINEL
    qs = torch.sort(q).values

    def join(queries, is_sorted=False):
        return tables.lookup(table, queries, assume_sorted=is_sorted,
                             method="join", key_bits=key_bits)

    def search(queries):
        return tables.lookup(table, queries, method="search")

    if not (torch.equal(join(q), search(q))
            and torch.equal(join(qs, True), search(qs))):
        raise AssertionError("join and search differ")
    print(f"{m} queries against {table.n_unique} keys at capacity {cap}: "
          "join and search agree")
    for what, fn in (("join", lambda: join(q)),
                     ("search", lambda: search(q)),
                     ("join, sorted queries", lambda: join(qs, True)),
                     ("search, sorted queries", lambda: search(qs))):
        ms = _timed_ms(fn)
        print(f"{what}: {ms:.4f} ms = {ms * 1e6 / m:.4f} ns/query")

    x = torch.randint(0, 100, (cap + m,), dtype=torch.int32, device=dev,
                      generator=gen)
    flag = x > 50
    print(f"torch.cummax over {cap + m} int32: "
          f"{_timed_ms(lambda: torch.cummax(x, 0)):.4f} ms")
    print(f"torch.cumsum over {cap + m} bool into int32: "
          f"{_timed_ms(lambda: torch.cumsum(flag, 0, dtype=torch.int32)):.4f}"
          " ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        join(q)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20,
                                    max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
