"""Where the device time of the counting path goes on the card.

    python -m kat_tpu_torch.benchmarks.profile_main [--k K] [--shards N]

Counts chip_smoke.py's main-path workload (benchmarks/workloads.py: k=27
canonical, 48 batches of 4096 reads x 1024 bases from a 2^23-base random
genome, staged on the card, 196,214,784 windows in 3 flushes, table grown
from 2^20 slots) once to warm up and once under torch.profiler, and prints
the wall time, the device time in all, the share of each hand-written
kernel (the histogram's binned sums among them; a memset of a kernel's scratch counts with the kernel that runs
just after it: K1's histogram, K3's tile pass), and the 15 costliest
kernels.  With --k above 31 the same reads go through the wide counter
(k = 41: 193,462,272 windows, W = 2 words a key) and its W-word kernels.
With --shards N they are counted on a mesh of N shards, all on the card
(workloads.sharded_counter: parallel/sharded.py), whose flush adds K6's
arrival merge and the exchange's copies.
Needs an NVIDIA card; the first line names it with its power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

# how the kernels of csrc/ begin in the profiler's names (after "void "),
# in the order they are matched: an event joins the first group it fits
# (K1's W-word sort: the split's histogram, passes and plan, the bucket
# sort, the fallback's histogram; K6: its plan and merge, `kway_`)
_NS = "(anonymous namespace)::"
KERNEL_GROUPS = (("K1 sort", tuple(_NS + p for p in (
                     "radix_", "split_", "words_pass", "sort_units",
                     "segment_histogram"))),
                 ("K6 run merge", (_NS + "kway_", _NS + "merge_runs")),
                 ("K2 merge", "(anonymous namespace)::merge_"),
                 ("K3 reduce", "(anonymous namespace)::reduce_"),
                 ("binned sums", "(anonymous namespace)::binned_"))


def _group(name: str) -> str | None:
    return next((g for g, prefix in KERNEL_GROUPS
                 if name.startswith(prefix)), None)


def main(argv: list[str] | None = None) -> int:
    import argparse

    from ..core import stats
    from . import workloads

    parser = argparse.ArgumentParser(prog="profile_main")
    parser.add_argument("--k", type=int, default=workloads.MAIN_K)
    parser.add_argument("--shards", type=int, default=None)
    args = parser.parse_args(argv)
    k = args.k

    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    _genome, batches = workloads.main_path_batches(dev, 42)
    table = None

    def run():
        nonlocal table
        if args.shards:
            from ..parallel import sharded

            sc = workloads.sharded_counter(k, sharded.make_mesh(args.shards))
            for b in batches:
                sc.add_codes(b)
            sc.histogram(1, 10001, 1, 10001)  # checks, then bins per shard
            table = sc
        else:
            sc = (workloads.wide_counter(k, dev) if k > 31
                  else workloads.main_path_counter(dev))
            for b in batches:
                sc.add_codes(b)
            table = sc.finish()
            stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    events = workloads.device_events(run)
    device_us = sum(us for _name, us in events)
    n_windows = (workloads.MAIN_BATCHES * workloads.MAIN_ROWS
                 * (workloads.MAIN_LENGTH - k + 1))
    n_unique = int(table.n_unique.sum()) if args.shards else table.n_unique
    print(f"main path k={k}"
          + (f" on {args.shards} shards" if args.shards else "")
          + f", warm: {n_windows} windows, {n_unique} distinct, "
          f"wall {wall * 1e3:.1f} ms unprofiled, device {device_us / 1e3:.1f} "
          "ms")
    names = [name.removeprefix("void ") for name, _us in events]
    groups = [_group(name) if not name.startswith("Memset") else
              (_group(names[i + 1]) if i + 1 < len(names) else None)
              for i, name in enumerate(names)]
    for group, _prefix in KERNEL_GROUPS:
        mine = [i for i, g in enumerate(groups) if g == group]
        us = sum(events[i][1] for i in mine)
        print(f"{group}: {us / 1e3:.3f} ms = {100 * us / device_us:.1f}% of "
              f"the device time, in {len(mine)} launches")
    by_name = {}
    for name, (_full, us) in zip(names, events):
        calls, total = by_name.get(name, (0, 0.0))
        by_name[name] = (calls + 1, total + us)
    print("the 15 costliest kernels: ms, calls, name")
    for name, (calls, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:15]:
        print(f"{us / 1e3:10.3f} {calls:6d} {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
