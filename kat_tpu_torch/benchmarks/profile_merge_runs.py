"""Where K6's time goes on the card, kernel by kernel.

    python -m kat_tpu_torch.benchmarks.profile_merge_runs

At the shapes the port runs K6 at (benchmarks/workloads.py): one shard's
arrivals in the main path's flush on 8 shards at k = 27 (8 runs of 2^22
slots, a quarter of each real keys, one word) and at k = 41 (W = 2), and
the bucketed flush's largest hot group (128 chunk runs of 2^14 keys, 30%
SENTINEL), prints the k-way merge's time (CUDA events over 5 calls after a
warm-up), the tree of pairwise merges it replaced (benchmarks/earlier/)
and the plain version in the same process, both bounds (every byte once;
the real keys read and every output written, at 3.35 TB/s), and the
device time of each kernel of one call (torch.profiler: the plan and the
merge of every pass).  Needs an NVIDIA card; the first line names it with
its power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


def _ms(fn, reps: int = 5) -> float:
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


def shapes(dev, gen):
    """(what, keys, run_len) of K6 at the port's shapes."""
    from ..core import bucketed
    from ..core.kmers import SENTINEL
    from ..ops import sort_kernel
    from . import workloads

    rl = workloads.SHARDED_ROUTE_CAP
    yield ("sharded k=27", workloads.sharded_runs(27, dev, gen), rl)
    yield ("sharded k=41", workloads.sharded_runs(41, dev, gen), rl)
    chunk = 1 << bucketed.SLOTS_LOG
    group = torch.randint(0, 1 << 60, (128 * chunk,), dtype=torch.int64,
                          device=dev, generator=gen)
    group[torch.rand(group.numel(), device=dev, generator=gen) < 0.3] = \
        SENTINEL
    yield ("bucketed group of 128", sort_kernel.sort_chunks_plain(
        group, chunk), chunk)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_merge_runs: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    from ..core.kmers import SENTINEL
    from ..ops import sort_kernel
    from . import earlier_kernels, workloads

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    for what, keys, rl in shapes(dev, gen):
        wide = keys.dim() == 2
        W, n = (keys.shape[0] if wide else 1), keys.shape[-1]
        fn = sort_kernel.merge_runs_words if wide else sort_kernel.merge_runs
        tree = (earlier_kernels.merge_runs_words if wide
                else earlier_kernels.merge_runs)
        plain = (sort_kernel.merge_runs_words_plain if wide
                 else sort_kernel.merge_runs_plain)
        got = fn(keys, rl)
        if not (torch.equal(got, plain(keys, rl))
                and torch.equal(got, tree(keys, rl))):
            raise AssertionError(f"{what}: K6 differs from its plain "
                                 "version or the tree")
        n_real = int(((keys if wide else keys[None]) != SENTINEL)
                     .any(0).sum())
        rate = workloads.HBM_BYTES_PER_S
        row = dict(
            shape=what, n=n, W=W, real_keys=n_real,
            passes=len(sort_kernel.merge_passes(n, rl)),
            ms=_ms(lambda: fn(keys, rl)), tree_ms=_ms(lambda: tree(keys, rl)),
            plain_ms=_ms(lambda: plain(keys, rl), 3),
            bound_ms=2 * 8 * W * n / rate * 1e3,
            touch_bound_ms=8 * W * (n_real + n) / rate * 1e3,
            kernels_us=[(name.split("::", 1)[-1].split("(")[0], us)
                        for name, us in workloads.device_events(
                            lambda: fn(keys, rl))])
        print(json.dumps(row))
        del keys, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
