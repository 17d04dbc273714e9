"""Stress the exit path of a multi-process gloo group on the CPU: start
`--runs` groups of 4 processes of torch_mp_workers.exit_early (one uneven
all_gather, then rank 0 reaches its exit first), `--parallel` groups at a
time, and count the groups in which a worker did not exit 0, by exit code.
`--no-shutdown` leaves out the workers' final distributed.shutdown, as the
workers were before it existed.  Not a test (pytest does not collect it):
an abort here is intermittent, so one run proves little either way.

    python tests/torch_mp_stress.py [--runs 200] [--parallel 4]
        [--no-shutdown] [--delay 0.3]
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp  # noqa: E402


def one_group(i: int, root: str, delay: float) -> str:
    """"ok", or the failing worker's exit code as text."""
    try:
        torch_mp.run("exit_early", 4, os.path.join(root, str(i)), delay,
                     timeout=240)
    except AssertionError as e:
        m = re.search(r"worker \d+ failed \((-?\d+)\)", str(e))
        return m.group(1) if m else "timeout"
    return "ok"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--delay", type=float, default=0.3)
    ap.add_argument("--no-shutdown", action="store_true")
    args = ap.parse_args(argv)
    if args.no_shutdown:
        last = "distributed.shutdown()\n"
        assert torch_mp.BOOT.endswith(last)
        torch_mp.BOOT = torch_mp.BOOT[:-len(last)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root, \
            concurrent.futures.ThreadPoolExecutor(args.parallel) as pool:
        got = collections.Counter(pool.map(
            lambda i: one_group(i, root, args.delay), range(args.runs)))
    bad = args.runs - got["ok"]
    print(f"{'without' if args.no_shutdown else 'with'} shutdown: "
          f"{args.runs} groups of 4, {bad} with a worker that did not exit "
          f"0 {dict(got)}, {time.perf_counter() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
