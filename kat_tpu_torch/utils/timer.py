"""Per-stage wall-clock timing with the reference's console UX.

The reference wraps every phase in `boost::timer::auto_cpu_timer(1,
"  Time taken: %ws\n\n")` (e.g. histogram.cc:117,147,164).  `stage()` prints
"<label> ..." then " done.\n  Time taken: X.XXXXXXs" on exit.
"""

from __future__ import annotations

import contextlib
import sys
import time


@contextlib.contextmanager
def stage(label: str, quiet: bool = False):
    t0 = time.perf_counter()
    if not quiet:
        print(f"{label} ...", end="", flush=True)
    yield
    dt = time.perf_counter() - t0
    if not quiet:
        print(f" done.\n  Time taken: {dt:.6f}s\n", flush=True)


@contextlib.contextmanager
def total(label: str, quiet: bool = False):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if not quiet:
        print(f"{label} completed.\nTotal runtime: {dt:.6f}s\n", flush=True)
