"""Structured tracing over torch.profiler, and the counting path's counters.

Port of kat_tpu/utils/profiling.py.  The reference's observability is
per-stage wall-clock prints (boost::timer::auto_cpu_timer, SURVEY §5),
kept in utils/timer.py.  This adds a torch.profiler trace of a whole CLI
run (host ops, and the card's kernels and copies where there is one),
written as a Chrome trace viewable in Perfetto: kat_tpu's KAT_TPU_PROFILE
switch is the CLI's top-level `--profile DIR` here, since the port reads
no environment variable.

`annotate` names a span around a phase.  The port opens its spans under
the prefix `kat.` where the work happens (extraction, each flush and its
sort, merge, reduce and growth replays, each host read, binning, comp's
passes, the artifacts).  A span records where the host was, never when
the card ran the work: it neither synchronises nor reads a tensor.  Spans
cost a probe of the profiler's state when nothing records, and are
ranges of whichever torch.profiler records (the CLI's `--profile`, a
benchmark's tracer, a script's).

`count` adds to one per-process table of counters, counted always, from
numbers the host already holds (COUNTERS).
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

# flushes, growth replays, keys into K1 (SENTINEL windows included), keys
# into K2 and K3 over every merge (the table's real entries plus the
# fresh keys), the part of those that went through a replay, the
# synchronous host reads (one per `kat.read.*` span), and the merges that
# went through the fused K2 + K3 kernel
COUNTERS = ("flushes", "replays", "fresh_keys", "merged_keys",
            "replayed_keys", "host_reads", "fused_merges")
_counts = dict.fromkeys(COUNTERS, 0)
_OFF = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (one of COUNTERS)."""
    _counts[name] += n


def counters() -> dict[str, int]:
    """A copy of this process's counters since it started."""
    return dict(_counts)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """Profile the enclosed block into `trace_dir` when it is given: one
    `kat_tpu_torch-<pid>.json` Chrome trace a process, and beside it
    `kat_tpu_torch-<pid>.counters.json`, the counters of the block."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    before = counters()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        stem = os.path.join(trace_dir, f"kat_tpu_torch-{os.getpid()}")
        prof.export_chrome_trace(stem + ".json")
        with open(stem + ".counters.json", "w") as f:
            json.dump({n: v - before[n] for n, v in counters().items()}, f,
                      indent=1)
        print(f"Profiler trace written to {trace_dir}")


def annotate(name: str):
    """A named span of the profiler's timeline while a torch.profiler
    records, else a shared no-op context.  The span is an operator range
    (`cpu_op`), not a user annotation: torch.profiler copies each user
    annotation onto the card's timeline as an event of its own, which
    readers of the card's events would take for work."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
