"""Structured tracing over torch.profiler.

Port of kat_tpu/utils/profiling.py.  The reference's observability is
per-stage wall-clock prints (boost::timer::auto_cpu_timer, SURVEY §5),
kept in utils/timer.py.  This adds a torch.profiler trace of a whole CLI
run (host ops, and the card's kernels and copies where there is one),
written as a Chrome trace viewable in Perfetto: kat_tpu's KAT_TPU_PROFILE
switch is the CLI's top-level `--profile DIR` here, since the port reads
no environment variable.  `annotate` adds a named span around a phase.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None = None):
    """Profile the enclosed block into `trace_dir` when it is given: one
    `kat_tpu_torch-<pid>.json` Chrome trace a process."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"kat_tpu_torch-{os.getpid()}.json"))
        print(f"Profiler trace written to {trace_dir}")


def annotate(name: str):
    """Named trace span (shows up in the profiler timeline)."""
    import torch

    return torch.profiler.record_function(name)
