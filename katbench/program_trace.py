"""The program's own spans and counters, read from the traced job.

The port opens spans under `kat.` where its work happens (extraction,
each flush and its sort, merge, reduce and growth replays, each host read,
binning, comp's passes, the artifacts) and keeps counters of flushes,
replays and keys (kat_tpu_torch/utils/profiling.py).  Its spans do not
synchronise: the card runs the work a span launched after the span has
closed.  So a card event belongs to the span in which the host launched
it, found through the launch call (`cudaLaunchKernel`, `cudaMemcpyAsync`
and the like) that shares the event's correlation id.

The harness's Trace (trace.Tracer) keeps neither the program's spans nor
the launch calls, and the harness keeps its Tracer only as a local of
`harness.run_cell`, which calls the metric readers.  `of(run)` finds that
Tracer on the call stack (the one whose flush calls the run's Trace
holds), reads its profiler's events again, and gives every reader of the
run a ProgramTrace of the same job: the Trace's events, each with its
launch, and the program's spans.  Its counters are the port's since the
process started: every job of a run counts the same reads, so their
shares are the traced job's.  `of` gives None where the port keeps no
counters (a port without these spans), the run was not traced, or no
caller holds the Tracer; it is the run's own trace where that already is
a ProgramTrace.
"""

from __future__ import annotations

import bisect
import re
import sys
from dataclasses import dataclass, field

import torch

from .trace import DeviceEvent, Trace, Tracer

PROGRAM_PREFIX = "kat."
# the CUDA API calls on the host that launch card work (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...): each card event's launch is one
LAUNCH_CALL = re.compile(r"cu(da)?[A-Z]")


@dataclass
class LaunchedEvent(DeviceEvent):
    launch_ns: int | None = None  # start of the host call that launched it


@dataclass
class ProgramTrace(Trace):
    """A Trace whose events carry their launch time, with the program's
    spans (full names, `kat.` included) and its counters."""
    program_spans: list[tuple[str, int, int]] = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    def __post_init__(self):
        self._times, self._names = _innermost(self.program_spans)

    def program_span_at(self, t_ns: int) -> str | None:
        """The innermost program span the host was in at t_ns."""
        i = bisect.bisect_right(self._times, t_ns) - 1
        return self._names[i] if i >= 0 else None

    def launch_span(self, e: LaunchedEvent) -> str | None:
        """The innermost program span the host launched e in."""
        return (None if e.launch_ns is None
                else self.program_span_at(e.launch_ns))

    def launched_in(self, name: str) -> list[LaunchedEvent]:
        """Card events launched while `name` was the innermost program
        span open on the host."""
        return [e for e in self.events if self.launch_span(e) == name]

    def gaps(self) -> list[tuple[int, float, LaunchedEvent | None]]:
        """(start, seconds, the event whose end began it, None at the
        window's start) of each stretch of the window with nothing on the
        card, in time order."""
        out, end, last = [], self.window[0], None
        for e in sorted(self.events, key=lambda e: e.start_ns):
            if e.start_ns > end:
                out.append((end, (e.start_ns - end) * 1e-9, last))
            if e.end_ns > end:
                end, last = e.end_ns, e
        if self.window[1] > end:
            out.append((end, (self.window[1] - end) * 1e-9, last))
        return out

    def idle_gaps(self) -> list[tuple[str, float]]:
        """The gaps, longest first, each named `<katbench span>/<program
        span>` by where the host was when it began, or by the katbench
        span alone where no program span was open."""
        named = []
        for t, s, _last in self.gaps():
            prog = self.program_span_at(t)
            name = self.span_of(t)
            named.append((f"{name}/{prog}" if prog else name, s))
        return sorted(named, key=lambda g: -g[1])


def _innermost(spans) -> tuple[list[int], list[str | None]]:
    """Properly nested spans as segments of time: (starts, the innermost
    span's name from each start to the next).  A span of no length holds
    no time."""
    held = [i for i, (_n, a, b) in enumerate(spans) if b > a]
    marks = sorted([(spans[i][2], 0, i) for i in held]
                   + [(spans[i][1], 1, i) for i in held])
    times, names, stack = [], [], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        name = spans[stack[-1]][0] if stack else None
        if times and times[-1] == t:
            names[-1] = name
        else:
            times.append(t)
            names.append(name)
    return times, names


def program_counters():
    """The port's counters() function, or None where it keeps none."""
    try:
        from kat_tpu_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "counters", None)


def from_profile(prof, base: Trace, counters: dict) -> ProgramTrace:
    """`base`, the Trace that trace.Tracer made of the profiled job `prof`
    (a torch.profiler.profile), as a ProgramTrace: the same events, each
    with its launch call's start, and the program's spans."""
    launch, corr, prog = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            corr[(name, start)] = e.correlation_id()
        elif name.startswith(PROGRAM_PREFIX):
            end = (e.end_ns() if hasattr(e, "end_ns")
                   else start + e.duration_ns())
            prog.append((name, start, end))
        elif LAUNCH_CALL.match(name):
            c = e.correlation_id()
            launch[c] = min(start, launch.get(c, start))
    events = [LaunchedEvent(e.name, e.start_ns, e.end_ns, e.group,
                            launch.get(corr.get((e.name, e.start_ns))))
              for e in base.events]
    return ProgramTrace(events, base.spans, base.window,
                        list(base.flush_bytes), prog, dict(counters))


def _tracer_of(run) -> Tracer | None:
    """The Tracer that traced `run`'s job, held by a caller of the reader
    (harness.run_cell): the innermost whose flush calls the Trace holds."""
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            if isinstance(v, Tracer) and v.flush_bytes == \
                    run.trace.flush_bytes:
                return v
        frame = frame.f_back
    return None


_last: tuple = (None, None)  # (run, its ProgramTrace): one run a process


def of(run) -> ProgramTrace | None:
    """The ProgramTrace of `run`'s traced job, made once for all the run's
    readers; None where there is none to make (module docstring)."""
    global _last
    if isinstance(run.trace, ProgramTrace):
        return run.trace
    if _last[0] is not run:
        counters = program_counters()
        tracer = (_tracer_of(run) if run.trace is not None
                  and counters is not None else None)
        _last = (run, None if tracer is None
                 else from_profile(tracer._prof, run.trace, counters()))
    return _last[1]
