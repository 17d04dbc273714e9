"""One job under torch.profiler, and what the per-layer metrics read from
it: the card's events (kernels, memsets, copies) with their groups, the
host spans that katbench opened around the program's calls, and the
busy, idle and breakdown figures of the result line.

KERNEL_GROUPS is a frozen copy of kat_tpu_torch/benchmarks/profile_main.py's
table (how the hand-written kernels of kat_tpu_torch/csrc/ begin in the
profiler's names): a later change to the program cannot move the
yardstick.  A memset counts with the kernel that runs just after it (a
kernel's scratch), as profile_main counts it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

_NS = "(anonymous namespace)::"
KERNEL_GROUPS = (("K1 sort", tuple(_NS + p for p in (
                     "radix_", "split_", "words_pass", "sort_units",
                     "segment_histogram"))),
                 ("K6 run merge", (_NS + "kway_", _NS + "merge_runs")),
                 ("K2 merge", (_NS + "merge_",)),
                 ("K3 reduce", (_NS + "reduce_",)),
                 ("K4 compact", (_NS + "compact_",)),
                 ("K5 chunk sort", (_NS + "chunk_", _NS + "sort_chunks")),
                 ("binned sums", (_NS + "binned_",)))
FLUSH_GROUPS = ("K1 sort", "K2 merge", "K3 reduce")
# the card's timeline also carries its waits, which are no work
NOT_WORK = ("Sync", "Synchronize")
SPAN_PREFIX = "katbench."


def kernel_group(name: str) -> str | None:
    """The hand-written kernel group a device event's name belongs to."""
    name = name.removeprefix("void ")
    return next((g for g, prefixes in KERNEL_GROUPS
                 if name.startswith(prefixes)), None)


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int
    group: str | None = None  # a hand-written kernel group, else None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass
class Trace:
    """The card's events of one traced job, its host spans and its window."""
    events: list[DeviceEvent]
    spans: list[tuple[str, int, int]]  # (name without prefix, start, end)
    window: tuple[int, int]
    # the least bytes of each flush call into ops: (sort|merge|reduce, bytes)
    flush_bytes: list[tuple[str, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def span_of(self, t_ns: int) -> str:
        """The innermost katbench span the host was in at t_ns."""
        best = None
        for name, a, b in self.spans:
            if a <= t_ns < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "between spans"

    def in_spans(self, names) -> list[DeviceEvent]:
        """Device events that started inside a span of one of `names`
        (every span ends in a synchronise, so its work lies inside it)."""
        iv = [(a, b) for n, a, b in self.spans if n in names]
        return [e for e in self.events
                if any(a <= e.start_ns < b for a, b in iv)]

    def busy_s(self, events=None) -> float:
        """Seconds in which at least one of the events ran."""
        evs = sorted(self.events if events is None else events,
                     key=lambda e: e.start_ns)
        busy, end = 0, None
        for e in evs:
            s = max(e.start_ns, self.window[0])
            t = min(e.end_ns, self.window[1])
            if t <= s:
                continue
            if end is None or s > end:
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        return busy * 1e-9

    def idle_gaps(self) -> list[tuple[str, float]]:
        """Stretches of the window with nothing on the card, each named by
        the span the host was in when it began, longest first."""
        gaps, end = [], self.window[0]
        for e in sorted(self.events, key=lambda e: e.start_ns):
            if e.start_ns > end:
                gaps.append((self.span_of(end), (e.start_ns - end) * 1e-9))
            end = max(end, e.end_ns)
        if self.window[1] > end:
            gaps.append((self.span_of(end), (self.window[1] - end) * 1e-9))
        return sorted(gaps, key=lambda g: -g[1])

    def device_ops(self) -> list[tuple[str, float]]:
        """Device seconds by kernel group (or by name outside the groups),
        costliest first."""
        by: dict[str, float] = {}
        for e in self.events:
            key = e.group or e.name.removeprefix("void ")[:80]
            by[key] = by.get(key, 0.0) + e.seconds
        return sorted(by.items(), key=lambda kv: -kv[1])


def _group_events(raw) -> list[DeviceEvent]:
    evs = sorted(raw, key=lambda e: e.start_ns)
    for i, e in enumerate(evs):
        if e.name.startswith("Memset"):
            nxt = next((x for x in evs[i + 1:]
                        if not x.name.startswith("Memset")), None)
            e.group = kernel_group(nxt.name) if nxt is not None else None
        else:
            e.group = kernel_group(e.name)
    return evs


class Tracer:
    """torch.profiler around one job (CPU ops and the card's events); the
    job's katbench spans and flush_calls' byte counts land in it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.flush_bytes: list[tuple[str, int]] = []

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    def result(self) -> Trace:
        events, spans, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            start = e.start_ns()
            end = (e.end_ns() if hasattr(e, "end_ns")
                   else start + e.duration_ns())
            on_card = e.device_type() == torch.autograd.DeviceType.CUDA
            if name.startswith(SPAN_PREFIX):
                if not on_card:  # the card's copy of a range is no work
                    item = (name[len(SPAN_PREFIX):], start, end)
                    if item[0] == "job":
                        window = item[1:]
                    spans.append(item)
            elif on_card and not any(w in name for w in NOT_WORK):
                events.append(DeviceEvent(name, start, end))
        if window is None:
            raise RuntimeError("the traced job left no katbench.job span")
        return Trace(_group_events(events), spans, window,
                     list(self.flush_bytes))


@contextlib.contextmanager
def flush_calls(counting, tracer: Tracer):
    """Record the bytes each flush call into ops needs, as the least that
    it can move: every input byte read once, every output byte written
    once.  Wraps the names kat_tpu_torch/core/counting.py calls through
    (`sort_keys`, `merge_sorted`, `reduce_by_key`) for the traced job."""
    saved = {n: getattr(counting, n)
             for n in ("sort_keys", "merge_sorted", "reduce_by_key")}

    def sort_keys(keys, *a, **kw):
        tracer.flush_bytes.append(("sort", sort_bytes(keys.numel())))
        return saved["sort_keys"](keys, *a, **kw)

    def merge_sorted(a_keys, a_counts, b_keys, *a, **kw):
        tracer.flush_bytes.append(
            ("merge", merge_bytes(a_keys.numel(), b_keys.numel())))
        return saved["merge_sorted"](a_keys, a_counts, b_keys, *a, **kw)

    def reduce_by_key(keys, w, out_size, *a, **kw):
        tracer.flush_bytes.append(
            ("reduce", reduce_bytes(keys.numel(), out_size)))
        return saved["reduce_by_key"](keys, w, out_size, *a, **kw)

    for n, f in (("sort_keys", sort_keys), ("merge_sorted", merge_sorted),
                 ("reduce_by_key", reduce_by_key)):
        setattr(counting, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(counting, n, f)


# The least bytes of the flush's calls (int64 keys, int32 counts).
def sort_bytes(n: int) -> int:
    """K1: n keys read, n sorted keys written."""
    return 16 * n


def merge_bytes(na: int, nb: int) -> int:
    """K2: the table's na keys and counts and nb fresh keys read, na + nb
    keys and weights written."""
    return 12 * na + 8 * nb + 12 * (na + nb)


def reduce_bytes(n: int, out_size: int) -> int:
    """K3: n keys and weights read, out_size slots of keys and counts and
    the run count written."""
    return 12 * n + 12 * out_size + 8
