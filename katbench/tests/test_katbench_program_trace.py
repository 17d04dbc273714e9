"""The readers of the program's spans and counters (program_trace.py and
the metrics extract_ms_per_gwin, flush_read_idle_ms, replay_key_share):
known values on hand-built traces whose card work runs after the span
that launched it has closed, gaps named by the program span the host was
in, nothing read from a port without counters, and a tiny traced cell's
replay_key_share, read from the harness's own traced job, equal to a count
of its merges by hand."""

from types import SimpleNamespace

import pytest
import torch

from katbench import harness, job, program_trace, trace
from katbench.program_trace import LaunchedEvent, ProgramTrace
from katbench.tests import tiny

torch.set_num_threads(1)

K1 = "void (anonymous namespace)::radix_sort_tile"
K3 = "void (anonymous namespace)::reduce_runs"
WINDOWS = 1000


def _hand_built() -> ProgramTrace:
    """One count span: an extraction kernel that runs after kat.extract
    closed, a sort kernel, a reduce kernel that runs while the host waits
    in the flush's read, the read's copy, and a kernel launched outside
    any program span.  Times in ns."""
    spans = [("job", 0, 2000), ("count", 0, 1500)]
    prog = [("kat.extract", 100, 200), ("kat.flush", 220, 1100),
            ("kat.flush.sort", 230, 300), ("kat.flush.reduce", 700, 1050),
            ("kat.read.n_unique", 800, 1000)]
    events = [LaunchedEvent("at::native::elementwise_kernel", 300, 500,
                            launch_ns=150),
              LaunchedEvent(K1, 500, 650, launch_ns=250),
              LaunchedEvent(K3, 820, 870, launch_ns=720),
              LaunchedEvent("Memcpy DtoH (Device -> Pageable)", 900, 950,
                            launch_ns=810),
              LaunchedEvent("at::native::fill_kernel", 1200, 1300,
                            launch_ns=1150)]
    return ProgramTrace(trace._group_events(events), spans, (0, 2000),
                        program_spans=prog,
                        counters={"merged_keys": 400, "replayed_keys": 100})


def _run(t):
    return SimpleNamespace(trace=t, job=SimpleNamespace(windows=WINDOWS))


def _read(name, run):
    return harness.metric_reader(tiny.REPO, name)(run)


def test_an_event_belongs_to_the_span_it_was_launched_in():
    t = _hand_built()
    assert t.program_span_at(150) == "kat.extract"
    assert t.program_span_at(200) is None  # kat.extract has closed
    assert t.program_span_at(250) == "kat.flush.sort"
    assert t.program_span_at(900) == "kat.read.n_unique"
    assert t.program_span_at(1050) == "kat.flush"
    assert t.program_span_at(1100) is None
    # the extraction kernel ran at 300-500, after kat.extract closed
    assert [e.name for e in t.launched_in("kat.extract")] == [
        "at::native::elementwise_kernel"]
    assert [e.group for e in t.launched_in("kat.flush.sort")] == ["K1 sort"]


def test_the_readers_on_a_hand_built_trace():
    run = _run(_hand_built())
    # 200 ns of extraction over 1000 windows
    assert _read("extract_ms_per_gwin", run) == pytest.approx(
        1e3 * 200e-9 / (WINDOWS / 1e9))
    # the gap from the read's copy (ends 950) to the next kernel (1200)
    assert _read("flush_read_idle_ms", run) == pytest.approx(250e-6)
    assert _read("replay_key_share", run) == 25.0


def test_only_the_gap_after_the_reads_copy_counts():
    t = _hand_built()
    gaps = t.gaps()
    assert [(s, round(d * 1e9)) for s, d, _e in gaps] == [
        (0, 300), (650, 170), (870, 30), (950, 250), (1300, 700)]
    assert [e.name[:6] if e else None for _s, _d, e in gaps] == [
        None, K1[:6], K3[:6], "Memcpy", "at::na"]
    # the gap at 650 begins in kat.flush (the host had left the sort); the
    # ones at 870 and 950 while the host waits in kat.read.n_unique, but
    # only the one at 950 follows the read's copy
    assert [(n, round(d * 1e9)) for n, d in t.idle_gaps()] == [
        ("count", 700), ("count", 300), ("count/kat.read.n_unique", 250),
        ("count/kat.flush", 170), ("count/kat.read.n_unique", 30)]
    assert _read("flush_read_idle_ms", _run(t)) == pytest.approx(250e-6)
    t.events[3].launch_ns = 1020  # a copy launched after the read
    assert _read("flush_read_idle_ms", _run(t)) == 0.0


def test_innermost_segments_of_nested_and_touching_spans():
    spans = [("a", 0, 10), ("b", 2, 5), ("c", 5, 8), ("d", 5, 5)]
    times, names = program_trace._innermost(spans)
    assert list(zip(times, names)) == [(0, "a"), (2, "b"), (5, "c"),
                                       (8, "a"), (10, None)]


@pytest.mark.parametrize("why", ["no counters", "no tracer", "not traced"])
def test_nothing_is_read_without_a_traced_port(monkeypatch, why):
    if why == "no counters":  # the parent's port
        monkeypatch.setattr(program_trace, "program_counters", lambda: None)
    run = SimpleNamespace(trace=None if why == "not traced" else
                          trace.Trace([], [], (0, 1), [("sort", 16)]),
                          job=SimpleNamespace(windows=WINDOWS))
    for name in ("extract_ms_per_gwin", "flush_read_idle_ms",
                 "replay_key_share"):
        assert _read(name, run) is None


def test_a_tiny_traced_cell_reports_the_replayed_share(tmp_path,
                                                       monkeypatch):
    from kat_tpu_torch.core import counting
    from kat_tpu_torch.utils import profiling

    root = tiny.make_root(str(tmp_path))
    seed = 2**31 + 29
    # counters of this run's jobs alone
    monkeypatch.setattr(profiling, "_counts",
                        dict.fromkeys(profiling.COUNTERS, 0))
    out = tiny.run(root, "tiny.hist", seed=seed, trace=True)
    assert out["correct"]
    got = out["metrics"]["replay_key_share"]
    assert got["unit"] == "%"
    # read from the harness's own traced job, found on the call stack
    read = program_trace._last[1]
    assert read is not None
    assert {n: (a, b) for n, a, b in read.spans}["job"] == read.window
    assert {"kat.extract", "kat.flush.replay", "kat.save"} <= {
        n for n, _a, _b in read.program_spans}
    # no card here: the readers of the card's events report nothing
    assert "extract_ms_per_gwin" not in out["metrics"]
    assert "flush_read_idle_ms" not in out["metrics"]
    assert not any("kat." in name for name, _s in
                   out["breakdown"]["idle_gaps"])

    merges = []
    least = trace.merge_bytes
    monkeypatch.setattr(trace, "merge_bytes",
                        lambda na, nb: merges.append(na + nb)
                        or least(na, nb))
    cell = harness.find_cell(root, "tiny.hist", True)
    j = job.Job(cell.config, cell.mix, seed, tiny.CPU, root)
    rec = SimpleNamespace(flush_bytes=[])
    try:
        with trace.flush_calls(counting, rec):
            j.count(j.batches)
    finally:
        j.close()
    kinds = [kind for kind, _b in rec.flush_bytes]
    after = [kinds[i - 1] for i, kind in enumerate(kinds) if kind == "merge"]
    replayed = sum(m for m, prev in zip(merges, after) if prev == "reduce")
    assert replayed > 0
    assert got["value"] == 100.0 * replayed / sum(merges)


def test_the_harness_trace_keeps_none_of_the_program_spans(tmp_path):
    root = tiny.make_root(str(tmp_path))
    out = tiny.run(root, "tiny.comp", trace=True)
    assert out["correct"]
    read = program_trace._last[1]
    assert not any(n.startswith("kat.") for n, _a, _b in read.spans)
    assert {n for n, _a, _b in read.spans} == {
        "job", "count", "count.asm", "compare", "artifact"}
    names = {n for n, _a, _b in read.program_spans}
    assert {"kat.extract", "kat.flush", "kat.read.n_unique",
            "kat.comp.pass1", "kat.comp.store", "kat.read.comp",
            "kat.save.main.mx"} <= names
