"""The port's spans and counters (kat_tpu_torch/utils/profiling.py): off
without a profiler, nested as the counting, binning, comp and output paths
open them under a CPU torch.profiler, opened as often as they are
counted, and the counters' keys equal to the keys of the flush calls that
katbench's flush_calls records on the same input."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kat_tpu_torch.core import counting, stats, wide
from kat_tpu_torch.tools.comp import Comp
from kat_tpu_torch.utils import profiling

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
ROWS, LENGTH = 16, 100
COUNTING = {"kat.extract", "kat.flush", "kat.flush.sort", "kat.flush.merge",
            "kat.flush.reduce", "kat.read.n_unique", "kat.flush.replay"}
# each span's innermost enclosing `kat.` span
PARENTS = {"kat.extract": {None}, "kat.flush": {None},
           "kat.flush.sort": {"kat.flush"},
           "kat.flush.merge": {"kat.flush", "kat.flush.replay"},
           "kat.flush.reduce": {"kat.flush", "kat.flush.replay"},
           "kat.read.n_unique": {"kat.flush.reduce"},
           "kat.flush.replay": {"kat.flush"}}


def _batches(n=6, seed=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 4, (ROWS, LENGTH), generator=g,
                          dtype=torch.uint8) for _ in range(n)]


def _count(k, batches, cap=256):
    """Two batches a flush from a table of `cap` slots: growth replays."""
    counter = (wide.WideCodeStreamingCounter if k > 31
               else counting.CodeStreamingCounter)
    sc = counter(k, True, initial_capacity=cap, max_capacity=1 << 20,
                 flush_windows=2 * ROWS * (LENGTH - k + 1), device=CPU)
    for b in batches:
        sc.add_codes(b)
    return sc.finish()


def _traced(fn):
    """fn() under a CPU torch.profiler: its result, its `kat.` spans as
    (name, start, end) and the counters it added."""
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    after = profiling.counters()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("kat.")]
    return out, spans, {n: after[n] - before[n] for n in after}


def _parent(spans, i):
    """The innermost other span that encloses spans[i], or None."""
    _n, a, b = spans[i]
    outer = [(pb - pa, pn) for j, (pn, pa, pb) in enumerate(spans)
             if j != i and pa <= a and b <= pb]
    return min(outer)[1] if outer else None


def _names(spans):
    return [n for n, _a, _b in spans]


def test_annotate_is_off_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("kat.a") is profiling.annotate("kat.b")
    before = profiling.counters()
    table = _count(27, _batches())
    after = profiling.counters()
    assert table.n_unique > 0
    assert after["flushes"] - before["flushes"] == 3  # counted always
    assert after["replays"] > before["replays"]


@pytest.mark.parametrize("k", [27, 41])
def test_counting_spans_nest_and_match_the_counters(k):
    table, spans, got = _traced(lambda: _count(k, _batches()))
    names = _names(spans)
    assert set(names) == COUNTING  # a wide run opens the same spans
    for i, (name, a, b) in enumerate(spans):
        assert a <= b
        assert _parent(spans, i) in PARENTS[name], (name, _parent(spans, i))
    assert names.count("kat.extract") == 6
    assert names.count("kat.flush") == got["flushes"] == 3
    assert names.count("kat.flush.replay") == got["replays"] > 0
    assert names.count("kat.read.n_unique") == got["host_reads"]
    assert names.count("kat.flush.merge") == got["flushes"] + got["replays"]
    assert got["fresh_keys"] == 6 * ROWS * (LENGTH - k + 1)
    assert 0 < got["replayed_keys"] < got["merged_keys"]
    assert table.n_unique > 0


# the fused route's counting spans and their parents
FUSED = (COUNTING - {"kat.flush.merge", "kat.flush.reduce"}) | {
    "kat.flush.merge_reduce"}
FUSED_PARENTS = {**PARENTS,
                 "kat.flush.merge_reduce": {"kat.flush", "kat.flush.replay"},
                 "kat.read.n_unique": {"kat.flush.merge_reduce"}}


def test_fused_route_spans_nest_and_match_the_counters(monkeypatch):
    """The card's route taken on the CPU (where the fused op is its plain
    version): one `kat.flush.merge_reduce` a merge, holding the merge's
    `kat.read.n_unique`; `fused_merges` counts every merge, the other
    counters and the table are the split route's."""
    want, _spans, split = _traced(lambda: _count(27, _batches()))
    monkeypatch.setattr(counting, "fused_merge", lambda *_a: True)
    table, spans, got = _traced(lambda: _count(27, _batches()))
    names = _names(spans)
    assert set(names) == FUSED
    for i, name in enumerate(names):
        assert _parent(spans, i) in FUSED_PARENTS[name], name
    merges = names.count("kat.flush.merge_reduce")
    assert merges == got["fused_merges"] == got["flushes"] + got["replays"]
    assert names.count("kat.read.n_unique") == got["host_reads"] == merges
    assert split["fused_merges"] == 0
    for n in ("flushes", "replays", "fresh_keys", "merged_keys",
              "replayed_keys", "host_reads"):
        assert got[n] == split[n], n
    assert table.n_unique == want.n_unique
    assert torch.equal(table.keys, want.keys)
    assert torch.equal(table.counts, want.counts)


def test_merged_and_replayed_keys_equal_the_flush_calls(monkeypatch):
    from katbench import trace

    merges = []
    least = trace.merge_bytes

    def merge_bytes(na, nb):
        merges.append(na + nb)
        return least(na, nb)

    monkeypatch.setattr(trace, "merge_bytes", merge_bytes)
    tr = SimpleNamespace(flush_bytes=[])

    def count():
        with trace.flush_calls(counting, tr):
            return _count(27, _batches(seed=9))

    _table, _spans, got = _traced(count)
    kinds = [kind for kind, _b in tr.flush_bytes]
    # a flush's own merge follows its sort; a merge after a reduce replays
    after = [kinds[i - 1] for i, kind in enumerate(kinds) if kind == "merge"]
    assert len(after) == len(merges) == got["flushes"] + got["replays"]
    assert got["merged_keys"] == sum(merges)
    assert got["replayed_keys"] == sum(
        m for m, prev in zip(merges, after) if prev == "reduce") > 0
    assert got["fresh_keys"] == sum(
        b // trace.sort_bytes(1) for kind, b in tr.flush_bytes
        if kind == "sort")


@pytest.mark.parametrize("binning", ["hist", "gcp"])
def test_binning_opens_one_span(binning):
    table = _count(27, _batches(n=2))
    fn = ((lambda: stats.hist_from_counts(table.counts, 1, 101, 1, 102))
          if binning == "hist" else
          (lambda: stats.gcp_matrix(table, 27, 100)))
    out, spans, got = _traced(fn)
    assert _names(spans) == ["kat.bin"]
    assert int(out.sum()) == table.n_unique
    assert got["host_reads"] == 0


def test_comp_spans_and_host_reads(tmp_path):
    t1 = _count(27, _batches(seed=1))
    t2 = _count(27, _batches(n=2, seed=1))
    c = Comp(["reads.fq"], ["asm.fa"])
    c.quiet = True
    c.output_prefix = str(tmp_path / "kat-comp")
    c.d1_bins = c.d2_bins = 40
    c.set_mer_len(27)

    def compare_and_save():
        c.compare_tables(t1, t2)
        c.save()

    _out, spans, got = _traced(compare_and_save)
    names = _names(spans)
    for name in ("kat.comp.compact", "kat.comp.probe", "kat.comp.pass1",
                 "kat.comp.pass2", "kat.comp.store", "kat.save",
                 "kat.save.main.mx", "kat.save.stats"):
        assert names.count(name) == 1, name
    parents = {n: _parent(spans, i) for i, n in enumerate(names)}
    assert parents["kat.save.main.mx"] == parents["kat.save.stats"] \
        == "kat.save"
    reads = [i for i, n in enumerate(names) if n == "kat.read.comp"]
    # counters, 6 count tensors (row 0 joins the main matrix on the device)
    assert len(reads) == 7
    assert {_parent(spans, i) for i in reads} == {"kat.comp.store"}
    # the main matrix's formatter: its least and largest cell, the
    # selection's length, the text
    formats = [i for i, n in enumerate(names) if n == "kat.read.format"]
    assert len(formats) == 3
    assert {_parent(spans, i) for i in formats} == {"kat.save.main.mx"}
    assert got["host_reads"] == len(reads) + len(formats)
    assert (tmp_path / "kat-comp-main.mx").exists()
    assert (tmp_path / "kat-comp.stats").exists()
    assert c.counters["hash1_distinct"] == t1.n_unique
