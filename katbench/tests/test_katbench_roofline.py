"""flush_roofline's byte count on known shapes, the calls it records
around the flush, and the trace's busy, idle and group arithmetic."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from katbench import trace
from katbench.trace import DeviceEvent, Trace

torch.set_num_threads(1)


def test_least_bytes_of_each_call():
    assert trace.sort_bytes(1 << 26) == 16 << 26
    # table 2^24 keys + counts read, 2^26 fresh keys read, both written
    assert trace.merge_bytes(1 << 24, 1 << 26) == (
        12 * (1 << 24) + 8 * (1 << 26) + 12 * ((1 << 24) + (1 << 26)))
    assert trace.reduce_bytes(1000, 4096) == 12 * 1000 + 12 * 4096 + 8


def test_flush_calls_record_every_flush_and_replay():
    from kat_tpu_torch.core import counting

    g = torch.Generator().manual_seed(4)
    k, rows, L = 15, 16, 100
    batches = [torch.randint(0, 4, (rows, L), generator=g,
                             dtype=torch.uint8) for _ in range(6)]
    win = rows * (L - k + 1)
    sc = counting.CodeStreamingCounter(
        k, True, initial_capacity=256, max_capacity=1 << 20,
        flush_windows=2 * win, device=torch.device("cpu"))
    tr = SimpleNamespace(flush_bytes=[])
    caps, uniq = [], []
    with trace.flush_calls(counting, tr):
        for b in batches:
            before = sc.table
            sc.add_codes(b)
            if sc.table is not before:
                caps.append(sc.capacity)
                uniq.append(sc.table.n_unique)
        sc.finish()
    kinds = [kd for kd, _b in tr.flush_bytes]
    assert kinds.count("sort") == 3  # 6 batches, 2 a flush
    # each sort is followed by merge + reduce, once more per doubling
    assert len(kinds) == 3 + 2 * (3 + int(np.log2(caps[-1] // 256)))
    sorts = [b for kd, b in tr.flush_bytes if kd == "sort"]
    assert sorts == [trace.sort_bytes(2 * win)] * 3
    # the last flush merges the table of the second with 2 batches' windows
    merges = [b for kd, b in tr.flush_bytes if kd == "merge"]
    assert merges[-1] == trace.merge_bytes(uniq[1], 2 * win)
    reduces = [b for kd, b in tr.flush_bytes if kd == "reduce"]
    assert reduces[-1] == trace.reduce_bytes(uniq[1] + 2 * win, caps[-1])
    assert counting.sort_keys.__module__ != trace.__name__  # restored


def _ev(name, a, b):
    return DeviceEvent(name, a, b)


def test_groups_busy_idle_and_breakdown():
    ns = "void (anonymous namespace)::"
    evs = trace._group_events([
        _ev("Memset (Device)", 100, 110), _ev(ns + "radix_pass<8>", 110, 200),
        _ev("elementwise_kernel", 150, 260), _ev(ns + "merge_tile", 400, 500),
        _ev("Memcpy DtoH (Device -> Pageable)", 500, 510),
        _ev(ns + "reduce_runs", 700, 800)])
    assert [e.group for e in evs] == ["K1 sort", "K1 sort", None, "K2 merge",
                                      None, "K3 reduce"]
    t = Trace(evs, [("job", 0, 1000), ("count", 50, 600),
                    ("artifact", 650, 1000)], (0, 1000))
    assert t.busy_s() == pytest.approx((160 + 110 + 100) * 1e-9)
    gaps = t.idle_gaps()
    assert gaps[0] == ("artifact", pytest.approx(200e-9))
    assert ("count", pytest.approx(140e-9)) in gaps
    assert [e.name for e in t.in_spans({"count"})][-1].startswith("Memcpy")
    ops = dict(t.device_ops())
    assert ops["K1 sort"] == pytest.approx(100e-9)


def test_flush_roofline_reader_on_a_known_trace():
    from katbench.harness import metric_reader
    from katbench.tests.tiny import REPO

    ns = "void (anonymous namespace)::"
    evs = trace._group_events([
        _ev(ns + "radix_pass", 0, 2_000_000),          # 2 ms K1
        _ev(ns + "merge_tile", 2_000_000, 3_000_000),  # 1 ms K2
        _ev(ns + "reduce_runs", 3_000_000, 4_000_000),  # 1 ms K3
        _ev(ns + "merge_tile", 6_000_000, 7_000_000)])  # outside count
    t = Trace(evs, [("job", 0, 8_000_000), ("count", 0, 5_000_000),
                    ("compare", 5_000_000, 8_000_000)], (0, 8_000_000),
              [("sort", 3_350_000_000), ("merge", 1_675_000_000)])
    run = SimpleNamespace(trace=t, device_name="NVIDIA H100 80GB HBM3")
    read = metric_reader(REPO, "flush_roofline")
    # 5.025 GB at 3.35 TB/s = 1.5 ms of 4 ms
    assert read(run) == pytest.approx(37.5)
    assert read(SimpleNamespace(trace=t, device_name="cpu")) is None
