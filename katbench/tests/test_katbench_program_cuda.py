"""The program's spans on the card, read from a tiny traced cell's own
traced job: every kernel, memset and copy is joined to the host call that
launched it, the device-to-host copies launched inside `kat.read.*` spans
are the port's `host_reads`, the harness's trace holds no card copy of a
program span, and the three metrics that read them each lie within what
they are part of."""

import pytest
import torch

from katbench import program_trace
from katbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["tiny.hist", "tiny.comp"])
def test_the_program_spans_on_the_card(tmp_path, monkeypatch, dev, cell):
    from kat_tpu_torch.utils import profiling

    # counters of this run's jobs alone: the warm-up and every attempted job
    monkeypatch.setattr(profiling, "_counts",
                        dict.fromkeys(profiling.COUNTERS, 0))
    out = tiny.run(tiny.make_root(str(tmp_path)), cell, trace=True,
                   device=dev)
    assert out["correct"], out["checks"]
    pt = program_trace._last[1]
    assert pt.events
    unjoined = [e.name for e in pt.events if e.launch_ns is None]
    assert not unjoined, unjoined[:10]
    assert not [e.name for e in pt.events if e.name.startswith("kat.")]
    reads = [e for e in pt.events if e.name.startswith("Memcpy DtoH")
             and (pt.launch_span(e) or "").startswith("kat.read.")]
    jobs = out["attempted"] + 1
    assert len(reads) * jobs == pt.counters["host_reads"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    # the same job's events: extraction is part of the plain-torch time,
    # the read's gaps part of the idle time
    assert 0 < m["extract_ms_per_gwin"] <= m["plain_ms_per_gwin"]
    d = out["device"]
    assert 0 < m["flush_read_idle_ms"] <= 1e3 * (d["window_s"] - d["busy_s"])
    assert 0 < m["replay_key_share"] < 100
