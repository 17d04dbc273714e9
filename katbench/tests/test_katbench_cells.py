"""Whole runs of tiny cells on the CPU (the harness's look for a chip
skipped): correct on clean runs, a cell, a metric and a job kind added as
files alone found by name, and `correct` false for each fault a cell can
have and for the control."""

import json
import os

import pytest
import torch

from katbench import harness, job
from katbench.tests import tiny

torch.set_num_threads(1)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(str(tmp_path))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_clean_run_is_correct(root, cell, trace):
    out = tiny.run(root, cell, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    names = set(out["metrics"])
    if trace:
        assert "artifact_ms" in names and "breakdown" in out
        assert out["device"]["window_s"] > 0
    else:
        assert {"kmers_per_s", "setup_s"} <= names
        assert out["metrics"]["kmers_per_s"]["unit"] == "kmers/s"


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    cfg = {**tiny.TINY, "name": "fixture_genome", "genome_len": 9000,
           "read_len": 100, "n_reads": 701, "files": 1}
    mix = {**tiny.MIXES["tiny_hist"], "row_len": 512, "low": 2, "high": 40,
           "inc": 3}
    root = tiny.make_root(str(tmp_path), {"fixture.hist": (cfg, mix)})
    with open(os.path.join(root, "katbench", "metrics",
                           "fixture_jobs.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.jobs))\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "fixture_jobs", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "tool", "moves": "kmers_per_s",
        "workloads": ["fixture.hist"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    out = tiny.run(root, "fixture.hist", trace=True)
    assert out["correct"]
    assert out["metrics"]["fixture_jobs"]["value"] >= 1
    cell = harness.find_cell(root, "fixture.hist", False)
    assert cell.config["genome_len"] == 9000 and cell.mix["inc"] == 3
    # the metric is only in the cell it names
    assert "fixture_jobs" not in tiny.run(root, "tiny.hist", trace=True)[
        "metrics"]


KIND = '''"""A job kind that only counts the reads and compares the table."""

from katbench import job as base
from katbench import reference


def setup(job):
    pass


def run(job, rec, span):
    with span("count"):
        rec.heavy = {"table": job.count(job.batches)}


def check(job, recs, ref_reads, ref_asm):
    return {"table_mismatch": (base.table_mismatch(
        recs[-1].heavy["table"], ref_reads, job.k), 0)}


def control_record(job, ctrl):
    rec = base.JobRecord(windows=job.windows)
    rec.heavy = {"table": reference.as_table(ctrl[0])}
    return rec
'''


def test_a_job_kind_added_as_a_file_is_found(tmp_path, monkeypatch):
    mix = {**tiny.MIXES["tiny_hist"], "job": "fixture_count"}
    root = tiny.make_root(str(tmp_path), {"fixture.count": (tiny.TINY, mix)})
    with open(os.path.join(root, "katbench", "kinds",
                           "fixture_count.py"), "w") as f:
        f.write(KIND)
    out = tiny.run(root, "fixture.count")
    assert out["correct"] and list(out["checks"]) == ["table_mismatch"]
    assert out["metrics"]["kmers_per_s"]["value"] > 0
    # the same kind fails when the program's count is wrong
    _fault_half_batch(monkeypatch)
    assert tiny.run(root, "fixture.count")["correct"] is False
    with pytest.raises(ValueError, match="no job kind"):
        job.kind_module("../metrics/kmers_per_s", root)


def _fault_unchanged(monkeypatch):
    from kat_tpu_torch.core import counting

    monkeypatch.setattr(counting.CodeStreamingCounter, "add_codes",
                        lambda self, codes: None)


def _fault_half_batch(monkeypatch):
    from kat_tpu_torch.core import counting

    add = counting.CodeStreamingCounter.add_codes
    monkeypatch.setattr(counting.CodeStreamingCounter, "add_codes",
                        lambda self, codes: add(self, codes[:len(codes) // 2]))


def _fault_count_altered(monkeypatch):
    from kat_tpu_torch.core import counting

    finish = counting.StreamingCounter.finish

    def altered(self):
        t = finish(self)
        t.counts[t.n_unique // 2] += 1
        return t

    monkeypatch.setattr(counting.StreamingCounter, "finish", altered)


def _fault_artifact_altered(monkeypatch):
    from kat_tpu_torch.core import stats

    binned = stats.binned_sum

    def altered(total, bins, mask):
        out = binned(total, bins, mask)
        out[1] += 1
        return out

    monkeypatch.setattr(stats, "binned_sum", altered)
    monkeypatch.setattr("kat_tpu_torch.core.comp_engine.binned_sum", altered)


FAULTS = {"state_unchanged": _fault_unchanged,
          "half_batch_left_out": _fault_half_batch,
          "count_altered": _fault_count_altered,
          "artifact_altered": _fault_artifact_altered}


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_make_correct_false(root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = tiny.run(root, cell)
    assert out["correct"] is False and out["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails(root, cell):
    spec = harness.find_cell(root, cell, False)
    j = job.Job(spec.config, spec.mix, 2**31 + 5, tiny.CPU, root)
    try:
        ref = j.reference_tables()
        assert all(v == 0 for v, _ in j.check([j.run()], ref).values())
        bad = j.check([j.kind.control_record(
            j, j.reference_tables(canonical=False))], ref)
    finally:
        j.close()
    assert any(v > lim for v, lim in bad.values())


def test_hist_header_is_held_against_the_job_inputs(root, monkeypatch):
    from kat_tpu_torch.tools import common

    monkeypatch.setattr(common.Input, "file_name",
                        lambda self: "not_the_input.fq")
    out = tiny.run(root, "tiny.hist")
    assert out["correct"] is False
    assert out["checks"]["hist_lines_wrong"]["value"] >= 1
    assert out["checks"]["table_mismatch"]["value"] == 0
