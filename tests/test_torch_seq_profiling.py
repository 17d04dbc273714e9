"""kat_tpu_torch/utils/seq.py against kat_tpu/utils/seq.py, and
utils/profiling.py: `maybe_trace` writes a torch.profiler trace and the
counters of the traced block only when given a directory, `annotate` names
a span in it, and the CLI's `--profile DIR` wraps a whole run, the port's
`kat.` spans and its counters file included."""

import json
import os

import numpy as np
import pytest
import torch

from kat_tpu.utils import seq as jseq
from kat_tpu_torch import cli
from kat_tpu_torch.utils import profiling, seq

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SEQS = ["", "ACGT", "acgtNNgc", "GGGGCCCC", "ACGTX", "nnnn", "AaCcGgTt-",
        "GATTACA" * 9]


@pytest.mark.parametrize("s", SEQS)
def test_seq_helpers_match_kat_tpu(s):
    assert seq.gc_count(s) == jseq.gc_count(s)
    assert seq.gc_count_n(s) == jseq.gc_count_n(s)
    assert seq.valid_kmer(s) == jseq.valid_kmer(s)


@pytest.mark.parametrize("line,sep", [("1 2  30", " "), ("4,5,,6", ","),
                                      ("", " "), ("7", " ")])
def test_split_uint_matches_kat_tpu(line, sep):
    assert seq.split_uint(line, sep) == jseq.split_uint(line, sep)


def test_random_sequences_match_kat_tpu():
    rng = np.random.default_rng(2)
    for _ in range(50):
        s = "".join(rng.choice(list("ACGTacgtNn"), rng.integers(0, 60)))
        assert seq.gc_count_n(s) == jseq.gc_count_n(s)
        assert seq.valid_kmer(s) == jseq.valid_kmer(s)


def test_maybe_trace_off_writes_nothing(tmp_path, capsys):
    with profiling.maybe_trace(None):
        torch.ones(3).sum()
    with profiling.maybe_trace(""):
        pass
    assert not os.listdir(tmp_path) and capsys.readouterr().out == ""


def test_maybe_trace_writes_the_spans(tmp_path, capsys):
    d = tmp_path / "trace"
    with profiling.maybe_trace(str(d)):
        with profiling.annotate("kat_phase"):
            torch.arange(1000).sum()
    stem = f"kat_tpu_torch-{os.getpid()}"
    assert sorted(os.listdir(d)) == [stem + ".counters.json", stem + ".json"]
    names = {e.get("name") for e in json.load(open(d / (stem + ".json")))[
        "traceEvents"]}
    assert "kat_phase" in names
    assert json.load(open(d / (stem + ".counters.json"))) == dict.fromkeys(
        profiling.COUNTERS, 0)
    assert capsys.readouterr().out == f"Profiler trace written to {d}\n"


def test_cli_profile_wraps_the_run(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_plot", lambda *a, **kw: None)
    monkeypatch.setattr(cli, "_analyse_peaks", lambda *a, **kw: None)
    fq = tmp_path / "r.fq"
    rng = np.random.default_rng(0)
    with open(fq, "w") as f:
        for i in range(20):
            s = "".join(rng.choice(list("ACGT"), 60))
            f.write(f"@r{i}\n{s}\n+\n{'I' * 60}\n")
    d = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--profile", str(d), "hist", "-o",
                     str(tmp_path / "h"), str(fq)]) == 0
    assert (tmp_path / "h").exists()
    trace = json.load(open(d / f"kat_tpu_torch-{os.getpid()}.json"))
    assert trace["traceEvents"]


def test_cli_profile_writes_the_spans_and_the_counters(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_plot", lambda *a, **kw: None)
    monkeypatch.setattr(cli, "_analyse_peaks", lambda *a, **kw: None)
    fq = tmp_path / "r.fq"
    rng = np.random.default_rng(1)
    with open(fq, "w") as f:
        for i in range(40):
            s = "".join(rng.choice(list("ACGT"), 80))
            f.write(f"@r{i}\n{s}\n+\n{'I' * 80}\n")
    d = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--profile", str(d), "hist", "-o",
                     str(tmp_path / "h"), str(fq)]) == 0
    stem = d / f"kat_tpu_torch-{os.getpid()}"
    names = [e.get("name") for e in json.load(open(f"{stem}.json"))[
        "traceEvents"]]
    for span in ("kat.input.wait", "kat.extract", "kat.flush",
                 "kat.flush.sort", "kat.flush.merge", "kat.flush.reduce",
                 "kat.read.n_unique", "kat.bin", "kat.save"):
        assert span in names, span
    got = json.load(open(f"{stem}.counters.json"))
    assert set(got) == set(profiling.COUNTERS)
    assert got["flushes"] == names.count("kat.flush") >= 1
    assert got["host_reads"] == names.count("kat.read.n_unique")
    # every real window went through K1, and through K2 and K3 at least once
    assert got["merged_keys"] >= got["fresh_keys"] >= 40 * (80 - 27 + 1)
