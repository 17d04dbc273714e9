"""The port against kat_tpu on kat_tpu's edge-case, stream-input and
native-reader suites (tests/test_edge_cases.py, test_stream_inputs.py,
test_native_io.py): every case feeds the same input, written from a seed,
to both packages and compares the outcomes, an equal result (records,
code rows, k-mer multisets, glob lists) or the same exception class with
the message fragment kat_tpu's test asserts.  The port counts on the CPU
(`device=torch.device("cpu")`); kat_tpu runs under JAX_PLATFORMS=cpu as
its own tests do.  The native cases hold the port's own build of
`native/fastxio.cpp` against kat_tpu's build of its copy and against
tests/oracle.py.  Exact throughout: the outputs are bytes and integers."""

import functools
import gzip
import io
import os
import random
import subprocess
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import oracle
from kat_tpu.io import fastx as jfastx
from kat_tpu.io import native as jnative
from kat_tpu.tools import common as jcommon
from kat_tpu.tools.filter_seq import FilterSeq as JFilterSeq
from kat_tpu.tools.hist import Histogram as JHistogram
from kat_tpu_native_fixture import kat_tpu_native  # noqa: F401
from kat_tpu_torch.io import fastx as tfastx
from kat_tpu_torch.io import jellyfish as tjellyfish
from kat_tpu_torch.io import native as tnative
from kat_tpu_torch.tools import common as tcommon
from kat_tpu_torch.tools.filter_seq import FilterSeq as TFilterSeq
from kat_tpu_torch.tools.hist import Histogram as THistogram

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
FASTX = {"kat_tpu": jfastx, "port": tfastx}
COMMON = {"kat_tpu": jcommon, "port": tcommon}
NATIVE = {"kat_tpu": jnative, "port": tnative}
FASTA = b">a\nACGTACGTAC\n>b\nGGGCCCTTT\n"


def _outcome(fn):
    """("ok", value) or (exception class, message) of fn()."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the class is the outcome
        return type(e), str(e)


def _same_refusal(fns, cls, fragment):
    """Both packages' calls raise cls with `fragment` in the message."""
    got = {name: _outcome(fn) for name, fn in fns.items()}
    for name, (kind, msg) in got.items():
        assert kind is cls, (name, kind, msg)
        assert fragment in msg, (name, msg)
    return got


def _records(mod, path):
    return [(r.name, r.seq, r.qual) for r in mod.read_records(path)]


def _write_fasta(path, named):
    with open(path, "w") as f:
        for name, s in named:
            f.write(f">{name}\n{s}\n")


def _write_fastq(path, named, gz=False):
    with (gzip.open if gz else open)(path, "wt") as f:
        for name, s in named:
            f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """test_edge_cases.py's database: 30 random reads of 60 bases."""
    tmp = tmp_path_factory.mktemp("edge")
    rng = random.Random(17)
    reads = ["".join(rng.choice("ACGT") for _ in range(60))
             for _ in range(30)]
    db = tmp / "db.fa"
    _write_fasta(db, [(f"r{i}", s) for i, s in enumerate(reads)])
    return reads, str(db)


# -- tests/test_edge_cases.py --------------------------------------------


def test_filter_seq_length_mismatch(base, tmp_path):
    reads, db = base
    f1, f2 = tmp_path / "a.fastq", tmp_path / "b.fastq"
    _write_fastq(f1, [("x", reads[0]), ("y", reads[1])])
    _write_fastq(f2, [("x", reads[0])])

    def run(cls, name, device=None):
        f = cls(str(f1), str(f2), [db])
        f.quiet = True
        f.output_prefix = str(tmp_path / name)
        f.input.mer_len = 11
        f.input.hash_size = 4096
        if device is not None:
            f.input.device = device
        return lambda: f.execute()

    got = _same_refusal({"kat_tpu": run(JFilterSeq, "j"),
                         "port": run(TFilterSeq, "t", CPU)},
                        ValueError, "longer than")
    assert got["kat_tpu"] == got["port"]


def test_mixed_input_types_rejected(base, tmp_path):
    """A sequence file and a .jf in one input group (a .jf the port
    writes: kat_tpu's test takes one from the reference data)."""
    reads, db = base
    jf = str(tmp_path / "t.jf27")
    tjellyfish.write_jf(jf, np.arange(1, 6, dtype=np.uint64),
                        np.ones(5, np.uint32), 27, True)
    got = _same_refusal(
        {name: (lambda m=m: m.Input(paths=[db, jf]).validate())
         for name, m in COMMON.items()}, ValueError, "Cannot mix")
    assert got["kat_tpu"] == got["port"]


def test_missing_file_rejected():
    got = _same_refusal(
        {name: (lambda m=m: m.Input(paths=["/nonexistent/file.fa"])
                .validate()) for name, m in COMMON.items()},
        FileNotFoundError, "/nonexistent/file.fa")
    assert got["kat_tpu"] == got["port"]


def test_glob_nocheck_keeps_pattern():
    """An unmatched pattern is kept verbatim (GLOB_NOCHECK)."""
    for spec in ("definitely_missing_*.fa", "a_{x,y}_missing.fq"):
        want = jcommon.glob_files(spec)
        assert tcommon.glob_files(spec) == want == [spec]


def test_hist_rejects_bad_range(base, tmp_path):
    reads, db = base

    def run(cls, name, device=None):
        h = cls([db], low=10, high=5)
        h.quiet = True
        h.output_prefix = str(tmp_path / name)
        if device is not None:
            h.input.device = device
        return lambda: h.execute()

    got = _same_refusal({"kat_tpu": run(JHistogram, "j"),
                         "port": run(THistogram, "t", CPU)},
                        ValueError, "High count value")
    assert got["kat_tpu"] == got["port"]


@pytest.mark.parametrize("text", [
    "@r1\nACGT\nNOTPLUS\nIIII\n",  # kat_tpu's case: a bad separator
    "@r1\nACGT\n+\nIIII\nr2\nACGT\n+\nIIII\n",  # a bad second header
], ids=["separator", "header"])
def test_malformed_fastq(tmp_path, text):
    bad = tmp_path / "bad.fastq"
    bad.write_text(text)
    got = _same_refusal({name: (lambda m=m: _records(m, str(bad)))
                         for name, m in FASTX.items()},
                        ValueError, "Malformed FASTQ")
    assert got["kat_tpu"] == got["port"]


def test_unknown_ext_sniffing(ref_data):
    """A .dat of FASTA content is a FASTA sequence file, a .jf is not
    (the reference's check_jellyfish.cc:182-220)."""
    for name in ("unknown.dat", "ecoli.header.jf27", "ecoli_r1.1K.fastq"):
        p = str(ref_data / name)
        assert tfastx.is_sequence_file(p) == jfastx.is_sequence_file(p)
        if jfastx.is_sequence_file(p):
            assert tfastx.sniff_format(p) == jfastx.sniff_format(p)
    assert tfastx.sniff_format(str(ref_data / "unknown.dat")) == "fasta"
    assert not tfastx.is_sequence_file(str(ref_data / "ecoli.header.jf27"))


# -- tests/test_stream_inputs.py -----------------------------------------


def test_fifo_single_open(tmp_path):
    """A FIFO is opened once: sniffing and reading share that open."""
    got = {}
    for name, mod in FASTX.items():
        fifo = str(tmp_path / f"{name}.fa")
        os.mkfifo(fifo)

        def writer():
            with open(fifo, "wb") as f:
                f.write(FASTA)

        t = threading.Thread(target=writer)
        t.start()
        try:
            assert mod.is_stream_path(fifo)
            assert mod.is_sequence_file(fifo)
            got[name] = _records(mod, fifo)
        finally:
            t.join(timeout=10)
    assert got["port"] == got["kat_tpu"]
    assert [r[0] for r in got["port"]] == ["a", "b"]


class _OneByte(io.RawIOBase):
    """A pipe that delivers one byte a read."""

    def __init__(self, data):
        self.data = data
        self.pos = 0

    def readable(self):
        return True

    def readinto(self, b):
        if self.pos >= len(self.data):
            return 0
        b[0] = self.data[self.pos]
        self.pos += 1
        return 1


def test_gzip_magic_survives_one_byte_reads():
    payload = gzip.compress(b">r1\nACGTACGT\n")
    got = {}
    for name, mod in FASTX.items():
        raw = _OneByte(payload)
        magic = mod._read_at_least(raw, 2)
        f = io.BufferedReader(mod._PushbackReader(magic, raw))
        got[name] = magic, gzip.GzipFile(fileobj=f).read()
    assert got["port"] == got["kat_tpu"] == (b"\x1f\x8b",
                                             b">r1\nACGTACGT\n")


def test_generator_failure_raises():
    """A gen: command that dies midway is an error, not a short input."""
    path = "gen:printf '>r1\\nACGT\\n'; exit 3"
    _same_refusal({name: (lambda m=m: _records(m, path))
                   for name, m in FASTX.items()},
                  RuntimeError, "generator command failed")


def test_generator_success_reaps_child():
    path = "gen:printf '>r1\\nACGTACGT\\n'"
    got = {name: _records(m, path) for name, m in FASTX.items()}
    assert got["port"] == got["kat_tpu"] == [("r1", b"ACGTACGT", None)]


def test_gzipped_generator_failure_raises(tmp_path):
    """The exit check survives the gzip wrapper."""
    p = tmp_path / "r.fa.gz"
    p.write_bytes(gzip.compress(b">r1\nACGTACGT\n"))
    ok = {name: _records(m, f"gen:cat {p}") for name, m in FASTX.items()}
    assert ok["port"] == ok["kat_tpu"] == [("r1", b"ACGTACGT", None)]
    _same_refusal({name: (lambda m=m: _records(m, f"gen:cat {p}; exit 3"))
                   for name, m in FASTX.items()},
                  RuntimeError, "generator command failed")


def test_cli_generator_command_with_spaces():
    """A gen:<command> is opaque to glob and space splitting."""
    for spec in ("gen:gzip -c a.fq.gz", ["gen:cat a b", "x.fa"],
                 ["shard://gen:cat a*", "gen:ls {a,b}"]):
        assert tcommon.glob_files(spec) == jcommon.glob_files(spec)
    assert tcommon.glob_files(["gen:cat a b", "x.fa"]) == \
        ["gen:cat a b", "x.fa"]


# -- tests/test_native_io.py ---------------------------------------------


@pytest.fixture
def seqs():
    """test_native_io.py's 50 random records of 5-200 bases, some Ns."""
    rng = random.Random(77)
    out = []
    for _ in range(50):
        n = rng.randint(5, 200)
        out.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.05 else "ACGT")
            for _ in range(n)))
    return out


def _rows(mod, paths, k, **kw):
    """Every code row the reader yields, as a sorted list of bytes (batch
    order interleaves when threads > 1)."""
    return sorted(bytes(r) for b in mod.stream_code_batches(paths, k, **kw)
                  for r in b)


def _kmers(rows, k):
    """The canonical k-mer multiset of code rows (codes >= 4 break)."""
    counts = Counter()
    for row in rows:
        row = np.frombuffer(row, np.uint8)
        for i in range(len(row) - k + 1):
            win = row[i:i + k]
            if (win < 4).all():
                v = 0
                for c in win:
                    v = (v << 2) | int(c)
                counts[min(v, oracle.revcomp(v, k))] += 1
    return counts


def _same_kmers(paths, seqs, k, **kw):
    """Both readers yield the same rows, whose k-mers are the oracle's."""
    got = _rows(tnative, paths, k, **kw)
    assert got == _rows(jnative, paths, k, **kw)
    assert _kmers(got, k) == oracle.count_seqs(seqs, k)


def test_range_split_quality_at_signs(tmp_path, monkeypatch):
    """Byte ranges that start inside a quality line of '@'s sync to the
    next record, not to the quality line."""
    seqs = ["ACGTACGTACGTACGTACGT"] * 40
    fq = tmp_path / "at.fastq"
    with open(fq, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'@' * len(s)}\n")
    for mod in NATIVE.values():
        monkeypatch.setattr(mod, "_work_items", functools.partial(
            mod._work_items, range_chunk=64))
    items = tnative._work_items(tnative.get_lib(), [str(fq)], [0], 8)
    assert len(items) == 16 and {i[4] for i in items} == {"range"}
    _same_kmers([str(fq)], seqs, 9, threads=8)


def test_abandoned_consumer_stops_workers(tmp_path, seqs):
    """Closing the reader's generator mid-stream stops its threads."""
    paths = []
    for i in range(3):
        p = tmp_path / f"ab{i}.fastq"
        _write_fastq(p, [(f"r{j}", s) for j, s in enumerate(seqs * 20)])
        paths.append(str(p))
    stopped = {}
    for name, mod in NATIVE.items():
        before = threading.active_count()
        gen = mod.stream_code_batches(paths, 9, rows=4, row_len=64,
                                      threads=3)
        next(gen)
        assert threading.active_count() > before
        gen.close()
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        stopped[name] = threading.active_count() <= before
    assert stopped == {"kat_tpu": True, "port": True}


@pytest.mark.parametrize("threads", [2, 1], ids=["raw_inflate", "gzread"])
def test_gz_threaded_raw_inflate_real_gzip_and_multimember(tmp_path, seqs,
                                                           threads):
    """gzip(1)'s output (FNAME set), two members concatenated."""
    a, b = tmp_path / "a.fastq", tmp_path / "b.fastq"
    _write_fastq(a, [(f"r{i}", s) for i, s in enumerate(seqs[:25])])
    _write_fastq(b, [(f"r{i}", s) for i, s in enumerate(seqs[25:])])
    subprocess.run(["gzip", "-k", str(a), str(b)], check=True)
    multi = tmp_path / "multi.fastq.gz"
    multi.write_bytes((tmp_path / "a.fastq.gz").read_bytes()
                      + (tmp_path / "b.fastq.gz").read_bytes())
    _same_kmers([str(multi)], seqs, 9, threads=threads)


@pytest.mark.parametrize("threads", [2, 1], ids=["raw_inflate", "gzread"])
def test_gz_threaded_truncation_raises(tmp_path, seqs, threads):
    """A member cut in half is an error on both inflate paths."""
    gz = tmp_path / "c.fastq.gz"
    _write_fastq(gz, [(f"r{i}", s) for i, s in enumerate(seqs * 30)],
                 gz=True)
    data = gz.read_bytes()
    gz.write_bytes(data[:len(data) // 2])
    got = {name: _outcome(lambda m=m: _rows(m, [str(gz)], 9,
                                            threads=threads))
           for name, m in NATIVE.items()}
    assert got["port"][0] is got["kat_tpu"][0] is RuntimeError, got


@pytest.mark.parametrize("threads", [2, 1], ids=["raw_inflate", "gzread"])
def test_gz_trailing_garbage_tolerated(tmp_path, seqs, threads):
    """Bytes after the last gzip member are ignored (gzread's rule)."""
    gz = tmp_path / "t.fastq.gz"
    _write_fastq(gz, [(f"r{i}", s) for i, s in enumerate(seqs)], gz=True)
    with open(gz, "ab") as f:
        f.write(b"\x00" * 37)
    _same_kmers([str(gz)], seqs, 9, threads=threads)
