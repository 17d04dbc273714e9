"""kat_tpu_torch.io and the input plumbing of tools/common against kat_tpu:
parity means identical code batches from the same files (exact), for the
native reader (its own build of kat_tpu/native/fastxio.cpp) and for the
Python reader."""

import functools
import gzip

import numpy as np
import pytest

from kat_tpu.io import fastx as jfastx
from kat_tpu.io import native as jnative
from kat_tpu.tools import common as jcommon
from kat_tpu_torch.io import fastx as tfastx
from kat_tpu_torch.io import native as tnative
from kat_tpu_torch.io.prefetch import prefetch
from kat_tpu_torch.tools import common as tcommon
from kat_tpu_native_fixture import kat_tpu_native  # noqa: F401


def _write_inputs(tmp_path):
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGTN", np.uint8)
    fa = tmp_path / "long.fa"
    with open(fa, "wb") as f:
        for i in range(3):  # long records: split into rows with seams
            seq = bases[rng.choice(5, 3000, p=[.24, .24, .24, .24, .04])]
            f.write(b">s%d\n" % i)
            for j in range(0, seq.size, 70):
                f.write(seq[j:j + 70].tobytes() + b"\n")
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as f:
        for i in range(200):
            seq = bases[rng.integers(0, 4, int(rng.integers(20, 180)))]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                           b"I" * seq.size))
    return str(fa), str(fq)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("threads", [1, 2])
def test_native_batches_match_jax(tmp_path, threads):
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ compiler: the native reader did not build")
    fa, fq = _write_inputs(tmp_path)
    for paths, trims in (([fa], None), ([fq], [3])):
        kw = dict(trim5=trims, rows=64, row_len=256, threads=threads)
        got = list(tnative.stream_code_batches(paths, 21, **kw))
        want = list(jnative.stream_code_batches(paths, 21, **kw))
        _assert_batches_equal(got, want)


def test_native_range_split_matches_jax(tmp_path, monkeypatch):
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ compiler: the native reader did not build")
    fa, _ = _write_inputs(tmp_path)
    items = tnative._work_items(tnative.get_lib(), [fa], [0], 3,
                                range_chunk=1024)
    assert items == jnative._work_items(jnative.get_lib(), [fa], [0], 3,
                                        range_chunk=1024)
    assert len(items) > 1 and all(i[4] == "range" for i in items)
    # byte ranges parse in parallel: compare the multiset of rows
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_work_items", functools.partial(
            mod._work_items, range_chunk=1024))
    got = np.concatenate(list(tnative.stream_code_batches(
        [fa], 21, rows=64, row_len=256, threads=3)))
    want = np.concatenate(list(jnative.stream_code_batches(
        [fa], 21, rows=64, row_len=256, threads=3)))
    assert sorted(map(bytes, got)) == sorted(map(bytes, want))


def test_python_reader_matches_jax(tmp_path):
    fa, fq = _write_inputs(tmp_path)
    paths = [fa, f"gen:cat {fq}"]
    assert tfastx.is_stream_path(paths[1]) and not tfastx.is_stream_path(fa)
    assert [tfastx.sniff_format(p) for p in (fa, fq)] == ["fasta", "fastq"]
    got = list(tfastx.encode_batches(
        tfastx.read_records_multi(paths, [0, 2]), 21, target_codes=4096,
        max_row=512))
    want = list(jfastx.encode_batches(
        jfastx.read_records_multi(paths, [0, 2]), 21, target_codes=4096,
        max_row=512))
    _assert_batches_equal(got, want)


def test_prefetch_reraises_producer_error():
    def items():
        yield 1
        raise KeyError("boom")

    it = prefetch(items())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


def test_glob_shard_scheme_matches_jax(tmp_path):
    """`shard://` marks a multi-process input group: both packages strip it
    and expand the rest as usual (braces, globs, a missing file kept
    verbatim, a gen: command left whole), as one string or a list."""
    for name in ("r1.fq", "r2.fq", "r3.fa"):
        (tmp_path / name).write_text("@r\nACGT\n+\nIIII\n")
    specs = [f"shard://{tmp_path}/r{{1,2}}.fq",
             f"shard://{tmp_path}/r*.f?",
             f"shard://{tmp_path}/r1.fq {tmp_path}/r3.fa",
             f"shard://{tmp_path}/missing.fq",
             f"shard://{tmp_path}/missing*.fq",
             "shard://gen:cat x y",
             [f"shard://{tmp_path}/r{{1,3}}.f?", f"{tmp_path}/r2.fq"],
             [f"shard://{tmp_path}/r2.fq", "shard://gen:zcat a.gz"]]
    for spec in specs:
        got = tcommon.glob_files(spec)
        assert got == jcommon.glob_files(spec), spec
        assert not any(p.startswith("shard://") for p in got)
    assert tcommon.glob_files(f"shard://{tmp_path}/r{{1,2}}.fq") == [
        str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]


def test_glob_and_trims_match_jax(tmp_path):
    for name in ("a1.fq", "a2.fq", "b.fa"):
        (tmp_path / name).write_text("@r\nACGT\n+\nIIII\n")
    specs = [f"{tmp_path}/a*.fq {tmp_path}/b.fa", f"{tmp_path}/{{a1,b}}.f?",
             f"{tmp_path}/missing*.fq", "gen:cat x y"]
    for spec in specs:
        assert tcommon.glob_files(spec) == jcommon.glob_files(spec)
    assert tcommon.brace_expand("x{1,{2,3}}y") == \
        jcommon.brace_expand("x{1,{2,3}}y")
    assert tcommon.parse_trim_list("0,5,2") == jcommon.parse_trim_list("0,5,2")
    for n in (1, 2, 3, 1000, 1 << 20):
        assert tcommon._next_pow2(n) == jcommon._next_pow2(n)
    inp = tcommon.Input(paths=[str(tmp_path / "a1.fq")], trim5=[1, 2])
    with pytest.raises(ValueError, match="trimming"):
        inp.validate()
