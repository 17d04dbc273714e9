"""The port's .jf codec (a copy of kat_tpu's) and the LOAD / dump paths of
tools/common.Input against kat_tpu: written files byte-identical once the
header's host, time and user are pinned, and loaded tables equal."""

import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.core import wide as jwide
from kat_tpu.io import jellyfish as jjf
from kat_tpu.tools import common as jcommon
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import kmers
from kat_tpu_torch.core import wide as twide
from kat_tpu_torch.io import jellyfish as tjf
from kat_tpu_torch.tools import common as tcommon

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")


@pytest.fixture
def pinned(monkeypatch):
    """Pin what a .jf header records about the machine and the moment.
    Both codecs read them through the same stdlib modules."""
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    monkeypatch.setattr("getpass.getuser", lambda: "user")
    monkeypatch.setattr("sys.argv", ["kat", "hist"])


def _table(seed, n, k):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    counts = rng.integers(1, 70000, len(keys)).astype(np.uint32)
    return rng.permutation(keys), counts


@pytest.mark.parametrize("k,canonical,counter_len", [
    (27, True, 4), (17, False, 4), (31, True, 2), (21, True, 1)])
def test_write_jf_bytes_match_jax(tmp_path, pinned, k, canonical,
                                  counter_len):
    keys, counts = _table(k, 500, k)
    want, got = tmp_path / "j.jf", tmp_path / "t.jf"
    jjf.write_jf(str(want), keys, counts, k, canonical, counter_len)
    tjf.write_jf(str(got), keys, counts, k, canonical, counter_len)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("k,counter_len", [(27, 4), (21, 1)])
def test_read_jf_of_a_jax_file(tmp_path, k, counter_len):
    keys, counts = _table(k + 1, 400, k)
    path = str(tmp_path / "j.jf")
    jjf.write_jf(path, keys, counts, k, True, counter_len)
    jh, jk, jv = jjf.read_jf(path)
    th, tk, tv = tjf.read_jf(path)
    assert (th.key_len, th.counter_len, th.canonical, th.size, th.mer_len) \
        == (jh.key_len, jh.counter_len, jh.canonical, jh.size, k)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    order = np.argsort(keys)
    np.testing.assert_array_equal(tk, keys[order])
    np.testing.assert_array_equal(
        tv, np.minimum(counts[order], (1 << (8 * counter_len)) - 1))
    assert tjf.read_header(path)[1] % 8 == 0  # records start 8-byte aligned


def test_read_header_rejects_other_files(tmp_path):
    p = tmp_path / "x.jf"
    p.write_bytes(b">seq\nACGT\n")
    with pytest.raises(ValueError, match="Not a jellyfish hash"):
        tjf.read_header(str(p))
    p.write_bytes(b'000000024{"format":"text/sorted"}')
    with pytest.raises(ValueError, match="Text format"):
        tjf.read_header(str(p))


def test_wide_writer_raises(tmp_path, pinned):
    """The wide writer (python-int keys, or [W, n] int64 words) writes
    kat_tpu's bytes, counts saturating, records in key order whatever the
    input order; it raises, as kat_tpu's does, on a key too wide for k."""
    rng = np.random.default_rng(40)
    keys = sorted({int.from_bytes(rng.bytes(10), "little") >> 1
                   for _ in range(300)}, key=lambda v: v % 97)
    counts = rng.integers(1, 70000, len(keys)).astype(np.uint32)
    want, got, got_w = (tmp_path / n for n in ("j.jf", "t.jf", "w.jf"))
    for counter_len in (4, 2):
        jjf.write_jf(str(want), keys, counts, 40, True, counter_len)
        tjf.write_jf(str(got), keys, counts, 40, True, counter_len)
        tjf.write_jf(str(got_w), kmers.ints_to_words(keys, 40), counts, 40,
                     True, counter_len)
        assert got.read_bytes() == want.read_bytes()
        assert got_w.read_bytes() == want.read_bytes()
    hdr, words, c = tjf.read_jf_words(str(got))
    assert hdr.mer_len == 40 and kmers.words_to_ints(words) == sorted(keys)
    with pytest.raises(OverflowError):
        jjf.write_jf(str(want), [1 << 80], np.array([1]), 40, True)
    with pytest.raises(ValueError, match="does not fit"):
        tjf.write_jf(str(got), [1 << 80], np.array([1]), 40, True)


def test_input_load_matches_jax(tmp_path):
    keys, counts = _table(3, 3000, 27)
    path = str(tmp_path / "in.jf27")
    jjf.write_jf(path, keys, counts, 27, False)
    ji = jcommon.Input(paths=[path])
    ti = tcommon.Input(paths=[path], device=CPU)
    for inp in (ji, ti):
        inp.validate()
        assert inp.mode.name == "LOAD"
        inp.count_or_load(quiet=True)
    assert (ti.mer_len, ti.canonical) == (ji.mer_len, ji.canonical) \
        == (27, False)
    assert ti.table.capacity == ji.table.capacity
    jk, jv = jc.table_to_numpy(ji.table)
    tk, tv = tc.table_to_numpy(ti.table)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)
    ti.validate_mer_len(27)
    with pytest.raises(ValueError, match="different K-mer lengths"):
        ti.validate_mer_len(21)


def test_input_dump_matches_jax(tmp_path, pinned):
    """COUNT mode writes the table as a .jf; LOAD mode links the input."""
    fq = tmp_path / "reads.fq"
    rng = np.random.default_rng(4)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (60, 80))]
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 80)
                            for i, s in enumerate(seq)))
    ji = jcommon.Input(paths=[str(fq)], mer_len=21)
    ti = tcommon.Input(paths=[str(fq)], mer_len=21, device=CPU)
    for inp, name in ((ji, "j.jf21"), (ti, "t.jf21")):
        inp.validate()
        inp.count_or_load(quiet=True)
        inp.dump(str(tmp_path / name), quiet=True)
    assert (tmp_path / "t.jf21").read_bytes() == \
        (tmp_path / "j.jf21").read_bytes()
    assert ti.header.size == ji.header.size

    loaded = tcommon.Input(paths=[str(tmp_path / "t.jf21")], device=CPU)
    loaded.validate()
    loaded.count_or_load(quiet=True)
    link = tmp_path / "link.jf21"
    loaded.dump(str(link))
    assert link.is_symlink() and link.read_bytes() == \
        (tmp_path / "t.jf21").read_bytes()
    tk, tv = tc.table_to_numpy(loaded.table)
    ck, cv = tc.table_to_numpy(ti.table)
    np.testing.assert_array_equal(tk, ck)
    np.testing.assert_array_equal(tv, cv)


def test_input_load_of_wide_keys_raises(tmp_path):
    """LOAD of a .jf of wide keys builds kat_tpu's table; a .jf whose keys
    are wider than the reader takes (k > 256) raises."""
    path = str(tmp_path / "wide.jf40")
    jjf.write_jf(path, [1 << 70, 5, 3 << 60], np.array([1, 2, 7]), 40, True)
    ji = jcommon.Input(paths=[path])
    ti = tcommon.Input(paths=[path], device=CPU)
    for inp in (ji, ti):
        inp.validate()
        inp.count_or_load(quiet=True)
    assert ti.mer_len == ji.mer_len == 40
    assert ti.table.capacity == ji.table.capacity == 4
    jkeys, jv = jwide.table_to_numpy(ji.table)
    tkeys, tv = twide.table_to_numpy(ti.table)
    assert tkeys == jkeys == [5, 3 << 60, 1 << 70]
    np.testing.assert_array_equal(tv, jv)
    too_wide = str(tmp_path / "w.jf257")
    jjf.write_jf(too_wide, [1 << 65], np.array([1]), 257, True)
    inp = tcommon.Input(paths=[too_wide], device=CPU)
    inp.validate()
    with pytest.raises(ValueError, match="key_len 514"):
        inp.count_or_load(quiet=True)
