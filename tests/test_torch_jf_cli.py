"""`python -m kat_tpu_torch.jf_cli` (the `kat_jellyfish` utilities) against
kat_tpu.jf_cli: count, histo, dump, query, merge and stats on the same
seeded reads, stdout and files equal.  `count` runs through the port's
`Input` on the CPU (`--device cpu`); what a .jf header records about the
machine and the moment is pinned, so the files are compared byte for byte.
Where kat_tpu's utilities fail (count at k > 31; dump and query of a .jf
of k > 31), the port refuses with a ValueError that names the limit; on a
wide .jf the others (histo, stats, merge) match kat_tpu's."""

import numpy as np
import pytest
import torch

from kat_tpu import jf_cli as jjf
from kat_tpu.io import jellyfish as jjelly
from kat_tpu_torch import cli as tcli
from kat_tpu_torch import jf_cli as tjf
from kat_tpu_torch.core import kmers

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """The host, the time and the user a .jf header records; the port's
    plots and peak analysis (the wide .jf comes from its `hist -d`)
    recorded instead of run."""
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    monkeypatch.setattr("getpass.getuser", lambda: "user")
    monkeypatch.setattr("sys.argv", ["kat_jellyfish"])
    monkeypatch.setattr(tcli, "_plot", lambda *a, **kw: None)
    monkeypatch.setattr(tcli, "_analyse_peaks", lambda *a, **kw: None)


def _reads(path, genome, rng, n, length=120):
    with open(path, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - length, n)):
            s = genome[o:o + length].copy()
            if rng.random() < 0.05:
                s[rng.integers(0, length)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * length))
    return str(path)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two halves of one read set over a 2500-base genome (~12x
    together), with a few Ns."""
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(29)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2500)]
    return (_reads(d / "a.fq", genome, rng, 130),
            _reads(d / "b.fq", genome, rng, 130))


def _both(capsys, argv, jout=None, tout=None):
    """Run argv through both CLIs (the port's with --device cpu); output
    file paths given as jout/tout replace '{out}'.  Returns (rc, stdout,
    stderr) of each."""
    res = []
    for main, head, out in ((jjf.main, [], jout), (tjf.main,
                                                   ["--device", "cpu"],
                                                   tout)):
        args = [out if a == "{out}" else a for a in argv]
        rc = main([*head, *args])
        cap = capsys.readouterr()
        res.append((rc, cap.out, cap.err))
    return res


@pytest.fixture(scope="module")
def counted(tmp_path_factory, reads):
    """count -m 27 of the two halves and of both, canonical (-C) and not,
    through both CLIs."""
    d = tmp_path_factory.mktemp("counted")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("socket.gethostname", lambda: "host")
        mp.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
        mp.setattr("sys.argv", ["kat_jellyfish"])
        for tag, files in (("a", reads[:1]), ("b", reads[1:]),
                           ("ab", list(reads))):
            for canon in ("C", "N"):
                flags = ["-C"] if canon == "C" else []
                for side, main, head in (("j", jjf.main, []),
                                         ("t", tjf.main,
                                          ["--device", "cpu"])):
                    out = str(d / f"{side}_{tag}{canon}.jf")
                    assert main([*head, "count", "-m", "27", *flags, "-s",
                                 "5000", "-o", out, *files]) == 0
    return d


@pytest.mark.parametrize("canon", ["C", "N"])
def test_count_matches_jax(counted, canon):
    for tag in ("a", "b", "ab"):
        jp, tp = (str(counted / f"{s}_{tag}{canon}.jf") for s in "jt")
        jh, jk, jc = jjelly.read_jf(jp)
        th, tk, tc = jjelly.read_jf(tp)
        assert np.array_equal(tk, jk) and np.array_equal(tc, jc)
        assert len(jk) > 1000
        assert {k: v for k, v in vars(th).items() if k != "raw"} == \
            {k: v for k, v in vars(jh).items() if k != "raw"}
        assert th.canonical == (canon == "C")
        with open(jp, "rb") as f:
            jb = f.read()
        with open(tp, "rb") as f:
            tb = f.read()
        assert tb == jb  # the machine and the moment pinned


@pytest.mark.parametrize("argv", [
    ["histo", "{db}"], ["histo", "-f", "-l", "2", "-h", "9", "-i", "3",
                        "{db}"],
    ["histo", "-h", "1", "-l", "3", "{db}"],
    ["stats", "{db}"], ["stats", "-L", "2", "-U", "5", "{db}"],
    ["dump", "{db}"], ["dump", "-c", "-t", "-L", "3", "{db}"],
    ["dump", "-c", "-U", "1", "{db}"],
], ids=["histo", "histo_full_range", "histo_bad_range", "stats",
        "stats_range", "dump", "dump_column_tab_low", "dump_upper"])
@pytest.mark.parametrize("canon", ["C", "N"])
def test_readers_match_jax(counted, capsys, argv, canon):
    db = str(counted / f"t_ab{canon}.jf")
    (jrc, jout, jerr), (trc, tout, terr) = _both(
        capsys, [db if a == "{db}" else a for a in argv])
    assert (trc, tout, terr) == (jrc, jout, jerr)
    assert tout or trc == 1


@pytest.mark.parametrize("mode", ["histo", "stats", "dump"])
def test_output_files_match_jax(counted, tmp_path, capsys, mode):
    db = str(counted / "t_abC.jf")
    jo, to = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    (jrc, jout, _), (trc, tout, _) = _both(
        capsys, [mode, "-o", "{out}", db], jo, to)
    assert trc == jrc == 0 and tout == jout == ""
    with open(jo) as f:
        want = f.read()
    with open(to) as f:
        assert f.read() == want
    assert want


@pytest.mark.parametrize("canon", ["C", "N"])
def test_query_matches_jax(counted, capsys, canon):
    """Present and absent k-mers, both strands; a mer of the wrong length
    stops with rc 1 after the lines before it."""
    db = str(counted / f"t_ab{canon}.jf")
    _h, keys, counts = jjelly.read_jf(db)
    rng = np.random.default_rng(3)
    present = [kmers.unpack_string(int(v), 27)
               for v in keys[rng.integers(0, keys.size, 20)]]
    rc_of = ["".join("TGCA"["ACGT".index(b)] for b in reversed(m))
             for m in present[:8]]
    absent = ["".join("ACGT"[c] for c in rng.integers(0, 4, 27))
              for _ in range(12)]
    mers = present + rc_of + absent
    res = _both(capsys, ["query", db, *mers])
    assert res[1] == res[0]
    got = dict(ln.split(" ") for ln in res[1][1].splitlines())
    assert sum(int(v) > 0 for v in got.values()) >= 20
    bad = _both(capsys, ["query", db, present[0], "ACGT"])
    assert bad[1] == bad[0] and bad[1][0] == 1


def test_merge_matches_jax(counted, tmp_path, capsys):
    """merge of the halves' tables: kat_tpu's bytes, and the table that
    counting both halves gives."""
    a, b = str(counted / "t_aC.jf"), str(counted / "t_bC.jf")
    jo, to = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
    res = _both(capsys, ["merge", "-o", "{out}", a, b], jo, to)
    assert res[1] == res[0] == (0, "", "")
    with open(jo, "rb") as f:
        want = f.read()
    with open(to, "rb") as f:
        assert f.read() == want
    _h, mk, mc = jjelly.read_jf(to)
    _h, bk, bc = jjelly.read_jf(str(counted / "t_abC.jf"))
    assert np.array_equal(mk, bk) and np.array_equal(mc, bc)


def test_merge_refuses_another_k(counted, tmp_path, capsys, reads):
    other = str(tmp_path / "k25.jf")
    assert tjf.main(["--device", "cpu", "count", "-m", "25", "-C", "-o",
                     other, reads[0]]) == 0
    res = _both(capsys, ["merge", "-o", str(tmp_path / "m.jf"),
                         str(counted / "t_aC.jf"), other])
    assert res[1] == res[0] and res[1][0] == 1
    assert "different k" in res[1][2]


def test_count_past_k31_is_refused(tmp_path, reads):
    """kat_tpu's count dies writing a wide table (it calls the narrow
    table_to_numpy on it); the port refuses before counting."""
    with pytest.raises(AttributeError, match="keys_hi"):
        jjf.main(["count", "-m", "41", "-C", "-o", str(tmp_path / "j.jf"),
                  reads[0]])
    with pytest.raises(ValueError, match="k <= 31"):
        tjf.main(["--device", "cpu", "count", "-m", "41", "-C", "-o",
                  str(tmp_path / "t.jf"), reads[0]])
    assert not (tmp_path / "t.jf").exists()


def test_count_without_a_card_raises(tmp_path, reads, monkeypatch):
    """No --device means the card; without one count raises before it
    reads anything and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for head in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tjf.main([*head, "count", "-m", "27", "-o",
                      str(tmp_path / "t.jf"), reads[0]])
    assert not (tmp_path / "t.jf").exists()


@pytest.fixture(scope="module")
def wide_jf(tmp_path_factory, reads):
    """The .jf of 41-mers that the port's `kat hist -m 41 -d` dumps, for
    each half."""
    d = tmp_path_factory.mktemp("wide")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, "_plot", lambda *a, **kw: None)
        mp.setattr(tcli, "_analyse_peaks", lambda *a, **kw: None)
        for tag, fq in zip("ab", reads):
            assert tcli.main(["--device", "cpu", "hist", "-m", "41", "-d",
                              "-o", str(d / tag), fq]) == 0
    return str(d / "a-hash.jf41"), str(d / "b-hash.jf41")


@pytest.mark.parametrize("argv", [
    ["histo", "{db}"], ["histo", "-f", "-h", "20", "{db}"],
    ["stats", "{db}"], ["stats", "-L", "2", "{db}"],
], ids=["histo", "histo_full", "stats", "stats_low"])
def test_readers_of_a_wide_jf_match_jax(wide_jf, capsys, argv):
    res = _both(capsys, [wide_jf[0] if a == "{db}" else a for a in argv])
    assert res[1] == res[0] and res[1][0] == 0 and res[1][1]


def test_merge_of_wide_jfs_matches_jax(wide_jf, tmp_path, capsys):
    jo, to = str(tmp_path / "j.jf"), str(tmp_path / "t.jf")
    res = _both(capsys, ["merge", "-o", "{out}", *wide_jf], jo, to)
    assert res[1] == res[0] == (0, "", "")
    with open(jo, "rb") as f:
        want = f.read()
    with open(to, "rb") as f:
        assert f.read() == want
    h, _keys, counts = jjelly.read_jf(to)
    assert h.mer_len == 41 and int(counts.sum()) > 1000


@pytest.mark.parametrize("argv", [["dump", "-c", "{db}"],
                                  ["query", "{db}", "A" * 41]],
                         ids=["dump", "query"])
def test_dump_and_query_of_a_wide_jf_are_refused(wide_jf, capsys, argv):
    """kat_tpu's dump and query die on the list of wide keys that read_jf
    returns; the port's refuse, naming the limit."""
    args = [wide_jf[0] if a == "{db}" else a for a in argv]
    with pytest.raises(AttributeError, match="tolist"):
        jjf.main(args)
    with pytest.raises(ValueError, match="k <= 31"):
        tjf.main(["--device", "cpu", *args])
    assert capsys.readouterr().out == ""
