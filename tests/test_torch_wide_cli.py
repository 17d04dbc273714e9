"""Wide keys (k > 31) through kat_tpu_torch's command line against kat_tpu:
`hist -m 33` and `hist -m 41` (canonical, and non-canonical once), the
`.jf` that `-d` dumps, `hist` of that `.jf` (LOAD), and `sect -m 41`, all
byte-identical.  kat_tpu runs its Histogram tool (what its CLI's `hist`
writes; the CLI would also plot) and its CLI's `sect` in this process on
the CPU; the port runs its CLI with `--device cpu`."""

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu.tools import hist as jhist
from kat_tpu_torch import cli as tcli

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SECT_ARTIFACTS = ("-counts.cvg", "-stats.tsv", "-contamination.mx",
                  "-counts.gc", "-non_repetitive.fa", "-repetitive.fa")


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """What a dumped .jf header records about the machine and the moment;
    the port's plots and peak analysis recorded instead of run
    (test_torch_default_cli.py runs them).  Returns those calls, each a
    flat tuple of its arguments."""
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    monkeypatch.setattr("getpass.getuser", lambda: "user")
    monkeypatch.setattr("sys.argv", ["kat"])
    calls = []
    monkeypatch.setattr(tcli, "_plot", lambda mode, argv, quiet=False:
                        calls.append((mode, *argv)))
    monkeypatch.setattr(tcli, "_analyse_peaks", lambda *a, **kw:
                        calls.append(("peaks", *a, *kw.values())))
    return calls


def hist_calls(prefix) -> list:
    """What kat_tpu's `hist -o prefix` plots and analyses."""
    return [("spectra-hist", f"--output={prefix}.png", str(prefix)),
            ("peaks", str(prefix), str(prefix), "Analysing peaks", False)]


def _write_inputs(tmp_path, seed):
    """Reads covering a 4000-base genome several times over (a few with an
    N), and contigs of that genome: shorter than k, with an N, with a
    repeat, in few 64-base length buckets."""
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)]
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as f:
        for i, o in enumerate(rng.integers(0, 4000 - 120, 400)):
            s = genome[o:o + 120].copy()
            if rng.random() < 0.05:
                s[rng.integers(0, 120)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 120))
    fa = tmp_path / "asm.fa"
    with open(fa, "wb") as f:
        for i, (a, b) in enumerate([(0, 30), (100, 220), (900, 1015),
                                    (2000, 2125), (3000, 3118)]):
            s = genome[a:b].copy()
            if i == 2:
                s[60] = ord("N")
                s[70:100] = s[0:30]
            f.write(b">c%d\n" % i)
            for o in range(0, s.size, 70):
                f.write(s[o:o + 70].tobytes() + b"\n")
    return str(fa), str(fq)


def _jax_hist(tmp_path, paths, k, canonical=True, dump=False):
    h = jhist.Histogram(paths, 1, 10000, 1)
    h.output_prefix = str(tmp_path / "j.hist")
    h.input.mer_len = k
    h.input.canonical = canonical
    h.input.dump_hash = dump
    h.quiet = True
    h.execute()
    h.save()
    return tmp_path / "j.hist"


@pytest.mark.parametrize("k,canonical", [(33, True), (41, True),
                                         (41, False)])
def test_wide_hist_dump_and_load_match_jax(tmp_path, k, canonical, pinned):
    """hist -d: the histogram and the dumped .jf equal kat_tpu's byte for
    byte; hist of that .jf (LOAD, k from the file) gives the histogram."""
    _fa, fq = _write_inputs(tmp_path, seed=k)
    want = _jax_hist(tmp_path, [fq], k, canonical, dump=True)
    got = tmp_path / "t.hist"
    flags = [] if canonical else ["-N"]
    assert tcli.main(["--device", "cpu", "hist", "-m", str(k), *flags,
                      "-d", "-o", str(got), fq]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert want.read_text().count("\n") > 10
    jf = tmp_path / f"t.hist-hash.jf{k}"
    assert jf.read_bytes() == (tmp_path / f"j.hist-hash.jf{k}").read_bytes()
    loaded = tmp_path / "l.hist"
    assert tcli.main(["--device", "cpu", "hist", "-o", str(loaded),
                      str(jf)]) == 0
    assert loaded.read_text().split("###")[1] == \
        got.read_text().split("###")[1]
    assert pinned == hist_calls(got) + hist_calls(loaded)


def test_wide_sect_matches_jax(tmp_path):
    """sect -m 41 with GC stats and both region files, byte-identical."""
    fa, fq = _write_inputs(tmp_path, seed=4)
    flags = ["-m", "41", "-g", "-E", "-F"]
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcli.main(["sect", *flags, "-o", jp, fa, fq]) == 0
    assert tcli.main(["--device", "cpu", "sect", *flags, "-o", tp, fa,
                      fq]) == 0
    for suffix in SECT_ARTIFACTS:
        want = (tmp_path / ("j" + suffix)).read_bytes()
        assert (tmp_path / ("t" + suffix)).read_bytes() == want, suffix
        assert len(want) > 10
    cvg = (tmp_path / "t-counts.cvg").read_text()
    assert any(v not in ("0", "1") for v in cvg.split())  # repeats counted
