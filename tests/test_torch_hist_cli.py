"""`kat hist` in kat_tpu_torch against kat_tpu: the hist artifacts written
for the same synthetic FASTQ must be byte-identical.  Both sides run their
Histogram tool (kat_tpu's CLI would also plot); the port's CLI runs once.
Inputs cover the native reader (plain and gz FASTQ) and the Python reader
(a gz stream through a `gen:` pipe).  Where both CLIs run, their plots and
peak analysis are recorded instead of run (test_torch_default_cli.py runs
them) and must be the same calls."""

import gzip

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu.io import jellyfish
from kat_tpu.tools import hist as jhist
from kat_tpu_torch import cli as tcli
from kat_tpu_torch.tools import hist as thist

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _write_fastq(path, seed, n_reads=300, read_len=150, gz=False):
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2500)]
    off = rng.integers(0, genome.size - read_len, n_reads)
    seqs = genome[off[:, None] + np.arange(read_len)]
    noisy = rng.random(n_reads) < 0.05
    seqs[noisy, rng.integers(0, read_len, noisy.sum())] = ord("N")
    text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * read_len)
                    for i, s in enumerate(seqs))
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(text)
    return str(path)


def _hist_text(mod, tmp_path, paths, k, low=1, high=10000, inc=1):
    h = mod.Histogram(paths, low, high, inc)
    h.output_prefix = str(tmp_path / f"{mod.__name__}.hist")
    h.input.mer_len = k
    h.input.hash_size = 1 << 11  # first table < distinct k-mers: it grows
    if mod is thist:
        h.input.device = torch.device("cpu")
    h.quiet = True
    h.execute()
    h.save()
    with open(h.output_prefix) as f:
        return f.read()


@pytest.mark.parametrize("k,low,high,inc", [(17, 1, 10000, 1),
                                            (27, 1, 10000, 1),
                                            (31, 1, 10000, 1),
                                            (27, 3, 60, 4)])
def test_hist_matches_jax(tmp_path, k, low, high, inc):
    fq = _write_fastq(tmp_path / "reads.fq", seed=k)
    want = _hist_text(jhist, tmp_path, [fq], k, low, high, inc)
    got = _hist_text(thist, tmp_path, [fq], k, low, high, inc)
    assert got == want
    assert want.count("\n") > 6


@pytest.mark.parametrize("reader", ["native_gz", "python_gz"])
def test_hist_gz_inputs_match_jax(tmp_path, reader):
    gz = _write_fastq(tmp_path / "reads.fq.gz", seed=5, gz=True)
    path = gz if reader == "native_gz" else f"gen:cat {gz}"
    want = _hist_text(jhist, tmp_path, [path], 27)
    got = _hist_text(thist, tmp_path, [path], 27)
    assert got == want


def test_cli_hist_matches_jax(tmp_path, monkeypatch):
    """Both CLIs write the same histogram and ask for the same plot
    (spectra-hist) and peak analysis, with the output prefix mapped."""
    calls = {"j": [], "t": []}
    for side, cli in (("j", jcli), ("t", tcli)):
        monkeypatch.setattr(cli, "_plot", lambda mode, argv, quiet=False,
                            side=side: calls[side].append((mode, *argv)))
        monkeypatch.setattr(cli, "_analyse_peaks", lambda *a, side=side:
                            calls[side].append(("peaks", *a)))
    fq = _write_fastq(tmp_path / "reads.fq", seed=9)
    out, jout = tmp_path / "cli.hist", tmp_path / "jcli.hist"
    assert tcli.main(["--device", "cpu", "hist", "-m", "27", "-o", str(out),
                      fq]) == 0
    assert jcli.main(["hist", "-m", "27", "-o", str(jout), fq]) == 0
    assert out.read_text() == _hist_text(jhist, tmp_path, [fq], 27)
    assert out.read_text() == jout.read_text()
    assert calls["j"] == [
        ("spectra-hist", f"--output={jout}.png", str(jout)),
        ("peaks", str(jout), str(jout), "Analysing peaks", False)]
    assert [tuple(a.replace(str(out), str(jout)) if isinstance(a, str)
                  else a for a in c) for c in calls["t"]] == calls["j"]


def test_unported_modes_raise(tmp_path):
    """What `hist` still refuses: the bucketed flush at a wide k (outside
    its range), a k past 255, and a .jf of keys past 256 bases."""
    fq = _write_fastq(tmp_path / "reads.fq", seed=10, n_reads=20)
    with pytest.raises(ValueError, match="bucketed"):
        tcli.main(["--device", "cpu", "--flush", "bucketed", "hist", "-m",
                   "33", "-o", str(tmp_path / "b.hist"), fq])
    with pytest.raises(ValueError, match="255"):
        tcli.main(["--device", "cpu", "hist", "-m", "256", "-o",
                   str(tmp_path / "w.hist"), fq])
    jf = tmp_path / "x.jf257"
    jellyfish.write_jf(str(jf), [1 << 65, 7], np.array([2, 1]), 257, True)
    with pytest.raises(ValueError, match="key_len 514"):
        tcli.main(["--device", "cpu", "hist", "-o", str(tmp_path / "l.hist"),
                   str(jf)])
