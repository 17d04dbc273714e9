"""The default runs of `hist`, `gcp`, `comp` and `cold` through both command
lines, with their plots and peak analysis run for real: every file that
kat_tpu's default run writes, the PNGs and `.dist_analysis.json` among
them, the port writes byte for byte.  Each CLI writes into a directory of
its own under the same prefix, from the same inputs, so that a path in a
title or label cannot hide a difference; stdout is compared too, with
timings masked and the directory mapped.

The reads cover a 12 kbp genome ~20x with 0.4% substitution errors, so
the spectra have an error tail and a homozygous peak that the analysis
fits (and then plots).  comp runs its three branches: the spectra-cn
default (analysis of the matrix), `-n` (density plot, no analysis) and
`-n -h` (density plot, analysis of both histograms)."""

import re

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu_torch import cli as tcli

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _reads(path, genome, rng, n, length=150, err=0.004):
    with open(path, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - length, n)):
            s = genome[o:o + length].copy()
            hit = rng.random(length) < err
            s[hit] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, int(hit.sum()))]
            if rng.random() < 0.02:
                s[rng.integers(0, length)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * length))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two read draws of one genome (~20x and ~10x) and the genome as
    four contigs."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(41)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 12_000)]
    a = _reads(d / "a.fq", genome, rng, 2000)
    b = _reads(d / "b.fq", genome, rng, 1000)
    fa = d / "asm.fa"
    with open(fa, "wb") as f:
        for i, (s, e) in enumerate([(0, 3100), (3000, 7000), (7000, 9500),
                                    (9400, 12_000)]):
            f.write(b">c%d\n" % i)
            for o in range(s, e, 70):
                f.write(genome[o:min(o + 70, e)].tobytes() + b"\n")
    return dict(a=a, b=b, asm=str(fa))


CASES = {
    "hist": ["hist", "-m", "27", "{a}"],
    "hist_k41": ["hist", "-m", "41", "{a}"],
    "gcp": ["gcp", "{a}"],
    "comp": ["comp", "{a}", "{asm}"],
    "comp_density": ["comp", "-n", "{a}", "{asm}"],
    "comp_density_hists": ["comp", "-n", "-h", "{a}", "{b}"],
    "cold": ["cold", "{asm}", "{a}"],
}
# what each default run must leave beside its text artifacts
EXPECT = {
    "hist": ("x.png", "x.dist_analysis.json",
             "x.kmerfreq_distributions.png"),
    "hist_k41": ("x.png", "x.dist_analysis.json",
                 "x.kmerfreq_distributions.png"),
    "gcp": ("x.mx.png", "x.dist_analysis.json",
            "x.kmerfreq_distributions.png", "x.gc_distributions.png"),
    "comp": ("x-main.mx.spectra-cn.png", "x.dist_analysis.json",
             "x.kmerfreq_general.png"),
    "comp_density": ("x-main.mx.density.png",),
    "comp_density_hists": ("x-main.mx.density.png",
                           "x.1.dist_analysis.json",
                           "x.2.dist_analysis.json"),
    "cold": ("x.png",),
}


def _run(main, head, d, argv, inputs, capfd):
    d.mkdir()
    args = [inputs[a[1:-1]] if a.startswith("{") else a for a in argv]
    assert main([*head, args[0], "-o", str(d / "x"), *args[1:]]) == 0
    cap = capfd.readouterr()
    out = re.sub(r"\d+\.\d+s\b", "<t>s", cap.out.replace(str(d), "<dir>"))
    return out, cap.err


@pytest.mark.parametrize("case", list(CASES))
def test_default_run_matches_jax(tmp_path, inputs, capfd, case):
    jout, jerr = _run(jcli.main, [], tmp_path / "j", CASES[case], inputs,
                      capfd)
    tout, terr = _run(tcli.main, ["--device", "cpu"], tmp_path / "t",
                      CASES[case], inputs, capfd)
    want = {p.name: p.read_bytes() for p in (tmp_path / "j").iterdir()}
    got = {p.name: p.read_bytes() for p in (tmp_path / "t").iterdir()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert set(EXPECT[case]) <= set(want)
    for err in (jerr, terr):
        assert "failed" not in err and "ERROR" not in err
    assert tout == jout
