"""The port's peak analysis (kat_tpu_torch/analysis) against kat_tpu's: the
same seeded artifacts go through both `distanalysis.main` calls, each in a
directory of its own under the same basenames, so that any difference in
the bytes is a real one.  The `.dist_analysis.json` files and every figure
must be byte-identical and stdout equal, with only the `Time taken:`
value masked and the directory mapped.  The helpers (`spectra_helper`) and
the peak model (`peak`) are held against kat_tpu's directly, tolerance 0.

The artifacts are written here with numpy in the mme format the tools
write (the same headers): a k-mer spectrum with error, heterozygous and
homozygous peaks, a gcp `.mx`, a spectra-cn `-main.mx` and a spectrum
with no peak.  test_torch_plot.py renders the same artifacts."""

import re
from math import comb

import numpy as np
import pytest
import torch

from kat_tpu.analysis import distanalysis as jda
from kat_tpu.analysis import peak as jpeak
from kat_tpu.analysis import spectra_helper as jsh
from kat_tpu_torch.analysis import distanalysis as tda
from kat_tpu_torch.analysis import peak as tpeak
from kat_tpu_torch.analysis import spectra_helper as tsh

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

FREQS = 10001  # the hist's bins 1..10001 (kat hist's defaults)


def _spectrum(rng, n, err=3e5, het=4e4, hom=8e4, hom_mean=30.0):
    """Poisson draws of a k-mer spectrum at frequencies 1..n: an error
    tail at 1x, a heterozygous peak at half the homozygous mean and the
    homozygous peak (any of the three may be switched off with 0)."""
    f = np.arange(1, n + 1, dtype=float)
    lam = (err * np.exp(-(f - 1) / 1.3)
           + het * np.exp(-(f - hom_mean / 2) ** 2 / (2 * (hom_mean / 8) ** 2))
           + hom * np.exp(-(f - hom_mean) ** 2 / (2 * (hom_mean / 5) ** 2)))
    return rng.poisson(lam)


def write_hist(path, k, seed, peaks=True):
    """A `kat hist` artifact; without peaks a plain error tail."""
    rng = np.random.default_rng(seed)
    counts = (_spectrum(rng, FREQS) if peaks
              else _spectrum(rng, FREQS, het=0, hom=0))
    lines = [f"# Title:{k}-mer spectra for: reads.fq",
             f"# XLabel:{k}-mer frequency", f"# YLabel:# distinct {k}-mers",
             f"# Kmer value:{k}", "# Input 1:reads.fq", "###"]
    lines += [f"{i + 1} {int(c)}" for i, c in enumerate(counts)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _mx_text(header: list[str], mx: np.ndarray) -> str:
    rows = [" ".join(map(str, r)) for r in mx.tolist()]
    return "\n".join(header + rows) + "\n"


def write_gcp(path, k, seed, cols=1001):
    """A `kat gcp` matrix: GC count 0..k-1 by k-mer frequency 0..cols-1,
    the spectrum spread over a binomial GC distribution."""
    rng = np.random.default_rng(seed)
    spec = np.concatenate([[0], _spectrum(rng, cols - 1)]).astype(float)
    gc = np.array([comb(k, g) * 0.42 ** g * 0.58 ** (k - g)
                   for g in range(k)])
    mx = rng.poisson(np.outer(gc, spec))
    header = ["# Title:K-mer coverage vs GC count plot for: reads.fq",
              f"# XLabel:{k}-mer frequency", "# YLabel:GC count",
              f"# ZLabel:# distinct {k}-mers", f"# Columns:{cols}",
              f"# Rows:{k}", f"# MaxVal:{int(mx.max())}", "# Transpose:0",
              f"# Kmer value:{k}", "# Input 1:reads.fq", "###"]
    path.write_text(_mx_text(header, mx))
    return str(path)


def write_spectra_cn(path, k, seed, rows=1001, cols=11):
    """A `kat comp` -main.mx of reads against an assembly: a line per read
    frequency 0..rows-1, a column per copy number in the assembly
    0..cols-1 (comp -j 11).  Errors are absent from the assembly, half of
    the heterozygous k-mers too, the homozygous ones present once, and a
    repeat peak at twice the homozygous mean present twice."""
    rng = np.random.default_rng(seed)
    f = np.arange(rows, dtype=float)
    err = 3e5 * np.exp(-(f - 1) / 1.3) * (f > 0)
    het = 4e4 * np.exp(-(f - 15) ** 2 / (2 * 3.75 ** 2))
    hom = 8e4 * np.exp(-(f - 30) ** 2 / (2 * 6.0 ** 2))
    rep = 6e3 * np.exp(-(f - 60) ** 2 / (2 * 8.0 ** 2))
    lam = np.zeros((rows, cols))
    lam[:, 0] = err + het / 2 + hom * 0.02
    lam[:, 1] = het / 2 + hom * 0.98
    lam[:, 2] = rep
    lam[:, 3] = rep * 0.1
    mx = rng.poisson(lam)
    header = ["# Title:K-mer comparison plot",
              f"# XLabel:{k}-mer frequency for: reads.fq",
              f"# YLabel:{k}-mer frequency for: asm.fa",
              f"# ZLabel:# distinct {k}-mers", f"# Columns:{cols}",
              f"# Rows:{rows}", f"# MaxVal:{int(mx.max())}",
              "# Transpose:1", f"# Kmer value:{k}", "# Input 1:reads.fq",
              "# Input 2:asm.fa", "###"]
    path.write_text(_mx_text(header, mx))
    return str(path)


ARTIFACTS = {
    "hist": ("x.hist", lambda p, k, s: write_hist(p, k, s)),
    "hist_no_peak": ("x.hist", lambda p, k, s: write_hist(p, k, s, False)),
    "gcp": ("x.mx", write_gcp),
    "spectra_cn": ("x-main.mx", write_spectra_cn),
}


def files_of(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def both_analyses(tmp_path, capsys, kind, k, seed, argv_head):
    """distanalysis.main of kat_tpu in tmp_path/j and of the port in
    tmp_path/t on copies of one artifact; returns both directories and
    both stdouts, the directory mapped and the time masked."""
    name, write = ARTIFACTS[kind]
    outs = {}
    for side, main in (("j", jda.main), ("t", tda.main)):
        d = tmp_path / side
        d.mkdir()
        src = write(d / name, k, seed)
        assert main([*argv_head, f"--output_prefix={d / 'x'}", src]) == 0
        text = capsys.readouterr().out.replace(str(d), "<dir>")
        outs[side] = re.sub(r"Time taken:  [0-9.]+s", "Time taken: <t>s",
                            text)
    return tmp_path / "j", tmp_path / "t", outs


@pytest.mark.parametrize("kind,k,argv_head", [
    ("hist", 27, ["--from_kat"]),
    ("hist", 41, ["--from_kat", "--verbose"]),
    ("hist", 27, []),
    ("hist_no_peak", 27, ["--from_kat"]),
    ("gcp", 27, ["--from_kat"]),
    ("gcp", 41, ["--from_kat"]),
    ("spectra_cn", 27, ["--from_kat"]),
], ids=["hist_k27", "hist_k41_verbose", "hist_banner", "no_peak",
        "gcp_k27", "gcp_k41", "spectra_cn_k27"])
def test_distanalysis_matches_jax(tmp_path, capsys, kind, k, argv_head):
    jd, td, outs = both_analyses(tmp_path, capsys, kind, k, 7, argv_head)
    want, got = files_of(jd), files_of(td)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert outs["t"] == outs["j"]
    assert "x.dist_analysis.json" in want
    pngs = [n for n in want if n.endswith(".png")]
    if kind == "hist_no_peak":
        assert not pngs
        assert "No peaks" in outs["t"]
    else:
        assert pngs  # the fitted peaks were plotted
        assert "ERROR" not in outs["t"]


def test_the_fitted_homozygous_peak_is_where_the_model_put_it(tmp_path,
                                                               capsys):
    """The spectrum's homozygous peak (mean 30x) comes back from the
    port's fit within 1.5x, the heterozygous one (15x) beside it."""
    import json

    _jd, td, _outs = both_analyses(tmp_path, capsys, "hist", 27, 3,
                                   ["--from_kat"])
    stats = json.loads((td / "x.dist_analysis.json").read_text())
    peaks = stats["peaks"]
    assert stats["nb_peaks"] == len(peaks) == 2
    assert abs(peaks[stats["hom_peak"]["index"] - 1]["mean_freq"] - 30) < 1.5
    assert abs(peaks[0]["mean_freq"] - 15) < 1.5


def _hist_pairs(seed, n=200):
    rng = np.random.default_rng(seed)
    return [(i + 1, int(v)) for i, v in enumerate(_spectrum(rng, n))]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_spectra_helper_matches_jax(tmp_path, seed):
    h = _hist_pairs(seed)
    flat = [(i, 5) for i in range(1, 30)]
    falling = [(i, 100 - i) for i in range(1, 60)]
    for histo in (h, flat, falling, h[:3], []):
        assert tsh.find_first_min(histo) == jsh.find_first_min(histo)
        assert tsh.find_first_min(histo, True) == \
            jsh.find_first_min(histo, True)
        assert tsh.find_peak(histo) == jsh.find_peak(histo)
        assert tsh.find_peak(histo, False) == jsh.find_peak(histo, False)
        if histo:
            assert tsh.lim97(histo) == jsh.lim97(histo)
    path = write_hist(tmp_path / "x.hist", 27, seed)
    assert tsh.load_hist(path) == jsh.load_hist(path)
    bad = tmp_path / "bad.hist"
    bad.write_text("1 2\n3\n")
    for mod in (tsh, jsh):
        with pytest.raises(ValueError, match="line 2"):
            mod.load_hist(str(bad))


@pytest.mark.parametrize("seed", [4, 5])
def test_peak_model_matches_jax(seed):
    """gaussian, create_model, and a soft-l1 fit of one peak below an
    error boundary: exactly kat_tpu's numbers."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 99, 100)
    assert np.array_equal(tpeak.gaussian(x, 30.5, 4.2),
                          jpeak.gaussian(x, 30.5, 4.2))
    assert np.array_equal(tpeak.create_model(x, 30.5, 4.2, 7e4),
                          jpeak.create_model(x, 30.5, 4.2, 7e4))
    hist = _spectrum(rng, 100, err=2e5, het=0).astype(float)
    fits = []
    for mod in (tpeak, jpeak):
        p = mod.Peak(29.0, 5.0, float(hist[29]), True, "hom")
        p.optimise(hist, fmin=4)
        fits.append((p.mean(), p.stddev(), p.peak(), p.elements(),
                     p.left(), p.right(), str(p), p.to_row(), p.Ty.tolist()))
    assert fits[0] == fits[1]
    assert tpeak.Peak.header() == jpeak.Peak.header()
    with pytest.raises(RuntimeError):
        tpeak.Peak(1, 1, 1, False).optimise([])
