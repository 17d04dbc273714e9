"""The port's plots (kat_tpu_torch/plot) against kat_tpu's: each of the six
modes renders the same seeded artifact, copied into two directories under
the same basename, once through kat_tpu's `run_plot` and once through the
port's, by `run_plot` and by the `plot` subcommand of its command line
(`python -m kat_tpu_torch plot <mode>`).  The files must be byte-identical:
both packages draw with this process's matplotlib.  Modes that read k
(spectra-hist, density, spectra-cn, spectra-mx) run at k = 27 and 41."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kat_tpu.plot import run_plot as jax_run_plot
from kat_tpu_torch import cli as tcli
from kat_tpu_torch.plot import run_plot as torch_run_plot
from test_torch_analysis import write_gcp, write_hist, write_spectra_cn

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_cvg(path, _k, seed):
    """A `kat sect` -counts.cvg: three sequences' per-window counts."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, n in enumerate((400, 90, 1200)):
            c = rng.poisson(20 + 15 * np.sin(np.arange(n) / 40.0))
            c[rng.integers(0, n, n // 20)] = 0
            f.write(f">contig{i}\n" + " ".join(map(str, c)) + "\n")
    return str(path)


def write_cold_stats(path, _k, seed):
    """A `kat cold` -stats.tsv: 80 contigs' read coverage, copy number
    (1..8), GC and length."""
    rng = np.random.default_rng(seed)
    lines = ["seq_name\tread_median_cvg\tread_mean_cvg\tasm_cn\tgc%\t"
             "seq_length\tkmers_in_seq\tinvalid_kmers\t%_invalid\t"
             "non_zero_kmers\t%_non_zero\t%_non_zero_corrected"]
    for i in range(80):
        cn = int(rng.integers(1, 9))
        med = float(rng.poisson(25 * cn))
        n = int(rng.integers(200, 20000))
        lines.append(f"contig{i}\t{med:g}\t{med + rng.random():.5f}\t{cn}\t"
                     f"{rng.uniform(0.3, 0.6):.5f}\t{n}\t{n - 26}\t0\t0\t"
                     f"{n - 30}\t99.8\t99.8")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


# mode -> (artifact name, writer, extra plot flags, whether k matters)
MODES = {
    "spectra-hist": ("x.hist", write_hist, [], True),
    "density": ("x.mx", write_gcp, [], True),
    "spectra-cn": ("x-main.mx", write_spectra_cn, [], True),
    "spectra-mx": ("x-main.mx", write_spectra_cn, ["--intersection"], True),
    "profile": ("x-counts.cvg", write_cvg, ["-n", "0,2"], False),
    "cold": ("x-stats.tsv", write_cold_stats, [], False),
}
CASES = [(m, k) for m, (_n, _w, _f, by_k) in MODES.items()
         for k in ((27, 41) if by_k else (27,))]


def _render(d, mode, k, run):
    """Write mode's artifact into d and plot it to d/x.png with run."""
    name, write, flags, _by_k = MODES[mode]
    d.mkdir()
    src = write(d / name, k, 11)
    run(mode, [f"--output={d / 'x.png'}", *flags, src])
    return (d / "x.png").read_bytes()


def _cli(mode, argv):
    assert tcli.main(["plot", mode, *argv]) == 0


@pytest.mark.parametrize("route", ["run_plot", "cli"])
@pytest.mark.parametrize("mode,k", CASES,
                         ids=[f"{m}_k{k}" for m, k in CASES])
def test_plot_matches_jax(tmp_path, mode, k, route):
    want = _render(tmp_path / "j", mode, k, jax_run_plot)
    got = _render(tmp_path / "t", mode, k,
                  torch_run_plot if route == "run_plot" else _cli)
    assert want[:8] == b"\x89PNG\r\n\x1a\n"
    assert got == want


def test_plot_module_entry_point(tmp_path):
    """`python -m kat_tpu_torch plot spectra-hist` in a process of its own
    (no --device: plotting touches none) writes kat_tpu's bytes."""
    want = _render(tmp_path / "j", "spectra-hist", 27, jax_run_plot)
    d = tmp_path / "t"
    d.mkdir()
    src = write_hist(d / "x.hist", 27, 11)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "kat_tpu_torch", "plot", "spectra-hist",
         f"--output={d / 'x.png'}", src], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (d / "x.png").read_bytes() == want


def test_unknown_plot_mode_raises():
    with pytest.raises(ValueError, match="Unknown plot mode"):
        torch_run_plot("histogram", [])
    with pytest.raises(SystemExit):
        tcli.main(["plot", "histogram"])
