"""`kat cold`, `kat filter kmer` and `kat filter seq` in kat_tpu_torch
against kat_tpu: every artifact written for the same synthetic reads and
contigs must be byte-identical (gzip output: its decompressed bytes, since
a gzip header records the file's name and the moment).  Both CLIs run in
this process on the CPU (the port's with `--device cpu`), at k = 27 and
k = 41, their plots recorded instead of run: both must ask for the same
ones with the same arguments (test_torch_default_cli.py runs them).  Subsampling (`-f`) draws from one
seeded generator in each tool (random.Random is pinned while both run).

On the CPU the port's lookups take the binary search; with the join policy
forced on they take the join (narrow and wide, with the plain versions of
its kernels), and the artifacts stay the same."""

import gzip
import random

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu_torch import cli as tcli
from kat_tpu_torch.core import tables

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SMALL = ["-H", "5000"]  # tables grow from 8192


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """What a dumped .jf header records about the machine and the moment;
    both CLIs' plots recorded instead of run (kat_tpu's under "j", the
    port's under "t"); one seed for both tools' subsampling
    generators."""
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    monkeypatch.setattr("getpass.getuser", lambda: "user")
    monkeypatch.setattr("sys.argv", ["kat"])
    real = random.Random
    monkeypatch.setattr(random, "Random", lambda *a: real(11))
    calls = {"j": [], "t": []}
    for side, cli in (("j", jcli), ("t", tcli)):
        monkeypatch.setattr(cli, "_plot", lambda mode, argv, quiet=False,
                            side=side: calls[side].append((mode, *argv)))
    return calls


def _fastq(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Reads of a 3000-base genome (coverage ~15, a few Ns), a mate file,
    reads of another genome (misses for filter seq), the genome as
    contigs (one of them shorter than k, one all N), and the mixed reads
    gzipped."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(23)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, 3000)]
    other = acgt[rng.integers(0, 4, 3000)]

    def draw(src, n):
        out = []
        for o in rng.integers(0, src.size - 150, n):
            s = src[o:o + 150].copy()
            if rng.random() < 0.05:
                s[rng.integers(0, 150)] = ord("N")
            out.append(s.tobytes())
        return out

    r1 = draw(genome, 300)
    mix = draw(genome, 40) + draw(other, 40)
    mates = draw(genome, 40) + draw(other, 40)
    reads = _fastq(d / "reads.fq", r1)
    seq1 = _fastq(d / "mix.fq", mix)
    seq2 = _fastq(d / "mates.fq", mates)
    gz = str(d / "mix.fq.gz")
    with open(seq1, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    fa = d / "asm.fa"
    with open(fa, "wb") as f:
        for i, (s, e) in enumerate([(0, 1200), (1150, 2600), (2600, 3000)]):
            f.write(b">c%d\n" % i)
            for o in range(s, e, 70):
                f.write(genome[o:min(o + 70, e)].tobytes() + b"\n")
        f.write(b">short\n%s\n>gap\n%s\n" % (genome[:20].tobytes(),
                                             b"N" * 60))
    return dict(reads=reads, seq1=seq1, seq2=seq2, gz=gz, asm=str(fa))


def _both(tmp_path, mode, flags, paths):
    """Run `mode` through both CLIs into tmp_path/j and tmp_path/t; returns
    the two output prefixes."""
    jp, tp = tmp_path / "j", tmp_path / "t"
    assert jcli.main([*mode, *flags, "-o", str(jp), *paths]) == 0
    assert tcli.main(["--device", "cpu", *mode, *flags, "-o", str(tp),
                      *paths]) == 0
    return jp, tp


def _same(jp, tp, suffixes, opener=open):
    for suffix in suffixes:
        with opener(f"{jp}{suffix}", "rb") as f:
            want = f.read()
        with opener(f"{tp}{suffix}", "rb") as f:
            got = f.read()
        assert got == want, suffix
        assert len(want) > 10, suffix


@pytest.mark.parametrize("k,dump", [(27, True), (41, False), (41, True)],
                         ids=["k27_dump", "k41", "k41_dump"])
def test_cold_matches_jax(tmp_path, inputs, pinned, k, dump):
    flags = [*SMALL, "-m", str(k)] + (["-d"] if dump else [])
    jp, tp = _both(tmp_path, ["cold"], flags, [inputs["asm"],
                                               inputs["reads"]])
    _same(jp, tp, ["-stats.tsv"] + ([f"-reads_hash.jf{k}",
                                     f"-asm_hash.jf{k}"] if dump else []))
    rows = (tmp_path / "t-stats.tsv").read_text().splitlines()
    assert len(rows) == 6 and rows[4].startswith("short\t0\t0.00000")
    assert pinned["j"] == [("cold", f"--output={jp}.png", f"{jp}-stats.tsv")]
    assert [tuple(a.replace(str(tp), str(jp)) for a in c)
            for c in pinned["t"]] == pinned["j"]


@pytest.mark.parametrize("k,flags", [
    (27, []), (27, ["-i"]), (27, ["-s", "-c", "10", "-d", "40"]),
    (27, ["-g", "8", "-h", "15", "-i", "-s"]),
    (41, ["-s", "-c", "12", "-g", "12", "-h", "30"]), (41, ["-i"])],
    ids=["k27", "k27_invert", "k27_separate_counts", "k27_gc_invert_sep",
         "k41_separate_counts_gc", "k41_invert"])
def test_filter_kmer_matches_jax(tmp_path, inputs, capsys, k, flags):
    jp, tp = _both(tmp_path, ["filter", "kmer"], [*SMALL, "-m", str(k),
                                                   *flags], [inputs["reads"]])
    _same(jp, tp, [f"-in.jf{k}"] + ([f"-out.jf{k}"] if "-s" in flags
                                    else []))
    out = capsys.readouterr().out
    summaries = [ln for ln in out.splitlines() if ln.startswith("K-mers ")]
    n = 3 if "-s" in flags else 2
    assert len(summaries) == 2 * n and summaries[:n] == summaries[n:]


@pytest.mark.parametrize("k,flags,paired", [
    (27, ["--stats"], False), (27, ["-i", "-s", "--stats"], False),
    (27, ["-s", "--stats", "-T", "0.5"], True),
    (27, ["-f", "0.5", "-s", "--stats"], False),
    (41, ["--stats", "-s"], True), (41, ["-i"], False),
    (41, ["-f", "0.5", "-s", "--stats"], False)],
    ids=["k27_stats", "k27_invert_separate", "k27_paired_threshold",
         "k27_subsampled", "k41_paired", "k41_invert", "k41_subsampled"])
def test_filter_seq_matches_jax(tmp_path, inputs, capsys, k, flags, paired):
    seq = ["--seq", inputs["seq1"]] + (["--seq2", inputs["seq2"]]
                                       if paired else [])
    jp, tp = _both(tmp_path, ["filter", "seq"],
                   [*SMALL, "-m", str(k), *flags, *seq], [inputs["reads"]])
    ends = [".in"] + ([".out"] if "-s" in flags else [])
    files = [f"{e}.R{r}.fq" for e in ends for r in (1, 2)] if paired else \
        [f"{e}.fq" for e in ends]
    _same(jp, tp, files + ([".stats"] if "--stats" in flags else []))
    found = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Found ")]
    assert len(found) == 2 and found[0] == found[1]
    kept = int(found[0].split()[1])
    assert 0 < kept < 80


@pytest.mark.parametrize("k", [27, 41])
def test_filter_seq_gzip_output_matches_jax(tmp_path, inputs, k):
    """A gzipped sequence file writes gzipped outputs: the same records."""
    jp, tp = _both(tmp_path, ["filter", "seq"],
                   [*SMALL, "-m", str(k), "-s", "--seq", inputs["gz"]],
                   [inputs["reads"]])
    _same(jp, tp, [".in.gz", ".out.gz"], opener=gzip.open)


@pytest.mark.parametrize("k", [27, 41])
def test_tools_with_the_join_forced_match_jax(tmp_path, inputs, monkeypatch,
                                              k):
    """cold and filter seq with the join policy forced on (the route the
    card takes for large wide batches): the join's plain versions give the
    same artifacts as kat_tpu."""
    monkeypatch.setattr(tables, "_join_policy", lambda *a, **kw: True)
    jp, tp = _both(tmp_path, ["cold"], [*SMALL, "-m", str(k)],
                   [inputs["asm"], inputs["reads"]])
    _same(jp, tp, ["-stats.tsv"])
    (tmp_path / "seq").mkdir()
    jp, tp = _both(tmp_path / "seq", ["filter", "seq"],
                   [*SMALL, "-m", str(k), "--stats", "--seq", inputs["seq1"]],
                   [inputs["reads"]])
    _same(jp, tp, [".in.fq", ".stats"])


@pytest.mark.parametrize("mode", [["cold"], ["filter", "kmer"],
                                  ["filter", "seq"]])
def test_cli_without_a_card_raises(tmp_path, inputs, mode):
    paths = {"cold": [inputs["asm"], inputs["reads"]],
             "kmer": [inputs["reads"]],
             "seq": ["--seq", inputs["seq1"], inputs["reads"]]}[mode[-1]]
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main([*mode, "-o", str(tmp_path / "x"), *paths])
