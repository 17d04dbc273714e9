"""`kat sect`, `hist` from a .jf and `hist -d` in kat_tpu_torch against
kat_tpu: every artifact written for the same synthetic FASTA + FASTQ must
be byte-identical.  kat_tpu runs its own CLI (`sect`) or tool (`hist`, whose
CLI would also plot) in this process on the CPU; the port runs its CLI with
`--device cpu`."""

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu.tools import hist as jhist
from kat_tpu_torch import cli as tcli

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SECT_ARTIFACTS = ("-counts.cvg", "-stats.tsv", "-contamination.mx")
SECT_EXTRA = ("-counts.gc", "-non_repetitive.fa", "-repetitive.fa")


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


def _write_inputs(tmp_path, seed, long_contig=False):
    """Reads covering part of a genome several times over, and contigs of
    that genome: shorter than k, with Ns, with lower case, repeated
    stretches, and (optionally) one longer than the 65,536-base encoder row
    so that its windows cross a seam.  Contig lengths fall into few 64-base
    buckets to keep kat_tpu's compiled shapes few."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    genome = alphabet[rng.integers(0, 4, 66_000 if long_contig else 4000)]
    fq = tmp_path / "reads.fq"
    off = rng.integers(0, 3000 - 100, 500)
    with open(fq, "wb") as f:
        for i, o in enumerate(off):
            s = genome[o:o + 100].copy()
            if rng.random() < 0.05:
                s[rng.integers(0, 100)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * 100))
    spans = [(0, 5), (10, 130), (500, 625), (900, 1210), (2000, 2315),
             (2900, 3215), (3500, 3620)]
    if long_contig:
        spans.append((0, 65_990))
    fa = tmp_path / "asm.fa"
    with open(fa, "wb") as f:
        for i, (a, b) in enumerate(spans):
            s = genome[a:b].copy()
            if i == 3:
                s[100] = ord("N")
                s[200:230] = s[0:30]  # a repeat inside the contig
            if i == 4:
                s[50:60] += 32  # lower case
            f.write(b">c%d some description\n" % i)
            for o in range(0, s.size, 70):
                f.write(s[o:o + 70].tobytes() + b"\n")
    return str(fa), str(fq)


def _sect_both(tmp_path, flags, fa, counts_file):
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcli.main(["sect", *flags, "-o", jp, fa, counts_file]) == 0
    assert tcli.main(["--device", "cpu", "sect", *flags, "-o", tp, fa,
                      counts_file]) == 0
    return tmp_path / "j", tmp_path / "t"


def _assert_same_files(jp, tp, suffixes):
    for suffix in suffixes:
        want = (jp.parent / (jp.name + suffix)).read_bytes()
        got = (tp.parent / (tp.name + suffix)).read_bytes()
        assert got == want, suffix
        assert len(want) > 10


@pytest.mark.parametrize("flags", [
    ["-m", "21"],
    ["-m", "27", "-g", "-E", "-F"],
    ["-m", "17", "-N", "-g", "-E", "-F", "-M", "3", "-G", "9", "-l",
     "-x", "50", "-y", "40"]],
    ids=["defaults_k21", "gc_and_regions_k27", "non_canonical_k17"])
def test_sect_from_reads_matches_jax(tmp_path, flags):
    fa, fq = _write_inputs(tmp_path, seed=len(flags))
    jp, tp = _sect_both(tmp_path, flags, fa, fq)
    _assert_same_files(jp, tp, SECT_ARTIFACTS)
    if "-g" in flags:
        _assert_same_files(jp, tp, SECT_EXTRA)
    stats = (tmp_path / "t-stats.tsv").read_text().splitlines()
    assert len(stats) == 8
    assert stats[1].split("\t")[5] == str((5 - int(flags[1]) + 1) % (1 << 32))


def test_sect_long_contig_crosses_the_seam(tmp_path):
    fa, fq = _write_inputs(tmp_path, seed=7, long_contig=True)
    jp, tp = _sect_both(tmp_path, ["-m", "21", "-g"], fa, fq)
    _assert_same_files(jp, tp, SECT_ARTIFACTS + ("-counts.gc",))
    last = (tmp_path / "t-counts.cvg").read_text().splitlines()[-1]
    assert len(last.split(" ")) == 65_990 - 21 + 1


def test_sect_dump_and_sect_from_jf_match_jax(tmp_path):
    fa, fq = _write_inputs(tmp_path, seed=3)
    jp, tp = _sect_both(tmp_path, ["-m", "21", "-d"], fa, fq)
    _assert_same_files(jp, tp, SECT_ARTIFACTS + ("-hash.jf21",))
    # the dumped hash as the counts input: LOAD mode, k taken from the file
    out = tmp_path / "from_jf"
    out.mkdir()
    jp2, tp2 = _sect_both(out, ["-g", "-E", "-F"], fa,
                          str(tmp_path / "t-hash.jf21"))
    _assert_same_files(jp2, tp2, SECT_ARTIFACTS + SECT_EXTRA)
    assert (out / "t-counts.cvg").read_bytes() == \
        (tmp_path / "t-counts.cvg").read_bytes()


def _jax_hist(tmp_path, paths, k, dump=False):
    h = jhist.Histogram(paths, 1, 10000, 1)
    h.output_prefix = str(tmp_path / "j.hist")
    h.input.mer_len = k
    h.input.dump_hash = dump
    h.quiet = True
    h.execute()
    h.save()
    return tmp_path / "j.hist"


def test_hist_dump_and_hist_from_jf_match_jax(tmp_path, capsys, pinned):
    _fa, fq = _write_inputs(tmp_path, seed=5)
    want = _jax_hist(tmp_path, [fq], 27, dump=True)
    got = tmp_path / "t.hist"
    assert tcli.main(["--device", "cpu", "hist", "-m", "27", "-d", "-o",
                      str(got), fq]) == 0
    assert got.read_bytes() == want.read_bytes()
    jf = tmp_path / "t.hist-hash.jf27"
    assert jf.read_bytes() == (tmp_path / "j.hist-hash.jf27").read_bytes()

    # LOAD mode: k comes from the file, the default -m is overridden
    out = tmp_path / "from_jf"
    out.mkdir()
    want2 = _jax_hist(out, [str(jf)], 21)
    got2 = out / "t.hist"
    assert tcli.main(["--device", "cpu", "hist", "-o", str(got2),
                      str(jf)]) == 0
    assert got2.read_bytes() == want2.read_bytes()
    assert "Loading hashes into memory" in capsys.readouterr().out
    assert got2.read_text().split("###")[1] == \
        got.read_text().split("###")[1]
    assert pinned == hist_calls(got) + hist_calls(got2)


@pytest.mark.parametrize("mode", ["hist", "sect"])
def test_cli_without_a_card_raises(tmp_path, mode):
    """No flag means the card; without one the CLI raises and counts
    nothing on the CPU."""
    fa, fq = _write_inputs(tmp_path, seed=1)
    args = ["hist", "-o", str(tmp_path / "x.hist"), fq] if mode == "hist" \
        else ["sect", "-o", str(tmp_path / "x"), fa, fq]
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(args)
    assert not list(tmp_path.glob("x*"))
