"""`--flush bucketed` through the port's command line: `hist` writes the
bytes that `--flush classic` and kat_tpu's `hist` write, and a bucketed
request raises where one of its conditions fails or the router cannot be
built; it never counts through the classic flush by itself."""

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu_torch import cli
from kat_tpu_torch.io import native
from kat_tpu_torch.tools.common import Input

pytestmark = pytest.mark.kernel_interpret
CPU = torch.device("cpu")


def _rand_seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def _write_fastq(tmp_path, seqs, name="r.fastq"):
    p = tmp_path / name
    with open(p, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.encode(), b"I" * len(s)))
    return str(p)


def _hist_bytes(main, tmp_path, tag, argv_head, path, k="27"):
    out = tmp_path / tag
    assert main([*argv_head, "hist", "-m", k, "-o", str(out),
                 *(["-p", "none"] if main is jcli.main else []), path]) == 0
    return out.read_bytes()


def test_hist_cli_flush_bucketed_is_byte_identical(tmp_path, monkeypatch):
    """`hist --flush bucketed` writes the bytes that `--flush classic` and
    kat_tpu's hist (classic and minimizer-bucketed) write."""
    rng = np.random.default_rng(21)
    genome = _rand_seq(rng, 600)
    seqs = [genome[int(rng.integers(0, 500)):][:90] for _ in range(80)]
    path = _write_fastq(tmp_path, seqs)
    classic = _hist_bytes(cli.main, tmp_path, "t_classic",
                          ["--device", "cpu", "--flush", "classic"], path)
    buck = _hist_bytes(cli.main, tmp_path, "t_bucketed",
                       ["--device", "cpu", "--flush", "bucketed"], path)
    default = _hist_bytes(cli.main, tmp_path, "t_default",
                          ["--device", "cpu"], path)
    monkeypatch.setenv("KAT_TPU_MINIMIZER", "0")
    j_classic = _hist_bytes(jcli.main, tmp_path, "j_classic", [], path)
    monkeypatch.setenv("KAT_TPU_MINIMIZER", "1")
    monkeypatch.setenv("KAT_TPU_SMR_CHUNKS", "8")
    j_mini = _hist_bytes(jcli.main, tmp_path, "j_mini", [], path)
    assert buck == classic == default == j_classic == j_mini
    assert b"###" in buck


@pytest.mark.parametrize("why,argv,stdin", [
    ("k=31", ["-m", "31"], False),
    ("non-canonical", ["-N"], False),
    ("stdin", [], True),
])
def test_flush_bucketed_raises_where_a_condition_fails(tmp_path, why, argv,
                                                       stdin):
    rng = np.random.default_rng(2)
    path = _write_fastq(tmp_path, [_rand_seq(rng, 100) for _ in range(10)])
    args = ["--device", "cpu", "--flush", "bucketed", "hist", "-o",
            str(tmp_path / "o"), *argv, "-" if stdin else path]
    with pytest.raises(ValueError, match="flush='bucketed' cannot take"):
        cli.main(args)
    assert not (tmp_path / "o").exists()  # nothing counted another way
    # the same request through the classic flush is fine where it reads files
    if not stdin:
        assert cli.main(["--device", "cpu"] + args[4:]) == 0


def test_flush_bucketed_raises_when_the_router_cannot_be_built(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    path = _write_fastq(tmp_path, [_rand_seq(rng, 100) for _ in range(10)])
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_READER", native.NativeReader())
    inp = Input([path], mer_len=27, device=CPU, flush="bucketed")
    with pytest.raises(RuntimeError, match="g\\+\\+ build.*failed"):
        inp.count(quiet=True)
    assert inp.table is None
    # the classic flush still counts, through the Python reader
    inp = Input([path], mer_len=27, device=CPU)
    inp.count(quiet=True)
    assert inp.table.n_unique > 0
    with pytest.raises(ValueError, match="flush="):
        Input([path], mer_len=27, device=CPU, flush="auto").count(quiet=True)
