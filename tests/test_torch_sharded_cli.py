"""The port's tools on a mesh of shards, through its command line with
`--device cpu --shards 8`: `hist` and `sect` (contigs past a lowered halo
threshold, so the halo path runs) write artifacts byte-identical to
kat_tpu's sharded tools (KAT_TPU_SHARD=1 on its conftest's 8 virtual CPU
devices); `gcp`, `comp`, `cold`, `filter kmer` and `filter seq` byte-
identical to the port's own one-device command line, which the other
test_torch_*_cli files hold against kat_tpu; `--shards 1` and the rules
that pick a mesh."""

import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu.tools import hist as jhist
from kat_tpu_torch import cli as tcli
from kat_tpu_torch.parallel import longseq
from kat_tpu_torch.tools import common, sect

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SECT_FILES = ("-counts.cvg", "-counts.gc", "-stats.tsv", "-contamination.mx")


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    """What a dumped .jf header records about the machine and the moment;
    kat_tpu's plots and peak analysis stubbed out, the port's recorded
    instead of run (test_torch_default_cli.py runs them).  Returns the
    port's calls, each a flat tuple of its arguments."""
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    monkeypatch.setattr("getpass.getuser", lambda: "user")
    monkeypatch.setattr("sys.argv", ["kat"])
    monkeypatch.setattr(jcli, "_plot", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "_analyse_peaks", lambda *a, **kw: None)
    calls = []
    monkeypatch.setattr(tcli, "_plot", lambda mode, argv, quiet=False:
                        calls.append(("plot", mode, *argv)))
    monkeypatch.setattr(tcli, "_analyse_peaks", lambda *a, **kw:
                        calls.append(("peaks", *a, *kw.values())))
    return calls


def _same_calls(calls, n, tp, one):
    """The first n calls (the mesh's run, prefix tp) are the rest (the
    one-device run, prefix one) with the prefix mapped: a mesh plots and
    analyses what one device does."""
    assert n and len(calls) == 2 * n
    assert [tuple(a.replace(str(tp), str(one)) if isinstance(a, str)
                  else a for a in c) for c in calls[:n]] == calls[n:]


def _reads(path, genome, rng, n, length=120):
    with open(path, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - length, n)):
            s = genome[o:o + length].copy()
            if rng.random() < 0.05:
                s[rng.integers(0, length)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * length))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two read sets of one 3000-base genome, and the genome as contigs:
    one of 2400 bases (past the lowered halo threshold) and short ones."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(29)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
    a = _reads(d / "a.fq", genome, rng, 300)
    b = _reads(d / "b.fq", genome, rng, 150)
    fa = d / "asm.fa"
    with open(fa, "wb") as f:
        for i, (s, e) in enumerate([(0, 2400), (2300, 2650), (2700, 2710),
                                    (2800, 3000)]):
            seq = genome[s:e].copy()
            if i == 0:
                seq[500] = ord("N")
            f.write(b">c%d\n" % i)
            for o in range(0, seq.size, 70):
                f.write(seq[o:o + 70].tobytes() + b"\n")
    return dict(a=a, b=b, asm=str(fa))


def _files(prefix, suffixes):
    return {s: (prefix.parent / (prefix.name + s)).read_bytes()
            for s in suffixes}


def _port(tmp_path, name, mode, args, shards=("--shards", "8")):
    """Run the port's command line: `mode` the mode's words, -o into
    tmp_path/name; returns that prefix."""
    prefix = tmp_path / name
    assert tcli.main(["--device", "cpu", *shards, *mode, "-o", str(prefix),
                      *args]) == 0
    return prefix


@pytest.mark.parametrize("k", [27, 41])
def test_hist_matches_kat_tpu_sharded(tmp_path, inputs, monkeypatch, k,
                                      pinned):
    """hist -d: the histogram equals kat_tpu's sharded one, byte for byte,
    and the .jf dumped from the merged shards equals the one-device
    port's."""
    monkeypatch.setenv("KAT_TPU_SHARD", "1")
    h = jhist.Histogram([inputs["a"]], 1, 10000, 1)
    h.quiet = True
    h.input.mer_len = k
    h.input.hash_size = 4096
    h.output_prefix = str(tmp_path / "j")
    h.execute()
    h.save()
    assert h.input.shards is not None
    args = ["-m", str(k), "-H", "4096", "-d", inputs["a"]]
    tp = _port(tmp_path, "t", ["hist"], args)
    n = len(pinned)
    one = _port(tmp_path, "one", ["hist"], args, shards=())
    _same_calls(pinned, n, tp, one)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    jf = f"-hash.jf{k}"
    assert _files(tp, (jf,)) == _files(one, (jf,))


@pytest.mark.parametrize("k", [27, 41])
def test_sect_halo_matches_kat_tpu_sharded(tmp_path, inputs, monkeypatch, k):
    """sect with its counts sharded and the 2400-base contig on the halo
    path (routed lookups), the short contigs on the chunked path (routed
    window counts): every artifact equals kat_tpu's."""
    monkeypatch.setenv("KAT_TPU_SHARD", "1")
    monkeypatch.setenv("KAT_TPU_HALO_MIN", "1000")
    monkeypatch.setattr(sect, "HALO_MIN", 1000)
    calls = []
    real = longseq.sharded_window_profile_routed
    monkeypatch.setattr(longseq, "sharded_window_profile_routed",
                        lambda *a: calls.append(1) or real(*a))
    args = ["-m", str(k), "-H", "4096", "-g", inputs["asm"], inputs["a"]]
    jp = tmp_path / "j"
    assert jcli.main(["sect", "-o", str(jp), *args]) == 0
    tp = _port(tmp_path, "t", ["sect"], args)
    assert len(calls) == 1
    assert _files(tp, SECT_FILES) == _files(jp, SECT_FILES)


@pytest.mark.parametrize("mode,args,suffixes", [
    ("gcp", ["-m", "27", "-H", "4096"], (".mx",)),
    ("comp", ["-m", "27", "-H", "4096", "-I", "4096", "-h"],
     ("-main.mx", ".stats", ".1.hist", ".2.hist")),
    ("comp3", ["-m", "27", "-H", "4096", "-I", "4096", "-J", "4096"],
     ("-main.mx", ".stats", "-ends.mx", "-middle.mx", "-mixed.mx")),
    ("comp", ["-m", "41", "-H", "4096", "-I", "4096", "-N"],
     ("-main.mx", ".stats")),
], ids=["gcp", "comp", "comp_three", "comp_k41_non_canonical"])
def test_analysis_matches_one_device(tmp_path, inputs, mode, args,
                                     suffixes, monkeypatch, pinned):
    """gcp and comp on the mesh (the passes per shard, summed) write what
    the one-device port writes; the tables never leave their shards."""
    from kat_tpu_torch.core import counting

    merged = []
    monkeypatch.setattr(counting, "_unique_reduce",
                        lambda *a, f=counting._unique_reduce:
                        merged.append(1) or f(*a))
    paths = {"gcp": [inputs["a"]], "comp": [inputs["a"], inputs["b"]],
             "comp3": [inputs["a"], inputs["b"], inputs["asm"]]}[mode]
    cli_mode = ["comp" if mode == "comp3" else mode]
    tp = _port(tmp_path, "t", cli_mode, [*args, *paths])
    assert not merged  # no shard merge: finish() was never called
    n = len(pinned)
    one = _port(tmp_path, "one", cli_mode, [*args, *paths], shards=())
    _same_calls(pinned, n, tp, one)
    assert _files(tp, suffixes) == _files(one, suffixes)


@pytest.mark.parametrize("mode,args,suffixes", [
    (["cold"], ["-m", "27", "-H", "4096", "asm", "a"], ("-stats.tsv",)),
    (["filter", "kmer"], ["-m", "27", "-H", "4096", "-c", "2", "-d", "50",
                          "-s", "a"], ("-in.jf27", "-out.jf27")),
    (["filter", "seq"], ["-m", "27", "-H", "4096", "--stats", "-s", "--seq",
                         "a", "asm"], (".in.fq", ".out.fq", ".stats")),
], ids=["cold", "filter_kmer", "filter_seq"])
def test_lookup_tools_match_one_device(tmp_path, inputs, mode, args,
                                       suffixes, pinned):
    """cold and filter seq answer through routed window counts, filter
    kmer exports the merged shards: each writes what the one-device port
    writes."""
    args = [inputs.get(a, a) for a in args]
    tp = _port(tmp_path, "t", mode, args)
    n = len(pinned)
    one = _port(tmp_path, "one", mode, args, shards=())
    if mode == ["cold"]:
        _same_calls(pinned, n, tp, one)
    else:
        assert not pinned
    assert _files(tp, suffixes) == _files(one, suffixes)


def test_one_shard_mesh(tmp_path, inputs):
    """--shards 1 forces the one-shard mesh (sect then chunks every
    contig: the halo needs two shards)."""
    args = ["-m", "27", "-H", "4096", inputs["asm"], inputs["a"]]
    tp = _port(tmp_path, "t", ["sect"], args, shards=("--shards", "1"))
    one = _port(tmp_path, "one", ["sect"], args, shards=())
    assert _files(tp, SECT_FILES[::2]) == _files(one, SECT_FILES[::2])


def test_mesh_rules(monkeypatch):
    cpu = torch.device("cpu")
    inp = common.Input(paths=["x"], device=cpu)
    assert inp.mesh() is None  # the CPU, no --shards: one device
    inp.n_shards = 3
    mesh = inp.mesh()
    assert mesh.n == 3 and set(mesh.devices) == {cpu}
    card = common.Input(paths=["x"], device=torch.device("cuda", 0),
                        n_shards=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        card.mesh()  # a card's mesh never lands on the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card.n_shards = None
    assert card.mesh() is None  # one card: one device


def test_bucketed_flush_refuses_a_mesh(tmp_path, inputs):
    with pytest.raises(ValueError, match="does not run on a mesh"):
        tcli.main(["--device", "cpu", "--shards", "2", "--flush",
                   "bucketed", "hist", "-o", str(tmp_path / "t"),
                   inputs["a"]])


def test_shards_without_a_card_raise(tmp_path, inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--shards", "8", "hist", "-o", str(tmp_path / "t"),
                   inputs["a"]])


@pytest.mark.parametrize("disable_grow", [True, False])
def test_sharded_count_that_cannot_grow_raises(inputs, monkeypatch,
                                               disable_grow):
    """Tables that overflow with growth disabled, or capped below what the
    reads need, raise TableFullError instead of restarting for ever."""
    from kat_tpu_torch.core import counting
    from kat_tpu_torch.parallel import sharded

    real = sharded.ShardedCounter
    monkeypatch.setattr(sharded, "ShardedCounter", lambda *a, **kw: real(
        *a, **{**kw, "shard_capacity": 16, "max_capacity": 64}))
    inp = common.Input(paths=[inputs["a"]], device=torch.device("cpu"),
                       n_shards=4, disable_grow=disable_grow)
    with pytest.raises(counting.TableFullError):
        inp.count(quiet=True)
