"""`kat gcp` and `kat comp` in kat_tpu_torch against kat_tpu: every artifact
written for the same synthetic reads and contigs must be byte-identical.
Both CLIs run in this process on the CPU (the port's with `--device cpu`),
their plots and peak analysis recorded instead of run: both must ask for
the same ones with the same arguments (test_torch_default_cli.py runs
them), for two and three
inputs, reads and `.jf`, -N/-O (the pass-2 always-canonical quirk), bins
and scales, -h, -d and k = 27 and 41.  The comp engine is also held against
kat_tpu's on tables carried across from kat_tpu's, and the fused dual probe
(forced on the CPU) against two searches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu import cli as jcli
from kat_tpu.core import comp_engine as jce
from kat_tpu.core import counting as jc
from kat_tpu.core import kmers as jk
from kat_tpu.core import wide as jw
from kat_tpu_torch import cli as tcli
from kat_tpu_torch.core import comp_engine as tce
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import tables
from kat_tpu_torch.core import wide as tw
from kat_tpu_torch.ops import join

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

SMALL = ["-H", "5000", "-I", "5000", "-J", "5000"]  # tables grow from 8192
COMP_BASE = ("-main.mx", ".stats")
COMP_THREE = ("-ends.mx", "-middle.mx", "-mixed.mx")
COMP_HISTS = (".1.hist", ".2.hist")


def _record(mp, cli, calls):
    """cli's plots and peak analysis recorded into calls, each a flat tuple
    of its arguments, instead of run."""
    mp.setattr(cli, "_plot", lambda mode, argv, quiet=False:
               calls.append(("plot", mode, *argv)))
    mp.setattr(cli, "_analyse_peaks", lambda *a, **kw:
               calls.append(("peaks", *a, *kw.values())))


def _mapped(calls, src, dst):
    """calls with the output prefix src written as dst."""
    return [tuple(a.replace(str(src), str(dst)) if isinstance(a, str) else a
                  for a in c) for c in calls]


def _pin(mp):
    """What a dumped .jf header records about the machine and the moment;
    both CLIs' plots and peak analysis recorded instead of run.  Returns
    the calls, kat_tpu's under "j" and the port's under "t"."""
    mp.setattr("socket.gethostname", lambda: "host")
    mp.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    mp.setattr("getpass.getuser", lambda: "user")
    mp.setattr("sys.argv", ["kat"])
    calls = {"j": [], "t": []}
    _record(mp, jcli, calls["j"])
    _record(mp, tcli, calls["t"])
    return calls


def _same_calls(calls, jp, tp):
    """Both CLIs asked for the same plots and peak analyses, in the same
    order, with the same arguments (the output prefix mapped); returns
    the plot modes."""
    assert calls["j"]
    assert _mapped(calls["t"], tp, jp) == calls["j"]
    return [c[1] for c in calls["j"] if c[0] == "plot"]


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    return _pin(monkeypatch)


def _reads(path, genome, rng, n, length, n_frac=0.05):
    with open(path, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - length, n)):
            s = genome[o:o + length].copy()
            if rng.random() < n_frac:
                s[rng.integers(0, length)] = ord("N")
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * length))
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two read sets of one 3000-base genome (coverage ~15 and ~8), a
    second draw (~4), and the genome as contigs: what `kat comp` is run
    on."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(17)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 3000)]
    other = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 800)]
    # one read length: kat_tpu compiles its counting per batch shape
    a = _reads(d / "a.fq", genome, rng, 300, 150)
    b = _reads(d / "b.fq", np.concatenate([genome[:2000], other]), rng, 160,
               150)
    c = _reads(d / "c.fq", genome, rng, 80, 150)
    fa = d / "asm.fa"
    with open(fa, "wb") as f:
        for i, (s, e) in enumerate([(0, 1200), (1150, 2600), (2600, 3000)]):
            f.write(b">c%d\n" % i)
            for o in range(s, e, 70):
                f.write(genome[o:min(o + 70, e)].tobytes() + b"\n")
    return dict(a=a, b=b, c=c, asm=str(fa))


def _both(tmp_path, mode, flags, paths):
    """Run `mode` through both CLIs into tmp_path/j and tmp_path/t."""
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    assert jcli.main([mode, *flags, "-o", jp, *paths]) == 0
    assert tcli.main(["--device", "cpu", mode, *flags, "-o", tp,
                      *paths]) == 0
    return tmp_path / "j", tmp_path / "t"


def _same(jp, tp, suffixes):
    for suffix in suffixes:
        want = (jp.parent / (jp.name + suffix)).read_bytes()
        got = (tp.parent / (tp.name + suffix)).read_bytes()
        assert got == want, suffix
        assert len(want) > 10
    for suffix in (COMP_THREE + COMP_HISTS):
        if suffix not in suffixes:
            assert not (tp.parent / (tp.name + suffix)).exists(), suffix


@pytest.mark.parametrize("flags", [
    ["-m", "27"], ["-m", "27", "-x", "0.37", "-y", "60"],
    ["-m", "25", "-N"], ["-m", "25", "-d"], ["-m", "41"],
    ["-m", "41", "-x", "3", "-y", "7"]],
    ids=["k27", "k27_scaled", "k25_non_canonical", "k25_dump", "k41",
         "k41_scaled"])
def test_gcp_matches_jax(tmp_path, inputs, flags, pinned):
    jp, tp = _both(tmp_path, "gcp", ["-H", "5000", *flags], [inputs["a"]])
    k = int(flags[1])
    _same(jp, tp, (".mx",) + ((f"-hash.jf{k}",) if "-d" in flags else ()))
    rows = [ln for ln in (tmp_path / "t.mx").read_text().splitlines()
            if not ln.startswith("#")]
    assert len(rows) == k  # the GC == k row is never printed
    assert _same_calls(pinned, jp, tp) == ["density"]
    assert pinned["t"][1][:3] == ("peaks", f"{tp}.mx", str(tp))


@pytest.mark.parametrize("flags,three", [
    (["-m", "27"], False),
    (["-m", "27"], True),
    (["-m", "25", "-N", "-O", "-n"], False),
    (["-m", "27", "-x", "0.5", "-y", "2", "-i", "51", "-j", "31", "-h",
      "--d1_5ptrim", "7", "--d2_5ptrim", "3"], False),
    (["-m", "25", "-O", "-P", "-x", "2", "-i", "201", "-j", "1001"], True),
    (["-m", "41", "-h", "-N"], False),
], ids=["k27", "k27_three", "k25_N_O_density", "k27_scales_bins_trims_hists",
        "k25_O_P_scaled_three", "k41_hists_N"])
def test_comp_matches_jax(tmp_path, inputs, flags, three, pinned, capsys):
    paths = [inputs["a"], inputs["asm"] if three else inputs["b"]]
    if three:
        paths.append(inputs["c"])
    jp, tp = _both(tmp_path, "comp", [*SMALL, *flags], paths)
    suffixes = COMP_BASE + (COMP_THREE if three else ()) + (
        COMP_HISTS if "-h" in flags else ())
    _same(jp, tp, suffixes)
    out = capsys.readouterr().out
    assert "Distance between spectra 1 and 2" in out  # the summary
    assert _same_calls(pinned, jp, tp) == [
        "density" if "-n" in flags else "spectra-cn"]
    density, hists = "-n" in flags, "-h" in flags
    peaks = [c[1] for c in pinned["t"] if c[0] == "peaks"]
    assert peaks == ([f"{tp}.1.hist", f"{tp}.2.hist"] if density and hists
                     else [] if density else [f"{tp}-main.mx"])
    assert ("Current configuration does not support peak analysis."
            in out) == (density and not hists)
    stats = (tmp_path / "t.stats").read_text()
    assert (" - Hash 3: " in stats) == three


@pytest.fixture(scope="module")
def dumped(tmp_path_factory, inputs):
    """comp -d -m 25 through both CLIs (the machine and the moment that a
    .jf header records pinned), once for the tests of the dumped hashes."""
    d = tmp_path_factory.mktemp("dumped")
    with pytest.MonkeyPatch.context() as mp:
        _pin(mp)
        jp, tp = _both(d, "comp", [*SMALL, "-m", "25", "-d"],
                       [inputs["a"], inputs["b"]])
    return jp, tp


def test_comp_dumps_match_jax(dumped):
    _same(*dumped, COMP_BASE + ("-hash1.jf25", "-hash2.jf25"))


def test_gcp_of_a_dumped_jf_matches_jax(tmp_path, dumped):
    """LOAD: k comes from the .jf, bins from -y."""
    jp, tp = _both(tmp_path, "gcp", ["-y", "300"],
                   [str(dumped[1]) + "-hash1.jf25"])
    _same(jp, tp, (".mx",))


@pytest.mark.parametrize("which", ["load", "mixed"])
def test_comp_of_dumped_jfs_matches_jax(tmp_path, inputs, dumped, which):
    """comp of the two dumped .jf (LOAD, k from the files), and of one .jf
    with reads (mixed, k from -m): the same matrix as from the reads."""
    tp = dumped[1]
    jf1, jf2 = str(tp) + "-hash1.jf25", str(tp) + "-hash2.jf25"
    paths, flags = (([jf1, jf2], []) if which == "load"
                    else ([jf1, inputs["b"]], ["-m", "25"]))
    jp2, tp2 = _both(tmp_path, "comp", [*SMALL, *flags], paths)
    _same(jp2, tp2, COMP_BASE)
    assert (tmp_path / "t-main.mx").read_text().split("###")[1] == \
        (tp.parent / "t-main.mx").read_text().split("###")[1]


def test_comp_refuses_a_jf_of_another_k(tmp_path, inputs, dumped):
    """Mixed inputs must share k (validate_mer_len): both raise alike."""
    jf1 = str(dumped[1]) + "-hash1.jf25"
    with pytest.raises(ValueError, match="different K-mer lengths") as want:
        jcli.main(["comp", *SMALL, "-m", "27", "-o", str(tmp_path / "x"),
                   jf1, inputs["b"]])
    with pytest.raises(ValueError, match="different K-mer lengths") as got:
        tcli.main(["--device", "cpu", "comp", *SMALL, "-m", "27", "-o",
                   str(tmp_path / "y"), jf1, inputs["b"]])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["gcp", "comp"])
def test_cli_without_a_card_raises(tmp_path, inputs, mode):
    paths = [inputs["a"]] if mode == "gcp" else [inputs["a"], inputs["b"]]
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main([mode, "-o", str(tmp_path / "x"), *paths])
    assert not list(tmp_path.glob("x*"))


# -- the engine on tables carried across from kat_tpu's --

def _pad(planes, cap):
    """uint32 planes padded to cap with kat_tpu's all-ones sentinel."""
    return tuple(jnp.asarray(np.concatenate([
        p, np.full(cap - p.size, 0xFFFFFFFF, np.uint32)])) for p in planes)


def _narrow_pair(k, seed):
    """kat_tpu tables of three overlapping sets of canonical keys, built
    slot by slot as its counters leave them (sorted, sentinel padding),
    and the port's copies of them (table_from_jax_numpy)."""
    rng = np.random.default_rng(seed)
    universe = np.unique(jk.canonical_np(
        rng.integers(0, 1 << (2 * k), 6000).astype(np.uint64), k))
    out = []
    for n in (2500, 1800, 900):
        keys = np.sort(rng.choice(universe, size=n, replace=False))
        counts = rng.poisson(9, n).astype(np.uint32) + 1
        counts[:2] = [(1 << 32) - 1, 1 << 31]
        hi, lo, c = _pad(((keys >> np.uint64(32)).astype(np.uint32),
                          keys.astype(np.uint32), counts), 4096)
        jt = jc.CountTable(hi, lo, c.at[n:].set(0), jnp.int32(n))
        tt = tc.table_from_jax_numpy(np.asarray(hi), np.asarray(lo),
                                     np.asarray(jt.counts), n, device="cpu")
        out.append((jt, tt))
    return out


def _wide_pair(k, seed):
    """The same for wide keys: kat_tpu's big-first u32 words, the port's
    31-base int64 words (table_from_jax_words)."""
    rng = np.random.default_rng(seed)
    universe = list({int.from_bytes(rng.bytes(16), "little")
                     % (1 << (2 * k)) for _ in range(3000)})
    out = []
    for n in (1500, 1100, 700):
        keys = sorted(universe[i] for i in rng.choice(len(universe), n,
                                                      replace=False))
        counts = rng.poisson(9, n).astype(np.uint32) + 1
        counts[:2] = [(1 << 32) - 1, 1 << 31]
        words = jw.ints_to_words(keys, jk.words_for_k(k))
        *planes, c = _pad([*words.T, counts], 2048)
        jt = jw.WideTable(tuple(planes), c.at[n:].set(0), jnp.int32(n))
        tt = tw.table_from_jax_words(tuple(np.asarray(w) for w in planes),
                                     np.asarray(jt.counts), n, k,
                                     device="cpu")
        out.append((jt, tt))
    return out


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for key in w:
                assert int(g[key]) == int(w[key]), key
        elif w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy().astype(np.uint64),
                                          np.asarray(w, np.uint64))


@pytest.mark.parametrize("k,wide,bins,scales,three", [
    (15, False, (51, 31), (0.5, 2.0), True),
    (41, True, (21, 61), (0.3, 0.7), True)],
    ids=["narrow_scaled_three", "wide_scaled_three"])
def test_comp_engine_on_carried_tables_matches_jax(k, wide, bins, scales,
                                                   three):
    """pass1, pass2 and pass3 of both packages on the same tables, counts
    of 2^31 and 2^32 - 1 among them (read as unsigned)."""
    (j1, t1), (j2, t2), (j3, t3) = (_wide_pair if wide else _narrow_pair)(
        k, k)
    d1, d2 = bins
    dm = min(d1, d2)
    kw = dict(k=k, d1_bins=d1, d2_bins=d2, dm_size=dm, d1_scale=scales[0],
              d2_scale=scales[1], canon2=True, canon3=True, three=three)
    _assert_outputs_equal(tce.pass1(t1, t2, t3 if three else None, **kw),
                          jce.pass1(j1, j2, j3 if three else None, **kw))
    kw2 = dict(k=k, d2_bins=d2, dm_size=dm, d2_scale=scales[1])
    _assert_outputs_equal(tce.pass2(t2, t1, **kw2), jce.pass2(j2, j1, **kw2))
    _assert_outputs_equal((tce.pass3(t3),), (jce.pass3(j3),))


def test_dual_probe_matches_jax_and_two_searches(tmp_path, inputs,
                                                 monkeypatch):
    """The fused dual probe (tables.lookup_dual: K2 with two payload
    planes, then two K4 compactions) forced on the CPU through comp's
    CLI: its artifacts equal kat_tpu's and the search route's, and it ran
    exactly once, with the shared_spectrum2 contribution moved to pass 2."""
    paths = [inputs["a"], inputs["b"]]
    flags = [*SMALL, "-m", "27", "-h"]
    search = tmp_path / "search"
    search.mkdir()
    jp, tp = _both(search, "comp", flags, paths)
    _same(jp, tp, COMP_BASE + COMP_HISTS)

    calls = []
    real_dual = join.counts_join_dual

    def spy(*args):
        calls.append(args[0].numel())
        return real_dual(*args)

    monkeypatch.setattr(join, "counts_join_dual", spy)
    monkeypatch.setattr(tables, "_join_policy", lambda *a, **kw: True)
    fused = tmp_path / "t"
    assert tcli.main(["--device", "cpu", "comp", *flags, "-o", str(fused),
                      *paths]) == 0
    assert len(calls) == 1
    for suffix in COMP_BASE + COMP_HISTS:
        assert (tmp_path / f"t{suffix}").read_bytes() == \
            (search / f"j{suffix}").read_bytes(), suffix


def test_engine_passes_split_shared_spectrum2_under_the_dual_probe():
    """Exactly one of pass1's and pass2's shared_spectrum2 contributions is
    non-zero, and their sum is the same whichever ran."""
    (_j1, t1), (_j2, t2), _ = _narrow_pair(13, 3)
    kw = dict(k=13, d1_bins=101, d2_bins=101, dm_size=101, d1_scale=1.0,
              d2_scale=1.0, canon2=True, canon3=True, three=False)
    h2, h1 = join.counts_join_dual(t1.keys, t1.counts, t2.keys, t2.counts)
    plain1 = tce.pass1(t1, t2, None, **kw)
    plain2 = tce.pass2(t2, t1, k=13, d2_bins=101, dm_size=101, d2_scale=1.0)
    dual1 = tce.pass1(t1, t2, None, h2_pre=h2, **kw)
    dual2 = tce.pass2(t2, t1, k=13, d2_bins=101, dm_size=101, d2_scale=1.0,
                      h1_pre=h1)
    assert int(plain2[3].sum()) == 0 and int(dual1[3].sum()) == 0
    assert int(plain1[3].sum()) > 0
    assert torch.equal(plain1[3], dual2[3])
    for a, b in zip(plain1[:3] + plain1[4:5], dual1[:3] + dual1[4:5]):
        if isinstance(a, dict):
            assert {x: int(v) for x, v in a.items()} == \
                {x: int(v) for x, v in b.items()}
        else:
            assert torch.equal(a, b)


def test_lookup_dual_returns_none_for_wide_tables(monkeypatch):
    """The fused probe once declined two WideTables (the narrow join would
    have read their [W, capacity] words as one key plane).  With the W-word
    merge it takes them: with the join policy forced on, lookup_dual of two
    WideTables equals two searches; with it off, it returns None."""
    (_j1, t1), (_j2, t2), _ = _wide_pair(41, 5)
    assert tables.lookup_dual(t1, t2) is None  # CPU tables: the search
    monkeypatch.setattr(tables, "_join_policy", lambda *a, **kw: True)
    got = tables.lookup_dual(t1, t2)
    assert torch.equal(got[0], tables.lookup(t2, t1.keys, method="search"))
    assert torch.equal(got[1], tables.lookup(t1, t2.keys, method="search"))
    (_n1, n1), (_n2, n2), _ = _narrow_pair(13, 5)
    got = tables.lookup_dual(n1, n2)
    assert got is not None
    assert torch.equal(got[0], tables.lookup(n2, n1.keys, method="search"))


def test_comp_k41_with_the_join_policy_forced_matches_jax(tmp_path, inputs,
                                                          monkeypatch):
    """The repair end to end: comp -m 41 with the join policy forced on
    (as on the card at comp's sizes) equals kat_tpu's output."""
    monkeypatch.setattr(tables, "_join_policy", lambda *a, **kw: True)
    jp, tp = _both(tmp_path, "comp", [*SMALL, "-m", "41"],
                   [inputs["a"], inputs["b"]])
    _same(jp, tp, COMP_BASE)
