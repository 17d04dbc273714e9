"""The port's binding of the supermer router (kat_tpu_torch.io.native) against
kat_tpu.io.native on the same files: chunks, hot groups and window counts
byte for byte.  Both bind the same C++ (kat_tpu/native/fastxio.cpp), each
through its own build."""

import gzip

import numpy as np
import pytest

from kat_tpu.io import native as jnative
from kat_tpu_torch.core import minimizer
from kat_tpu_torch.io import native

K, M = 27, minimizer.M_DEFAULT


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """~300 kB of FASTQ: overlapping reads of a small genome, poly-A reads
    (a hot bucket), reads with Ns; plain and gzipped."""
    rng = np.random.default_rng(12)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, size=20000))
    seqs = [genome[int(o):int(o) + 150]
            for o in rng.integers(0, 19850, 900)]
    seqs += ["A" * 200] * 60
    seqs[5] = seqs[5][:70] + "N" + seqs[5][71:]
    body = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(seqs)).encode()
    d = tmp_path_factory.mktemp("router")
    plain, gz = d / "r.fastq", d / "r.fastq.gz"
    plain.write_bytes(body)
    with gzip.open(gz, "wb") as f:
        f.write(body)
    return str(plain), str(gz), len(body)


def _drain(router, max_chunks, rpc, finalize=True, max_groups=512):
    out = []
    while True:
        fl = router.next_flush(max_chunks, rpc, max_groups, finalize=finalize)
        if fl is None:
            return out
        out.append(fl)


def _same(got, want):
    assert len(got) == len(want) and len(got) > 0
    for (gc, gg, gn), (wc, wg, wn) in zip(got, want):
        assert gc.dtype == np.uint64 and gc.tobytes() == wc.tobytes()
        assert gc.shape == wc.shape
        np.testing.assert_array_equal(gg, wg)
        assert gn == wn


@pytest.mark.parametrize("kind", ["plain", "gz"])
@pytest.mark.parametrize("k,bucket_bits", [(27, 6), (17, 8), (29, 6)])
def test_router_matches_kat_tpu(reads, kind, k, bucket_bits):
    path = reads[0] if kind == "plain" else reads[1]
    rpc = 1024 // minimizer.rec_windows(k)
    with native.SupermerRouter(path, k, M, bucket_bits) as r:
        got = _drain(r, 16, rpc)
    with jnative.SupermerRouter(path, k, M, bucket_bits) as r:
        want = _drain(r, 16, rpc)
    _same(got, want)
    assert any(len(g) for _c, g, _n in got)  # the poly-A bucket is hot
    # records reach torch as int64: the same bits
    assert got[0][0].view(np.int64).tobytes() == want[0][0].tobytes()


def test_router_ranges_and_attach_match_kat_tpu(reads):
    plain, _gz, size = reads
    cuts = [0, size // 3, 2 * size // 3, size]
    outs = []
    for mod in (native, jnative):
        r = mod.SupermerRouter(plain, K, M, 6, byte_range=(cuts[0], cuts[1]))
        fl = _drain(r, 16, 256, finalize=False)
        for a, b in zip(cuts[1:-1], cuts[2:]):
            r.attach(plain, byte_range=(a, b))
            fl += _drain(r, 16, 256, finalize=False)
        fl += _drain(r, 16, 256, finalize=True)
        r.close()
        outs.append(fl)
    _same(*outs)
    # the ranges together hold every window of the file
    with native.SupermerRouter(plain, K, M, 6) as r:
        whole = sum(n for _c, _g, n in _drain(r, 16, 256))
    assert sum(n for _c, _g, n in outs[0]) == whole


def test_router_max_groups_defers_hot_buckets(reads):
    """A hot bucket past the report array waits for the next flush: no
    group is ever placed unreported."""
    plain = reads[0]
    outs = []
    for mod in (native, jnative):
        with mod.SupermerRouter(plain, K, M, 6) as r:
            outs.append(_drain(r, 16, 64, max_groups=1))
    _same(*outs)
    assert max(len(g) for _c, g, _n in outs[0]) == 1


@pytest.mark.parametrize("threads", [1, 3])
def test_route_flushes_matches_kat_tpu(reads, threads, monkeypatch):
    """All flushes of several files; with more workers the flush order
    interleaves, so compare the multiset of records and the window total."""
    plain, gz, _size = reads
    monkeypatch.setattr(native, "RANGE_CHUNK", 1 << 19)
    monkeypatch.setattr(jnative, "RANGE_CHUNK", 1 << 19)
    args = ([plain, gz], K, M, 6, 16, 256)
    got = list(native.route_flushes(*args, trim5=[0, 3], threads=threads))
    want = list(jnative.route_flushes(*args, trim5=[0, 3], threads=threads))
    if threads == 1:
        _same(got, want)
    assert sum(n for *_x, n in got) == sum(n for *_x, n in want)
    rec = [np.sort(np.concatenate([c.reshape(-1) for c, *_x in fl]))
           for fl in (got, want)]
    rec = [r[r != 0] for r in rec]
    np.testing.assert_array_equal(*rec)


def test_router_errors(tmp_path):
    with pytest.raises(OSError):
        native.SupermerRouter(str(tmp_path / "absent.fa"), K, M, 6)
    p = tmp_path / "x.fa"
    p.write_text(">a\nACGT\n")
    with pytest.raises(OSError):  # k outside the router's range
        native.SupermerRouter(str(p), 31, M, 6)
    with native.SupermerRouter(str(p), K, M, 6) as r:
        with pytest.raises(OSError):
            r.attach(str(tmp_path / "absent.fa"))


def test_failed_build_keeps_the_compilers_output(monkeypatch, tmp_path):
    """A failed g++ build leaves available() false and the compiler's words
    in build_log(); require_lib() raises with them."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_READER", native.NativeReader())
    assert not native.available()
    assert "error" in native.build_log()
    with pytest.raises(RuntimeError, match="error"):
        native.require_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ build"):
        next(native.route_flushes([str(bad)], K, M, 6, 8, 256))
