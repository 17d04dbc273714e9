"""The minimizer-bucketed counting flush of kat_tpu_torch against kat_tpu's,
run as tests/test_bucketed.py runs it (Pallas kernels in interpret mode,
tiny chunk geometry), on the same files made from a seed.  Exact (integers:
tolerance 0).  On the CPU the port uses the plain versions of K5 and K6."""

import numpy as np
import pytest
import torch

from kat_tpu.core import bucketed as jbucketed
from kat_tpu.core.counting import table_to_numpy as jtable_to_numpy
from kat_tpu.io import native as jnative
from kat_tpu_torch.core import bucketed, counting, minimizer
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.io import native
from kat_tpu_torch.tools.common import Input
from kat_tpu_native_fixture import kat_tpu_native  # noqa: F401

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

pytestmark = pytest.mark.kernel_interpret
CPU = torch.device("cpu")
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rand_seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def _case(name):
    """(k, reads, initial capacity) of the cases of tests/test_bucketed.py."""
    if name in ("plain_k17", "plain_k27"):
        k = int(name[-2:])
        rng = np.random.default_rng(k)
        genome = _rand_seq(rng, 800)
        seqs = [genome[int(o):int(o) + 100]
                for o in rng.integers(0, 700, 120)]
        seqs[3] = seqs[3][:40] + "N" + seqs[3][41:]
        return k, seqs, 1 << 13
    if name == "poly_a_hot_group":
        rng = np.random.default_rng(9)
        return 27, ["A" * 300] * 30 + [_rand_seq(rng, 120)
                                       for _ in range(20)], 1 << 13
    if name == "growth_from_2^9":
        rng = np.random.default_rng(4)
        return 27, [_rand_seq(rng, 120) for _ in range(60)], 1 << 9
    if name == "reverse_complements":
        rng = np.random.default_rng(31)
        base = [_rand_seq(rng, 90) for _ in range(15)]
        base += ["A" * 120, "AT" * 60, "AAT" * 40, ("A" * 30 + "C") * 3]
        rcs = ["".join(COMP[c] for c in reversed(s)) for s in base]
        return 27, base + rcs, 1 << 13
    if name == "k29":
        rng = np.random.default_rng(8)
        genome = _rand_seq(rng, 700)
        return 29, [genome[int(o):][:110]
                    for o in rng.integers(0, 580, 70)], 1 << 13
    raise KeyError(name)


def _write_fastq(tmp_path, seqs, name="r.fastq"):
    p = tmp_path / name
    with open(p, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s.encode(), b"I" * len(s)))
    return str(p)


@pytest.mark.parametrize("name", ["plain_k17", "plain_k27",
                                  "poly_a_hot_group", "growth_from_2^9",
                                  "reverse_complements", "k29"])
def test_count_paths_bucketed_matches_jax(tmp_path, name):
    k, seqs, cap0 = _case(name)
    path = _write_fastq(tmp_path, seqs)
    geo = dict(max_chunks=8, bucket_bits=6, initial_capacity=cap0)
    want = jbucketed.count_paths_bucketed(
        [path], k, rec_per_chunk=1024 // minimizer.rec_windows(k), **geo)
    stats = {}
    got = bucketed.count_paths_bucketed([path], k, slots_log=10, device=CPU,
                                        stats=stats, **geo)
    wk, wc = jtable_to_numpy(want)
    gk, gc = counting.table_to_numpy(got)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert got.n_unique == int(want.n_unique) == len(wk)
    assert got.capacity == want.keys_hi.shape[0]  # grew as far as kat_tpu
    assert bool((got.keys[got.n_unique:] == SENTINEL).all())
    assert stats["windows"] == int(gc.sum()) and stats["flushes"] >= 1
    if name == "poly_a_hot_group":
        assert stats["groups"] >= 1
    # the classic flush of the port counts the same table
    inp = Input([path], mer_len=k, device=CPU)
    inp.count(quiet=True)
    ck, cc = counting.table_to_numpy(inp.table)
    np.testing.assert_array_equal(gk, ck)
    np.testing.assert_array_equal(gc, cc)


def test_mid_stream_table_matches_jax(tmp_path):
    """After every flush the two counters hold the same key'-space table
    (carried across with bucketed.table_from_jax_numpy); k = 29 takes the
    bit-63-flipped form."""
    for k, seed in ((27, 1), (29, 2)):
        rng = np.random.default_rng(seed)
        genome = _rand_seq(rng, 1500)
        seqs = [genome[int(o):int(o) + 120]
                for o in rng.integers(0, 1380, 150)] + ["A" * 200] * 20
        path = _write_fastq(tmp_path, seqs, f"r{k}.fastq")
        rpc = 1024 // minimizer.rec_windows(k)
        jc = jbucketed.BucketedCodeCounter(k, initial_capacity=1 << 12)
        tc = bucketed.BucketedCodeCounter(k, initial_capacity=1 << 12,
                                          device=CPU)
        n_flushes = 0
        for chunks, groups, _nw in native.route_flushes(
                [path], k, minimizer.M_DEFAULT, 6, 8, rpc):
            chunks = bucketed.pad_flush(chunks, 8)
            jc.add_flush(chunks, groups)
            tc.add_flush(chunks, groups)
            jc._check_overflow()
            want = bucketed.table_from_jax_numpy(
                np.asarray(jc.table.keys_hi), np.asarray(jc.table.keys_lo),
                np.asarray(jc.table.counts), int(jc.table.n_unique), k,
                device=CPU)
            n = tc.table.n_unique
            assert n == want.n_unique and tc.capacity == jc.capacity
            assert torch.equal(tc.table.keys[:n], want.keys[:n])
            assert torch.equal(tc.table.counts[:n], want.counts[:n])
            n_flushes += 1
        assert n_flushes >= 2 and tc.table.n_unique > 0
        if k == 29:
            assert bool((tc.table.keys[:n] < 0).any())  # the flipped form


def test_add_flush_takes_staged_tensors_and_checks_them(tmp_path):
    k = 27
    rng = np.random.default_rng(5)
    path = _write_fastq(tmp_path, [_rand_seq(rng, 150) for _ in range(40)])
    fl = list(native.route_flushes([path], k, minimizer.M_DEFAULT, 6, 8, 256))
    a = bucketed.BucketedCodeCounter(k, device=CPU)
    b = bucketed.BucketedCodeCounter(k, device=CPU)
    for chunks, groups, _nw in fl:
        a.add_flush(chunks, groups)
        b.add_flush(torch.from_numpy(chunks.view(np.int64)), groups)
    ta, tb = a.finish(), b.finish()
    assert ta.n_unique == tb.n_unique and torch.equal(ta.keys, tb.keys)
    assert torch.equal(ta.counts, tb.counts)
    with pytest.raises(ValueError):
        b.add_flush(torch.zeros(8, dtype=torch.int64), [])
    with pytest.raises(ValueError):
        b.add_flush(torch.zeros((2, 8), dtype=torch.int64, device="meta"), [])
    with pytest.raises(ValueError):
        bucketed.BucketedCodeCounter(31, device=CPU)
    with pytest.raises(counting.TableFullError):
        c = bucketed.BucketedCodeCounter(k, initial_capacity=16,
                                         disable_grow=True, device=CPU)
        c.add_flush(*fl[0][:2])


def test_geometry_and_padding():
    assert bucketed.geometry(27) == ((1 << bucketed.SLOTS_LOG) // 4,
                                     bucketed.BUCKET_BITS)
    assert bucketed.geometry(27, max_chunks=1 << 16)[1] == bucketed.BUCKET_BITS
    assert bucketed.geometry(29, max_chunks=8, slots_log=10) == (512, 7)
    c = np.ones((5, 4), np.uint64)
    assert bucketed.pad_flush(c, 4096).shape == (8, 4)
    assert bucketed.pad_flush(np.ones((9, 4), np.uint64), 4096).shape == \
        (16, 4)
    assert bucketed.pad_flush(np.ones((9, 4), np.uint64), 12).shape == (12, 4)
    assert bucketed.pad_flush(c, 4).shape == (5, 4)
    assert not bucketed.pad_flush(c, 8)[5:].any()


def test_jax_router_is_what_the_reference_ran():
    assert jnative.available() and native.available()
