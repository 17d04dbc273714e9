"""kat_tpu_torch's core/wide.py against kat_tpu's: WideCodeStreamingCounter
(k = 33, 63, 127, through at least two growth replays) against kat_tpu's
counter on the CPU (its plain XLA flush), compared through table_to_numpy;
table_from_jax_words, table_from_ints / table_from_words and lookup_wide;
the counters' guard before a stream the kernels would refuse; histogram
binning of counts of 2^31 and more.  Exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import kmers as jk
from kat_tpu.core import stats as jstats
from kat_tpu.core import wide as jw
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import kmers as tk
from kat_tpu_torch.core import stats as tstats
from kat_tpu_torch.core import wide as tw

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")


def _batches(k, seed, n_batches=6, rows=40, length=200):
    """Reads cut from a 3000-base genome (so k-mers repeat), a few N."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        off = rng.integers(0, genome.size - length, rows)
        codes = genome[off[:, None] + np.arange(length)]
        codes[rng.random(codes.shape) < 0.002] = 4
        out.append(codes.astype(np.uint8))
    return out


@pytest.fixture(scope="module", params=[33, 63, 127])
def counted(request):
    """(k, batches, kat_tpu's table, the port's table) for one k: 1024
    initial slots and two batches a flush, so the table grows twice."""
    k = request.param
    batches = _batches(k, k)
    jc = jw.WideCodeStreamingCounter(k, initial_capacity=1 << 10,
                                     flush_batches=2)
    tcn = tw.WideCodeStreamingCounter(k, initial_capacity=1 << 10,
                                      flush_batches=2, device=CPU)
    for b in batches:
        jc.add_codes(b)
        tcn.add_codes(b)
    return k, batches, jc.finish(), tcn.finish()


def test_wide_counter_matches_jax(counted):
    k, _batches_, jt, tt = counted
    assert tt.capacity == jt.capacity == 1 << 12  # two growth replays
    assert tt.n_unique == int(jt.n_unique) > 2000
    jkeys, jcounts = jw.table_to_numpy(jt)
    tkeys, tcounts = tw.table_to_numpy(tt)
    assert tkeys == jkeys
    np.testing.assert_array_equal(tcounts, jcounts)
    assert bool((tt.keys[:, tt.n_unique:] == tk.SENTINEL).all())
    words, counts = tw.table_words_to_numpy(tt)
    assert words.shape == (tk.words_for_k(k), tt.n_unique)
    np.testing.assert_array_equal(counts, jcounts)


def test_table_from_jax_words_round_trip(counted):
    """kat_tpu's table, fetched as numpy, is the port's table slot for
    slot; built again from its ints or words it is the same."""
    k, _b, jt, tt = counted
    got = tw.table_from_jax_words(tuple(np.asarray(w) for w in jt.words),
                                  np.asarray(jt.counts), jt.n_unique, k,
                                  device=CPU)
    assert got.n_unique == tt.n_unique and got.capacity == tt.capacity
    assert torch.equal(got.keys, tt.keys)
    assert torch.equal(got.counts, tt.counts)
    keys, counts = tw.table_to_numpy(tt)
    rng = np.random.default_rng(k)
    order = rng.permutation(len(keys))  # unsorted, and duplicated below
    shuffled = [keys[i] for i in order] + keys[:5]
    c = np.concatenate([counts[order], np.zeros(5, np.uint32)])
    back = tw.table_from_ints(shuffled, c, k, capacity=tt.capacity,
                              device=CPU)
    assert torch.equal(back.keys, tt.keys)
    assert torch.equal(back.counts, tt.counts)


def test_lookup_wide_matches_jax(counted):
    """Canonical queries of a batch the table counted, and of random
    reads (mostly absent), by the binary search of both packages."""
    k, batches, jt, tt = counted
    rng = np.random.default_rng(1)
    codes = np.concatenate([batches[0][:8],
                            rng.integers(0, 4, (4, 200)).astype(np.uint8)])
    q, _ = tk.extract_kmers_wide(torch.from_numpy(codes), k, True)
    jq, _ = jk.extract_kmers_wide(jnp.asarray(codes), k, True)
    got = tw.lookup_wide(tt, q)
    want = np.asarray(jw.lookup_wide(jt, jq)).astype(np.int32)
    assert got.shape == q.shape[1:]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 100 and (want == 0).sum() > 100


def test_wide_counter_shapes_and_devices():
    """A longer batch flushes first; batches sized by windows; codes on
    another device raise; the table stays empty-shaped before any add."""
    sc = tw.WideCodeStreamingCounter(41, initial_capacity=64,
                                     flush_windows=1000, device=CPU)
    assert sc.finish().n_unique == 0 and sc.table.keys.shape == (2, 64)
    rng = np.random.default_rng(0)
    sc.add_codes(rng.integers(0, 4, (4, 100)).astype(np.uint8))
    assert sc._fb_eff == 1000 // (4 * 60)
    sc.add_codes(rng.integers(0, 4, (2, 150)).astype(np.uint8))
    t = sc.finish()
    assert int(t.counts.sum()) == 4 * 60 + 2 * 110
    with pytest.raises(ValueError, match="codes: on meta"):
        sc.add_codes(torch.empty((2, 64), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="wide keys"):
        tw.WideCodeStreamingCounter(31, device=CPU)


def _meta_table(n_unique, capacity, wide):
    keys_shape = (2, capacity) if wide else (capacity,)
    table = (tw.WideTable if wide else tc.CountTable)(
        torch.empty(keys_shape, dtype=torch.int64, device="meta"),
        torch.empty(capacity, dtype=torch.int32, device="meta"), n_unique)
    return table


@pytest.mark.parametrize("wide", [False, True])
def test_counters_refuse_streams_the_kernels_refuse(wide):
    """2^30 fresh windows raise TableFullError before any launch (K1 takes
    fewer a launch).  A merged stream (table entries + fresh windows) of
    2^30 no longer does: it is reduced in pieces (counting.reduce_stream),
    so the flush goes on to the sort, which refuses the `meta` tensors
    that reach these checks without memory."""
    n_fresh = 1 << 26
    if wide:
        sc = tw.WideCodeStreamingCounter(41, initial_capacity=1 << 30,
                                         device="meta")
        fresh = torch.empty((2, n_fresh), dtype=torch.int64, device="meta")
    else:
        sc = tc.StreamingCounter(initial_capacity=1 << 30, device="meta")
        fresh = torch.empty(n_fresh, dtype=torch.int64, device="meta")
    sc.table = _meta_table((1 << 30) - n_fresh, 1 << 30, wide)
    sc._fresh = [fresh]
    with pytest.raises(ValueError, match="unsupported device meta"):
        sc._flush()
    big = torch.empty((2, 1 << 30) if wide else (1 << 30,),
                      dtype=torch.int64, device="meta")
    sc._fresh = [big]
    with pytest.raises(tc.TableFullError, match="fresh windows"):
        sc._flush()


@pytest.mark.parametrize("wide", [False, True])
def test_hist_reads_counts_unsigned(wide):
    """Counts [1, 5, 2^31, 2^32 - 1, 0] binned 1..10 as kat_tpu bins its
    uint32 counts: the two past 2^31 land in the last bin, the 0 nowhere
    (a narrow and a wide table's int32 counts alike)."""
    counts = np.array([1, 5, 2 ** 31, 2 ** 32 - 1, 0], np.uint32)
    want = np.asarray(jstats.hist_from_counts(jnp.asarray(counts), 1, 10, 1,
                                              10))
    if wide:
        t = tw.table_from_ints([1, 2, 3, 4], counts[:4], 41, capacity=5,
                               device=CPU)
        c = t.counts
    else:
        c = tc.table_from_numpy(np.arange(5, dtype=np.uint64), counts,
                                device=CPU).counts
    got = tstats.hist_from_counts(c, 1, 10, 1, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want) == [1, 0, 0, 0, 1, 0, 0, 0, 0, 2]
