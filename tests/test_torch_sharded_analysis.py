"""The analysis over mesh-sharded tables (kat_tpu_torch/parallel/
analysis.py and longseq.py) against kat_tpu's on its conftest's 8 virtual
CPU devices: the summed histogram, GC matrix and comp passes (two and three
inputs), routed point lookups with skewed and sentinel queries, and the
halo-exchanged window profiles of one long contig, replicated and routed.
The port's mesh lies on the CPU.  Tolerance 0: counts and sums are
integers."""

import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jcounting
from kat_tpu.parallel import analysis as janalysis
from kat_tpu.parallel import longseq as jlongseq
from kat_tpu.parallel import sharded as jsharded
from kat_tpu_torch.core import counting, kmers, tables
from kat_tpu_torch.parallel import analysis, longseq, sharded

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _reads(genome, rng, rows, length=100):
    off = rng.integers(0, genome.size - length, rows)
    b = np.stack([genome[o:o + length] for o in off])
    b[rng.random(b.shape) < 0.01] = 4
    return b


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(17).integers(0, 4, 2500, dtype=np.uint8)


def _count(batches, k, canonical=True):
    jc = jsharded.ShardedCounter(jsharded.make_mesh(8), k,
                                 canonical=canonical, shard_capacity=1 << 9)
    tc = sharded.ShardedCounter(sharded.make_mesh(8, devices=["cpu"]), k,
                                canonical=canonical, shard_capacity=1 << 9)
    for b in batches:
        jc.add_codes(b)
        tc.add_codes(b)
    jc.check()
    tc.check()
    return tc, jc


@pytest.fixture(scope="module")
def counted(genome):
    """Three read sets of one genome counted on both meshes at k = 27 (the
    third non-canonical, at a lower depth) and the first at k = 41."""
    rng = np.random.default_rng(4)
    sets = [[_reads(genome, rng, 64)] for _ in range(2)] + \
        [[_reads(genome, rng, 32)]]
    out = {27: [_count(s, 27, canonical=(i < 2))
                for i, s in enumerate(sets)]}
    out[41] = [_count(sets[0], 41)]
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _assert_tree_equal(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_tree_equal(got[key], want[key])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        assert (_np(got) == _np(want)).all()


@pytest.mark.parametrize("k", [27, 41])
def test_hist_and_gcp_sharded_match_kat_tpu(counted, k):
    tc, jc = counted[k][0]
    assert (analysis.hist_sharded(tc, 1, 101, 1, 102)
            == janalysis.hist_sharded(jc, 1, 101, 1, 102)).all()
    got = analysis.gcp_sharded(tc, k, 200, 0.5)
    assert got.dtype == np.uint64
    assert (got == janalysis.gcp_sharded(jc, k, 200, 0.5)).all()


@pytest.mark.parametrize("three", [False, True])
def test_comp_sharded_matches_kat_tpu(counted, three):
    """All three passes per shard, summed, against kat_tpu's psum over its
    shards; input 3 is non-canonical, so its probes canonicalize."""
    (t1, j1), (t2, j2), (t3, j3) = counted[27]
    kw = dict(k=27, d1_bins=101, d2_bins=61, dm_size=61, d1_scale=1.0,
              d2_scale=0.5, canon2=True, canon3=False, sorted1=True,
              sorted2=True, sorted3=True)
    got = analysis.comp_sharded(t1, t2, t3 if three else None, **kw)
    want = janalysis.comp_sharded(j1, j2, j3 if three else None, **kw)
    _assert_tree_equal(got[0], tuple(want[0]))
    _assert_tree_equal(got[1], tuple(want[1]))
    _assert_tree_equal(got[2], want[2])


def test_comp_sharded_refuses_other_meshes(counted):
    (t1, _j1), _b, _c = counted[27]
    other = sharded.ShardedCounter(sharded.make_mesh(4, devices=["cpu"]),
                                   27)
    with pytest.raises(ValueError, match="different meshes"):
        analysis.comp_sharded(t1, other, None, k=27, d1_bins=11, d2_bins=11,
                              dm_size=11, d1_scale=1.0, d2_scale=1.0,
                              canon2=True, canon3=True)


def _queries(tc, rng, k, m):
    """m queries: a fifth copies of one present key (one owner's bucket
    takes them all), a fifth SENTINEL, the rest drawn from the table's own
    keys and from random k-mers (mostly absent)."""
    host = tc.finish()
    n = host.n_unique
    real = host.keys[..., :n]
    pick = rng.integers(0, n, m)
    q = real[..., torch.from_numpy(pick)].clone()
    absent = torch.from_numpy(rng.random(m) < 0.3)
    if k <= kmers.MAX_K:
        q[absent] = torch.from_numpy(
            rng.integers(0, 1 << (2 * k), int(absent.sum()), dtype=np.int64))
    q[..., : m // 5] = real[..., :1]
    q[..., m // 5: 2 * m // 5] = kmers.SENTINEL
    return q


@pytest.mark.parametrize("k", [27, 41])
def test_sharded_lookup_matches_kat_tpu(counted, k):
    tc, jc = counted[k][0]
    rng = np.random.default_rng(k)
    q = _queries(tc, rng, k, 999)
    svc = analysis.ShardedLookup(tc)
    got = svc.lookup(q)
    ref = (kmers.to_planes(q) if k <= kmers.MAX_K else
           tuple(kmers.to_ref_words(q, k).T))
    want = janalysis.ShardedLookup(jc).lookup(list(ref))
    assert got.shape == (999,)
    assert (got.numpy().astype(np.int64) == want.astype(np.int64)).all()
    assert (got[: 999 // 5] > 0).all()
    assert (got[999 // 5: 2 * 999 // 5] == 0).all()
    # the same counts from the merged table's bulk lookup
    assert torch.equal(got, tables.lookup(tc.finish(), q))
    # the plan holds the skewed bucket: source 0's 125 queries are all
    # copies of one key (a power of two, capped at the row's 125)
    lead = q.shape[:-1]
    padded = torch.cat([q, torch.full((*lead, 1), kmers.SENTINEL)], -1)
    assert svc._plan_qcap(padded.numpy(), 125) == 125
    assert svc._plan_qcap(padded[..., :800].numpy(), 100) == 100


@pytest.mark.parametrize("qcap", [1, 4])
def test_routed_lookup_retries_a_small_capacity(counted, qcap, monkeypatch):
    """A capacity below the largest bucket drops queries; the lookup
    doubles it until none drop, and the counts stay exact."""
    tc, _jc = counted[27][0]
    rng = np.random.default_rng(8)
    q = _queries(tc, rng, 27, 200)
    svc = analysis.ShardedLookup(tc)
    want = svc.lookup(q)
    monkeypatch.setattr(svc, "_plan_qcap", lambda *a: qcap)
    assert torch.equal(svc.lookup(q), want)


def test_window_counts_routed_matches_one_table(counted, genome):
    """Routed window counts of a batch of reads equal the merged table's
    window counts (core/coverage.py)."""
    from kat_tpu_torch.core import coverage

    tc, _jc = counted[27][0]
    codes = torch.from_numpy(_reads(genome, np.random.default_rng(1), 20))
    got = analysis.window_counts_routed(analysis.ShardedLookup(tc), codes,
                                        27, True)
    want = coverage.window_counts(tc.finish(), codes, 27, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _contig(genome):
    c = np.concatenate([genome, genome[:700]]).copy()
    c[[5, 800, 2999]] = 4  # invalid bases
    return c


@pytest.mark.parametrize("k", [27, 41])
def test_halo_profile_routed_matches_kat_tpu(counted, genome, k):
    tc, jc = counted[k][0]
    codes = _contig(genome)
    got = longseq.sharded_window_profile_routed(tc, codes, k, True)
    want = jlongseq.sharded_window_profile_routed(jc, codes, k, True)
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int32
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert len(got[0]) == codes.size - k + 1 and (got[0] > 0).any()


@pytest.mark.parametrize("canonical", [True, False])
def test_halo_profile_replicated_matches_kat_tpu(counted, genome,
                                                 canonical):
    tc, jc = counted[27][0]
    codes = _contig(genome)
    table = tc.finish()
    keys, counts = counting.table_to_numpy(table)
    jt = jcounting.table_from_numpy(keys, counts)
    mesh = sharded.make_mesh(8, devices=["cpu"])
    got = longseq.sharded_window_profile(table, codes, 27, canonical, mesh)
    want = jlongseq.sharded_window_profile(jt, codes, 27, canonical,
                                           jsharded.make_mesh(8))
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert (longseq.sharded_window_counts(table, codes, 27, canonical, mesh)
            == got[0]).all()


def test_halo_profile_of_a_short_contig_is_empty(counted):
    tc, _jc = counted[27][0]
    c, g = longseq.sharded_window_profile_routed(
        tc, np.zeros(10, np.uint8), 27, True)
    assert c.size == 0 and g.size == 0
