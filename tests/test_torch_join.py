"""The port's bulk lookups (ops/join.py, core/tables.py, core/counting.lookup)
against kat_tpu's on the same numpy tables and queries made from a seed.
Exact (tolerance 0): counts are integers.  kat_tpu's join runs its XLA
formulation (use_kernel=False); the port's runs the plain versions of its
kernels, as on any CPU tensor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.ops import join as jjoin
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import tables
from kat_tpu_torch.core.kmers import SENTINEL, to_planes
from kat_tpu_torch.ops import join as tjoin

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _tables(rng, n_keys, capacity):
    """The same table in both packages, and its keys."""
    keys = rng.choice(np.arange(1, 10 * n_keys, dtype=np.uint64),
                      size=n_keys, replace=False)
    cnts = rng.integers(1, 1000, size=n_keys).astype(np.uint32)
    return (jc.table_from_numpy(keys, cnts, capacity=capacity),
            tc.table_from_numpy(keys, cnts, capacity=capacity, device="cpu"),
            np.sort(keys))


def _queries(rng, keys, m):
    """Present keys (some heavily repeated), absent keys just above a
    present key, random absent keys, and SENTINEL queries."""
    pick = rng.integers(0, 4, size=m)
    q = np.empty(m, np.int64)
    q[pick == 0] = rng.choice(keys, size=(pick == 0).sum())
    q[pick == 1] = rng.choice(keys, size=(pick == 1).sum()) + 1
    q[pick == 2] = rng.integers(1, 1 << 40, size=(pick == 2).sum())
    q[pick == 3] = rng.choice(keys[:3], size=(pick == 3).sum())
    q[rng.random(m) < 0.1] = SENTINEL
    return q


def _jax_planes(q):
    return tuple(jnp.asarray(p) for p in to_planes(q))


def _expect(jt, keys, q):
    lut = dict(zip(keys.tolist(), np.asarray(jt.counts[:len(keys)]).tolist()))
    return np.array([lut.get(x, 0) for x in q.reshape(-1).tolist()],
                    np.int32).reshape(q.shape)


@pytest.mark.parametrize("shape,is_sorted", [
    ((5,), False), ((700,), False), ((2048,), False), ((6, 37), False),
    ((700,), True)],
    ids=["m5", "m700", "m2048_above_table", "2d", "sorted"])
def test_counts_join_matches_jax(shape, is_sorted):
    rng = np.random.default_rng(int(np.prod(shape)) + is_sorted)
    jt, tt, keys = _tables(rng, n_keys=300, capacity=1024)
    q = _queries(rng, keys.astype(np.int64), int(np.prod(shape)))
    q = (np.sort(q) if is_sorted else q).reshape(shape)
    want = jjoin.counts_join((jt.keys_hi, jt.keys_lo), jt.counts,
                             _jax_planes(q), use_kernel=False,
                             queries_sorted=is_sorted)
    got = tjoin.counts_join(tt.keys, tt.counts, torch.from_numpy(q),
                            queries_sorted=is_sorted, key_bits=42)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), _expect(jt, keys, q))
    assert 0 < int((got > 0).sum()) < q.size


def test_counts_join_edge_cases():
    rng = np.random.default_rng(3)
    _jt, tt, keys = _tables(rng, n_keys=10, capacity=16)
    empty = tjoin.counts_join(tt.keys, tt.counts,
                              torch.zeros((0, 4), dtype=torch.int64))
    assert empty.shape == (0, 4) and empty.dtype == torch.int32
    # queries below every table key, and a table without padding
    full = tc.CountTable(tt.keys[:10], tt.counts[:10], 10)
    q = torch.tensor([0, int(keys[0]), SENTINEL, int(keys[-1]),
                      int(keys[-1]) + 1])
    got = tjoin.counts_join(full.keys, full.counts, q)
    assert got.tolist() == [0, int(tt.counts[0]), 0, int(tt.counts[9]), 0]
    # an empty table
    none = tc.empty_table(0, device="cpu")
    assert tjoin.counts_join(none.keys, none.counts, q).tolist() == [0] * 5


def test_counts_join_dual_matches_jax_and_two_lookups():
    rng = np.random.default_rng(31)
    ja, ta, _ = _tables(rng, n_keys=220, capacity=512)
    jb, tb, _ = _tables(rng, n_keys=90, capacity=128)
    want_a, want_b = jjoin.counts_join_dual(
        (ja.keys_hi, ja.keys_lo), ja.counts, (jb.keys_hi, jb.keys_lo),
        jb.counts, use_kernel=False)
    got_a, got_b = tjoin.counts_join_dual(ta.keys, ta.counts, tb.keys,
                                          tb.counts)
    np.testing.assert_array_equal(got_a.numpy().astype(np.uint32),
                                  np.asarray(want_a))
    np.testing.assert_array_equal(got_b.numpy().astype(np.uint32),
                                  np.asarray(want_b))
    assert torch.equal(got_a, tc.lookup(tb, ta.keys))
    assert torch.equal(got_b, tc.lookup(ta, tb.keys))
    assert int(got_a.sum()) > 0  # the two key universes overlap


def test_counting_lookup_matches_jax():
    rng = np.random.default_rng(5)
    jt, tt, keys = _tables(rng, n_keys=200, capacity=256)
    q = _queries(rng, keys.astype(np.int64), 333).reshape(9, 37)
    want = jc.lookup(jt, *_jax_planes(q))
    got = tc.lookup(tt, torch.from_numpy(q))
    assert got.shape == (9, 37) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(want))
    assert tc.lookup(tc.empty_table(0, device="cpu"), torch.from_numpy(q)).sum() == 0


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_tables_lookup_join_equals_search(assume_sorted):
    rng = np.random.default_rng(7)
    _jt, tt, keys = _tables(rng, n_keys=500, capacity=512)
    q = _queries(rng, keys.astype(np.int64), 4000)
    q = torch.from_numpy(np.sort(q) if assume_sorted else q)
    by_join = tables.lookup(tt, q, assume_sorted, method="join")
    by_search = tables.lookup(tt, q, assume_sorted, method="search")
    assert torch.equal(by_join, by_search)
    # on a CPU table the policy takes the search, whatever the batch size
    assert not tables._join_policy(1 << 30, tt.capacity, tt.keys.device)
    assert torch.equal(tables.lookup(tt, q, assume_sorted), by_search)
    assert tables.lookup_dual(tt, tt) is None
    with pytest.raises(ValueError, match="method"):
        tables.lookup(tt, q, method="hash")


def test_join_policy_on_a_card_table():
    """The card measured the one-word search faster than the one-word join
    in every cell, so a narrow single lookup takes the search at any size;
    wide lookups and the fused probe take the join from
    max(JOIN_MIN_QUERIES, cap / JOIN_CAP_RATIO) queries."""
    cuda = torch.device("cuda", 0)
    for m in (1 << 16, 1 << 20, 1 << 24, 1 << 30):
        assert not tables._join_policy(m, 1 << 20, cuda)
    assert tables._join_policy(1 << 16, 1 << 20, cuda, 2)
    assert not tables._join_policy((1 << 16) - 1, 1 << 20, cuda, 2)
    assert not tables._join_policy(1 << 16, 1 << 25, cuda, 3)  # m < cap/256
    assert tables._join_policy(1 << 17, 1 << 25, cuda, 9)
    assert tables._join_policy(1 << 20, 1 << 20, cuda, 1, dual=True)


def test_tables_compact_preserves_lookups():
    rng = np.random.default_rng(9)
    _jt, tt, keys = _tables(rng, n_keys=100, capacity=4096)
    small = tables.compact(tt, min_capacity=128)
    assert small.capacity == 128 and small.n_unique == tt.n_unique == 100
    q = torch.from_numpy(_queries(rng, keys.astype(np.int64), 256))
    assert torch.equal(tc.lookup(small, q), tc.lookup(tt, q))
    assert torch.equal(tables.lookup(small, q, method="join"),
                       tc.lookup(tt, q))
    assert tables.compact(small, min_capacity=128) is small  # already tight


def test_table_helpers():
    rng = np.random.default_rng(13)
    _jt, tt, _keys = _tables(rng, n_keys=40, capacity=64)
    mask = tables.real_mask(tt)
    assert int(mask.sum()) == 40 and bool(mask[:40].all())
    gc = tables.gc_of_keys(tt)
    assert gc.shape == (64,) and int(gc[40:].sum()) == 0
    filled = tables.where_real(tt, torch.full((64,), 5), fill=-1)
    assert filled[:40].tolist() == [5] * 40 and filled[40:].tolist() == [-1] * 24
    words, valid = tables.extract(torch.zeros((1, 64), dtype=torch.uint8),
                                  33, True)
    assert words.shape == (2, 1, 32) and bool(valid.all())
    with pytest.raises(ValueError, match="255"):
        tables.extract(torch.zeros((1, 300), dtype=torch.uint8), 256, True)
