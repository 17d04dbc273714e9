"""The wide join (W-word K1 with a value, W-word K2 with payload planes) and
the piecewise reduce of tables past the kernels' stream limit, against
kat_tpu and numpy on the CPU.  Exact (tolerance 0): keys and counts are
integers.

- ops/join.counts_join and counts_join_dual over [W, n] words against
  kat_tpu's join (its XLA formulation, use_kernel=False) and against the
  port's binary search (wide.lookup_wide): sorted and unsorted queries,
  SENTINEL and absent queries;
- sort_words_pairs_plain and merge_sorted_words_payload_plain against
  numpy's lexsort, W = 2..9 (the plain versions the card is held to);
- tables.lookup and lookup_dual under every route, narrow and wide;
- counting.reduce_stream with counting.MAX_STREAM lowered: the narrow and
  wide counters past the lowered limit against kat_tpu's counters, and
  the pieces against one launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.core import wide as jw
from kat_tpu.ops import join as jjoin
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import kmers as tk
from kat_tpu_torch.core import tables
from kat_tpu_torch.core import wide as tw
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops import join as tjoin
from kat_tpu_torch.ops import reduce_kernel
from kat_tpu_torch.ops.merge_kernel import merge_sorted_words_payload_plain
from kat_tpu_torch.ops.sort_kernel import (sort_words_pairs,
                                           sort_words_pairs_plain)

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")


def _wide_table(k, rng, n_keys, capacity):
    """The same table of n_keys random k-mers in both packages, and its
    keys as ints."""
    keys = sorted({int.from_bytes(rng.bytes(32), "little") % (1 << (2 * k))
                   for _ in range(n_keys)})
    counts = rng.integers(1, 1000, len(keys)).astype(np.uint32)
    counts[:2] = [(1 << 32) - 1, 1 << 31]
    jt = jw.table_from_ints(keys, counts, capacity,
                            n_words=tk.ref_words_for_k(k))
    tt = tw.table_from_ints(keys, counts, k, capacity=capacity, device=CPU)
    return jt, tt, keys


def _wide_queries(k, rng, keys, m):
    """[W, m] words: present keys (some repeated), absent keys one above a
    present key, random keys, and SENTINEL."""
    pick = rng.integers(0, 4, m)
    q = []
    for p in pick:
        if p == 0:
            q.append(keys[rng.integers(len(keys))])
        elif p == 1:
            q.append((keys[rng.integers(len(keys))] + 1) % (1 << (2 * k)))
        elif p == 2:
            q.append(int.from_bytes(rng.bytes(32), "little")
                     % (1 << (2 * k)))
        else:
            q.append(keys[rng.integers(3)])
    words = tk.ints_to_words(q, k)
    words[:, rng.random(m) < 0.1] = SENTINEL
    return words


def _jax_planes(words, k):
    ref = tk.to_ref_words(words, k)
    return tuple(jnp.asarray(ref[:, i]) for i in range(ref.shape[1]))


def _order(words):
    """numpy's stable lexicographic order of [W, n] words (word 0 most
    significant)."""
    return np.lexsort(words[::-1])


@pytest.mark.parametrize("k,m,is_sorted", [
    (41, 700, False), (41, 700, True), (95, 300, False), (255, 64, False)],
    ids=["k41", "k41_sorted", "k95", "k255"])
def test_wide_counts_join_matches_jax_and_search(k, m, is_sorted):
    rng = np.random.default_rng(k + m + is_sorted)
    jt, tt, keys = _wide_table(k, rng, 300, 512)
    q = _wide_queries(k, rng, keys, m)
    if is_sorted:
        q = q[:, _order(q)]
    want = np.asarray(jjoin.counts_join(jt.words, jt.counts,
                                        _jax_planes(q, k),
                                        queries_sorted=is_sorted))
    tq = torch.from_numpy(q)
    got = tjoin.counts_join(tt.keys, tt.counts, tq, queries_sorted=is_sorted,
                            key_bits=2 * k + 1)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert torch.equal(got, tw.lookup_wide(tt, tq))
    assert (want > 0).sum() > m // 4 and (want == 0).sum() > m // 10
    # [W, rows, cols] queries keep their shape
    grid = tq[:, :m // 4 * 4].reshape(q.shape[0], 4, m // 4)
    assert torch.equal(tjoin.counts_join(tt.keys, tt.counts, grid),
                       got[:m // 4 * 4].reshape(4, m // 4))


def test_wide_counts_join_dual_matches_jax_and_search():
    k = 41
    rng = np.random.default_rng(5)
    keys = sorted({int.from_bytes(rng.bytes(16), "little") % (1 << (2 * k))
                   for _ in range(900)})
    a = sorted(rng.choice(len(keys), 500, replace=False).tolist())
    b = sorted(rng.choice(len(keys), 400, replace=False).tolist())
    tabs = []
    for pick, cap in ((a, 1024), (b, 512)):
        ks = [keys[i] for i in pick]
        counts = rng.integers(1, 50, len(ks)).astype(np.uint32)
        tabs.append((jw.table_from_ints(ks, counts, cap,
                                        n_words=tk.ref_words_for_k(k)),
                     tw.table_from_ints(ks, counts, k, capacity=cap,
                                        device=CPU)))
    (ja, ta), (jb, tb) = tabs
    want = jjoin.counts_join_dual(ja.words, ja.counts, jb.words, jb.counts)
    got = tjoin.counts_join_dual(ta.keys, ta.counts, tb.keys, tb.counts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
    assert torch.equal(got[0], tw.lookup_wide(tb, ta.keys))
    assert torch.equal(got[1], tw.lookup_wide(ta, tb.keys))
    assert int((got[0] > 0).sum()) > 100


@pytest.mark.parametrize("W", range(2, 10))
def test_sort_words_pairs_plain_matches_numpy(W):
    """Stable: equal keys (many, and SENTINEL) keep their input order."""
    rng = np.random.default_rng(W)
    n = 3000
    words = rng.integers(0, 1 << 62, (W, n), dtype=np.int64)
    words[:, rng.random(n) < 0.3] = words[:, :1]  # one key, many times
    words[0, rng.random(n) < 0.2] = 7  # equal top words
    words[:, rng.random(n) < 0.1] = SENTINEL
    vals = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    order = _order(words)
    k, v = sort_words_pairs_plain(torch.from_numpy(words),
                                  torch.from_numpy(vals))
    np.testing.assert_array_equal(k.numpy(), words[:, order])
    np.testing.assert_array_equal(v.numpy(), vals[order])
    # the wrapper takes the plain version on a CPU tensor
    k2, v2 = sort_words_pairs(torch.from_numpy(words), torch.from_numpy(vals),
                              63)
    assert torch.equal(k2, k) and torch.equal(v2, v)


@pytest.mark.parametrize("W", range(2, 10))
@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_merge_sorted_words_payload_plain_matches_numpy(W, n_planes):
    """Ties take `a` first; every plane follows its key."""
    rng = np.random.default_rng(10 * W + n_planes)
    both = rng.integers(0, 1 << 62, (W, 1500), dtype=np.int64)
    both[:, ::3] = both[:, 1::3]  # keys shared by both sides
    sides = []
    for lo, hi in ((0, 900), (900, 1500)):
        w = both[:, lo:hi].copy()
        w[:, -5:] = SENTINEL
        o = _order(w)
        planes = [rng.integers(-9, 9, hi - lo).astype(np.int32)
                  for _ in range(n_planes)]
        sides.append((w[:, o], [p[o] for p in planes]))
    (aw, ap), (bw, bp) = sides
    keys, planes = merge_sorted_words_payload_plain(
        torch.from_numpy(aw), tuple(map(torch.from_numpy, ap)),
        torch.from_numpy(bw), tuple(map(torch.from_numpy, bp)))
    cat = np.concatenate([aw, bw], axis=1)
    order = _order(cat)  # stable: a's rows, first, lead each tie
    np.testing.assert_array_equal(keys.numpy(), cat[:, order])
    for got, pa, pb in zip(planes, ap, bp):
        np.testing.assert_array_equal(got.numpy(),
                                      np.concatenate([pa, pb])[order])


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_tables_lookup_every_route(wide, monkeypatch):
    """lookup and lookup_dual by join, search and the policy (forced on
    and off) agree, narrow and wide; on the CPU the policy takes the
    search and lookup_dual returns None."""
    rng = np.random.default_rng(3)
    if wide:
        _jt, tt, keys = _wide_table(41, rng, 400, 512)
        q = torch.from_numpy(_wide_queries(41, rng, keys, 1500))
        m = q.shape[1]
    else:
        keys = np.unique(rng.integers(1, 1 << 40, 400))
        tt = tc.table_from_numpy(keys.astype(np.uint64),
                                 rng.integers(1, 99, keys.size), 512,
                                 device=CPU)
        q = torch.from_numpy(np.where(rng.random(1500) < 0.5,
                                      rng.choice(keys, 1500),
                                      rng.integers(1, 1 << 40, 1500)))
        m = q.numel()
    want = tables.lookup(tt, q, method="search")
    assert torch.equal(tables.lookup(tt, q, method="join",
                                     key_bits=83 if wide else 41), want)
    assert not tables._join_policy(m, tt.capacity, CPU, tt.keys.dim())
    assert torch.equal(tables.lookup(tt, q), want)
    assert tables.lookup_dual(tt, tt) is None
    monkeypatch.setattr(tables, "_join_policy", lambda *a, **kw: True)
    assert torch.equal(tables.lookup(tt, q), want)
    h_ab, h_ba = tables.lookup_dual(tt, tt)
    assert torch.equal(h_ab, tt.counts) and torch.equal(h_ba, tt.counts)
    with pytest.raises(ValueError, match="method"):
        tables.lookup(tt, q, method="hash")


def test_join_policy_follows_the_measurements():
    """On the card the narrow single lookup takes the search; the wide
    lookup and the fused probe take the join at the sizes the card
    measured it faster (PERF.md); nothing takes it on the CPU."""
    cuda = torch.device("cuda", 0)
    for m in (1 << 16, 1 << 20, 1 << 23):
        assert not tables._join_policy(m, 1 << 24, cuda)
        assert not tables._join_policy(m, 1 << 20, CPU, 2)
    assert tables._join_policy(1 << 23, 1 << 24, cuda, 2)
    assert tables._join_policy(1 << 24, 1 << 24, cuda, 1, dual=True)
    assert tables._join_policy(1 << 24, 1 << 24, cuda, 2, dual=True)
    assert not tables._join_policy(1 << 24, 1 << 24, CPU, 2, dual=True)
    assert not tables._join_policy((1 << 16) - 1, 1 << 10, cuda, 2)


# -- tables past the kernels' stream limit, at a lowered limit --

LIMIT = 1500


def _reads(seed, n_batches=24, rows=8, length=200):
    """Reads of a 3000-base genome: ~6000 distinct canonical k-mers, a
    batch of 8 x 200 bases under LIMIT windows."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    out = []
    for _ in range(n_batches):
        off = rng.integers(0, genome.size - length, rows)
        codes = genome[off[:, None] + np.arange(length)]
        codes[rng.random(codes.shape) < 0.002] = 4
        out.append(codes.astype(np.uint8))
    return out


@pytest.mark.parametrize("k", [27, 41])
def test_counters_past_the_stream_limit_match_jax(k, monkeypatch):
    """With MAX_STREAM lowered to 1500, tables of ~4000 distinct keys: the
    merged stream of every later flush passes the limit and is reduced in
    pieces (where the old guard raised TableFullError); the tables equal
    kat_tpu's counters."""
    batches = _reads(k)
    monkeypatch.setattr(tc, "MAX_STREAM", LIMIT)
    calls = []
    real = reduce_kernel.reduce_by_key_words if k > 31 else \
        reduce_kernel.reduce_by_key
    name = real.__name__

    def spy(keys, w, out_size, out=None):
        calls.append(keys.shape[-1])
        return real(keys, w, out_size, out)

    monkeypatch.setattr(tc, name, spy)
    if k > 31:
        jcn = jw.WideCodeStreamingCounter(k, initial_capacity=1 << 10,
                                          flush_batches=1)
        tcn = tw.WideCodeStreamingCounter(k, initial_capacity=1 << 10,
                                          flush_batches=1, device=CPU)
    else:
        jcn = jc.CodeStreamingCounter(k, initial_capacity=1 << 10,
                                      flush_batches=1)
        tcn = tc.CodeStreamingCounter(k, initial_capacity=1 << 10,
                                      flush_batches=1, device=CPU)
    for b in batches:
        jcn.add_codes(b)
        tcn.add_codes(b)
    jt, tt = jcn.finish(), tcn.finish()
    assert tt.n_unique == int(jt.n_unique) > LIMIT * 3 // 2
    assert tt.capacity == jt.capacity
    assert max(calls) < LIMIT and len(calls) > len(batches)
    if k > 31:
        jkeys, jcounts = jw.table_to_numpy(jt)
        tkeys, tcounts = tw.table_to_numpy(tt)
        assert tkeys == jkeys
    else:
        jkeys, jcounts = jc.table_to_numpy(jt)
        tkeys, tcounts = tc.table_to_numpy(tt)
        np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(tcounts, jcounts)
    keys = tt.keys if k > 31 else tt.keys[None]
    assert bool((keys[:, tt.n_unique:] == SENTINEL).all())


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("out_size", [40, 700, 4096])
def test_reduce_stream_pieces_match_one_launch(W, out_size, monkeypatch):
    """Runs of up to 60 equal keys, weights past 2^31 and trailing
    SENTINEL, reduced in pieces of fewer than 100 keys against one
    launch: the same keys, counts and n_unique, also where the output is
    too small (overflow reported, writes past out_size dropped)."""
    rng = np.random.default_rng(W + out_size)
    runs = rng.integers(1, 60, 200)
    n = int(runs.sum())
    first = np.sort(rng.choice(1 << 40, runs.size, replace=False))
    words = np.repeat(np.stack([first + q for q in range(W)]), runs, axis=1)
    words[:, -30:] = SENTINEL
    w = rng.integers(0, 1 << 31, n).astype(np.int64).astype(np.int32)
    keys = torch.from_numpy(words if W > 1 else words[0].copy())
    wt = torch.from_numpy(w)
    one = (reduce_kernel.reduce_by_key_words if W > 1
           else reduce_kernel.reduce_by_key)(keys, wt, out_size)
    monkeypatch.setattr(tc, "MAX_STREAM", 100)
    got = tc.reduce_stream(keys, wt, out_size)
    assert got[2] == int(one[2]) > 150
    assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def test_reduce_stream_refuses_a_run_longer_than_a_piece(monkeypatch):
    monkeypatch.setattr(tc, "MAX_STREAM", 100)
    keys = torch.cat([torch.zeros(150, dtype=torch.int64),
                      torch.arange(1, 60)])
    with pytest.raises(tc.TableFullError, match="run of at least 100"):
        tc.reduce_stream(keys, torch.ones(keys.numel(), dtype=torch.int32),
                         64)
