"""Tables of MAX_STREAM keys or more built off the flush path
(`counting.merge_tables`, `table_from_numpy`, `wide.table_from_words`,
`ShardedCounter.finish`), and the bucketed flush's final re-sort past
MAX_STREAM distinct keys, against kat_tpu on the CPU.

counting.MAX_STREAM (2^30, the keys that K1 and K3 take a launch) is
lowered to 1500 with monkeypatch, and the kernels' CPU paths
(`reduce_by_key_plain`, `reduce_by_key_words_plain`, `sort_pairs_plain`)
are wrapped to raise at n >= 1500: they stand in for the kernels' 2^30
bound, whatever name a caller imported the wrapper under.  Each table,
of ~4000 distinct keys, must equal kat_tpu's for the same input bit for
bit (tolerance 0: keys and counts are integers)."""

import numpy as np
import pytest
import torch

from kat_tpu.core import bucketed as jbucketed
from kat_tpu.core import counting as jc
from kat_tpu.core import wide as jw
from kat_tpu.parallel import sharded as jsharded
from kat_tpu_torch.core import bucketed, counting, minimizer
from kat_tpu_torch.core import kmers as tk
from kat_tpu_torch.core import wide as tw
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops import reduce_kernel, sort_kernel
from kat_tpu_torch.parallel import sharded

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
LIMIT = 1500


def _bound(monkeypatch, module, name: str) -> list:
    """Lower MAX_STREAM to LIMIT and wrap module.name to raise at n >=
    LIMIT; returns the lengths it is called with."""
    monkeypatch.setattr(counting, "MAX_STREAM", LIMIT)
    calls = []
    real = getattr(module, name)

    def bounded(keys, *args, **kw):
        n = keys.shape[-1]
        calls.append(n)
        if n >= LIMIT:
            raise ValueError(f"{name}: n={n} must be < {LIMIT}")
        return real(keys, *args, **kw)

    monkeypatch.setattr(module, name, bounded)
    return calls


def _bound_reduce(monkeypatch) -> list:
    return (_bound(monkeypatch, reduce_kernel, "reduce_by_key_plain"),
            _bound(monkeypatch, reduce_kernel, "reduce_by_key_words_plain"))


def _in_pieces(calls) -> None:
    """The reduce ran, in more than one piece, each under the limit."""
    assert len(calls) > 1 and max(calls) < LIMIT


def _assert_narrow_equal(got: counting.CountTable, want) -> None:
    wk, wc = jc.table_to_numpy(want)
    gk, gc = counting.table_to_numpy(got)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gc, wc)
    assert got.n_unique == int(want.n_unique) == len(wk) > 2 * LIMIT
    assert got.capacity == want.keys_hi.shape[0]
    assert bool((got.keys[got.n_unique:] == SENTINEL).all())
    assert bool((got.counts[got.n_unique:] == 0).all())


def _narrow_keys(rng, m: int) -> np.ndarray:
    """m 54-bit keys (k = 27) drawn from 5000: many duplicates."""
    pool = rng.integers(0, 1 << 54, 5000, dtype=np.uint64)
    return pool[rng.integers(0, pool.size, m)]


def test_merge_tables_past_the_stream_limit_match_jax(monkeypatch):
    """Two tables of ~2600 keys, about a third shared, merged into ~4300:
    the 2^13-slot stream (its SENTINEL padding one run past the limit) is
    reduced in pieces, equal to kat_tpu's merge_tables."""
    calls, _ = _bound_reduce(monkeypatch)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, 1 << 54, 1000, dtype=np.uint64)
    sides = [np.concatenate([shared, rng.integers(0, 1 << 54, 1700,
                                                  dtype=np.uint64)])
             for _ in range(2)]
    counts = [rng.integers(1, 1 << 20, s.size).astype(np.uint32)
              for s in sides]
    want = jc.merge_tables(*[jc.table_from_numpy(s, c, capacity=1 << 12)
                             for s, c in zip(sides, counts)])
    tables = [counting.table_from_numpy(s, c, capacity=1 << 12, device=CPU)
              for s, c in zip(sides, counts)]
    calls.clear()
    got = counting.merge_tables(*tables)
    _in_pieces(calls)
    _assert_narrow_equal(got, want)


def test_table_from_numpy_past_the_stream_limit_matches_jax(monkeypatch):
    """8000 host keys with duplicates (counts past 2^31 summed as uint32)
    into ~4000 distinct: equal to kat_tpu's table_from_numpy."""
    calls, _ = _bound_reduce(monkeypatch)
    rng = np.random.default_rng(12)
    keys = _narrow_keys(rng, 8000)
    counts = rng.integers(1, 1000, keys.size).astype(np.uint32)
    counts[:3] = [(1 << 31) + 5, 7, (1 << 30)]
    want = jc.table_from_numpy(keys, counts)
    got = counting.table_from_numpy(keys, counts, device=CPU)
    _in_pieces(calls)
    _assert_narrow_equal(got, want)


@pytest.mark.parametrize("k", [41, 95])
def test_table_from_words_past_the_stream_limit_matches_jax(k, monkeypatch):
    """7000 wide keys drawn from 6000 (W = 2 and 4): equal to kat_tpu's
    table_from_ints, through table_from_words and the W-word reduce in
    pieces."""
    _, calls = _bound_reduce(monkeypatch)
    rng = np.random.default_rng(k)
    pool = [int.from_bytes(rng.bytes(32), "little") % (4 ** k)
            for _ in range(6000)]
    keys = [pool[i] for i in rng.integers(0, len(pool), 7000)]
    counts = rng.integers(1, 1000, len(keys)).astype(np.uint32)
    want = jw.table_from_ints(keys, counts, n_words=tk.ref_words_for_k(k))
    got = tw.table_from_ints(keys, counts, k, device=CPU)
    _in_pieces(calls)
    wkeys, wcounts = jw.table_to_numpy(want)
    gkeys, gcounts = tw.table_to_numpy(got)
    assert gkeys == wkeys and len(gkeys) > 2 * LIMIT
    np.testing.assert_array_equal(gcounts, wcounts)
    assert got.n_unique == int(want.n_unique)
    assert got.capacity == len(keys)
    assert bool((got.keys[:, got.n_unique:] == SENTINEL).all())


def _reads(seed: int, n_batches: int = 3, rows: int = 24, length: int = 100):
    """Code batches of random reads: ~4000 distinct k-mers in all."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, (rows, length)).astype(np.uint8)
            for _ in range(n_batches)]


@pytest.mark.parametrize("k", [27, 41])
def test_sharded_finish_past_the_stream_limit_matches_jax(k, monkeypatch):
    """8 shards of ~500 keys each merged by finish() into ~4000: equal to
    kat_tpu's ShardedCounter.finish on its 8 virtual CPU devices."""
    narrow, wide = _bound_reduce(monkeypatch)
    batches = _reads(k)
    tc = sharded.ShardedCounter(sharded.make_mesh(8, devices=["cpu"]), k,
                                shard_capacity=1 << 9, flush_batches=1)
    jsc = jsharded.ShardedCounter(jsharded.make_mesh(8), k,
                                  shard_capacity=1 << 9, flush_batches=1)
    for b in batches:
        tc.add_codes(b)
        jsc.add_codes(b)
    tc.check()
    (narrow if k <= tk.MAX_K else wide).clear()
    got, want = tc.finish(), jsc.finish()
    _in_pieces(narrow if k <= tk.MAX_K else wide)
    if k <= tk.MAX_K:
        _assert_narrow_equal(got, want)
        return
    wkeys, wcounts = jw.table_to_numpy(want)
    gkeys, gcounts = tw.table_to_numpy(got)
    assert gkeys == wkeys and len(gkeys) > 2 * LIMIT
    np.testing.assert_array_equal(gcounts, wcounts)
    assert got.capacity == want.capacity


def test_bucketed_finish_past_the_stream_limit_matches_jax(tmp_path,
                                                          monkeypatch):
    """A bucketed count of ~4000 distinct k-mers (k = 27): finish() sorts
    pieces of fewer than MAX_STREAM keys with sort_pairs and merges them
    with K2's payload form, equal to kat_tpu's bucketed count."""
    calls = _bound(monkeypatch, sort_kernel, "sort_pairs_plain")
    k = 27
    rng = np.random.default_rng(5)
    path = tmp_path / "r.fastq"
    with open(path, "wb") as f:
        for i in range(48):
            s = bytes(rng.choice(list(b"ACGT"), 110).tolist())
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    geo = dict(max_chunks=8, bucket_bits=6, initial_capacity=1 << 13)
    want = jbucketed.count_paths_bucketed(
        [str(path)], k, rec_per_chunk=1024 // minimizer.rec_windows(k), **geo)
    got = bucketed.count_paths_bucketed([str(path)], k, slots_log=10,
                                        device=CPU, **geo)
    assert len(calls) > 1 and max(calls) < LIMIT
    _assert_narrow_equal(got, want)
