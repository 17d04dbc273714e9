"""kat_tpu_torch.core.counting (plain versions on the CPU) against
kat_tpu.core.counting (XLA on the CPU) on the same code batches made from a
seed: tables and histograms must be equal exactly (integer keys and
counts, tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.core import stats as js
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import stats as ts
from kat_tpu_torch.core.kmers import to_planes

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

K = 27
LENGTH = 128


def _batches(seed, rows_seq, genome_len=3000):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    out = []
    for rows in rows_seq:
        off = rng.integers(0, genome_len - LENGTH, rows)
        b = genome[off[:, None] + np.arange(LENGTH)]
        b[rng.random(b.shape) < 0.003] = 4
        out.append(b)
    return out


def _run_both(batches, **kw):
    j = jc.CodeStreamingCounter(K, **kw)
    t = tc.CodeStreamingCounter(K, device="cpu", **kw)
    for b in batches:
        j.add_codes(b)
        t.add_codes(b)
    jt, tt = j.finish(), t.finish()
    return j, t, jt, tt


def _assert_same(jt, tt):
    jk, jv = jc.table_to_numpy(jt)
    tk, tv = tc.table_to_numpy(tt)
    assert int(jt.n_unique) == tt.n_unique
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("low,high,inc", [(1, 10000, 1), (3, 40, 4)])
def test_counter_and_hist_match_jax(low, high, inc):
    batches = _batches(1, [32] * 5)
    _j, _t, jt, tt = _run_both(batches, initial_capacity=1 << 13,
                               flush_batches=2)
    _assert_same(jt, tt)
    base = low - 1 if low > 1 else 1
    ceil = high + 1
    nb = ceil + 1 - base
    want = np.asarray(js.hist_from_counts(jt.counts, base, ceil, inc, nb))
    got = ts.hist_from_counts(tt.counts, base, ceil, inc, nb)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_capacity_doubling_matches_jax():
    batches = _batches(2, [32] * 4)
    j, t, jt, tt = _run_both(batches, initial_capacity=512, flush_batches=2)
    assert t.capacity == j.capacity > 512
    _assert_same(jt, tt)


def test_row_shape_change_resets_budget():
    """A short first batch, then full ones: the flush budget must be
    recomputed through _set_shape (kat_tpu's 25 GB OOM fix), and smaller
    batches join the current flush."""
    rows_seq = [8, 32, 32, 16, 32]
    batches = _batches(3, rows_seq)
    fw = 2 * 32 * (LENGTH - K + 1)
    j, t, jt, tt = _run_both(batches, initial_capacity=1 << 13,
                             flush_windows=fw)
    _assert_same(jt, tt)
    t2 = tc.CodeStreamingCounter(K, flush_windows=fw, device="cpu")
    t2.add_codes(batches[0])
    assert t2._fb_eff == fw // (8 * (LENGTH - K + 1))
    t2.add_codes(batches[1])
    assert t2._fb_eff == 2 and len(t2._fresh) == 1


def test_table_full_raises_like_jax():
    batches = _batches(4, [32] * 2)
    for mod, kw in ((jc, {}), (tc, {"device": "cpu"})):
        sc = mod.CodeStreamingCounter(K, initial_capacity=256,
                                      disable_grow=True, flush_batches=2,
                                      **kw)
        with pytest.raises(mod.TableFullError):
            for b in batches:
                sc.add_codes(b)
            sc.finish()


def test_tables_carried_across_and_merged():
    """Both packages start from the same table (table_from_jax_numpy /
    to_planes) and merge it with a second one."""
    rng = np.random.default_rng(5)
    keys_a = rng.integers(0, 1 << 54, 700, dtype=np.uint64)
    keys_b = np.concatenate([keys_a[:300], rng.integers(0, 1 << 54, 200,
                                                        dtype=np.uint64)])
    ja = jc.table_from_numpy(keys_a, rng.integers(1, 9, 700), capacity=1024)
    jb = jc.table_from_numpy(keys_b, rng.integers(1, 9, 500), capacity=512)
    pa, pb = (tc.table_from_jax_numpy(np.asarray(t.keys_hi),
                                      np.asarray(t.keys_lo),
                                      np.asarray(t.counts), t.n_unique,
                                      device="cpu")
              for t in (ja, jb))
    hi, lo = to_planes(pa.keys)
    np.testing.assert_array_equal(hi, np.asarray(ja.keys_hi))
    np.testing.assert_array_equal(lo, np.asarray(ja.keys_lo))
    for cap in (2048, 256):  # 256 < n_unique: both report the true count
        _assert_same(jc.merge_tables(ja, jb, capacity=cap),
                     tc.merge_tables(pa, pb, capacity=cap))


def test_table_from_numpy_matches_jax():
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 50, 300).astype(np.uint64)
    counts = rng.integers(1, 5, 300)
    _assert_same(jc.table_from_numpy(keys, counts, capacity=64),
                 tc.table_from_numpy(keys, counts, capacity=64,
                                     device="cpu"))
    empty = tc.empty_table(8, device="cpu")
    assert empty.n_unique == 0 and empty.capacity == 8
    assert tc.table_to_numpy(empty)[0].size == 0
    assert jnp.asarray(jc.empty_table(8).counts).sum() == 0


@pytest.mark.parametrize("flush_windows", [1 << 25, 700])
def test_streaming_counter_matches_jax(flush_windows):
    """The reader-agnostic counter over extracted keys: one flush at the
    end, or several with the table growing from 2^9 slots."""
    from kat_tpu.core import kmers as jk
    from kat_tpu_torch.core import kmers as tk

    batches = _batches(6, [8] * 4)
    j = jc.StreamingCounter(initial_capacity=1 << 9,
                            flush_windows=flush_windows)
    t = tc.StreamingCounter(initial_capacity=1 << 9,
                            flush_windows=flush_windows, key_bits=2 * K + 1,
                            device="cpu")
    for b in batches:
        j.add(*jk.extract_kmers(jnp.asarray(b), K, True))
        keys, valid = tk.extract_kmers(torch.from_numpy(b), K, True)
        t.add(keys, valid)
    jt, tt = j.finish(), t.finish()
    _assert_same(jt, tt)
    assert t.capacity == j.capacity > 1 << 9
    # the code counter is the same engine behind a batch-counting budget
    c = tc.CodeStreamingCounter(K, initial_capacity=1 << 9, device="cpu")
    for b in batches:
        c.add_codes(b)
    ct = c.finish()
    assert torch.equal(ct.keys[:ct.n_unique], tt.keys[:tt.n_unique])


@pytest.mark.parametrize("make", [
    lambda: tc.StreamingCounter(),
    lambda: tc.CodeStreamingCounter(K),
    lambda: tc.empty_table(8),
    lambda: tc.table_from_numpy(np.arange(4, dtype=np.uint64), np.ones(4)),
], ids=["StreamingCounter", "CodeStreamingCounter", "empty_table",
        "table_from_numpy"])
def test_device_must_be_named(make):
    """Nothing in the counting module picks the CPU for a caller that named
    no device."""
    with pytest.raises(TypeError, match="device"):
        make()


def test_counter_never_moves_keys_off_their_device():
    """Keys that lie on another device than the counter's raise instead of
    being moved (the `meta` device stands in for a card here)."""
    sc = tc.StreamingCounter(initial_capacity=16, device="cpu")
    elsewhere = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="keys: on meta"):
        sc.add(elsewhere)
    with pytest.raises(ValueError, match="valid: on meta"):
        sc.add(torch.arange(8), torch.empty(8, dtype=torch.bool,
                                            device="meta"))
    csc = tc.CodeStreamingCounter(K, initial_capacity=16, device="cpu")
    with pytest.raises(ValueError, match="codes: on meta"):
        csc.add_codes(torch.empty((2, 64), dtype=torch.uint8, device="meta"))
    sc.add(torch.arange(8))
    assert sc.finish().n_unique == 8
