"""The port against kat_tpu on kat_tpu's skew, growth and property suites
(tests/test_sharded_skew.py, test_distance_and_growth.py,
test_property_fuzz.py): the same seeded reads through both packages'
sharded counters on a mesh of 8 shards (the port's on the CPU, kat_tpu's
on conftest's 8 virtual CPU devices), their streaming counters as they
grow or refuse to, their `Input.count` at boundary k, and their joins on
random tables.  Each case compares the two tables (or the same exception
class) and holds both against tests/oracle.py.  Exact: keys and counts
are integers."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from kat_tpu.core import counting as jcounting
from kat_tpu.core import wide as jwide
from kat_tpu.io import fastx as jfastx
from kat_tpu.parallel import sharded as jsharded
from kat_tpu.tools import common as jcommon
from kat_tpu_torch.core import counting, kmers, tables, wide
from kat_tpu_torch.io import fastx
from kat_tpu_torch.ops import join
from kat_tpu_torch.parallel import sharded
from kat_tpu_torch.tools import common

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
K = 13


def _table_dict(table):
    """{key: count} of either package's narrow or wide table."""
    if isinstance(table, (wide.WideTable, jwide.WideTable)):
        mod = wide if isinstance(table, wide.WideTable) else jwide
        keys, counts = mod.table_to_numpy(table)
        return dict(zip(keys, counts.tolist()))
    mod = counting if isinstance(table, counting.CountTable) else jcounting
    keys, counts = mod.table_to_numpy(table)
    return dict(zip(keys.tolist(), counts.tolist()))


def _random_reads(seed, n, length, alphabet="ACGT"):
    rng = random.Random(seed)
    return ["".join(rng.choice(alphabet) for _ in range(length))
            for _ in range(n)]


def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{s}\n")


# -- tests/test_sharded_skew.py ------------------------------------------


def _sharded_counts(seqs, **kw):
    """Both packages' sharded counters of 8 shards over the same code
    batches: (port counter, kat_tpu counter, the port's {key: count}); the
    two tables are equal and the oracle's."""
    batches = []
    for mod in (fastx, jfastx):
        recs = [mod.Record(f"s{i}", s.encode()) for i, s in enumerate(seqs)]
        batches.append(list(mod.encode_batches(iter(recs), K,
                                               target_codes=1 << 12)))
    assert all(np.array_equal(a, b) for a, b in zip(*batches))
    assert len(batches[0]) == len(batches[1])
    tc = sharded.ShardedCounter(sharded.make_mesh(8, devices=["cpu"]), K,
                                canonical=True, **kw)
    jc = jsharded.ShardedCounter(jsharded.make_mesh(8), k=K,
                                 canonical=True, **kw)
    for b in batches[0]:
        tc.add_codes(b)
        jc.add_codes(b)
    got = _table_dict(tc.finish())
    assert got == _table_dict(jc.finish())
    assert got == dict(oracle.count_seqs(seqs, K))
    return tc, jc, got


def test_poly_a_floods_one_shard_exactly():
    """Every poly-A window is one canonical key, so one shard receives
    the stream; a tight route slack has to widen."""
    seqs = ["A" * 500] * 40 + ["C" * 300] * 10 + _random_reads(3, 20, 200)
    tc, jc, _got = _sharded_counts(seqs, shard_capacity=1 << 12,
                                   route_slack=1.05)
    assert tc.route_slack > 1.05 and jc.route_slack > 1.05


def test_hot_key_imbalance_factor_reported():
    """One hot key (poly-G, canonically poly-C) is ~90% of the windows:
    the owner hash sends them all to one shard, > 4x the mean load."""
    seqs = ["G" * 500] * 45 + _random_reads(7, 5, 494)
    tc, jc, got = _sharded_counts(seqs, shard_capacity=1 << 12,
                                  route_slack=1.1)
    keys = np.array(sorted(got), np.int64)
    w = np.array([got[int(v)] for v in keys], np.int64)
    dest = sharded.owner_shard_np(keys, K, 8)
    hi, lo = kmers.to_planes(keys)
    raw = np.asarray(jsharded.shard_hash(jnp.asarray(hi), jnp.asarray(lo))
                     % np.uint32(8))
    assert np.array_equal(dest, raw.astype(np.int64))
    assert np.array_equal(dest, jsharded.owner_shard_np(
        (hi, lo), K, 8).astype(np.int64))
    loads = np.bincount(dest, weights=w, minlength=8)
    assert loads.max() / loads.mean() > 4.0
    assert tc.route_slack >= 1.1 and jc.route_slack >= 1.1


def test_mixed_skew_capacity_and_slack_recovery():
    """Low complexity and unique reads from a tiny capacity: capacity and
    slack both grow in one run, and the counts stay exact."""
    seqs = ["AT" * 250] * 30 + _random_reads(11, 40, 300)
    tc, jc, _got = _sharded_counts(seqs, shard_capacity=1 << 8,
                                   route_slack=1.05)
    assert tc.shard_capacity > 1 << 8


def test_shard_hash_on_degenerate_keys():
    """Poly-A, poly-AT, ... canonical keys of k = 5..29 spread under the
    owner hash: no shard owns more than half of them."""
    keys = set()
    for kk in range(5, 30):
        for pat in ("A", "AT", "AC", "AG", "C", "CG"):
            v = oracle.pack((pat * kk)[:kk])
            keys.add(min(v, oracle.revcomp(v, kk)))
    keys = np.array(sorted(keys), np.int64)
    hi, lo = kmers.to_planes(keys)
    want = np.asarray(jsharded.shard_hash(jnp.asarray(hi), jnp.asarray(lo)))
    got = sharded.shard_hash_words(
        [torch.from_numpy(p.astype(np.int64)) for p in (hi, lo)]).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    freq = np.bincount(got % 8, minlength=8)
    assert freq.max() <= len(keys) / 2
    # the owner of each key at the k it came from, in both packages
    for kk in (5, 13, 29):
        sub = keys[keys < (1 << (2 * kk))]
        owner = sharded.owner_shard_np(sub, kk, 8)
        assert np.array_equal(owner, jsharded.owner_shard_np(
            kmers.to_planes(sub), kk, 8).astype(np.int64))


# -- tests/test_distance_and_growth.py -----------------------------------


def _codes(seqs):
    return [kmers.encode_ascii(np.frombuffer(s.encode(), np.uint8))[None]
            for s in seqs]


@pytest.mark.parametrize("k", [15, 33], ids=["narrow", "wide"])
def test_streaming_counter_growth(k):
    """Capacity doubles from 64, several times, in both packages."""
    seqs = (_random_reads(1, 60, 120) if k == 15
            else _random_reads(3, 30, 150))
    fb = 8 if k == 15 else 4
    if k == 15:
        tc = counting.CodeStreamingCounter(
            k, True, initial_capacity=64, max_capacity=1 << 16,
            flush_batches=fb, device=CPU)
        jc = jcounting.CodeStreamingCounter(
            k, True, initial_capacity=64, max_capacity=1 << 16,
            flush_batches=fb)
    else:
        tc = wide.WideCodeStreamingCounter(
            k, True, initial_capacity=64, max_capacity=1 << 16,
            flush_batches=fb, device=CPU)
        jc = jwide.WideCodeStreamingCounter(
            k, True, initial_capacity=64, max_capacity=1 << 16,
            flush_batches=fb)
    for c in _codes(seqs):
        tc.add_codes(c)
        jc.add_codes(c)
    got = _table_dict(tc.finish())
    assert got == _table_dict(jc.finish())
    assert got == dict(oracle.count_seqs(seqs, k))
    assert tc.capacity > 64 and jc.capacity > 64


def test_streaming_counter_disable_grow():
    """With growth disabled both raise TableFullError at 64 slots."""
    seqs = _random_reads(2, 20, 200)
    got = {}
    for name, make in (
            ("port", lambda: counting.CodeStreamingCounter(
                15, True, initial_capacity=64, disable_grow=True,
                device=CPU)),
            ("kat_tpu", lambda: jcounting.CodeStreamingCounter(
                15, True, initial_capacity=64, disable_grow=True))):
        sc = make()
        with pytest.raises(RuntimeError) as e:
            for c in _codes(seqs):
                sc.add_codes(c)
            sc.finish()
        got[name] = type(e.value).__name__
    assert got == {"port": "TableFullError", "kat_tpu": "TableFullError"}


def test_sharded_count_retry_on_overflow(tmp_path, monkeypatch):
    """Input.count on 8 shards from 128 slots a shard (both packages'
    `_next_pow2` capped at 128): kat_tpu restarts at doubled capacity,
    the port grows in place; the tables are equal."""
    seqs = _random_reads(4, 50, 100)
    fa = tmp_path / "f.fa"
    _write_fasta(fa, seqs)
    monkeypatch.setenv("KAT_TPU_SHARD", "1")
    for mod in (common, jcommon):
        monkeypatch.setattr(mod, "_next_pow2",
                            lambda n, f=mod._next_pow2: min(f(n), 128))
    ti = common.Input(paths=[str(fa)], device=CPU, n_shards=8)
    ji = jcommon.Input(paths=[str(fa)])
    for inp in (ti, ji):
        inp.mer_len = 13
        inp.hash_size = 256
        inp.validate()
        inp.count(quiet=True)
    got = _table_dict(ti.host_table())
    assert got == _table_dict(ji.host_table())
    assert got == dict(oracle.count_seqs(seqs, 13))
    assert ti.shards.shard_capacity > 128


# -- tests/test_property_fuzz.py -----------------------------------------


def _count_both(tmp_path, seqs, k, canonical, hash_size):
    fa = tmp_path / "f.fa"
    _write_fasta(fa, seqs)
    ti = common.Input(paths=[str(fa)], device=CPU)
    ji = jcommon.Input(paths=[str(fa)])
    for inp in (ti, ji):
        inp.mer_len = k
        inp.canonical = canonical
        inp.hash_size = hash_size
        inp.validate()
        inp.count(quiet=True)
    got = _table_dict(ti.table)
    assert got == _table_dict(ji.table)
    assert got == dict(oracle.count_seqs(seqs, k, canonical=canonical))


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32, 33, 48, 63])
def test_count_boundary_k(tmp_path, k):
    """Random reads with Ns, a homopolymer, a palindromic repeat and a
    read of exactly k bases, through Input.count from 2048 slots."""
    rng = random.Random(k * 131)
    seqs = []
    for _ in range(25):
        n = rng.randint(max(k, 2), max(k + 50, 120))
        seqs.append("".join(
            rng.choice("ACGTN" if rng.random() < 0.08 else "ACGT")
            for _ in range(n)))
    seqs += ["A" * (k + 9), "ACGT" * ((k + 3) // 4 + 2), "G" * k]
    _count_both(tmp_path, seqs, k, True, 2048)


@pytest.mark.parametrize("k", [5, 31, 33])
def test_count_non_canonical_boundary(tmp_path, k):
    _count_both(tmp_path, _random_reads(k, 10, k + 40), k, False, 4096)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_join_fuzz_random_tables_and_queries(seed):
    """Random tables and queries, sizes on and off the padding
    boundaries, 5% SENTINEL queries: the port's join and binary search
    against kat_tpu's binary search (`counting.lookup`), which kat_tpu's
    own test holds its joins against."""
    rng = np.random.default_rng(seed)
    n_keys = int(rng.integers(3, 700))
    cap = int(rng.integers(n_keys, 2 * n_keys + 64))
    m = int(rng.integers(1, 1500))
    keys = np.unique(rng.integers(1, 1 << 40, size=n_keys * 2,
                                  dtype=np.uint64))[:n_keys]
    cnts = rng.integers(1, 10_000, size=len(keys)).astype(np.uint32)
    q = rng.choice(np.concatenate(
        [keys, rng.integers(1, 1 << 40, size=m, dtype=np.uint64)]), size=m)
    sent = rng.random(m) < 0.05
    q[sent] = np.uint64(0xFFFFFFFFFFFFFFFF)

    jt = jcounting.table_from_numpy(keys, cnts, capacity=cap)
    qhi = jnp.asarray((q >> np.uint64(32)).astype(np.uint32))
    qlo = jnp.asarray((q & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    want = np.asarray(jcounting.lookup(jt, qhi, qlo)).astype(np.int64)

    tt = counting.table_from_numpy(keys, cnts, capacity=cap, device=CPU)
    tq = torch.from_numpy(np.where(sent, kmers.SENTINEL,
                                   q.astype(np.int64)))
    for got in (join.counts_join(tt.keys, tt.counts, tq),
                tables.lookup(tt, tq, method="join"),
                tables.lookup(tt, tq, method="search")):
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want,
                                      err_msg=f"seed={seed} n={n_keys} "
                                      f"cap={cap} m={m}")
