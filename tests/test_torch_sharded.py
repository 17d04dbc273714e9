"""The port's mesh-sharded counter (kat_tpu_torch/parallel/sharded.py)
against kat_tpu's on its conftest's 8 virtual CPU devices: the owner hash
bit for bit, every shard's keys, counts and n_unique, the in-place
capacity and route-slack replays, `finish()` against the port's
one-device counters, and the plain W-word K6 against kat_tpu's
`bitonic_merge_runs` in interpret mode.  Tolerance 0 throughout: keys and
counts are integers.  The port's mesh lies on the CPU
(make_mesh(8, devices=['cpu'])), where its wrappers take their kernels'
plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.ops import sort_kernel as jsort
from kat_tpu.parallel import sharded as jsharded
from kat_tpu_torch.core import counting, kmers, wide
from kat_tpu_torch.ops import sort_kernel
from kat_tpu_torch.parallel import sharded

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

HASH_K = (13, 16, 27, 31, 32, 47, 48, 63, 95, 127, 255)
MESH_N = (1, 2, 3, 8, 16)


def _mesh(n=8):
    return sharded.make_mesh(n, devices=["cpu"])


def _random_keys(rng, k, m):
    """m random k-mers: the port's keys (int64, or [W, m] words) and
    kat_tpu's uint32 words of the same keys."""
    if k <= kmers.MAX_K:
        keys = rng.integers(0, 1 << (2 * k), m, dtype=np.int64)
        return keys, kmers.to_planes(keys)
    ints = [int.from_bytes(rng.bytes(32), "little") % (4 ** k)
            for _ in range(m)]
    words = kmers.ints_to_words(ints, k)
    ref = kmers.to_ref_words(words, k)
    return words, tuple(ref[:, i] for i in range(ref.shape[1]))


@pytest.mark.parametrize("k", HASH_K)
def test_owner_shard_matches_kat_tpu(k):
    """fmix32 of kat_tpu's words and the owner of the canonical form, on
    the device path and the host path, bit-exact at every mesh size."""
    rng = np.random.default_rng(k)
    keys, ref = _random_keys(rng, k, 3000)
    got_words = kmers.ref_words(torch.from_numpy(keys), k).numpy()
    assert (got_words.astype(np.uint32) == np.stack(ref)).all()
    want_h = np.asarray(jsharded.shard_hash_words(
        tuple(jnp.asarray(w) for w in ref)))
    got_h = sharded.shard_hash_words(torch.from_numpy(
        np.stack(ref).astype(np.int64))).numpy()
    assert (got_h == want_h.astype(np.int64)).all()
    assert (sharded.shard_hash_words_np(ref) == want_h).all()
    for n in MESH_N:
        want = jsharded.owner_shard_np(ref, k, n).astype(np.int64)
        assert (sharded.owner_shard_np(keys, k, n) == want).all(), n
        assert (sharded.owner_shard(torch.from_numpy(keys), k, n).numpy()
                == want).all(), n


def test_owner_ignores_orientation():
    """A key and its reverse complement have one owner."""
    rng = np.random.default_rng(3)
    for k in (27, 41):
        keys, _ref = _random_keys(rng, k, 500)
        t = torch.from_numpy(keys)
        rc = (kmers.reverse_complement(t, k) if k <= kmers.MAX_K
              else kmers.reverse_complement_words(t, k))
        assert torch.equal(sharded.owner_shard(t, k, 8),
                           sharded.owner_shard(rc, k, 8))


def test_fold_rules():
    assert sharded._fold_shift(27, 8) == 54
    assert sharded._fold_shift(31, 1) == 62
    assert sharded._fold_shift(31, 2) is None
    assert sharded._fold_shift(30, 4) == 60
    assert sharded._fold_shift(30, 5) is None
    assert sharded._fold_shift(41, 8) == 20  # top word of 10 bases
    assert sharded._fold_shift(62, 2) is None  # no spare bits
    assert sharded._fold_shift(255, 16) == 14


def _batches(seed, n_batches=4, rows=37, length=120, genome_len=3000):
    """Reads of a random genome (so k-mers repeat), a few invalid codes."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    out = []
    for _ in range(n_batches):
        off = rng.integers(0, genome_len - length, rows)
        b = np.stack([genome[o:o + length] for o in off])
        b[rng.random(b.shape) < 0.01] = 4
        out.append(b)
    return out


def _jax_shard(jc, s, k):
    """kat_tpu shard s's real (keys as the port's, counts)."""
    n = int(np.asarray(jc.n_unique)[s])
    words = [np.asarray(w)[s, :n] for w in jc.twords]
    keys = (kmers.from_planes(*words) if k <= kmers.MAX_K
            else kmers.from_ref_words(words, k))
    return keys, np.asarray(jc.tc)[s, :n].astype(np.int64)


def _assert_shards_equal(tc, jc, k):
    nu = np.asarray(jc.n_unique).astype(np.int64)
    assert (tc.n_unique == nu).all()
    for s, t in enumerate(tc.tables):
        keys, counts = _jax_shard(jc, s, k)
        n = int(nu[s])
        assert (t.keys[..., :n].numpy() == keys).all(), s
        assert (t.counts[:n].numpy().astype(np.int64) & 0xFFFFFFFF
                == counts).all(), s
        assert (t.keys[..., n:] == kmers.SENTINEL).all()
        assert (t.counts[n:] == 0).all()


def _count_both(batches, k, canonical=True, **kw):
    jc = jsharded.ShardedCounter(jsharded.make_mesh(8), k,
                                 canonical=canonical, **kw)
    tc = sharded.ShardedCounter(_mesh(8), k, canonical=canonical, **kw)
    for b in batches:
        jc.add_codes(b)
        tc.add_codes(b)
    jc.check()
    tc.check()
    return tc, jc


@pytest.mark.parametrize("k,canonical", [(13, True), (27, True),
                                         (31, True), (41, True), (95, True),
                                         (27, False)])
def test_counter_matches_kat_tpu(k, canonical):
    """Every shard's table equals kat_tpu's: narrow keys with the owner
    folded (13, 27) and as a leading word (31), wide keys (41, 95)."""
    tc, jc = _count_both(_batches(k), k, canonical, shard_capacity=1 << 9,
                         flush_batches=2)
    assert tc.dropped == 0
    _assert_shards_equal(tc, jc, k)


def test_counter_matches_kat_tpu_kernel_flush():
    """kat_tpu's Pallas flush (interpret mode: sort, bitonic run merge,
    merge and reduce kernels) gives the same shard tables."""
    batches = _batches(11, n_batches=1, rows=8, length=40)
    jc = jsharded.ShardedCounter(jsharded.make_mesh(8), 27,
                                 shard_capacity=1 << 7, route_slack=8.0,
                                 use_kernel=True)
    tc = sharded.ShardedCounter(_mesh(8), 27, shard_capacity=1 << 7,
                                route_slack=8.0)
    for b in batches:
        jc.add_codes(b)
        tc.add_codes(b)
    jc.check()
    tc.check()
    _assert_shards_equal(tc, jc, 27)


@pytest.mark.parametrize("k", [27, 41])
def test_capacity_replay_matches_kat_tpu(k):
    """Shard tables too small for a flush double in place (the deferred
    settle replays the flush) and end equal to kat_tpu's."""
    tc, jc = _count_both(_batches(5, n_batches=2), k, shard_capacity=1 << 7,
                         flush_batches=1)
    assert tc.shard_capacity > 1 << 7
    assert tc.shard_capacity == jc.shard_capacity
    _assert_shards_equal(tc, jc, k)


def test_capacity_overflow_raises_without_growth():
    tc = sharded.ShardedCounter(_mesh(8), 27, shard_capacity=1 << 4,
                                disable_grow=True)
    tc.add_codes(_batches(5, n_batches=1)[0])
    with pytest.raises(RuntimeError, match="shard table overflow"):
        tc.check()


def _skewed_batches():
    """Most windows are one k-mer (poly-A reads): its owner's bucket
    overflows a small route slack."""
    rng = np.random.default_rng(9)
    b = np.zeros((40, 90), np.uint8)
    b[:8] = rng.integers(0, 4, (8, 90))
    return [b, b.copy()]


@pytest.mark.parametrize("k", [27, 41])
def test_route_slack_replay_matches_kat_tpu(k):
    """Buckets overflow their route_cap slots: the flush counts the drops,
    replays at doubled slack until none drop, and the tables end equal to
    kat_tpu's."""
    batches = _skewed_batches()
    tc = sharded.ShardedCounter(_mesh(8), k, shard_capacity=1 << 9,
                                route_slack=1.0, flush_batches=1)
    tc.add_codes(batches[0])
    tc.flush()
    assert tc.dropped > 0  # the first flush dropped, not settled yet
    tc.add_codes(batches[1])
    tc.check()
    assert tc.dropped == 0 and tc.route_slack > 1.0
    jc = jsharded.ShardedCounter(jsharded.make_mesh(8), k,
                                 shard_capacity=1 << 9, route_slack=1.0,
                                 flush_batches=1)
    for b in batches:
        jc.add_codes(b)
    jc.check()
    _assert_shards_equal(tc, jc, k)


@pytest.mark.parametrize("k,n", [(13, 8), (27, 1), (27, 3), (31, 8),
                                 (41, 8), (62, 2), (95, 5), (255, 8)])
def test_finish_matches_one_device_counter(k, n):
    """The shards merged by finish() equal the one-device counter's table
    bit for bit (keys, counts, n_unique), and the histogram its."""
    batches = _batches(k + n, length=300)
    tc = sharded.ShardedCounter(_mesh(n), k, shard_capacity=1 << 6,
                                flush_batches=3)
    one = (wide.WideCodeStreamingCounter if k > kmers.MAX_K
           else counting.CodeStreamingCounter)(
        k, initial_capacity=1 << 6, device="cpu", flush_batches=3)
    for b in batches:
        tc.add_codes(b)
        one.add_codes(b)
    got, want = tc.finish(), one.finish()
    assert got.n_unique == want.n_unique == int(tc.n_unique.sum())
    n_u = want.n_unique
    assert torch.equal(got.keys[..., :n_u], want.keys[..., :n_u])
    assert torch.equal(got.counts[:n_u], want.counts[:n_u])
    from kat_tpu_torch.core import stats
    assert (tc.histogram(1, 101, 1, 102) == stats.hist_from_counts(
        want.counts, 1, 101, 1, 102).numpy().astype(np.uint64)).all()


def test_mesh_places_shards_round_robin():
    mesh = sharded.make_mesh(5, devices=["cpu", "cpu"])
    assert mesh.n == 5 and mesh.one_device
    assert all(d == torch.device("cpu") for d in mesh.devices)


def test_mesh_without_devices_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(8)


def _runs(k, n, run_len, seed):
    """n keys in n / run_len ascending runs, some sentinel tails, some keys
    shared between runs: the port's [W, n] words and kat_tpu's planes."""
    rng = np.random.default_rng(seed)
    pool = [int.from_bytes(rng.bytes(32), "little") % (4 ** k)
            for _ in range(n // 2)]
    ints = [pool[i] for i in rng.integers(0, len(pool), n)]
    words = kmers.ints_to_words(ints, k)
    for r in range(n // run_len):
        lo, hi = r * run_len, (r + 1) * run_len
        seg = words[:, lo:hi][:, sort_kernel.words_order_plain(
            torch.from_numpy(words[:, lo:hi])).numpy()]
        cut = int(rng.integers(run_len // 2, run_len + 1))
        seg[:, cut:] = kmers.SENTINEL
        words[:, lo:hi] = seg
    ref = kmers.to_ref_words(words, k)
    return words, tuple(jnp.asarray(ref[:, i]) for i in range(ref.shape[1]))


@pytest.mark.parametrize("k", [41, 95])
def test_merge_runs_words_plain_matches_bitonic_merge_runs(k):
    """K6 over W words: the plain version against kat_tpu's runs mode of
    `_window_kernel` in interpret mode, at the smallest geometry it takes
    (n = 8192, run_len = 1024); keys compared through their integer value
    (both word layouts order alike)."""
    n, run_len = 8192, 1024
    words, planes = _runs(k, n, run_len, k)
    got = sort_kernel.merge_runs_words(torch.from_numpy(words), run_len)
    want = jsort.bitonic_merge_runs(planes, len(planes), run_len,
                                    interpret=True)
    want = kmers.from_ref_words([np.asarray(p) for p in want], k)
    assert (got.numpy() == want).all()


def test_merge_runs_words_plain_cases():
    """Any run length, a short last run, one run, ties across runs."""
    rng = np.random.default_rng(2)
    for n, run_len in ((1000, 64), (999, 100), (50, 50), (7, 1), (0, 4)):
        keys = torch.from_numpy(rng.integers(0, 5, (3, n), dtype=np.int64))
        for lo in range(0, n, run_len):
            seg = keys[:, lo:lo + run_len]
            keys[:, lo:lo + run_len] = seg[:, sort_kernel.words_order_plain(
                seg)]
        got = sort_kernel.merge_runs_words(keys, run_len)
        assert torch.equal(got, sort_kernel.sort_words_plain(keys))
    with pytest.raises(ValueError):
        sort_kernel.merge_runs_words(torch.zeros((3, 4), dtype=torch.int64),
                                     0)
