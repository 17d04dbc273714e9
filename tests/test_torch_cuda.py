"""The port's CUDA kernels (K1 sort, K2 merge, K3 reduce, K4 compact, the
payload forms of K1 and K2, the W-word forms of K1, K2 and K3, the W-word
forms of K1 with a value and K2 with payload planes (the wide join), K5
chunk sort, K6 run merge, one-word and W-word (also at the sharded
flush's arrival shapes and over several passes), K7's round classes and
the binned sums) against their plain PyTorch versions on the card, exactly
(integer keys and counts: tolerance 0); K3 in pieces
(counting.reduce_stream) at a lowered piece length against one launch;
the mesh-sharded counter on a mesh of 8 shards on the card against the
same mesh on the CPU; two processes of one gloo group with a shard each
on the card against one process's mesh of 2; ops/verify.py's
attestation on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor kat_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from kat_tpu_torch.benchmarks import workloads
from kat_tpu_torch.benchmarks.profile_rounds import (MODES, profile_rounds,
                                                     profile_rounds_plain,
                                                     ragged_count)
from kat_tpu_torch.core import bucketed, counting, coverage, minimizer, tables
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops.join import counts_join, counts_join_dual
from kat_tpu_torch.ops.merge_kernel import (
    merge_sorted, merge_sorted_payload, merge_sorted_payload_plain,
    merge_sorted_plain, merge_sorted_words, merge_sorted_words_payload,
    merge_sorted_words_payload_plain, merge_sorted_words_plain)
from kat_tpu_torch.ops.merge_kernel import tile_len as merge_tile_len
from kat_tpu_torch.ops.reduce_kernel import (compact_flagged,
                                             compact_flagged_plain,
                                             reduce_by_key,
                                             reduce_by_key_plain,
                                             reduce_by_key_words,
                                             reduce_by_key_words_plain)
from kat_tpu_torch.ops.reduce_kernel import tile_len as reduce_tile_len
from kat_tpu_torch.ops.sort_kernel import (merge_runs, merge_runs_plain,
                                           merge_runs_words,
                                           merge_runs_words_plain,
                                           sort_chunks, sort_chunks_plain,
                                           sort_keys, sort_keys_plain,
                                           sort_pairs, sort_pairs_plain,
                                           sort_words, sort_words_pairs,
                                           sort_words_pairs_plain,
                                           sort_words_plain, tile_len)

pytestmark = pytest.mark.cuda

TILE = 8192  # K1 keys per block; sizes below straddle it on purpose
TILE_PAIRS = 6144  # K1 pairs per block


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _keys(rng, n, bits=54, sent_frac=0.1):
    k = rng.integers(0, 1 << bits, n, dtype=np.int64)
    k[rng.random(n) < sent_frac] = SENTINEL
    return k


def _sort_case(name, rng):
    n = 3 * TILE + 17
    if name == "random":
        return _keys(rng, n), 55
    if name == "all_equal":
        return np.full(n, 12345, np.int64), 55
    if name == "all_sentinel":
        return np.full(n, SENTINEL, np.int64), 55
    if name == "sorted":
        return np.sort(_keys(rng, n)), 55
    if name == "reversed":
        return np.sort(_keys(rng, n))[::-1].copy(), 55
    if name == "low_digit_ties":
        # equal low digits, distinct high ones: wrong if a pass is unstable
        return (rng.integers(0, 1 << 20, n) << 30) | 77, 55
    if name == "one_pass":
        return rng.integers(0, 127, n), 8
    if name == "tiny":
        return _keys(rng, 5), 55
    if name == "k31":
        return _keys(rng, 1 << 20, bits=62), 63
    if name == "large":
        return _keys(rng, (1 << 22) + 3), 55
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "all_equal", "all_sentinel",
                                  "sorted", "reversed", "low_digit_ties",
                                  "one_pass", "tiny", "k31", "large"])
def test_sort_matches_plain(dev, name):
    keys, bits = _sort_case(name, np.random.default_rng(1))
    t = torch.from_numpy(keys).to(dev)
    before = sort_keys.launches
    got = sort_keys(t, bits)
    torch.cuda.synchronize()
    assert sort_keys.launches == before + 1
    assert torch.equal(got, sort_keys_plain(t))
    assert torch.equal(t.cpu(), torch.from_numpy(keys))  # input untouched


def _table(rng, n_real, cap, universe):
    keys = np.unique(rng.choice(universe, n_real))
    out = np.full(cap, SENTINEL, np.int64)
    out[:len(keys)] = keys
    counts = np.zeros(cap, np.int32)
    counts[:len(keys)] = rng.integers(1, 1000, len(keys))
    return out, counts


@pytest.mark.parametrize("na,nb", [(0, 100), (100, 0), (1, 1),
                                   (3000, 5000), (1 << 20, 1 << 22)])
def test_merge_matches_plain(dev, na, nb):
    rng = np.random.default_rng(na + nb)
    universe = _keys(rng, max(na, nb, 1) * 2, sent_frac=0.0)
    a, ac = _table(rng, na // 2, na, universe)
    b = np.sort(np.where(rng.random(nb) < 0.1, SENTINEL,
                         rng.choice(universe, nb)))
    args = [torch.from_numpy(x).to(dev) for x in (a, ac, b)]
    before = merge_sorted.launches
    gk, gw = merge_sorted(*args)
    torch.cuda.synchronize()
    assert merge_sorted.launches == before + 1
    wk, ww = merge_sorted_plain(*args)
    assert torch.equal(gk, wk) and torch.equal(gw, ww)


def test_merge_all_equal_keys(dev):
    a = torch.full((5000,), 7, dtype=torch.int64, device=dev)
    ac = torch.arange(5000, dtype=torch.int32, device=dev)
    b = torch.full((7000,), 7, dtype=torch.int64, device=dev)
    gk, gw = merge_sorted(a, ac, b)
    wk, ww = merge_sorted_plain(a, ac, b)
    assert torch.equal(gk, wk) and torch.equal(gw, ww)


def _reduce_case(name, rng):
    if name == "random":
        k = np.sort(_keys(rng, 20000, bits=12))
        return k, rng.integers(0, 5, len(k)), 20064
    if name == "overflow":
        k = np.sort(_keys(rng, 20000, bits=14, sent_frac=0.0))
        return k, np.ones(len(k)), 64
    if name == "interior_sentinels":
        # two sorted sentinel-padded runs back to back, not merged
        parts = [np.sort(_keys(rng, 5000, bits=10, sent_frac=0.2))
                 for _ in range(2)]
        k = np.concatenate(parts)
        w = np.where(k == SENTINEL, 0, rng.integers(1, 9, len(k)))
        return k, w, len(k)
    if name == "chunk_stream":
        # the bucketed flush's stream: sorted chunks, each with a sentinel
        # tail of its own, some chunks all sentinel
        k = _keys(rng, 64 * 1024, bits=10, sent_frac=0.3).reshape(64, 1024)
        k[::9] = SENTINEL
        k = np.sort(k, axis=1).reshape(-1)
        return k, (k != SENTINEL).astype(np.int64), len(k)
    if name == "all_sentinel":
        return np.full(9000, SENTINEL, np.int64), np.zeros(9000), 256
    if name == "empty":
        return np.zeros(0, np.int64), np.zeros(0), 100
    if name == "one_run":
        return np.full(3 * 2048 + 5, 42, np.int64), np.full(3 * 2048 + 5, 3), 8
    if name == "no_output":
        return np.sort(_keys(rng, 3000, bits=8)), np.ones(3000), 0
    if name == "large":
        k = np.sort(_keys(rng, 1 << 22, bits=21))
        return k, np.where(k == SENTINEL, 0, 1), 1 << 21
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "overflow", "interior_sentinels",
                                  "chunk_stream", "all_sentinel", "empty",
                                  "one_run", "no_output", "large"])
def test_reduce_matches_plain(dev, name):
    keys, w, out_size = _reduce_case(name, np.random.default_rng(2))
    k = torch.from_numpy(np.asarray(keys, np.int64)).to(dev)
    wt = torch.from_numpy(np.asarray(w, np.int32)).to(dev)
    before = reduce_by_key.launches
    gk, gc, gn = reduce_by_key(k, wt, out_size)
    torch.cuda.synchronize()
    assert reduce_by_key.launches == before + 1
    wk, wc, wn = reduce_by_key_plain(k, wt, out_size)
    assert int(gn) == int(wn)
    assert torch.equal(gk, wk) and torch.equal(gc, wc)


def test_counter_matches_cpu_run(dev):
    """The streaming counter on the card (kernels) and on the CPU (plain
    versions) give the same table, through several capacity doublings."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 1 << 16, dtype=np.uint8)
    batches = []
    for _ in range(6):
        off = rng.integers(0, len(genome) - 300, 256)
        b = np.stack([genome[o:o + 300] for o in off])
        b[rng.random(b.shape) < 0.001] = 4
        batches.append(b)
    tables = []
    for device in (dev, torch.device("cpu")):
        sc = counting.CodeStreamingCounter(
            27, initial_capacity=1 << 10, flush_batches=2, device=device)
        for b in batches:
            sc.add_codes(b)
        tables.append(counting.table_to_numpy(sc.finish()))
        assert sc.capacity >= 1 << 16
    np.testing.assert_array_equal(tables[0][0], tables[1][0])
    np.testing.assert_array_equal(tables[0][1], tables[1][1])


@pytest.mark.parametrize("name", ["random", "all_equal", "all_sentinel",
                                  "sorted", "reversed", "low_digit_ties",
                                  "one_pass", "tiny", "k31", "large"])
def test_sort_pairs_matches_plain(dev, name):
    """Keys AND values equal the stable plain sort: with all-equal or
    tied keys that holds only if every pass is stable."""
    keys, bits = _sort_case(name, np.random.default_rng(4))
    t = torch.from_numpy(keys).to(dev)
    v = torch.arange(t.numel(), dtype=torch.int32, device=dev)
    before = sort_pairs.launches
    gk, gv = sort_pairs(t, v, bits)
    torch.cuda.synchronize()
    assert sort_pairs.launches == before + 1
    wk, wv = sort_pairs_plain(t, v)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert torch.equal(t.cpu(), torch.from_numpy(keys))  # input untouched


def test_sort_pairs_empty(dev):
    k = torch.zeros(0, dtype=torch.int64, device=dev)
    v = torch.zeros(0, dtype=torch.int32, device=dev)
    gk, gv = sort_pairs(k, v, 55)
    assert gk.numel() == 0 and gv.numel() == 0


def test_sort_tiles_are_what_the_tests_assume(dev):
    assert tile_len(False) == TILE and tile_len(True) == TILE_PAIRS


def _k1(t, bits, with_values):
    """(kernel outputs, plain outputs) of K1; with values every key carries
    its position, so an unstable pass shows."""
    if not with_values:
        return (sort_keys(t, bits),), (sort_keys_plain(t),)
    pos = torch.arange(t.numel(), dtype=torch.int32, device=t.device)
    return sort_pairs(t, pos, bits), sort_pairs_plain(t, pos)


def _assert_k1(t, bits, with_values):
    before = t.clone()
    got, want = _k1(t, bits, with_values)
    torch.cuda.synchronize()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert torch.equal(t, before)  # input untouched
    return got


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("bits", [1, 8, 9, 16, 17, 55, 63])
def test_sort_key_bits(dev, bits, with_values):
    """Every pass count, odd and even (the ping-pong's parity), keys that
    fill key_bits - 1 bits, SENTINEL mixed in."""
    rng = np.random.default_rng(bits)
    n = 3 * TILE + 17
    keys = rng.integers(0, 1 << (bits - 1), n, dtype=np.int64)
    keys[rng.random(n) < 0.1] = SENTINEL
    _assert_k1(torch.from_numpy(keys).to(dev), bits, with_values)


def _look_back_case(name, rng, tile):
    n = 40 * tile + 5
    if name == "all_equal":
        return np.full(n, 12345, np.int64)
    if name == "all_sentinel":
        return np.full(n, SENTINEL, np.int64)
    if name == "one_key_90":
        k = _keys(rng, n)
        k[rng.random(n) < 0.9] = 0x2AAAAAAAAAAAAA
        return k
    if name == "sorted":
        return np.sort(_keys(rng, n))
    if name == "one_digit_differs":
        # every pass but one must move nothing
        return rng.integers(0, 256, n, dtype=np.int64) << 16
    if name == "low_bits_only":
        # key_bits overstates the keys: the top five passes move nothing
        return rng.integers(0, 1 << 16, n, dtype=np.int64)
    length = {"n_1": 1, "tile_minus_1": tile - 1, "tile": tile,
              "tile_plus_1": tile + 1, "three_tiles_17": 3 * tile + 17}[name]
    return _keys(rng, length)


@pytest.mark.parametrize("with_values", [False, True])
@pytest.mark.parametrize("name", ["all_equal", "all_sentinel", "one_key_90",
                                  "sorted", "one_digit_differs",
                                  "low_bits_only", "n_1",
                                  "tile_minus_1", "tile", "tile_plus_1",
                                  "three_tiles_17"])
def test_sort_look_back_shapes(dev, name, with_values):
    """One digit chain carrying all or nearly all keys (the uniform-digit
    cases of tests/test_torch_ops.py's pass model among them), sorted
    input, and lengths around the tile."""
    tile = TILE_PAIRS if with_values else TILE
    keys = _look_back_case(name, np.random.default_rng(7), tile)
    _assert_k1(torch.from_numpy(keys).to(dev), 55, with_values)


@pytest.mark.parametrize("with_values", [False, True])
def test_sort_back_to_back_on_different_lengths(dev, with_values):
    """Two sorts in a row may be handed the same scratch memory: the second
    must not see the first one's tile counters or status words."""
    rng = np.random.default_rng(8)
    for n in ((1 << 20) + 11, 5 * TILE + 3, (1 << 20) + 11, 77):
        _assert_k1(torch.from_numpy(_keys(rng, n)).to(dev), 55, with_values)


@pytest.mark.parametrize("with_values", [False, True])
def test_sort_repeats_agree(dev, with_values):
    """A race between tiles shows as a difference between runs."""
    t = torch.from_numpy(_keys(np.random.default_rng(9), 1 << 22)).to(dev)
    first = _assert_k1(t, 55, with_values)
    for _ in range(19):
        again, _ = _k1(t, 55, with_values)
        for a, b in zip(first, again, strict=True):
            assert torch.equal(a, b)


def test_sort_pairs_duplicates_across_tiles_keep_input_order(dev):
    """A handful of distinct keys, each repeated over many tiles: every
    key's values must come out in input order."""
    rng = np.random.default_rng(10)
    n = 20 * TILE_PAIRS + 123
    keys = rng.choice(_keys(rng, 5), n)
    t = torch.from_numpy(keys).to(dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    gk, gv = sort_pairs(t, pos, 55)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(gk.cpu().numpy(), keys[order])
    assert np.array_equal(gv.cpu().numpy(), order.astype(np.int32))


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("na,nb", [(0, 100), (100, 0), (3000, 5000),
                                   (1 << 18, (1 << 19) + 5)])
def test_merge_payload_matches_plain(dev, na, nb, n_planes):
    rng = np.random.default_rng(na + nb + n_planes)
    universe = _keys(rng, max(na, nb, 1), sent_frac=0.0)  # many ties
    a = np.sort(np.where(rng.random(na) < 0.2, SENTINEL,
                         rng.choice(universe, na)))
    b = np.sort(np.where(rng.random(nb) < 0.1, SENTINEL,
                         rng.choice(universe, nb)))
    ak, bk = (torch.from_numpy(x).to(dev) for x in (a, b))
    ap = tuple(torch.from_numpy(rng.integers(-5, 1 << 30, na).astype(
        np.int32)).to(dev) for _ in range(n_planes))
    bp = tuple(torch.from_numpy(rng.integers(-5, 1 << 30, nb).astype(
        np.int32)).to(dev) for _ in range(n_planes))
    before = merge_sorted_payload.launches
    gk, gp = merge_sorted_payload(ak, ap, bk, bp)
    torch.cuda.synchronize()
    assert merge_sorted_payload.launches == before + 1
    wk, wp = merge_sorted_payload_plain(ak, ap, bk, bp)
    assert torch.equal(gk, wk) and len(gp) == n_planes
    for g, w in zip(gp, wp):
        assert torch.equal(g, w)


def test_merge_payload_all_equal_keys(dev):
    a = torch.full((5000,), 7, dtype=torch.int64, device=dev)
    b = torch.full((7000,), 7, dtype=torch.int64, device=dev)
    ap = (torch.arange(5000, dtype=torch.int32, device=dev),)
    bp = (torch.arange(5000, 12000, dtype=torch.int32, device=dev),)
    gk, (gp,) = merge_sorted_payload(a, ap, b, bp)
    # ties take `a` first, both sides in their own order
    assert torch.equal(gp, torch.arange(12000, dtype=torch.int32,
                                        device=dev))
    assert bool((gk == 7).all())


def test_merge_payload_empty(dev):
    e = torch.zeros(0, dtype=torch.int64, device=dev)
    p = (torch.zeros(0, dtype=torch.int32, device=dev),)
    gk, (gp,) = merge_sorted_payload(e, p, e, p)
    assert gk.numel() == 0 and gp.numel() == 0


def _compact_case(name, rng):
    """(n, flag density, out_size as a function of the kept count)."""
    n = 5 * 2048 + 77
    if name == "third":
        return n, 0.33, lambda kept: kept
    if name == "all":
        return n, 1.1, lambda kept: kept
    if name == "none":
        return n, -1.0, lambda kept: 300
    if name == "roomy":
        return n, 0.5, lambda kept: kept + 1000
    if name == "short":
        return n, 0.5, lambda kept: kept // 3
    if name == "no_output":
        return n, 0.5, lambda kept: 0
    if name == "empty":
        return 0, 0.5, lambda kept: 64
    if name == "tiny":
        return 3, 0.5, lambda kept: 3
    if name == "large":
        return (1 << 22) + 3, 0.4, lambda kept: kept
    raise KeyError(name)


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("name", ["third", "all", "none", "roomy", "short",
                                  "no_output", "empty", "tiny", "large"])
def test_compact_matches_plain(dev, name, n_planes, flag_dtype):
    rng = np.random.default_rng(n_planes)
    n, density, out_of = _compact_case(name, rng)
    flag_np = rng.random(n) < density
    planes = tuple(torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, n).astype(np.int32)).to(dev)
        for _ in range(n_planes))
    flag = torch.from_numpy(flag_np).to(dev).to(flag_dtype)
    out_size = out_of(int(flag_np.sum()))
    before = compact_flagged.launches
    got = compact_flagged(planes, flag, out_size)
    torch.cuda.synchronize()
    assert compact_flagged.launches == before + 1
    want = compact_flagged_plain(planes, flag, out_size)
    assert len(got) == n_planes + 1
    assert int(got[-1]) == int(want[-1]) == int(flag_np.sum())
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape == (out_size,) and torch.equal(g, w)


def _lookup_table(rng, n_keys, cap, dev):
    keys = rng.choice(np.arange(1, 10 * n_keys, dtype=np.uint64), n_keys,
                      replace=False)
    t = counting.table_from_numpy(keys, rng.integers(1, 1000, n_keys),
                                  capacity=cap, device="cpu")
    return counting.CountTable(t.keys.to(dev), t.counts.to(dev), t.n_unique)


@pytest.mark.parametrize("m,cap", [(5, 4096), (70000, 4096), (3000, 1 << 17),
                                   (100000, 30000)])
def test_join_matches_search(dev, m, cap):
    """counts_join through the kernels equals the binary search: present,
    absent and SENTINEL queries, a table with and without padding."""
    rng = np.random.default_rng(m)
    n_keys = min(cap, 30000)
    table = _lookup_table(rng, n_keys, cap, dev)
    q = rng.integers(0, 10 * n_keys + 50, (m,)).astype(np.int64)
    present = table.keys[:n_keys].cpu().numpy()
    q[::2] = rng.choice(present, len(q[::2]))
    q[rng.random(m) < 0.1] = SENTINEL
    q = torch.from_numpy(q).to(dev)
    counters = (sort_pairs, merge_sorted_payload, compact_flagged)
    before = [f.launches for f in counters]
    got = counts_join(table.keys, table.counts, q, key_bits=40)
    assert [f.launches for f in counters] == [b + 1 for b in before]
    want = counting.lookup(table, q)
    assert torch.equal(got, want) and int((got > 0).sum()) > 0
    qs = torch.sort(q).values
    assert torch.equal(
        counts_join(table.keys, table.counts, qs, queries_sorted=True),
        counting.lookup(table, qs))


def test_join_dual_matches_two_lookups(dev):
    rng = np.random.default_rng(31)
    t_a = _lookup_table(rng, 22000, 1 << 15, dev)
    t_b = _lookup_table(rng, 9000, 9000, dev)
    got_a, got_b = counts_join_dual(t_a.keys, t_a.counts, t_b.keys,
                                    t_b.counts)
    assert torch.equal(got_a, counting.lookup(t_b, t_a.keys))
    assert torch.equal(got_b, counting.lookup(t_a, t_b.keys))
    assert int(got_a.sum()) > 0


def test_window_counts_join_equals_search(dev):
    """coverage.window_counts by the join on the card gives what the search
    route gives; for a narrow table the policy takes the search (the card
    measured it faster in every narrow cell), so only the forced join
    launches the compaction."""
    rng = np.random.default_rng(8)
    k = 27
    genome = rng.integers(0, 4, 1 << 17, dtype=np.uint8)
    sc = counting.CodeStreamingCounter(k, device=dev)
    sc.add_codes(genome.reshape(128, 1024))
    table = sc.finish()
    codes = genome.reshape(64, 2048).copy()
    codes[rng.random(codes.shape) < 0.002] = 4
    codes[rng.random(codes.shape) < 0.01] ^= 1
    codes = torch.from_numpy(codes).to(dev)
    assert not tables._join_policy(64 * (2048 - k + 1), table.capacity,
                                   table.keys.device)
    before = compact_flagged.launches
    got = coverage.window_counts(table, codes, k, True, method="join")
    assert compact_flagged.launches == before + 1
    want = coverage.window_counts(table, codes, k, True)
    assert compact_flagged.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] > 0).sum()) > 0 and int((~got[2]).sum()) > 0


def test_counter_keeps_card_keys_on_the_card(dev):
    """A counter on the CPU refuses keys that lie on the card (it never
    moves work off it); a counter on the card counts them through K1-K3."""
    keys = torch.arange(5000, dtype=torch.int64, device=dev) % 777
    cpu = counting.StreamingCounter(initial_capacity=1 << 10, device="cpu")
    with pytest.raises(ValueError, match="keys: on cuda"):
        cpu.add(keys)
    counters = (sort_keys, merge_sorted, reduce_by_key)
    before = [f.launches for f in counters]
    sc = counting.StreamingCounter(initial_capacity=1 << 10, key_bits=11,
                                   device=dev)
    sc.add(keys)
    table = sc.finish()
    assert [f.launches for f in counters] == [b + 1 for b in before]
    assert table.keys.device.type == "cuda" and table.n_unique == 777
    assert int(table.counts.sum()) == 5000


def test_sect_tool_launches_the_lookup_kernels(dev, tmp_path):
    """`sect -m 41` through the command line's entry point, on the card:
    contigs that fill one length bucket past the join threshold send their
    lookups through the wide join (K1 W-word with a value, K2 W-word with
    payload planes, K4), and the coverage file equals the CPU run's.  (A
    narrow table's lookups take the search: see the policy.)"""
    from kat_tpu_torch import cli

    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, 1 << 16)]
    fq, fa = tmp_path / "reads.fq", tmp_path / "asm.fa"
    with open(fq, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - 150, 3000)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, genome[o:o + 150].tobytes(),
                                            b"I" * 150))
    with open(fa, "wb") as f:
        for i in range(40):  # 40 rows x 4070 windows > JOIN_MIN_QUERIES
            o = int(rng.integers(0, genome.size - 4096))
            f.write(b">c%d\n%s\n" % (i, genome[o:o + 4096].tobytes()))
        f.write(b">short\n%s\n" % genome[:300].tobytes())
    counters = (sort_words, merge_sorted_words, reduce_by_key_words,
                sort_words_pairs, merge_sorted_words_payload, compact_flagged)
    before = [f.launches for f in counters]
    assert cli.main(["sect", "-m", "41", "-o", str(tmp_path / "gpu"),
                     str(fa), str(fq)]) == 0
    after = [f.launches for f in counters]
    assert all(a > b for a, b in zip(after, before))
    # one bucket above the threshold: exactly one join
    assert [a - b for a, b in zip(after[3:], before[3:])] == [1, 1, 1]
    assert cli.main(["--device", "cpu", "sect", "-m", "41", "-o",
                     str(tmp_path / "cpu"), str(fa), str(fq)]) == 0
    for suffix in ("-counts.cvg", "-stats.tsv"):
        assert (tmp_path / f"gpu{suffix}").read_bytes() \
            == (tmp_path / f"cpu{suffix}").read_bytes()


def _chunk_case(name, rng, chunk, n_chunks):
    n = chunk * n_chunks
    if name == "random":
        return _keys(rng, n, bits=60, sent_frac=0.3)
    if name == "all_sentinel_chunks":
        k = _keys(rng, n, bits=60, sent_frac=0.2).reshape(n_chunks, chunk)
        k[::2] = SENTINEL
        return k.reshape(-1)
    if name == "duplicates":
        return _keys(rng, n, bits=3, sent_frac=0.1)
    if name == "sorted":
        return np.sort(_keys(rng, n, bits=60))
    if name == "reversed":
        return np.sort(_keys(rng, n, bits=60))[::-1].copy()
    if name == "flipped_keyp":  # k = 29: key' with bit 63 flipped
        k = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        k[rng.random(n) < 0.2] = SENTINEL
        return k
    if name == "shared_high_bits":  # a real chunk: 8 router buckets
        top = (np.arange(n) // chunk) * 8 + rng.integers(0, 8, n)
        k = (top << 40) | rng.integers(0, 1 << 40, n)
        k[rng.random(n) < 0.3] = SENTINEL
        return k
    raise KeyError(name)


@pytest.mark.parametrize("chunk,n_chunks", [(32, 5), (64, 3), (1024, 7),
                                            (4096, 3), (8192, 9),
                                            (16384, 133)])
@pytest.mark.parametrize("name", ["random", "all_sentinel_chunks",
                                  "duplicates", "sorted", "reversed",
                                  "flipped_keyp", "shared_high_bits"])
def test_sort_chunks_matches_plain(dev, name, chunk, n_chunks):
    keys = _chunk_case(name, np.random.default_rng(chunk), chunk, n_chunks)
    t = torch.from_numpy(keys).to(dev)
    before = sort_chunks.launches
    got = sort_chunks(t, chunk)
    torch.cuda.synchronize()
    assert sort_chunks.launches == before + 1
    assert torch.equal(got, sort_chunks_plain(t, chunk))
    assert torch.equal(t.cpu(), torch.from_numpy(keys))  # input untouched


def _runs(rng, n, run_len, bits=40):
    """n keys in ascending runs of run_len (the last may be short), each
    with a sentinel tail of its own length."""
    keys = _keys(rng, n, bits=bits, sent_frac=0.0)
    for r, start in enumerate(range(0, n, run_len)):
        run = keys[start:start + run_len]
        run[rng.random(run.size) < 0.15 * (r % 5)] = SENTINEL
        run.sort()
    return keys


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 16, 64])
@pytest.mark.parametrize("run_len", [8192, 3000, 1])
def test_merge_runs_matches_plain(dev, g, run_len):
    rng = np.random.default_rng(g * run_len)
    n = g * run_len - (run_len // 3 if g % 2 else 0)  # a short last run
    keys = _runs(rng, max(n, 1), run_len)
    t = torch.from_numpy(keys).to(dev)
    before = merge_runs.launches
    got = merge_runs(t, run_len)
    torch.cuda.synchronize()
    assert merge_runs.launches == before + 1
    assert torch.equal(got, merge_runs_plain(t, run_len))
    assert torch.equal(t.cpu(), torch.from_numpy(keys))  # input untouched


def test_merge_runs_duplicates_and_negative_keys(dev):
    rng = np.random.default_rng(6)
    keys = _runs(rng, 5 * 4096, 4096, bits=4)
    keys[keys != SENTINEL] -= 8
    t = torch.from_numpy(keys).to(dev)
    assert torch.equal(merge_runs(t, 4096), merge_runs_plain(t, 4096))


@pytest.mark.parametrize("k", [27, *workloads.WIDE_STRAIN_K])
@pytest.mark.parametrize("run_len,real", [(1 << 16, 1 << 14), (3001, 750),
                                          (4096, 0), (5000, 5000)])
def test_merge_runs_sharded_shapes(dev, k, run_len, real):
    """K6 at the sharded flush's arrival shape, scaled down: 8 runs with
    SENTINEL tails at 3/4 (and a run length off every tile, no real key at
    all, no tail), one word (k = 27) and W = 2..9: one launch a call, the
    input untouched, equal to the plain version."""
    g = torch.Generator(device=dev)
    g.manual_seed(k + run_len)
    keys = workloads.sharded_runs(k, dev, g, run_len=run_len, real=real)
    fn, plain = ((merge_runs, merge_runs_plain) if keys.dim() == 1 else
                 (merge_runs_words, merge_runs_words_plain))
    kept = keys.clone()
    before = fn.launches
    got = fn(keys, run_len)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, plain(keys, run_len))
    assert torch.equal(keys, kept)  # input untouched


@pytest.mark.parametrize("n_words", [1, 2, 9])
@pytest.mark.parametrize("g_runs", [17, 33, 128, 300])
def test_merge_runs_many_passes(dev, n_words, g_runs):
    """More than 16 runs take several passes through the ping-pong buffer
    (2 for 17-256, 3 for 300): runs of 1024 keys with 30% SENTINEL, the
    last short; equal to the plain version and to merge_runs_model at the
    card's tile."""
    from kat_tpu_torch.ops.sort_kernel import (merge_passes,
                                               merge_runs_model,
                                               merge_runs_tile)

    rng = np.random.default_rng(g_runs + n_words)
    run_len = 1024
    n = g_runs * run_len - 100
    if n_words == 1:
        keys = torch.from_numpy(_runs(rng, n, run_len)).to(dev)
        fn, plain = merge_runs, merge_runs_plain
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(g_runs)
        k = {2: 41, 9: 255}[n_words]
        keys = workloads.sorted_runs(
            workloads.wide_keys(k, n, dev, g, sent=0.3), run_len)
        fn, plain = merge_runs_words, merge_runs_words_plain
    assert len(merge_passes(n, run_len)) == (3 if g_runs > 256 else 2)
    got = fn(keys, run_len)
    assert torch.equal(got, plain(keys, run_len))
    assert torch.equal(got, merge_runs_model(keys, run_len,
                                             merge_runs_tile(n_words)))


@pytest.mark.parametrize("mode", MODES)
def test_profile_rounds_matches_plain(dev, mode):
    """K7 on the card: every class of kat_tpu's profile_roll.py, on the
    class's `ragged_count` keys (a partial last block of pairs wherever 2 S
    is below a block's 2048 keys: the kernel's guarded loads and stores)
    and on 3 x 2^16 (three of rowsel-256's 65,536-key blocks)."""
    rng = np.random.default_rng(2)
    for n in (ragged_count(mode), 3 << 16):
        keys = torch.from_numpy(
            rng.integers(-(1 << 63), (1 << 63) - 1, n)).to(dev)
        for rounds in (0, 1, 7):
            before = profile_rounds.launches
            got = profile_rounds(keys, mode, rounds)
            torch.cuda.synchronize()
            assert profile_rounds.launches == before + 1
            assert torch.equal(got, profile_rounds_plain(keys, mode, rounds))


def test_bucketed_counter_on_the_card(dev, tmp_path):
    """count_paths_bucketed on the card launches K5, K6 (poly-A reads make a
    hot group), K3, K2 with counts and sort_pairs, and gives the table of
    the classic flush."""
    from kat_tpu_torch.tools.common import Input

    rng = np.random.default_rng(23)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, 1 << 16)]
    fq = tmp_path / "reads.fq"
    with open(fq, "wb") as f:
        for i, o in enumerate(rng.integers(0, genome.size - 150, 4000)):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, genome[o:o + 150].tobytes(),
                                            b"I" * 150))
        for i in range(200):
            f.write(b"@a%d\n%s\n+\n%s\n" % (i, b"A" * 300, b"I" * 300))
    for k in (27, 29):
        counters = (sort_chunks, merge_runs, reduce_by_key,
                    merge_sorted_payload, sort_pairs)
        before = [f.launches for f in counters]
        stats = {}
        got = bucketed.count_paths_bucketed(
            [str(fq)], k, max_chunks=64,
            slots_log=10, bucket_bits=8,
            initial_capacity=1 << 12, device=dev, stats=stats)
        after = [f.launches for f in counters]
        assert all(a > b for a, b in zip(after, before)), (before, after)
        assert stats["groups"] >= 1
        assert after[1] - before[1] == stats["groups"]
        inp = Input([str(fq)], mer_len=k, device=dev)
        inp.count(quiet=True)
        n = got.n_unique
        assert n == inp.table.n_unique
        assert torch.equal(got.keys[:n], inp.table.keys[:n])
        assert torch.equal(got.counts[:n], inp.table.counts[:n])
        cpu = bucketed.count_paths_bucketed(
            [str(fq)], k, max_chunks=64,
            slots_log=10, bucket_bits=8,
            initial_capacity=1 << 12, device="cpu")
        assert torch.equal(got.keys.cpu(), cpu.keys)
        assert torch.equal(got.counts.cpu(), cpu.counts)


# -- K3 and K2 where their single pass can go wrong, at the path's shapes ---

@functools.lru_cache(maxsize=1)
def _flush_shapes(device: str):
    """workloads.flush_shapes on the card, built once for the module."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    return workloads.flush_shapes(dev, g)


def _k3_strain(name, dev):
    """(keys, weights, out_size) on the card."""
    _tk, _tc, _f, mk, mw, _q = (_flush_shapes(str(dev)) if "main" in name
                                else (None,) * 6)
    if name == "main_path_shape":
        return mk, mw, 1 << 24
    if name == "main_path_overflow":
        return mk, mw, 1 << 20
    g = torch.Generator(device=dev)
    g.manual_seed(len(name))
    return workloads.reduce_strain(name, reduce_tile_len(), dev, g)


@pytest.mark.parametrize("name", ["main_path_shape", "main_path_overflow",
                                  *workloads.REDUCE_STRAIN])
def test_reduce_strain(dev, name):
    """One run across every tile (the longest chain of open sums through
    the look-back), sentinel runs inside the stream, more runs than slots,
    no slots, one element, lengths around the tile, and the main path's
    83.9M-element merge into 2^24 and 2^20 slots."""
    k, w, out_size = _k3_strain(name, dev)
    before = reduce_by_key.launches
    gk, gc, gn = reduce_by_key(k, w, out_size)
    torch.cuda.synchronize()
    assert reduce_by_key.launches == before + 1
    wk, wc, wn = reduce_by_key_plain(k, w, out_size)
    assert int(gn) == int(wn)
    assert torch.equal(gk, wk) and torch.equal(gc, wc)


def _k2_strain(name, dev):
    """(table keys, table counts, fresh keys) on the card."""
    if name == "main_path_shape":
        t_keys, t_counts, fresh, _mk, _mw, _q = _flush_shapes(str(dev))
        return t_keys, t_counts, fresh
    g = torch.Generator(device=dev)
    g.manual_seed(len(name) + 50)
    return workloads.merge_strain(name, merge_tile_len(), dev, g)


@pytest.mark.parametrize("name", ["main_path_shape", *workloads.MERGE_STRAIN])
def test_merge_strain(dev, name):
    """Tile splits where one side is empty, where every key ties, where one
    side lies wholly before the other, lengths around the tile, and the
    main path's 2^24 + 2^26 merge."""
    a, ac, b = _k2_strain(name, dev)
    before = merge_sorted.launches
    gk, gw = merge_sorted(a, ac, b)
    torch.cuda.synchronize()
    assert merge_sorted.launches == before + 1
    wk, ww = merge_sorted_plain(a, ac, b)
    assert torch.equal(gk, wk) and torch.equal(gw, ww)


@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_merge_payload_at_the_join_shape(dev, n_planes):
    """The join's merge: a 2^24-slot table and 2^23 sorted queries, each
    side carrying n_planes planes."""
    t_keys, _tc, _f, _mk, _mw, q = _flush_shapes(str(dev))
    g = torch.Generator(device=dev)
    g.manual_seed(n_planes)
    ap = tuple(torch.randint(-5, 1 << 30, (t_keys.numel(),),
                             dtype=torch.int32, device=dev, generator=g)
               for _ in range(n_planes))
    bp = tuple(torch.randint(-5, 1 << 30, (q.numel(),), dtype=torch.int32,
                             device=dev, generator=g)
               for _ in range(n_planes))
    gk, gp = merge_sorted_payload(t_keys, ap, q, bp)
    wk, wp = merge_sorted_payload_plain(t_keys, ap, q, bp)
    assert torch.equal(gk, wk)
    for x, y in zip(gp, wp, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("what", ["reduce", "merge", "merge_payload"])
def test_flush_kernels_repeat(dev, what):
    """Five runs on one input at the path's shapes give equal outputs: a
    race between tiles shows as a difference between runs."""
    t_keys, t_counts, fresh, mk, mw, q = _flush_shapes(str(dev))
    ap = (torch.full((t_keys.numel(),), -1, dtype=torch.int32, device=dev),)
    bp = (torch.arange(q.numel(), dtype=torch.int32, device=dev),)
    run = {"reduce": lambda: reduce_by_key(mk, mw, 1 << 24),
           "merge": lambda: merge_sorted(t_keys, t_counts, fresh),
           "merge_payload": lambda: (lambda k, p: (k, *p))(
               *merge_sorted_payload(t_keys, ap, q, bp))}[what]
    first = run()
    for _ in range(4):
        again = run()
        for x, y in zip(first, again, strict=True):
            assert torch.equal(x, y)


# --- the W-word forms of K1, K2 and K3 (wide keys, 31 < k <= 255) ---

WIDE_N = 3 * TILE + 17  # straddles every W-word kernel's tile


def _wide_case(dev, name, k):
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    return workloads.wide_strain(name, k, WIDE_N, dev, g), g


@pytest.mark.parametrize("name", workloads.WIDE_STRAIN + workloads.WIDE_SKEW)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_sort_words_matches_plain(dev, name, k):
    """K1 W-word at W = 2..9, the top word full or one base wide; the skewed
    keys fill one bucket past what a block sorts (the fallback passes)."""
    from kat_tpu_torch.core.kmers import top_bases

    keys, _g = _wide_case(dev, name, k)
    got = sort_words(keys, 2 * top_bases(k) + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, sort_words_plain(keys))


@pytest.mark.parametrize("name", workloads.WIDE_STRAIN)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_merge_words_matches_plain(dev, name, k):
    """K2 W-word; the table is the prefix of a wider buffer, as the flush
    passes its real entries (planes that lie apart)."""
    keys, g = _wide_case(dev, name, k)
    a, ac, b = workloads.wide_merge_inputs(keys, g)
    buf = torch.full((a.shape[0], a.shape[1] + 1000), SENTINEL,
                     dtype=torch.int64, device=dev)
    buf[:, :a.shape[1]] = a
    got = merge_sorted_words(buf[:, :a.shape[1]], ac, b)
    torch.cuda.synchronize()
    want = merge_sorted_words_plain(a, ac, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("name", workloads.WIDE_STRAIN)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_reduce_words_matches_plain(dev, name, k):
    """K3 W-word into room for every run, and into too few slots (the true
    n_unique must come back)."""
    keys, g = _wide_case(dev, name, k)
    sk, w = workloads.wide_reduce_inputs(keys, g)
    for out_size in (WIDE_N, 100):
        got = reduce_by_key_words(sk, w, out_size)
        want = reduce_by_key_words_plain(sk, w, out_size)
        torch.cuda.synchronize()
        assert int(got[2]) == int(want[2])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 3071, 3073, 4095,
                               4097, 6143, 6144, 6145, 8191, 8192, 8193])
@pytest.mark.parametrize("k", [41, 255])
def test_words_kernels_at_tile_edges(dev, k, n):
    """The three W-word kernels at lengths around their tiles (the merge's
    1024-3072 outputs, the reduce's 4096, the sort's split passes' 6144,
    its bucket sort's 4096 and fallback passes' 8192) and at one or two
    keys, W = 2 and 9."""
    from kat_tpu_torch.core.kmers import top_bases

    g = torch.Generator(device=dev)
    g.manual_seed(n)
    keys = workloads.wide_keys(k, n, dev, g)
    assert torch.equal(sort_words(keys, 2 * top_bases(k) + 1),
                       sort_words_plain(keys))
    both = torch.cat([keys, workloads.wide_keys(k, 2 * n, dev, g)], dim=1)
    a, ac, b = workloads.wide_merge_inputs(both, g)
    got = merge_sorted_words(a, ac, b)
    want = merge_sorted_words_plain(a, ac, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sk, w = workloads.wide_reduce_inputs(keys, g)
    got = reduce_by_key_words(sk, w, n)
    want = reduce_by_key_words_plain(sk, w, n)
    torch.cuda.synchronize()
    assert int(got[2]) == int(want[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wide_counter_on_the_card(dev):
    """WideCodeStreamingCounter on the card equals the same counter on the
    CPU (plain versions), with growth replays, and launched each W-word
    kernel."""
    from kat_tpu_torch.core import wide

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    batches = [genome[rng.integers(0, 19_000, 64)[:, None] + np.arange(900)]
               for _ in range(6)]
    fns = (sort_words, merge_sorted_words, reduce_by_key_words)
    tables = []
    for where in (dev, torch.device("cpu")):
        for fn in fns:
            fn.launches = 0
        sc = wide.WideCodeStreamingCounter(95, initial_capacity=1 << 12,
                                           flush_batches=2, device=where)
        for b in batches:
            sc.add_codes(b)
        tables.append(sc.finish())
        if where == dev:
            assert min(fn.launches for fn in fns) >= 1
    assert tables[0].n_unique == tables[1].n_unique
    assert torch.equal(tables[0].keys.cpu(), tables[1].keys)
    assert torch.equal(tables[0].counts.cpu(), tables[1].counts)


# --- the wide join: K1 W-word with a value, K2 W-word with payload planes ---

def _planes(n, n_planes, g, dev):
    return tuple(torch.randint(-(1 << 31), (1 << 31) - 1, (n,),
                               dtype=torch.int32, device=dev, generator=g)
                 for _ in range(n_planes))


@pytest.mark.parametrize("name", workloads.WIDE_STRAIN + workloads.WIDE_SKEW)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_sort_words_pairs_matches_plain(dev, name, k):
    """K1 W-word carrying a value, W = 2..9: equal keys (one run, all
    SENTINEL, equal top words) keep their values' input order."""
    from kat_tpu_torch.core.kmers import top_bases

    keys, g = _wide_case(dev, name, k)
    (vals,) = _planes(keys.shape[1], 1, g, dev)
    before = sort_words_pairs.launches
    gk, gv = sort_words_pairs(keys, vals, 2 * top_bases(k) + 1)
    torch.cuda.synchronize()
    assert sort_words_pairs.launches == before + 1
    wk, wv = sort_words_pairs_plain(keys, vals)
    assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_sort_words_fallback_and_clustered_units(dev, k):
    """Both W-word sorts where the bucket sort gives way: one bucket of
    50,000 keys (the fallback passes, with an odd and an even number of
    digits across k), 2^16 copies of one key among random ones, and a unit
    whose keys cluster below its spread (the merge sort); one host read a
    call."""
    from kat_tpu_torch.core.kmers import top_bases
    from kat_tpu_torch.ops.sort_kernel import BUCKET_CAP, words_bucket_cap

    assert words_bucket_cap() == BUCKET_CAP
    tb = 2 * top_bases(k) + 1
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    wide = workloads.wide_strain("one_prefix", k, 50_000, dev, g)
    hot = workloads.wide_keys(k, 1 << 18, dev, g)
    hot[:, torch.randperm(1 << 18, device=dev, generator=g)[:1 << 16]] = \
        hot[:, :1]
    near = workloads.wide_keys(k, 3000, dev, g, sent=0.0)
    near[0] = near[0, :1]
    near[-1] = torch.randint(0, 1 << 20, (3000,), device=dev, generator=g)
    near[-1, :5] = 1 << 61
    for keys in (wide, hot, near):
        vals = torch.arange(keys.shape[1], dtype=torch.int32, device=dev)
        before = (sort_words.host_reads, sort_words_pairs.host_reads)
        got = sort_words(keys, tb)
        gk, gv = sort_words_pairs(keys, vals, tb)
        torch.cuda.synchronize()
        assert (sort_words.host_reads, sort_words_pairs.host_reads) == \
            (before[0] + 1, before[1] + 1)
        wk, wv = sort_words_pairs_plain(keys, vals)
        assert torch.equal(got, wk)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("case", ["unaligned", "sparse"])
def test_compact_flagged_views_and_sparse_tiles(dev, case):
    """K4 on planes and flags that start off a 16-byte boundary (views one
    element in), and on flags so sparse that the tiles read their kept
    elements where they lie instead of staging the planes."""
    rng = np.random.default_rng(7)
    n = (1 << 20) + 5
    density = 0.5 if case == "unaligned" else 0.03
    flag_np = rng.random(n + 1) < density
    raw = [torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n + 1).astype(
        np.int32)).to(dev) for _ in range(2)]
    flag = torch.from_numpy(flag_np).to(dev)
    if case == "unaligned":
        planes, flag = tuple(p[1:] for p in raw), flag[1:]
    else:
        planes, flag = tuple(p[:n] for p in raw), flag[:n]
    kept = int(flag.sum())
    for out_size in (kept, kept // 2, kept + 100):
        got = compact_flagged(planes, flag, out_size)
        want = compact_flagged_plain(planes, flag, out_size)
        torch.cuda.synchronize()
        assert int(got[-1]) == int(want[-1]) == kept
        for x, y in zip(got[:-1], want[:-1]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("name", workloads.WIDE_STRAIN)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_merge_words_payload_matches_plain(dev, name, k, n_planes):
    """K2 W-word with 1-3 planes on both sides, ties taking `a` first; the
    table is the prefix of a wider buffer (planes that lie apart)."""
    keys, g = _wide_case(dev, name, k)
    a, _ac, b = workloads.wide_merge_inputs(keys, g)
    ap = _planes(a.shape[1], n_planes, g, dev)
    bp = _planes(b.shape[1], n_planes, g, dev)
    buf = torch.full((a.shape[0], a.shape[1] + 1000), SENTINEL,
                     dtype=torch.int64, device=dev)
    buf[:, :a.shape[1]] = a
    before = merge_sorted_words_payload.launches
    gk, gp = merge_sorted_words_payload(buf[:, :a.shape[1]], ap, b, bp)
    torch.cuda.synchronize()
    assert merge_sorted_words_payload.launches == before + 1
    wk, wp = merge_sorted_words_payload_plain(a, ap, b, bp)
    assert torch.equal(gk, wk)
    for x, y in zip(gp, wp, strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 2047, 2049, 3071,
                               3073, 8191, 8192, 8193])
@pytest.mark.parametrize("k", [41, 95, 255])
def test_wide_join_kernels_at_tile_edges(dev, k, n):
    """Both new forms at lengths around their tiles (the merge's 1024, 2048
    and 3072 outputs, the sort's 8192) and at one or two keys, W = 2, 4
    and 9; the merge with one side empty."""
    from kat_tpu_torch.core.kmers import top_bases

    g = torch.Generator(device=dev)
    g.manual_seed(n + k)
    keys = workloads.wide_keys(k, n, dev, g)
    (vals,) = _planes(n, 1, g, dev)
    got = sort_words_pairs(keys, vals, 2 * top_bases(k) + 1)
    want = sort_words_pairs_plain(keys, vals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    both = torch.cat([keys, workloads.wide_keys(k, 2 * n, dev, g)], dim=1)
    a, _ac, b = workloads.wide_merge_inputs(both, g)
    for a_, b_ in ((a, b), (a[:, :0], b), (a, b[:, :0])):
        ap, bp = _planes(a_.shape[1], 2, g, dev), _planes(b_.shape[1], 2, g,
                                                          dev)
        got = merge_sorted_words_payload(a_, ap, b_, bp)
        want = merge_sorted_words_payload_plain(a_, ap, b_, bp)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        for x, y in zip(got[1], want[1], strict=True):
            assert torch.equal(x, y)


def test_wide_join_on_the_card(dev):
    """counts_join and counts_join_dual over W-word keys on the card equal
    the binary search on the card and the same join on the CPU."""
    from kat_tpu_torch.core import wide

    g = torch.Generator(device=dev)
    g.manual_seed(41)
    keys = workloads.wide_keys(41, 300_000, dev, g, sent=0.0)
    t = wide.table_from_words(keys.cpu().numpy(),
                              np.ones(keys.shape[1], np.int64), 1 << 19,
                              device=dev)
    q = torch.cat([keys[:, ::3], workloads.wide_keys(41, 200_000, dev, g)],
                  dim=1).reshape(2, 100, -1)
    got = counts_join(t.keys, t.counts, q, key_bits=83)
    assert torch.equal(got, wide.lookup_wide(t, q))
    cpu = counts_join(t.keys.cpu(), t.counts.cpu(), q.cpu(), key_bits=83)
    assert torch.equal(got.cpu(), cpu)
    t2 = wide.table_from_words(q.reshape(2, -1).cpu().numpy(),
                               np.ones(q[0].numel(), np.int64), 1 << 19,
                               device=dev)
    d = counts_join_dual(t.keys, t.counts, t2.keys, t2.counts)
    assert torch.equal(d[0], wide.lookup_wide(t2, t.keys))
    assert torch.equal(d[1], wide.lookup_wide(t, t2.keys))


@pytest.mark.parametrize("W", [1, 2, 9])
def test_reduce_in_pieces_equals_one_launch(dev, W, monkeypatch):
    """K3 over a sorted stream of 2^20 keys (runs of 1-40, trailing
    SENTINEL) in pieces of fewer than 50,000 keys, each written from an
    unaligned offset of the output, equals one launch; also into too few
    slots."""
    rng = np.random.default_rng(W)
    runs = rng.integers(1, 40, 60_000)
    n = int(runs.sum())
    first = np.sort(rng.choice(1 << 50, runs.size, replace=False))
    words = np.repeat(np.stack([first + q for q in range(W)]), runs, axis=1)
    words[:, -1000:] = SENTINEL
    keys = torch.from_numpy(words if W > 1 else words[0].copy()).to(dev)
    w = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32)).to(dev)
    one = reduce_by_key_words if W > 1 else reduce_by_key
    monkeypatch.setattr(counting, "MAX_STREAM", 50_000)
    for out_size in (1 << 16, 40_001):
        want = one(keys, w, out_size)
        before = one.launches
        got = counting.reduce_stream(keys, w, out_size)
        torch.cuda.synchronize()
        assert one.launches - before > n // 50_000
        assert got[2] == int(want[2])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- binned sums (csrc/binned.cu), the binned form of K1 + K3 --

def _binned_case(name, rng, dev):
    """(bins int32, masks [M, n], total_bins) on the card; the views of
    "unaligned_views" start at odd offsets of larger tensors."""
    if name == "empty":
        n, total, m = 0, 10_001, 2
    elif name == "ragged":  # not a multiple of the block or the warp
        n, total, m = 3 * 512 + 17, 10_001, 1
    elif name == "one_bin":
        n, total, m = 1 << 20, 28_028, 1
    elif name in ("comp_three_masks", "one_hot_past_window"):
        n, total, m = 1 << 22, 1_002_001, 3
    elif name == "unaligned_views":
        n, total, m = (1 << 20) + 5, 1_002_001, 2
    elif name in ("n_mod16_1", "n_mod16_15"):
        n, total, m = (1 << 18) + int(name[-2:].strip("_")), 10_001, 3
    else:  # "all_masks_zero"
        n, total, m = 100_003, 1_002_001, 3
    if name == "one_bin":
        bins = np.full(n, 24 * 1001 + 1, np.int32)
    elif name == "one_hot_past_window":  # every element in the last bin
        bins = np.full(n, total - 1, np.int32)
    elif name == "comp_three_masks":
        # reads against an assembly: nearly all in a few dozen cells, the
        # rest spread over the matrix (outside the shared window too)
        hot = rng.poisson(24, n) * 1001 + 1
        bins = np.where(rng.random(n) < 0.95, np.minimum(hot, total - 1),
                        rng.integers(0, total, n)).astype(np.int32)
    else:
        bins = rng.integers(0, total, n).astype(np.int32)
    if name == "all_masks_zero":
        masks = np.zeros((m, n), bool)
    elif name == "comp_three_masks":  # three disjoint masks, as comp's
        pick = rng.integers(0, 4, n)
        masks = np.stack([pick == i for i in range(m)])
    else:
        masks = rng.random((m, n)) < 0.7
    if name == "unaligned_views":
        # keys from a slice at an odd offset, mask planes from masks[1:]
        # of three planes: neither starts 16-byte aligned
        kb = torch.from_numpy(np.concatenate([np.zeros(3, np.int32), bins]))
        mb = torch.from_numpy(np.concatenate([np.ones((1, n), bool), masks]))
        return kb.to(dev)[3:], mb.to(dev)[1:], total
    return (torch.from_numpy(bins).to(dev), torch.from_numpy(masks).to(dev),
            total)


@pytest.mark.parametrize("name", ["empty", "ragged", "one_bin",
                                  "comp_three_masks", "all_masks_zero",
                                  "unaligned_views", "n_mod16_1",
                                  "n_mod16_15", "one_hot_past_window"])
def test_binned_sums_matches_plain(dev, name):
    from kat_tpu_torch.ops.binned_kernel import (binned_sums,
                                                 binned_sums_plain)

    bins, masks, total = _binned_case(name, np.random.default_rng(7), dev)
    before = binned_sums.launches
    got = binned_sums(bins, masks, total)
    want = binned_sums_plain(bins, masks, total)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (masks.shape[0], total)
    assert torch.equal(got, want)
    assert binned_sums.launches == before + (1 if bins.numel() else 0)
    assert int(got.sum()) == int(masks.sum())
    if name == "one_bin":
        assert int(got[0, 24 * 1001 + 1]) == bins.numel() - int(
            (~masks[0]).sum())
    if name == "one_hot_past_window":
        assert torch.equal(got[:, -1], masks.sum(1))


def test_binned_sums_uint8_masks_and_repeats(dev):
    """uint8 masks count any non-zero value once; five runs agree."""
    from kat_tpu_torch.ops.binned_kernel import (binned_sums,
                                                 binned_sums_plain)

    rng = np.random.default_rng(3)
    n, total = (1 << 21) + 5, 10_001
    bins = torch.from_numpy(np.minimum(rng.poisson(20, n), total - 1)
                            .astype(np.int32)).to(dev)
    masks = torch.from_numpy(rng.integers(0, 4, (2, n)).astype(np.uint8)).to(
        dev)
    want = binned_sums_plain(bins, masks, total)
    for _ in range(5):
        assert torch.equal(binned_sums(bins, masks, total), want)


@pytest.mark.parametrize("reqs", [
    ((1001, 1001, 0), (1001, 1001, 1), (1, 1001 * 1001, 0)),
    ((1001, 1001, 0), (1, 1001, 1), (1001, 1001, 2)),
    ((7, 50_000, 2),),
    ((1, 1, 0), ((1 << 31) - 1, 3, 1), ((1 << 31) - 2, 1 << 20, 2)),
    ((1, 1 << 28, 0), (3, 1 << 22, 1))],
    ids=["comp_pass1", "comp_pass2", "one_request", "div_near_2_31",
         "ranges_widened"])
def test_packed_sums_matches_plain(dev, reqs):
    from kat_tpu_torch.ops.binned_kernel import packed_sums, packed_sums_plain

    rng = np.random.default_rng(len(reqs))
    n = (1 << 22) + 333
    s1 = np.minimum(rng.poisson(24, n), 1000)
    s2 = np.minimum(rng.poisson(1, n), 1000)
    packed = (s1 * 1001 + s2).astype(np.int32)
    if max(d * m for d, m, _i in reqs) > 1 << 27:  # keys across all int32
        packed = np.where(rng.random(n) < 0.5, packed,
                          rng.integers(0, 1 << 31, n)).astype(np.int32)
    packed = torch.from_numpy(packed).to(dev)
    masks = torch.from_numpy(rng.random((3, n)) < 0.6).to(dev)
    got = packed_sums(packed, masks, reqs)
    want = packed_sums_plain(packed, masks, reqs)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_stats_and_tools_launch_the_binned_kernel(dev, tmp_path):
    """hist_from_counts and gcp_matrix on a card table, and comp of two
    read sets through cli.main, run the binned-sums kernel (comp also the
    fused dual probe) and equal the CPU run."""
    from kat_tpu_torch import cli
    from kat_tpu_torch.core import stats
    from kat_tpu_torch.ops.binned_kernel import binned_sums

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, 50_000).astype(np.uint8)
    sc = counting.CodeStreamingCounter(27, device=dev)
    sc.add_codes(genome[rng.integers(0, 49_000, 512)[:, None]
                        + np.arange(800)])
    table = sc.finish()
    cpu = counting.CountTable(table.keys.cpu(), table.counts.cpu(),
                              table.n_unique)
    before = binned_sums.launches
    h = stats.hist_from_counts(table.counts, 1, 10001, 1, 10001)
    g = stats.gcp_matrix(table, 27, 1000, 1.0)
    assert binned_sums.launches == before + 2
    assert torch.equal(h.cpu(), stats.hist_from_counts(cpu.counts, 1, 10001,
                                                       1, 10001))
    assert torch.equal(g.cpu(), stats.gcp_matrix(cpu, 27, 1000, 1.0))

    alphabet = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i, n in enumerate((2000, 1200)):
        p = tmp_path / f"r{i}.fq"
        with open(p, "wb") as f:
            for j, o in enumerate(rng.integers(0, 49_000, n)):
                s = alphabet[genome[o:o + 100]].tobytes()
                f.write(b"@r%d\n%s\n+\n%s\n" % (j, s, b"I" * 100))
        paths.append(str(p))
    counters = (binned_sums, merge_sorted_payload, compact_flagged)
    before = [f.launches for f in counters]
    assert cli.main(["comp", "-o", str(tmp_path / "card"), *paths]) == 0
    # pass 1 and pass 2 bin; the fused dual probe merges once, compacts
    # twice
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 1, 2]
    assert cli.main(["--device", "cpu", "comp", "-o", str(tmp_path / "cpu"),
                     *paths]) == 0
    for suffix in ("-main.mx", ".stats"):
        assert (tmp_path / f"card{suffix}").read_bytes() == \
            (tmp_path / f"cpu{suffix}").read_bytes()


@pytest.mark.parametrize("name", workloads.RUNS_WORDS_STRAIN)
@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_merge_runs_words_matches_plain(dev, name, k):
    """K6 W-word at W = 2..9 on the inputs where it can go wrong: 8 runs
    of 3000 keys (the last short), ties across runs, sentinel tails of
    unequal length, one run."""
    g = torch.Generator(device=dev)
    g.manual_seed(k)
    keys, run_len = workloads.runs_words_strain(name, k, dev, g)
    before = merge_runs_words.launches
    kept = keys.clone()
    got = merge_runs_words(keys, run_len)
    torch.cuda.synchronize()
    assert merge_runs_words.launches == before + 1
    assert torch.equal(got, merge_runs_words_plain(keys, run_len))
    assert torch.equal(keys, kept)  # input untouched


@pytest.mark.parametrize("n_words", [2, 9])
@pytest.mark.parametrize("g_runs", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("run_len", [1, 1000, 4096])
def test_merge_runs_words_run_counts(dev, n_words, g_runs, run_len):
    """Any number of runs (odd counts leave a run without a neighbour at
    some level) and any run length, the last run short."""
    k = {2: 41, 9: 255}[n_words]
    g = torch.Generator(device=dev)
    g.manual_seed(g_runs * run_len)
    n = max(g_runs * run_len - run_len // 3, 1)
    keys = workloads.sorted_runs(workloads.wide_keys(k, n, dev, g), run_len)
    got = merge_runs_words(keys, run_len)
    assert torch.equal(got, merge_runs_words_plain(keys, run_len))


def test_merge_runs_words_planes_apart(dev):
    """The exchange's receive buffer hands K6 planes that lie apart."""
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    keys = workloads.sorted_runs(workloads.wide_keys(95, 8 * 2048, dev, g),
                                 2048)
    buf = torch.full((4, 3 * keys.shape[1]), SENTINEL, dtype=torch.int64,
                     device=dev)
    buf[:, 1000:1000 + keys.shape[1]] = keys
    view = buf[:, 1000:1000 + keys.shape[1]]
    assert view.stride(0) == 3 * keys.shape[1]
    assert torch.equal(merge_runs_words(view, 2048),
                       merge_runs_words_plain(keys, 2048))


@pytest.mark.parametrize("k", [27, 31, 41, 95])
def test_sharded_counter_on_the_card(dev, k):
    """A mesh of 8 shards on the card counts what the same mesh on the CPU
    counts, shard by shard, through K1, K6 (one-word or W-word), K2 and
    K3."""
    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel
    from kat_tpu_torch.parallel import sharded

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
    batches = [np.stack([genome[o:o + 150] for o in
                         rng.integers(0, 19_800, 512)]) for _ in range(5)]
    wide = k > 31
    fns = ((sort_kernel.sort_words,) if wide or k == 31 else
           (sort_kernel.sort_keys,)) + (
        (sort_kernel.merge_runs_words, merge_kernel.merge_sorted_words,
         reduce_kernel.reduce_by_key_words) if wide else
        (sort_kernel.merge_runs, merge_kernel.merge_sorted,
         reduce_kernel.reduce_by_key))
    before = [f.launches for f in fns]
    counters = [sharded.ShardedCounter(sharded.make_mesh(8, devices=[d]), k,
                                       shard_capacity=1 << 10,
                                       flush_batches=2)
                for d in (dev, torch.device("cpu"))]
    for b in batches:
        for c in counters:
            c.add_codes(b)
    for c in counters:
        c.check()
    card, cpu = counters
    assert all(f.launches > b for f, b in zip(fns, before))
    assert (card.n_unique == cpu.n_unique).all()
    for tc, tp in zip(card.tables, cpu.tables):
        assert torch.equal(tc.keys.cpu(), tp.keys)
        assert torch.equal(tc.counts.cpu(), tp.counts)
    assert card.shard_capacity == cpu.shard_capacity > 1 << 10


@pytest.mark.parametrize("k", [27, 41])
def test_two_processes_on_one_card(dev, tmp_path, k):
    """Two processes of one gloo group (they share the card, which NCCL
    refuses), one shard each on it, count the schedule's halves: each
    launches K1, K6, K2 and K3, and both get the histogram and table that
    one process's mesh of 2 shards on the card counts."""
    import torch_mp
    import torch_mp_workers as W

    from kat_tpu_torch.parallel import sharded

    res = torch_mp.run("card_count", 2, tmp_path, k, 6, 64, device="cuda")
    one = sharded.ShardedCounter(sharded.make_mesh(2, devices=[dev]), k,
                                 shard_capacity=1 << 10)
    for b in W.schedule(6, 64):
        one.add_codes(b)
    one.check()
    t = one.finish()
    n = t.n_unique
    for r in res:
        assert r["backend"] == "gloo"
        assert min(r["launches"]) > 0, r["launches"]
        assert np.array_equal(r["hist"], one.histogram(1, 1001, 1, 1002))
        assert r["table"][2] == n
        assert np.array_equal(r["table"][0], t.keys[..., :n].cpu().numpy())
        assert np.array_equal(r["table"][1], t.counts[:n].cpu().numpy())


def test_kernel_attestation_on_the_card(dev):
    """ops/verify.py on the card: K1, K2 and K3, one word and W words."""
    from kat_tpu_torch.ops import verify

    res = [verify.verify_kernels(n=1 << 20, device=dev)] + [
        verify.verify_kernels_wide(n_words=w, n=1 << 18, device=dev)
        for w in (3, 4, 8, 16)]
    for r in res:
        assert {r[c] for c in ("sort", "merge", "reduce")} == {"PASS"}, r


def test_jf_count_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch):
    """`python -m kat_tpu_torch.jf_cli count` on the card launches K1, K2
    and K3 and writes the .jf that `--device cpu` writes (the header's
    moment and machine pinned)."""
    from kat_tpu_torch import jf_cli

    monkeypatch.setattr("socket.gethostname", lambda: "host")
    monkeypatch.setattr("time.ctime", lambda: "Thu Jan  1 00:00:00 1970")
    rng = np.random.default_rng(13)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
    fq = tmp_path / "r.fq"
    with open(fq, "wb") as f:
        for j, o in enumerate(rng.integers(0, 19_850, 3000)):
            s = genome[o:o + 150].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (j, s, b"I" * 150))
    kernels = (sort_keys, merge_sorted, reduce_by_key)
    before = [fn.launches for fn in kernels]
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = tmp_path / f"{device}.jf"
        assert jf_cli.main(["--device", device, "count", "-m", "27", "-C",
                            "-o", str(out[device]), str(fq)]) == 0
        if device == "cuda":
            assert all(fn.launches > b for fn, b in zip(kernels, before))
    assert out["cuda"].read_bytes() == out["cpu"].read_bytes()
