"""The port's CUDA kernels (K1 sort, K2 merge, K3 reduce, K4 compact, the
payload forms of K1 and K2, K5 chunk sort, K6 run merge and K7's round
classes) against their plain PyTorch versions on the card, exactly (integer
keys and counts: tolerance 0).

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor kat_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kat_tpu_torch.benchmarks.profile_rounds import (MODES, profile_rounds,
                                                     profile_rounds_plain)
from kat_tpu_torch.core import bucketed, counting, coverage, minimizer, tables
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops.join import counts_join, counts_join_dual
from kat_tpu_torch.ops.merge_kernel import (merge_sorted, merge_sorted_payload,
                                            merge_sorted_payload_plain,
                                            merge_sorted_plain)
from kat_tpu_torch.ops.reduce_kernel import (compact_flagged,
                                             compact_flagged_plain,
                                             reduce_by_key,
                                             reduce_by_key_plain)
from kat_tpu_torch.ops.sort_kernel import (merge_runs, merge_runs_plain,
                                           sort_chunks, sort_chunks_plain,
                                           sort_keys, sort_keys_plain,
                                           sort_pairs, sort_pairs_plain)

pytestmark = pytest.mark.cuda

TILE = 4096  # K1 keys per block; sizes below straddle it on purpose


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
    """coverage.window_counts picks the join on the card for a large batch
    and gives what the search route gives."""
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
    assert tables._join_policy(64 * (2048 - k + 1), table.capacity,
                               table.keys.device)
    before = compact_flagged.launches
    got = coverage.window_counts(table, codes, k, True)
    assert compact_flagged.launches == before + 1
    want = coverage.window_counts(table, codes, k, True, method="search")
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
    """`sect` through the command line's entry point, on the card: contigs
    that fill one length bucket past the join threshold send their lookups
    through K1 with a value, K2 with payload planes and K4, and the
    coverage file equals the CPU run's."""
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
    counters = (sort_keys, merge_sorted, reduce_by_key, sort_pairs,
                merge_sorted_payload, compact_flagged)
    before = [f.launches for f in counters]
    assert cli.main(["sect", "-m", "27", "-o", str(tmp_path / "gpu"),
                     str(fa), str(fq)]) == 0
    after = [f.launches for f in counters]
    assert all(a > b for a, b in zip(after, before))
    # one bucket above the threshold: exactly one join
    assert [a - b for a, b in zip(after[3:], before[3:])] == [1, 1, 1]
    assert cli.main(["--device", "cpu", "sect", "-m", "27", "-o",
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
    raise KeyError(name)


@pytest.mark.parametrize("chunk,n_chunks", [(32, 5), (64, 3), (1024, 7),
                                            (4096, 3), (8192, 9),
                                            (16384, 133)])
@pytest.mark.parametrize("name", ["random", "all_sentinel_chunks",
                                  "duplicates", "sorted", "reversed",
                                  "flipped_keyp"])
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


@pytest.mark.parametrize("mode", MODES)
def test_profile_rounds_matches_plain(dev, mode):
    rng = np.random.default_rng(2)
    keys = torch.from_numpy(
        rng.integers(-(1 << 62), 1 << 62, 2048 * 37)).to(dev)
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
