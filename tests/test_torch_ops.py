"""The plain versions of the port's kernels (what runs on the CPU) against
kat_tpu's Pallas kernels in interpret mode, on the same numpy inputs made
from a seed.  Exact (tolerance 0): keys and counts are integers.  The CUDA
kernels themselves are held against these plain versions on the card in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.ops.merge_kernel import merge_sorted_kernel
from kat_tpu.ops.reduce_kernel import compact_flagged as jax_compact_flagged
from kat_tpu.ops.reduce_kernel import reduce_compact_sorted
from kat_tpu.ops.sort_kernel import (bitonic_merge_runs, bitonic_sort_chunks,
                                     sort_planes_padded)
from kat_tpu_torch.core.kmers import SENTINEL, from_planes, to_planes
from kat_tpu_torch.ops.merge_kernel import merge_sorted, merge_sorted_payload
from kat_tpu_torch.ops.reduce_kernel import compact_flagged, reduce_by_key
from kat_tpu_torch.benchmarks.profile_rounds import (MODES, profile_rounds,
                                                     profile_rounds_plain)
from kat_tpu_torch.ops.sort_kernel import (merge_runs, sort_chunks, sort_keys,
                                           sort_keys_plain, sort_pairs,
                                           sort_pairs_plain)

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _keys(rng, n, bits=54, sent_frac=0.1):
    k = rng.integers(0, 1 << bits, n, dtype=np.int64)
    k[rng.random(n) < sent_frac] = SENTINEL
    return k


def _planes(keys):
    return tuple(jnp.asarray(p) for p in to_planes(keys))


@pytest.mark.parametrize("n", [2048, 5000])
def test_sort_matches_jax(n):
    keys = _keys(np.random.default_rng(n), n)
    hi, lo = sort_planes_padded(_planes(keys), 2, block_rows=8,
                                interpret=True)
    want = from_planes(np.asarray(hi), np.asarray(lo))
    got = sort_keys(torch.from_numpy(keys), 55)
    np.testing.assert_array_equal(got.numpy(), want)


def _radix_pass_model(keys, values, key_bits):
    """csrc/sort.cu's passes, digit by digit, in plain torch: one stable
    pass per 8-bit digit of the low key_bits bits, least significant first;
    none is skipped, as in the kernel.  Returns (keys, values, the passes
    that moved a key)."""
    moved = []
    for p in range((key_bits + 7) // 8):
        digit = (keys >> (8 * p)) & 255
        order = torch.sort(digit, stable=True).indices
        if not torch.equal(order, torch.arange(keys.numel())):
            moved.append(p)
        keys, values = keys[order], values[order]
    return keys, values, moved


@pytest.mark.parametrize("bits", [8, 9, 55, 63])
def test_radix_pass_model_matches_plain_and_jax(bits):
    """ceil(key_bits / 8) stable 8-bit passes sort what sort_keys_plain and
    kat_tpu's full-sort kernel sort, SENTINEL last, and carry the values as
    the stable plain sort does."""
    rng = np.random.default_rng(bits)
    n = 3000
    keys = _keys(rng, n, bits=bits - 1)
    t = torch.from_numpy(keys)
    pos = torch.arange(n, dtype=torch.int32)
    mk, mv, moved = _radix_pass_model(t, pos, bits)
    assert moved == list(range((bits + 7) // 8))  # random keys: every pass
    assert torch.equal(mk, sort_keys_plain(t))
    assert torch.equal(mk, sort_keys(t, bits))
    wk, wv = sort_pairs_plain(t, pos)
    assert torch.equal(mk, wk) and torch.equal(mv, wv)
    hi, lo = sort_planes_padded(_planes(keys), 2, block_rows=8,
                                interpret=True)
    np.testing.assert_array_equal(
        mk.numpy(), from_planes(np.asarray(hi), np.asarray(lo)))


@pytest.mark.parametrize("name,ran", [("all_equal", []),
                                      ("all_sentinel", []),
                                      ("one_digit_differs", [2]),
                                      ("low_bits_only", [0, 1])])
def test_radix_pass_model_skips_uniform_digits(name, ran):
    """The kernel runs every pass, also over a digit that is the same for
    every key (key_bits overstating the keys, all-equal input): such a pass
    must move nothing, so only the passes in `ran` do, and the result still
    equals the stable plain sort."""
    rng = np.random.default_rng(11)
    n = 2000
    keys = {"all_equal": np.full(n, 12345, np.int64),
            "all_sentinel": np.full(n, SENTINEL, np.int64),
            "one_digit_differs": rng.integers(0, 256, n) << 16,
            "low_bits_only": rng.integers(0, 1 << 16, n)}[name]
    t = torch.from_numpy(keys.astype(np.int64))
    pos = torch.arange(n, dtype=torch.int32)
    mk, mv, moved = _radix_pass_model(t, pos, 55)
    assert moved == ran
    wk, wv = sort_pairs_plain(t, pos)
    assert torch.equal(mk, wk) and torch.equal(mv, wv)


def test_sort_wrappers_check_length_and_key_bits():
    k = torch.zeros(8, dtype=torch.int64)
    v = torch.zeros(8, dtype=torch.int32)
    for bits in (0, 64, -1):
        with pytest.raises(ValueError, match="key_bits"):
            sort_keys(k, bits)
        with pytest.raises(ValueError, match="key_bits"):
            sort_pairs(k, v, bits)
    for bits in (1, 63):
        assert sort_keys(k, bits).numel() == 8
    # the kernel's status words count in 30 bits; a meta tensor has the
    # length without the memory
    too_long = torch.empty(1 << 30, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match=r"2\^30"):
        sort_keys(too_long, 55)
    with pytest.raises(ValueError, match=r"2\^30"):
        sort_pairs(too_long, torch.empty(1 << 30, dtype=torch.int32,
                                         device="meta"), 55)
    with pytest.raises(ValueError, match="unsupported device"):
        sort_keys(too_long[:-1], 55)


def _table(rng, n, universe):
    keys = np.unique(rng.choice(universe, n))
    pad = n - len(keys)
    keys = np.concatenate([keys, np.full(pad, SENTINEL, np.int64)])
    counts = np.where(keys == SENTINEL, 0, rng.integers(1, 50, n))
    return keys, counts.astype(np.int32)


@pytest.mark.parametrize("na,nb", [(1024, 1024), (700, 3000)])
def test_merge_matches_jax(na, nb):
    rng = np.random.default_rng(na + nb)
    universe = _keys(rng, 1500, sent_frac=0.0)
    a, ac = _table(rng, na, universe)
    b = np.sort(_keys(rng, nb, sent_frac=0.0))
    b[rng.random(nb) < 0.1] = SENTINEL
    b = np.sort(b)
    bw = (b != SENTINEL).astype(np.uint32)
    (mh, ml), (mw,) = merge_sorted_kernel(
        _planes(a), (jnp.asarray(ac.astype(np.uint32)),), _planes(b),
        (jnp.asarray(bw),), block_rows=8, interpret=True)
    n = na + nb
    jkeys = from_planes(np.asarray(mh)[:n], np.asarray(ml)[:n])
    jw = np.asarray(mw)[:n].astype(np.int32)

    gk, gw = merge_sorted(torch.from_numpy(a), torch.from_numpy(ac),
                          torch.from_numpy(b))
    np.testing.assert_array_equal(gk.numpy(), jkeys)
    # equal keys may meet in another order: compare after reducing both
    got = reduce_by_key(gk, gw, n)
    want = reduce_by_key(torch.from_numpy(jkeys), torch.from_numpy(jw), n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _reduce_case(name, rng):
    n = 4096
    if name == "random":
        k = np.sort(_keys(rng, n, bits=9))
        return k, np.where(k == SENTINEL, 0, rng.integers(0, 5, n)), n
    if name == "overflow":
        k = np.sort(_keys(rng, n, bits=12, sent_frac=0.0))
        return k, np.ones(n), 64
    if name == "interior_sentinels":
        parts = [np.sort(_keys(rng, n // 2, bits=8, sent_frac=0.2))
                 for _ in range(2)]
        k = np.concatenate(parts)
        return k, np.where(k == SENTINEL, 0, rng.integers(1, 9, n)), n
    if name == "all_sentinel":
        return np.full(n, SENTINEL, np.int64), np.zeros(n), 256
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "overflow", "interior_sentinels",
                                  "all_sentinel"])
def test_reduce_matches_jax(name):
    keys, w, out_size = _reduce_case(name, np.random.default_rng(7))
    w = np.asarray(w, np.int64)
    jh, jl, jc, jn = reduce_compact_sorted(
        _planes(keys), jnp.asarray(w.astype(np.uint32)), out_size,
        rows_per_tile=8, interpret=True)
    gk, gc, gn = reduce_by_key(torch.from_numpy(keys),
                               torch.from_numpy(w.astype(np.int32)), out_size)
    assert int(gn) == int(jn)
    np.testing.assert_array_equal(gk.numpy(),
                                  from_planes(np.asarray(jh), np.asarray(jl)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jc).astype(np.int32))


def test_wrappers_reject_bad_input():
    k = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        sort_keys(k.to(torch.int32), 55)
    with pytest.raises(ValueError):
        sort_keys(k.reshape(2, 4), 55)
    with pytest.raises(ValueError):
        sort_keys(torch.zeros(16, dtype=torch.int64)[::2], 55)
    with pytest.raises(TypeError):
        merge_sorted(k, k, k)
    with pytest.raises(ValueError):
        reduce_by_key(k, torch.zeros(7, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        reduce_by_key(k, torch.zeros(8, dtype=torch.int32), -1)


def _i32(x):
    return torch.from_numpy(np.asarray(x).astype(np.int32))


def test_compact_matches_jax():
    """compact_flagged (plain version) against kat_tpu's Pallas kernel in
    interpret mode: two planes, ragged n, out_size above the kept count."""
    rng = np.random.default_rng(11)
    n, out_size = 3000, 1100
    planes = [rng.integers(0, 1 << 32, n, dtype=np.uint32) for _ in range(2)]
    flag = rng.random(n) < 0.33
    j0, j1, jn = jax_compact_flagged(
        tuple(jnp.asarray(p) for p in planes),
        jnp.asarray(flag.astype(np.uint32)), out_size, rows_per_tile=8,
        interpret=True)
    g0, g1, gn = compact_flagged([_i32(p) for p in planes],
                                 torch.from_numpy(flag), out_size)
    assert int(gn) == int(jn) == int(flag.sum()) < out_size
    np.testing.assert_array_equal(g0.numpy().astype(np.uint32),
                                  np.asarray(j0))
    np.testing.assert_array_equal(g1.numpy().astype(np.uint32),
                                  np.asarray(j1))


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.uint8])
@pytest.mark.parametrize("name,density,n_planes", [
    ("exact", 0.4, 2), ("none", -1.0, 1), ("all", 2.0, 3), ("short", 0.5, 2),
    ("roomy", 0.2, 1), ("empty", 0.5, 2)])
def test_compact_matches_numpy(name, density, n_planes, flag_dtype):
    rng = np.random.default_rng(len(name))
    n = 0 if name == "empty" else 5000
    planes = [rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
              for _ in range(n_planes)]
    flag = rng.random(n) < density
    kept = int(flag.sum())
    out_size = {"short": kept // 3, "roomy": kept + 77,
                "none": 64, "empty": 16}.get(name, kept)
    got = compact_flagged([torch.from_numpy(p) for p in planes],
                          torch.from_numpy(flag).to(flag_dtype), out_size)
    assert len(got) == n_planes + 1
    assert int(got[-1]) == kept and got[-1].dim() == 0
    for g, p in zip(got, planes):
        want = np.zeros(out_size, np.int32)
        m = min(kept, out_size)
        want[:m] = p[flag][:m]
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("name", ["random", "few_keys", "all_equal"])
def test_sort_pairs_is_stable(name):
    """Equal keys keep their input order, sentinels go last: the values
    (positions) of each run of equal keys come out ascending."""
    rng = np.random.default_rng(5)
    n = 3000
    bits = {"random": 54, "few_keys": 3, "all_equal": 0}[name]
    keys = _keys(rng, n, bits=bits) if bits else np.full(n, 9, np.int64)
    gk, gv = sort_pairs(torch.from_numpy(keys),
                        torch.arange(n, dtype=torch.int32), 55)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk.numpy(), keys[order])
    np.testing.assert_array_equal(gv.numpy(), order.astype(np.int32))
    if name != "all_equal":
        assert gk[-1] == SENTINEL


@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_merge_payload_ties_take_a_first(n_planes):
    rng = np.random.default_rng(n_planes)
    a = np.sort(rng.integers(0, 40, 300)).astype(np.int64)
    b = np.sort(rng.integers(0, 40, 500)).astype(np.int64)
    a[-20:] = SENTINEL
    b[-30:] = SENTINEL
    # plane 0 names the source row: a rows 0..299, b rows 1000..1499
    ap = [np.arange(300)] + [rng.integers(0, 99, 300)
                             for _ in range(n_planes - 1)]
    bp = [1000 + np.arange(500)] + [rng.integers(0, 99, 500)
                                    for _ in range(n_planes - 1)]
    gk, gp = merge_sorted_payload(
        torch.from_numpy(a), [_i32(p) for p in ap],
        torch.from_numpy(b), [_i32(p) for p in bp])
    order = np.argsort(np.concatenate([a, b]), kind="stable")
    np.testing.assert_array_equal(gk.numpy(), np.concatenate([a, b])[order])
    assert len(gp) == n_planes
    for g, pa, pb in zip(gp, ap, bp):
        np.testing.assert_array_equal(g.numpy(),
                                      np.concatenate([pa, pb])[order])
    # inside every run of equal keys, all of a's rows precede b's
    src = gp[0].numpy()
    same = gk.numpy()[1:] == gk.numpy()[:-1]
    assert not np.any(same & (src[:-1] >= 1000) & (src[1:] < 1000))


def test_lookup_wrappers_reject_bad_input():
    k = torch.zeros(8, dtype=torch.int64)
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        sort_pairs(k, v.to(torch.int64), 55)
    with pytest.raises(ValueError):
        sort_pairs(k, v[:7], 55)
    with pytest.raises(ValueError):
        sort_pairs(k, v, 64)
    with pytest.raises(ValueError):
        merge_sorted_payload(k, (), k, ())
    with pytest.raises(ValueError):
        merge_sorted_payload(k, (v, v), k, (v,))
    with pytest.raises(ValueError):
        merge_sorted_payload(k, (v[:7],), k, (v,))
    with pytest.raises(ValueError):
        compact_flagged((v, v, v, v), v > 0, 4)
    with pytest.raises(TypeError):
        compact_flagged((v,), v, 4)  # int32 flag
    with pytest.raises(ValueError):
        compact_flagged((v,), (v > 0)[:7], 4)
    with pytest.raises(ValueError):
        compact_flagged((v,), v > 0, -1)


@pytest.mark.parametrize("n,chunk", [(4096, 1024), (6144, 2048)])
def test_sort_chunks_matches_jax(n, chunk):
    """K5's plain version against kat_tpu's chunk-mode kernel in interpret
    mode: every chunk sorted on its own, sentinels at each chunk's tail."""
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, sent_frac=0.3)
    keys[:chunk] = SENTINEL                       # an all-sentinel chunk
    keys[chunk:chunk + 600] = keys[chunk + 600]   # duplicates
    hi, lo = bitonic_sort_chunks(_planes(keys), 2, chunk, block_rows=8,
                                 interpret=True)
    got = sort_chunks(torch.from_numpy(keys), chunk)
    np.testing.assert_array_equal(
        got.numpy(), from_planes(np.asarray(hi), np.asarray(lo)))
    np.testing.assert_array_equal(
        got.numpy(), np.sort(keys.reshape(-1, chunk), axis=1).reshape(-1))


def test_sort_chunks_orders_the_flipped_keyp_form():
    """Negative int64 keys (the bit-63-flipped key' of k = 29) sort below
    the positive ones, as kat_tpu's unsigned planes order key'."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << 64, 2048, dtype=np.uint64)
    keys = (u ^ np.uint64(1 << 63)).astype(np.int64)
    got = sort_chunks(torch.from_numpy(keys), 1024).numpy()
    want = np.sort(u.reshape(2, 1024), axis=1).reshape(-1)
    np.testing.assert_array_equal(got.astype(np.uint64) ^ np.uint64(1 << 63),
                                  want)


@pytest.mark.parametrize("g,run_len", [(2, 1024), (4, 1024)])
def test_merge_runs_matches_jax(g, run_len):
    """K6's plain version against kat_tpu's runs-mode kernel in interpret
    mode: g ascending runs with unequal sentinel tails become one stream."""
    rng = np.random.default_rng(g)
    runs = [np.sort(_keys(rng, run_len, bits=20, sent_frac=0.1 * (r + 1)))
            for r in range(g)]
    keys = np.concatenate(runs)
    hi, lo = bitonic_merge_runs(_planes(keys), 2, run_len, block_rows=8,
                                interpret=True)
    got = merge_runs(torch.from_numpy(keys), run_len)
    np.testing.assert_array_equal(
        got.numpy(), from_planes(np.asarray(hi), np.asarray(lo)))
    np.testing.assert_array_equal(got.numpy(), np.sort(keys))


def test_chunk_and_run_wrappers_reject_bad_input():
    k = torch.zeros(4096, dtype=torch.int64)
    for chunk in (16, 1000, 1 << 15):
        with pytest.raises(ValueError):
            sort_chunks(k, chunk)
    with pytest.raises(ValueError):
        sort_chunks(k[:3000], 1024)
    with pytest.raises(TypeError):
        sort_chunks(k.to(torch.int32), 1024)
    with pytest.raises(ValueError):
        merge_runs(k, 0)
    with pytest.raises(ValueError):
        merge_runs(k.reshape(2, -1), 1024)
    assert merge_runs(k[:0], 8).numel() == 0
    assert sort_chunks(k[:0], 1024).numel() == 0


def test_interior_sentinel_gaps_are_never_emitted():
    """The bucketed flush reduces a stream of sorted chunks, each with its
    own sentinel tail: reduce_by_key drops sentinel runs wherever they lie,
    and keys equal across a gap stay separate runs."""
    chunk = np.array([3, 3, 5, SENTINEL, SENTINEL, SENTINEL], np.int64)
    keys = np.concatenate([chunk, np.full(6, SENTINEL),
                           [7, 7, 9, SENTINEL, SENTINEL, SENTINEL],
                           [9, 9, 9, 9, 9, SENTINEL]]).astype(np.int64)
    w = (keys != SENTINEL).astype(np.int32)
    gk, gc, gn = reduce_by_key(torch.from_numpy(keys), torch.from_numpy(w), 8)
    assert int(gn) == 5
    np.testing.assert_array_equal(
        gk.numpy(), [3, 5, 7, 9, 9, SENTINEL, SENTINEL, SENTINEL])
    np.testing.assert_array_equal(gc.numpy(), [2, 1, 2, 1, 5, 0, 0, 0])


@pytest.mark.parametrize("mode", MODES)
def test_profile_rounds_plain(mode):
    """K7's plain version: `copy` adds one per round; every other class is a
    bitonic round, so the multiset of keys is kept, partners end up ordered
    by the last round's direction, and alu equals smem-1024."""
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 4096))
    out = profile_rounds(keys, mode, 3)
    assert torch.equal(out, profile_rounds_plain(keys, mode, 3))
    if mode == "copy":
        assert torch.equal(out, keys + 3)
        return
    assert torch.equal(out.sort().values, keys.sort().values)
    assert torch.equal(profile_rounds(keys, mode, 0), keys)
    s = 1024 if mode == "alu" else int(mode.split("-")[1])
    g = np.arange(4096)
    i = g[(g & s) == 0]
    asc = ((i >> s.bit_length()) & 1) == 0  # the last round's index is even
    o = out.numpy()
    assert np.where(asc, o[i] <= o[i ^ s], o[i] >= o[i ^ s]).all()
    if mode == "alu":
        assert torch.equal(out, profile_rounds(keys, "smem-1024", 3))


def test_profile_rounds_rejects_bad_input():
    k = torch.zeros(2048, dtype=torch.int64)
    for mode in ("roll", "shfl", "shfl-32", "smem-3", "copy-1", "smem-2048"):
        with pytest.raises(ValueError):
            profile_rounds(k, mode, 1)
    with pytest.raises(ValueError):
        profile_rounds(k[:100], "copy", 1)
    with pytest.raises(ValueError):
        profile_rounds(k, "copy", -1)


# -- K3's decomposition on the card (csrc/reduce.cu), modelled in numpy -----

MASK32 = (1 << 32) - 1
RUNS_MASK = (1 << 30) - 1
AGG_OPEN, AGG_CLOSED, PREFIX = 1, 2, 3


def _seg(a, b):
    """Segmented sums (runs emitted, a run ends inside, weight after the
    last run end mod 2^32): a, then b."""
    return (a[0] + b[0], a[1] or b[1],
            b[2] if b[1] else (a[2] + b[2]) & MASK32)


def _pack(flag, v):
    return flag << 62 | (v[0] & RUNS_MASK) << 32 | v[2]


def _unpack(word):
    flag = word >> 62
    return flag, ((word >> 32) & RUNS_MASK, flag == AGG_CLOSED, word & MASK32)


def _k3_model(keys, w, out_size, tile, rng, group=32):
    """csrc/reduce.cu's single pass: every tile's aggregate, each tile's
    exclusive prefix by a look-back down the lower tiles' 64-bit status
    words until one holds a prefix, `group` words a step (common.cuh's
    look_back: 1 for a thread, 32 for a warp, which combines the words of
    a step up to the nearest prefix as a tree), then each run written once
    at its rank and the padding filled.  Half the tiles (never tile 0)
    leave only their aggregate behind, as a tile does whose prefix is not
    out yet: the look-back must give the same answer either way."""
    n = keys.size
    end = np.ones(n, bool)
    end[:-1] = keys[:-1] != keys[1:]
    emit = end & (keys != SENTINEL)
    tiles = -(-n // tile)
    words, before, aggs = [], [], []
    for t in range(tiles):
        span = slice(t * tile, (t + 1) * tile)
        ends = np.flatnonzero(end[span])
        after = w[span][ends[-1] + 1:] if ends.size else w[span]
        agg = (int(emit[span].sum()), bool(ends.size),
               int(after.astype(np.uint64).sum()) & MASK32)
        aggs.append(agg)
        acc, hi = (0, False, 0), t
        while hi > 0:
            # lane l reads tile hi - 1 - l; below tile 0: a prefix of nothing
            step = [_unpack(words[j]) if j >= 0 else (PREFIX, (0, False, 0))
                    for j in range(hi - 1, hi - 1 - group, -1)]
            assert all(flag != 0 for flag, _v in step)
            last = next((i for i, (flag, _v) in enumerate(step)
                         if flag == PREFIX), group - 1)
            vals = [v for _flag, v in step[:last + 1]]
            while len(vals) > 1:  # farther tiles first, pairwise
                vals = [_seg(vals[i + 1], vals[i]) if i + 1 < len(vals)
                        else vals[i] for i in range(0, len(vals), 2)]
            acc = _seg(vals[0], acc)
            if step[last][0] == PREFIX:
                break
            hi -= group
        before.append(acc)
        if t == 0 or rng.random() < 0.5:
            words.append(_pack(PREFIX, _seg(acc, agg)))
        else:
            words.append(_pack(AGG_CLOSED if agg[1] else AGG_OPEN, agg))
    out_k = np.full(out_size, SENTINEL, np.int64)
    out_c = np.zeros(out_size, np.int32)
    for t in range(tiles):
        r, _closed, s = before[t]
        for i in range(t * tile, min((t + 1) * tile, n)):
            s = (s + int(w[i])) & MASK32
            if end[i]:
                if emit[i]:
                    if r < out_size:
                        out_k[r] = keys[i]
                        out_c[r] = np.uint32(s).view(np.int32)
                    r += 1
                s = 0
    # the tile holding the last element writes n_unique
    n_unique = before[-1][0] + aggs[-1][0] if tiles else 0
    return out_k, out_c, n_unique


K3_MODEL_TILE = 256


def _k3_case(name):
    """(keys, weights, out_size) of the strain cases, lengths around the
    model's middle tile of 256."""
    rng = np.random.default_rng(len(name))
    T = K3_MODEL_TILE
    if name == "one_run":
        k = np.full(3 * T + 7, 99, np.int64)
        return k, rng.integers(1, 1000, k.size), 8
    if name == "interior_sentinels":
        parts = [np.sort(_keys(rng, 2 * T + 1, bits=7, sent_frac=0.3))
                 for _ in range(3)]
        k = np.concatenate(parts)
        return k, np.where(k == SENTINEL, 0, rng.integers(1, 9, k.size)), 600
    if name == "overflow":
        k = np.sort(_keys(rng, 5 * T, bits=14, sent_frac=0.05))
        return k, (k != SENTINEL).astype(np.int64), 100
    if name == "out_size_0":
        k = np.sort(_keys(rng, 3 * T, bits=8))
        return k, rng.integers(0, 4, k.size), 0
    if name == "all_sentinel":
        return np.full(2 * T + 3, SENTINEL, np.int64), np.zeros(2 * T + 3), 64
    n = {"n_1": 1, "tile_minus_1": T - 1, "tile": T,
         "tile_plus_1": T + 1}[name]
    k = np.sort(_keys(rng, n, bits=6))
    return k, np.where(k == SENTINEL, 0, rng.integers(1, 50, n)), n + 3


K3_CASES = ["one_run", "interior_sentinels", "overflow", "out_size_0",
            "all_sentinel", "n_1", "tile_minus_1", "tile", "tile_plus_1"]
_JAX_REDUCED = {}


def _jax_reduced(name):
    """kat_tpu's reduce_compact_sorted in interpret mode, once per case."""
    if name not in _JAX_REDUCED:
        keys, w, out_size = _k3_case(name)
        w = np.asarray(w, np.int64)
        jh, jl, jc, jn = reduce_compact_sorted(
            _planes(keys), jnp.asarray(w.astype(np.uint32)),
            max(out_size, 1), rows_per_tile=8, interpret=True)
        _JAX_REDUCED[name] = (
            from_planes(np.asarray(jh), np.asarray(jl))[:out_size],
            np.asarray(jc).astype(np.int32)[:out_size], int(jn))
    return _JAX_REDUCED[name]


@pytest.mark.parametrize("group", [1, 32])
@pytest.mark.parametrize("tile", [32, K3_MODEL_TILE, 4096])
@pytest.mark.parametrize("name", K3_CASES)
def test_k3_look_back_model(name, tile, group):
    """The tile aggregates and the segmented look-back (one word a step,
    or a warp's 32) give what reduce_by_key_plain and kat_tpu's reduce
    kernel give, at tile sizes below, at and above the lengths: one run
    across every tile, interior sentinel runs, n_unique > out_size,
    out_size = 0, n = 1, tile +- 1."""
    keys, w, out_size = _k3_case(name)
    w = np.asarray(w, np.int64)
    mk, mc, mn = _k3_model(keys, w, out_size, tile,
                           np.random.default_rng(tile), group)
    pk, pc, pn = reduce_by_key(torch.from_numpy(keys),
                               torch.from_numpy(w.astype(np.int32)), out_size)
    assert mn == int(pn)
    np.testing.assert_array_equal(mk, pk.numpy())
    np.testing.assert_array_equal(mc, pc.numpy())
    jk, jc, jn = _jax_reduced(name)
    assert mn == jn
    np.testing.assert_array_equal(mk, jk)
    np.testing.assert_array_equal(mc, jc)


def test_k3_status_word_round_trip():
    """A status word holds a 30-bit run count and a 32-bit sum beside its
    flag, and an aggregate's flag says whether a run ends in its tile."""
    for flag, v in ((AGG_OPEN, (0, False, MASK32)),
                    (AGG_CLOSED, (RUNS_MASK, True, 12345)),
                    (PREFIX, ((1 << 30) - 7, False, 0))):
        w = _pack(flag, v)
        assert w < 1 << 64
        assert _unpack(w) == (flag, v)
    assert _unpack(_pack(PREFIX, (0, False, 0)))[0] == PREFIX
    # sums wrap mod 2^32 like the plain version's int64 sum cut to int32
    assert _seg((1, True, MASK32), (0, False, 2)) == (1, True, 1)


def test_reduce_wrapper_checks_length():
    too_long = torch.empty(1 << 30, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match=r"2\^30"):
        reduce_by_key(too_long, torch.empty(1 << 30, dtype=torch.int32,
                                            device="meta"), 4)


# -- K2's decomposition on the card (csrc/merge.cu), modelled in numpy ------

def _merge_path(a, b, diag):
    lo, hi = max(0, diag - b.size), min(diag, a.size)
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _k2_model(a, aw, b, tile, items):
    """csrc/merge.cu's two launches: the split of every tile boundary on
    the merge path, then each tile on its own: `items` outputs a thread,
    each thread's start found by a merge-path search inside the tile's two
    slices, ties to a; b's weight is (key != SENTINEL)."""
    n = a.size + b.size
    tiles = -(-n // tile)
    splits = [_merge_path(a, b, min(t * tile, n)) for t in range(tiles + 1)]
    assert splits[-1] == a.size and splits == sorted(splits)
    out_k, out_w = np.zeros(n, np.int64), np.zeros(n, np.int32)
    for t in range(tiles):
        d0 = t * tile
        length = min(d0 + tile, n) - d0
        sa, wa = a[splits[t]:splits[t + 1]], aw[splits[t]:splits[t + 1]]
        sb = b[d0 - splits[t]:d0 - splits[t] + length - sa.size]
        for dt in range(0, length, items):
            ia = _merge_path(sa, sb, dt)
            ib = dt - ia
            for d in range(dt, min(dt + items, length)):
                if ia < sa.size and (ib >= sb.size or sa[ia] <= sb[ib]):
                    out_k[d0 + d], out_w[d0 + d] = sa[ia], wa[ia]
                    ia += 1
                else:
                    out_k[d0 + d] = sb[ib]
                    out_w[d0 + d] = sb[ib] != SENTINEL
                    ib += 1
    return out_k, out_w


def _k2_case(name):
    rng = np.random.default_rng(len(name) + 100)
    universe = _keys(rng, 600, sent_frac=0.0)
    if name == "equal_keys":
        a, b = np.full(300, 5, np.int64), np.full(500, 5, np.int64)
        return a, rng.integers(1, 9, 300).astype(np.int32), b
    a, ac = _table(rng, 400, universe)
    b = np.sort(np.where(rng.random(600) < 0.1, SENTINEL,
                         rng.choice(universe, 600)))
    if name == "na_0":
        return a[:0], ac[:0], b
    if name == "nb_0":
        return a, ac, b[:0]
    if name == "a_before_b":
        return np.sort(a % (1 << 20)), ac, np.sort(b % (1 << 20) + (1 << 21))
    if name == "b_before_a":
        return np.sort(a % (1 << 20) + (1 << 21)), ac, np.sort(b % (1 << 20))
    return a, ac, b


K2_CASES = ["random", "na_0", "nb_0", "equal_keys", "a_before_b",
            "b_before_a"]
_JAX_MERGED = {}


def _jax_merged(name):
    """kat_tpu's merge kernel in interpret mode, reduced (equal keys may
    meet in another order there), once per case."""
    if name not in _JAX_MERGED:
        a, ac, b = _k2_case(name)
        bw = (b != SENTINEL).astype(np.uint32)
        (mh, ml), (mw,) = merge_sorted_kernel(
            _planes(a), (jnp.asarray(ac.astype(np.uint32)),), _planes(b),
            (jnp.asarray(bw),), block_rows=8, interpret=True)
        n = a.size + b.size
        keys = from_planes(np.asarray(mh)[:n], np.asarray(ml)[:n])
        _JAX_MERGED[name] = (keys, np.asarray(mw)[:n].astype(np.int32))
    return _JAX_MERGED[name]


@pytest.mark.parametrize("tile,items", [(16, 4), (256, 16), (4096, 16)])
@pytest.mark.parametrize("name", K2_CASES)
def test_k2_split_model(name, tile, items):
    """The tile splits and the per-thread merges inside a tile give
    merge_sorted_plain's stable merge exactly, and kat_tpu's merge kernel's
    keys (and its weights once equal keys are summed): na = 0, nb = 0,
    every key equal across both sides, one side wholly before the other."""
    a, ac, b = _k2_case(name)
    mk, mw = _k2_model(a, ac, b, tile, items)
    pk, pw = merge_sorted(torch.from_numpy(a), torch.from_numpy(ac),
                          torch.from_numpy(b))
    np.testing.assert_array_equal(mk, pk.numpy())
    np.testing.assert_array_equal(mw, pw.numpy())
    jk, jw = _jax_merged(name)
    np.testing.assert_array_equal(mk, jk)
    n = mk.size
    got = reduce_by_key(torch.from_numpy(mk), torch.from_numpy(mw), n)
    want = reduce_by_key(torch.from_numpy(jk), torch.from_numpy(jw), n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
