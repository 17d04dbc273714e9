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
                                           sort_pairs)


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
