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
from kat_tpu.ops.sort_kernel import sort_planes_padded
from kat_tpu_torch.core.kmers import SENTINEL, from_planes, to_planes
from kat_tpu_torch.ops.merge_kernel import merge_sorted, merge_sorted_payload
from kat_tpu_torch.ops.reduce_kernel import compact_flagged, reduce_by_key
from kat_tpu_torch.ops.sort_kernel import sort_keys, sort_pairs


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
