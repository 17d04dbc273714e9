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
from kat_tpu.ops.reduce_kernel import reduce_compact_sorted
from kat_tpu.ops.sort_kernel import sort_planes_padded
from kat_tpu_torch.core.kmers import SENTINEL, from_planes, to_planes
from kat_tpu_torch.ops.merge_kernel import merge_sorted
from kat_tpu_torch.ops.reduce_kernel import reduce_by_key
from kat_tpu_torch.ops.sort_kernel import sort_keys


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
