"""The plain versions of the W-word merge and reduce (what runs on the CPU)
against kat_tpu's Pallas kernels in interpret mode, as kat_tpu's own tests
run them: `merge_sorted_words_plain` against `merge_sorted_kernel`,
`reduce_by_key_words_plain` against `reduce_compact_sorted`, at W = 2, 3
and 4 (k = 41, 63, 95) on n <= 4096 keys made from a numpy seed; the
W-word wrappers' checks.  Keys cross between the packages through
kmers.to_ref_words / from_ref_words (the key's integer value).  Exact
(tolerance 0).  The sort is in test_torch_wide_sort.py; the CUDA kernels
are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.ops.merge_kernel import merge_sorted_kernel
from kat_tpu.ops.reduce_kernel import reduce_compact_sorted
from kat_tpu_torch.core.kmers import (SENTINEL, from_ref_words,
                                      to_ref_words, top_bases, words_for_k)
from kat_tpu_torch.ops.merge_kernel import (merge_sorted_words,
                                            merge_sorted_words_plain)
from kat_tpu_torch.ops.reduce_kernel import (reduce_by_key_words,
                                             reduce_by_key_words_plain)
from kat_tpu_torch.ops.sort_kernel import (sort_words, sort_words_plain,
                                           words_pass_floor_bytes,
                                           words_passes)

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

W_K = {2: 41, 3: 63, 4: 95}  # W -> a k with that many words


def _keys(rng, k, n, sent_frac=0.1, universe=None):
    """[W, n] int64 wide keys: random (or drawn from `universe`), a share
    of them SENTINEL."""
    W = words_for_k(k)
    if universe is None:
        words = [rng.integers(0, 1 << (2 * top_bases(k)), n)]
        words += [rng.integers(0, 1 << 62, n) for _ in range(W - 1)]
        keys = np.stack(words).astype(np.int64)
    else:
        keys = universe[:, rng.integers(0, universe.shape[1], n)]
    keys[:, rng.random(n) < sent_frac] = SENTINEL
    return keys


def _ref(keys, k):
    """kat_tpu's big-first uint32 planes of [W, n] keys."""
    return tuple(jnp.asarray(p) for p in to_ref_words(keys, k).T)


def _back(planes, k):
    return from_ref_words(tuple(np.asarray(p) for p in planes), k)


def _table(rng, k, n, universe):
    """A sorted table of n slots: distinct keys of `universe`, SENTINEL
    padding, counts 1-49 (0 in padding)."""
    keys = np.unique(universe[:, rng.integers(0, universe.shape[1], n)],
                     axis=1)
    keys = sort_words_plain(torch.from_numpy(keys)).numpy()
    pad = np.full((keys.shape[0], n - keys.shape[1]), SENTINEL, np.int64)
    keys = np.concatenate([keys, pad], axis=1)
    counts = np.where(keys[0] == SENTINEL, 0, rng.integers(1, 50, n))
    return keys, counts.astype(np.int32)


@pytest.mark.parametrize("W,na,nb", [(2, 1024, 1024), (2, 700, 3000),
                                     (3, 700, 3000), (4, 700, 3000)])
def test_merge_words_matches_jax(W, na, nb):
    """The W-word merge of a table and sorted fresh keys (with SENTINEL
    tails on both) equals kat_tpu's merge kernel; equal keys may meet in
    another order there, so both merges are compared after a reduce."""
    k = W_K[W]
    rng = np.random.default_rng(W + na + nb)
    universe = _keys(rng, k, 1500, sent_frac=0.0)
    a, ac = _table(rng, k, na, universe)
    b = sort_words_plain(torch.from_numpy(
        _keys(rng, k, nb, universe=universe))).numpy()
    bw = (b[0] != SENTINEL).astype(np.uint32)
    mwords, (mw,) = merge_sorted_kernel(
        _ref(a, k), (jnp.asarray(ac.astype(np.uint32)),), _ref(b, k),
        (jnp.asarray(bw),), block_rows=8, interpret=True)
    n = na + nb
    jkeys = _back(tuple(p[:n] for p in mwords), k)
    jw = np.asarray(mw)[:n].astype(np.int32)

    gk, gw = merge_sorted_words_plain(torch.from_numpy(a),
                                      torch.from_numpy(ac),
                                      torch.from_numpy(b))
    np.testing.assert_array_equal(gk.numpy(), jkeys)
    got = reduce_by_key_words_plain(gk, gw, n)
    want = reduce_by_key_words_plain(torch.from_numpy(jkeys),
                                     torch.from_numpy(jw), n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(x, y) for x, y in zip(
        merge_sorted_words(torch.from_numpy(a), torch.from_numpy(ac),
                           torch.from_numpy(b)), (gk, gw)))


def _reduce_case(name, rng, k):
    n = 4096
    if name == "random":
        universe = _keys(rng, k, 300, sent_frac=0.0)
        keys = _keys(rng, k, n, universe=universe)
        w = rng.integers(0, 5, n)
        out_size = n
    elif name == "top_equal":
        # runs that differ only below the top word
        universe = _keys(rng, k, 200, sent_frac=0.0)
        universe[0] = 7
        keys = _keys(rng, k, n, sent_frac=0.05, universe=universe)
        w = rng.integers(1, 9, n)
        out_size = n
    elif name == "overflow":
        keys = _keys(rng, k, n, sent_frac=0.0)
        w = np.ones(n)
        out_size = 64
    elif name == "all_sentinel":
        keys = np.full((words_for_k(k), n), SENTINEL, np.int64)
        w = np.zeros(n)
        out_size = 256
    else:
        raise KeyError(name)
    keys = sort_words_plain(torch.from_numpy(keys)).numpy()
    w = np.where(keys[0] == SENTINEL, 0, w).astype(np.int64)
    return keys, w, out_size


@pytest.mark.parametrize("name", ["random", "top_equal", "overflow",
                                  "all_sentinel"])
@pytest.mark.parametrize("W", [2, 3, 4])
def test_reduce_words_matches_jax(W, name):
    k = W_K[W]
    keys, w, out_size = _reduce_case(name, np.random.default_rng(W), k)
    *jwords, jc, jn = reduce_compact_sorted(
        _ref(keys, k), jnp.asarray(w.astype(np.uint32)), out_size,
        rows_per_tile=8, interpret=True)
    gk, gc, gn = reduce_by_key_words_plain(
        torch.from_numpy(keys), torch.from_numpy(w.astype(np.int32)),
        out_size)
    assert int(gn) == int(jn)
    np.testing.assert_array_equal(gk.numpy(), _back(jwords, k))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(jc).astype(np.int32))
    got = reduce_by_key_words(torch.from_numpy(keys),
                              torch.from_numpy(w.astype(np.int32)), out_size)
    assert all(torch.equal(x, y) for x, y in zip(got, (gk, gc, gn)))


def test_words_pass_structure():
    """Three passes over the whole array whatever W (the two split passes
    and the bucket sort); the floor counts one read of the words that hold
    the 16-bit prefix for the histogram (the top word at k = 41, the top
    two at k = 95, whose top word holds 4 bits) and a read and a write of
    every word (and the value) a pass: 104 bytes a key at k = 41."""
    assert words_passes(2, 21) == 3
    assert words_passes(9, 15) == 3
    assert words_pass_floor_bytes(1 << 26, 2, 21) == (1 << 26) * 104
    assert words_pass_floor_bytes(1 << 23, 4, 5, True) == \
        (1 << 23) * (16 + 6 * 36)


def test_word_wrappers_reject_bad_input():
    k = torch.zeros((2, 8), dtype=torch.int64)
    w = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        sort_words(k.to(torch.int32), 21)
    with pytest.raises(ValueError, match="W, n"):
        sort_words(torch.zeros(8, dtype=torch.int64), 21)
    with pytest.raises(ValueError, match="W, n"):
        sort_words(torch.zeros((10, 8), dtype=torch.int64), 21)
    with pytest.raises(ValueError, match="contiguous"):
        sort_words(torch.zeros((8, 2), dtype=torch.int64).t(), 21)
    with pytest.raises(ValueError, match="top_bits"):
        sort_words(k, 64)
    with pytest.raises(ValueError, match="differ in words"):
        merge_sorted_words(k, w, torch.zeros((3, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="differ in length"):
        reduce_by_key_words(k, w[:5], 8)
    big = torch.empty((2, 1 << 30), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="2\\^30"):
        sort_words(big, 21)
    with pytest.raises(ValueError, match="2\\^30"):
        reduce_by_key_words(big, torch.empty(1 << 30, dtype=torch.int32,
                                             device="meta"), 8)
