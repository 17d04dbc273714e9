"""The port's CUDA kernels (K1 sort, K2 merge, K3 reduce) against their plain
PyTorch versions on the card, exactly (integer keys and counts: tolerance 0).

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor kat_tpu, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kat_tpu_torch.core import counting
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops.merge_kernel import merge_sorted, merge_sorted_plain
from kat_tpu_torch.ops.reduce_kernel import reduce_by_key, reduce_by_key_plain
from kat_tpu_torch.ops.sort_kernel import sort_keys, sort_keys_plain

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
                                  "all_sentinel", "empty", "one_run",
                                  "no_output", "large"])
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
