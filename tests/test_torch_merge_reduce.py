"""The fused K2 + K3 op of the counting flush (ops/merge_reduce_kernel.py)
on the CPU, and the counting engine's choice between it and K2 then K3.

The op's plain version is held against K2's and K3's plain versions in a
row and against numpy's unique-and-sum over the same keys: an empty side,
fresh keys all SENTINEL, no real key at all, keys on both sides, long
runs, fewer slots than runs, counts that wrap mod 2^32.  The fused route
is taken only on a card and below MAX_STREAM keys; on the CPU the counter
keeps K2 then K3.  The kernel itself is held against the plain version in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from kat_tpu_torch.core import counting
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops.merge_kernel import merge_sorted_plain
from kat_tpu_torch.ops.merge_reduce_kernel import (merge_reduce,
                                                   merge_reduce_plain)
from kat_tpu_torch.ops.reduce_kernel import reduce_by_key_plain
from kat_tpu_torch.utils import profiling

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device object: no card is needed to name one


def _keys(rng, n, lo, hi, sent=0.0):
    k = rng.integers(lo, hi, n)
    k[rng.random(n) < sent] = SENTINEL
    return np.sort(k)


def _case(name):
    """(table keys, table counts, fresh keys, out_size) as numpy arrays."""
    rng = np.random.default_rng(len(name))
    table = np.unique(_keys(rng, 300, 0, 1 << 40))
    counts = rng.integers(1, 1000, table.size)
    fresh = _keys(rng, 700, 0, 1 << 40, sent=0.25)
    out = 2000
    if name == "empty_table":
        table, counts = table[:0], counts[:0]
    elif name == "empty_fresh":
        fresh = fresh[:0]
    elif name == "both_empty":
        table, counts, fresh = table[:0], counts[:0], fresh[:0]
    elif name == "fresh_all_sentinel":
        fresh = np.full(500, SENTINEL)
    elif name == "all_sentinel":
        table, fresh = np.full(table.size, SENTINEL), np.full(500, SENTINEL)
    elif name == "keys_on_both_sides":
        fresh = np.sort(np.concatenate([rng.choice(table, 400), fresh[:300]]))
    elif name == "long_runs":
        table = np.array([3, 9, 11])
        counts = np.array([5, 1, 7])
        fresh = np.sort(np.concatenate([np.full(900, 9), np.full(400, 10),
                                        np.full(50, SENTINEL)]))
    elif name == "out_size_below_runs":
        out = 100
    elif name == "out_size_0":
        out = 0
    elif name == "counts_wrap":
        table = np.array([4, 8, 15])
        counts = np.array([2 ** 31 - 1, -2, 2 ** 31 - 5])
        fresh = np.array([4, 4, 4, 8, 8, 8, 15, 15, 15, 15, 15, 16])
        out = 8
    return (table.astype(np.int64), counts.astype(np.int32),
            fresh.astype(np.int64), out)


def _numpy_runs(table, counts, fresh, out_size):
    """(keys, counts, n) by numpy's unique over the real keys, the counts
    summed in int64 and cut to int32 (mod 2^32), padded and truncated."""
    keys = np.concatenate([table, fresh])
    w = np.concatenate([counts.astype(np.int64),
                        (fresh != SENTINEL).astype(np.int64)])
    real = keys != SENTINEL
    uniq, inv = np.unique(keys[real], return_inverse=True)
    sums = np.zeros(uniq.size, np.int64)
    np.add.at(sums, inv, w[real])
    m = min(uniq.size, out_size)
    out_k = np.full(out_size, SENTINEL, np.int64)
    out_c = np.zeros(out_size, np.int32)
    out_k[:m] = uniq[:m]
    out_c[:m] = (sums[:m] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return out_k, out_c, uniq.size


CASES = ("empty_table", "empty_fresh", "both_empty", "fresh_all_sentinel",
         "all_sentinel", "keys_on_both_sides", "long_runs",
         "out_size_below_runs", "out_size_0", "counts_wrap")


@pytest.mark.parametrize("name", CASES)
def test_merge_reduce_is_k2_then_k3(name):
    table, counts, fresh, out_size = _case(name)
    args = (torch.from_numpy(table), torch.from_numpy(counts),
            torch.from_numpy(fresh))
    got = merge_reduce(*args, out_size)
    split = reduce_by_key_plain(*merge_sorted_plain(*args), out_size)
    want = _numpy_runs(table, counts, fresh, out_size)
    assert got[0].shape == got[1].shape == (out_size,)
    assert int(got[2]) == int(split[2]) == want[2]
    if name == "out_size_below_runs":
        assert want[2] > out_size  # the true count, past the slots
    for g, s, w in zip(got[:2], split[:2], want[:2]):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.equal(got[0], merge_reduce_plain(*args, out_size)[0])


def test_merge_reduce_refuses_what_the_kernel_cannot_take(monkeypatch):
    a = torch.arange(4, dtype=torch.int64)
    c = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ in length"):
        merge_reduce(a, c[:3], a, 8)
    with pytest.raises(ValueError, match="out_size"):
        merge_reduce(a, c, a, -1)
    with pytest.raises(TypeError):
        merge_reduce(a, c.to(torch.int64), a, 8)
    from kat_tpu_torch.ops import merge_reduce_kernel
    monkeypatch.setattr(merge_reduce_kernel, "MAX_N", 8)
    with pytest.raises(ValueError, match="2\\^30"):
        merge_reduce(a, c, a, 8)


@pytest.mark.parametrize("table,fresh,n,max_stream,want", [
    (CUDA, CUDA, 0, None, True),
    (CUDA, CUDA, (1 << 30) - 1, None, True),
    (CUDA, CUDA, 1 << 30, None, False),
    (torch.device("cuda", 0), torch.device("cuda", 0), 5, None, True),
    (CPU, CPU, 5, None, False),
    (CUDA, CPU, 5, None, False),
    (CPU, CUDA, 5, None, False),
    (CUDA, CUDA, 1499, 1500, True),
    (CUDA, CUDA, 1500, 1500, False),
    (CPU, CPU, 10, 1500, False),
])
def test_fused_route_only_on_a_card_below_max_stream(monkeypatch, table,
                                                     fresh, n, max_stream,
                                                     want):
    if max_stream is not None:
        monkeypatch.setattr(counting, "MAX_STREAM", max_stream)
    assert counting.fused_merge(table, fresh, n) is want


ROWS, LENGTH, K = 16, 100, 27


def _count(k=K, n_batches=6, cap=256):
    """One batch a flush from a table of `cap` slots: growth replays."""
    g = torch.Generator().manual_seed(7)
    sc = counting.CodeStreamingCounter(
        k, True, initial_capacity=cap, max_capacity=1 << 20,
        flush_windows=ROWS * (LENGTH - k + 1), device=CPU)
    for _ in range(n_batches):
        sc.add_codes(torch.randint(0, 4, (ROWS, LENGTH), generator=g,
                                   dtype=torch.uint8))
    return sc.finish()


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {n: after[n] - before[n] for n in after}


def test_the_cpu_counter_keeps_k2_then_k3():
    _table, got = _counted(_count)
    assert got["fused_merges"] == 0
    assert got["flushes"] == 6 and got["replays"] > 0


def test_lowered_max_stream_sends_long_merges_to_k2_then_k3_in_pieces(
        monkeypatch):
    """With the card's predicate on CPU tensors and MAX_STREAM lowered to
    1500 keys, the early merges take the fused op and the later ones K2
    then K3 in pieces; the table is the one the split route gives."""
    want = _count()
    real = counting.fused_merge
    monkeypatch.setattr(counting, "fused_merge",
                        lambda _t, _f, n: real(CUDA, CUDA, n))
    monkeypatch.setattr(counting, "MAX_STREAM", 1500)
    pieces = []
    reduce = counting.reduce_by_key
    monkeypatch.setattr(counting, "reduce_by_key",
                        lambda k, *a, **kw: pieces.append(k.numel())
                        or reduce(k, *a, **kw))
    table, got = _counted(_count)
    assert 0 < got["fused_merges"] < got["flushes"] + got["replays"]
    assert pieces and max(pieces) < 1500
    assert table.n_unique == want.n_unique
    assert torch.equal(table.keys, want.keys)
    assert torch.equal(table.counts, want.counts)
