"""The port's window profiles (core/coverage.py) and the indexed encoder of
io/fastx against kat_tpu's on the same code batches made from a seed.
Exact (tolerance 0): counts and GC are integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.core import coverage as jcov
from kat_tpu.io import fastx as jfastx
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import coverage as tcov
from kat_tpu_torch.io import fastx as tfastx
from kat_tpu_torch.tools import common as tcommon

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

ROWS, LENGTH = 12, 192


def _case(k, canonical):
    """A table counted from half of a small genome, and code rows cut from
    all of it with substitutions and Ns: present, absent and invalid
    windows."""
    rng = np.random.default_rng(k + canonical)
    genome = rng.integers(0, 4, 4000, dtype=np.uint8)
    j = jc.CodeStreamingCounter(k, canonical, initial_capacity=1 << 12)
    t = tc.CodeStreamingCounter(k, canonical, initial_capacity=1 << 12,
                                device="cpu")
    reads = genome[:2000].reshape(10, 200)
    j.add_codes(reads)
    t.add_codes(reads)
    off = rng.integers(0, genome.size - LENGTH, ROWS)
    codes = genome[off[:, None] + np.arange(LENGTH)]
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[-1, -5:] = 4  # row padding
    return j.finish(), t.finish(), codes


@pytest.mark.parametrize("k,canonical", [(17, True), (27, True), (31, True),
                                         (27, False)])
def test_window_counts_match_jax(k, canonical):
    jt, tt, codes = _case(k, canonical)
    jcnt, jgc, jvalid = jcov.window_counts(jt, jnp.asarray(codes), k,
                                           canonical)
    got = tcov.window_counts(tt, torch.from_numpy(codes), k, canonical)
    cnt, gc, valid = (x.numpy() for x in got)
    assert cnt.shape == (ROWS, LENGTH - k + 1)
    assert cnt.dtype == np.int32 and gc.dtype == np.int32
    np.testing.assert_array_equal(cnt.astype(np.uint32), np.asarray(jcnt))
    np.testing.assert_array_equal(gc, np.asarray(jgc))
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    assert (cnt > 0).any() and (cnt[valid] == 0).any() and (~valid).any()
    assert (gc[~valid] == -1).all() and (cnt[~valid] == 0).all()
    # the join route (plain versions of the kernels here) gives the same
    for a, b in zip(got, tcov.window_counts(tt, torch.from_numpy(codes), k,
                                            canonical, method="join")):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,canonical", [(27, True), (17, False)])
def test_window_hit_counts_match_jax(k, canonical):
    jt, tt, codes = _case(k, canonical)
    jhits, jn = jcov.window_hit_counts(jt, jnp.asarray(codes), k, canonical)
    hits, nwin = tcov.window_hit_counts(tt, torch.from_numpy(codes), k,
                                        canonical)
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    np.testing.assert_array_equal(nwin.numpy(), np.asarray(jn))
    assert 0 < int(hits.sum()) < int(nwin.sum())


def _records(mod, rng):
    bases = np.frombuffer(b"ACGTN", np.uint8)
    lens = [5, 20, 21, 64, 65, 150, 500, 1201]
    return [mod.Record(f"s{i}", bases[rng.choice(
        5, n, p=[.24, .24, .24, .24, .04])].tobytes())
        for i, n in enumerate(lens)]


@pytest.mark.parametrize("max_row", [1 << 16, 256])
def test_encode_batch_indexed_matches_jax(max_row):
    """Same buckets, rows and provenance, also when rows longer than
    max_row are split with a (k-1)-base seam."""
    k = 21
    want = list(jfastx.encode_batch_indexed(
        _records(jfastx, np.random.default_rng(2)), k, max_row))
    got = list(tfastx.encode_batch_indexed(
        _records(tfastx, np.random.default_rng(2)), k, max_row))
    assert len(got) == len(want) > 1
    for (gc, gm), (wc, wm) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        assert gm == wm
    # every window of every record long enough is covered exactly once
    covered = {}
    for _codes, meta in got:
        for ri, start, nw in meta:
            covered.setdefault(ri, []).append((start, nw))
    for ri, spans in covered.items():
        spans.sort()
        assert spans[0][0] == 0
        for (s0, n0), (s1, _n1) in zip(spans, spans[1:]):
            assert s0 + n0 == s1
    assert sorted(covered) == [2, 3, 4, 5, 6, 7]
    if max_row == 256:
        assert len(covered[7]) > 1


def test_input_window_counts_are_host_arrays():
    _jt, tt, codes = _case(27, True)
    inp = tcommon.Input(paths=[], mer_len=27, table=tt,
                        device=torch.device("cpu"))
    c, g, v = inp.window_counts(codes)
    assert (type(c), c.dtype, g.dtype, v.dtype) == \
        (np.ndarray, np.uint32, np.int32, np.bool_)
    want = tcov.window_counts(tt, torch.from_numpy(codes), 27, True)
    np.testing.assert_array_equal(c, want[0].numpy())
    hits, nwin = inp.window_hit_counts(codes)
    np.testing.assert_array_equal(hits, ((c > 0) & v).sum(-1))
    np.testing.assert_array_equal(nwin, v.sum(-1))
    # the compacted lookup table is cached per counted table
    assert inp._compacted_table() is inp._compacted_table()
