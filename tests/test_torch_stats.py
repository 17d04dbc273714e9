"""The port's binned sums and the statistics built on them (core/stats.py,
ops/binned_kernel.py) against kat_tpu's on the same numpy inputs, made
from a seed: binned_sums, monotone_packed_sums, spectrum, gcp_matrix and
hist_from_counts.  kat_tpu runs both its scatter path and its kernel path
(the binned form of its K1 sort + K3 reduce, Pallas in interpret mode at
n ~ 4K, as tests/test_counting.py runs it); the port runs the plain
versions of its kernel, as on any CPU tensor.  Exact (tolerance 0):
counts are integers.  Counts of 2^31 and 2^32 - 1 must be read as
unsigned, as kat_tpu's uint32 counts."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import counting as jc
from kat_tpu.core import kmers as jk
from kat_tpu.core import stats as jstats
from kat_tpu.core import wide as jw
from kat_tpu_torch.core import counting as tc
from kat_tpu_torch.core import stats as tstats
from kat_tpu_torch.core import wide as tw
from kat_tpu_torch.core.kmers import SENTINEL
from kat_tpu_torch.ops import binned_kernel as bk

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

BIG = [1 << 31, (1 << 32) - 1, (1 << 31) + 7]  # counts past int32


@pytest.fixture
def jax_path(request, monkeypatch):
    """kat_tpu's two routes: its scatter (`mask_bincount`), or its sort +
    reduce kernels in interpret mode from any size on.  jitted callers
    only see the kernel gate on a fresh trace, so each case takes its own
    odd length."""
    if request.param == "kernel":
        monkeypatch.setenv("KAT_TPU_KERNEL", "1")
        monkeypatch.setattr(jstats, "BINNED_SORT_MIN", 1)
    jc.kernels_enabled.cache_clear()
    yield request.param
    jc.kernels_enabled.cache_clear()


def _u64(x):
    return np.asarray(x).astype(np.uint64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("jax_path,n,total,n_masks", [
    ("scatter", 4003, 37, 1), ("scatter", 4021, 1001, 2),
    ("scatter", 4057, 5000, 3), ("kernel", 4093, 5000, 2)],
    indirect=["jax_path"])
def test_binned_sums_match_jax(jax_path, n, total, n_masks):
    rng = np.random.default_rng(n)
    # skewed bins, as k-mer spectra are: most of the mass in a few bins
    bins = np.where(rng.random(n) < 0.7, rng.integers(0, 4, n),
                    rng.integers(0, total, n)).astype(np.int32)
    masks = [rng.random(n) < p for p in (0.6, 0.3, 0.9)[:n_masks]]
    want = jstats.binned_sums(total, jnp.asarray(bins),
                              tuple(jnp.asarray(m) for m in masks))
    got = tstats.binned_sums(total, _t(bins), [_t(m) for m in masks])
    assert len(got) == n_masks
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (total,)
        np.testing.assert_array_equal(_u64(g), _u64(w))
    assert sum(int(g.sum()) for g in got) == sum(int(m.sum()) for m in masks)
    model = bk.partition_model(_t(bins), _t(np.stack(masks)),
                               [(1, total, m) for m in range(n_masks)],
                               **TINY)
    for g, w in zip(model, got, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("jax_path,n", [("scatter", 4127),
                                        ("scatter", 4111)],
                         indirect=["jax_path"])
def test_monotone_packed_sums_match_jax(jax_path, n):
    """comp pass 2's shape: two monotone step binnings of one value packed
    together, requests that coarsen across packed runs (the derived bin
    repeats) and nested ones, three masks."""
    rng = np.random.default_rng(n)
    v = rng.integers(0, 500, size=n)
    spec = np.minimum(v, 36).astype(np.int32)  # dm = 37
    col = np.minimum((v + 2) // 3, 28).astype(np.int32)  # d2 = 29
    packed = spec * 29 + col
    masks = [rng.random(n) < p for p in (0.6, 0.3, 0.8)]
    reqs = ((29, 37, 0), (1, 29, 1), (29, 37, 2))
    want = jstats.monotone_packed_sums(
        jnp.asarray(packed), 37 * 29, reqs,
        tuple(jnp.asarray(m) for m in masks), runs_cap=37 + 29 + 8)
    got = tstats.monotone_packed_sums(_t(packed), reqs,
                                      [_t(m) for m in masks])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u64(g), _u64(w))
    for g, w in zip(bk.partition_model(_t(packed), _t(np.stack(masks)), reqs,
                                       **TINY), got, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("jax_path,n", [("scatter", 4133), ("kernel", 4093)],
                         indirect=["jax_path"])
def test_monotone_packed_sums_nested_request_matches_jax(jax_path, n):
    """comp pass 1's default shape: the spectrum bin is the high part of
    the flat matrix key, the matrix is the key itself; masks 1 and 2 only
    (mask 0 unused, so the port stacks just the two it reads)."""
    rng = np.random.default_rng(3)
    d1, d2 = 41, 23
    s1 = np.minimum(rng.poisson(6, n), d1 - 1)
    s2 = np.minimum(rng.poisson(2, n), d2 - 1)
    packed = (s1 * d2 + s2).astype(np.int32)
    masks = [rng.random(n) < p for p in (0.5, 0.9, 0.4)]
    reqs = ((d2, d1, 1), (d2, d1, 2), (1, d1 * d2, 1))
    want = jstats.monotone_packed_sums(
        jnp.asarray(packed), d1 * d2, reqs,
        tuple(jnp.asarray(m) for m in masks))
    got = tstats.monotone_packed_sums(_t(packed), reqs,
                                      [_t(m) for m in masks])
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_u64(g), _u64(w))
    for g, w in zip(bk.partition_model(_t(packed), _t(np.stack(masks)), reqs,
                                       **TINY), got, strict=True):
        assert torch.equal(g, w)


# the card's geometry, and one small enough that ~4K elements cut ranges
# into pieces, widen ranges past their window and span many tiles
TINY = dict(small=0, max_ranges=16, window_bits=(6, 5), blocks=3, tile=256)


def _partition_case(name, rng):
    """(keys int32, masks bool [M, n], requests, kat_tpu's sums)."""
    if name in ("one_hot_past_window", "all_masks_zero"):
        n, total = (4097, 1_002_001) if name[0] == "o" else (4111, 1_002_001)
        m = 3 if name[0] == "o" else 2
        keys = np.full(n, total - 1, np.int32) if name[0] == "o" else \
            rng.integers(0, total, n).astype(np.int32)
        masks = rng.random((m, n)) < 0.6 if name[0] == "o" else \
            np.zeros((m, n), bool)
        reqs = [(1, total, i) for i in range(m)]
        want = jstats.binned_sums(total, jnp.asarray(keys),
                                  tuple(jnp.asarray(x) for x in masks))
        return keys, masks, reqs, want
    n = 4129
    if name == "div_edges":  # keys across int32, divisors 1 to 2^31 - 1
        keys = rng.integers(0, 1 << 31, n).astype(np.int32)
        keys[:4] = [0, 1, (1 << 31) - 1, (1 << 31) - 2]
        masks = rng.random((3, n)) < 0.6
        reqs = [(1, 1, 0), ((1 << 31) - 1, 3, 1), (1001, 1001, 2)]
        want = [jstats.binned_sum(mod, jnp.asarray((keys.astype(np.int64)
                                                    // div) % mod),
                                  jnp.asarray(masks[mi]))
                for div, mod, mi in reqs]
        return keys, masks, reqs, want
    s1 = np.minimum(rng.poisson(24, n), 1000)
    s2 = np.minimum(rng.poisson(1, n), 1000)
    masks = rng.random((3, n)) < np.array([[0.9], [0.5], [0.3]])
    if name == "comp_pass1":  # the spectrum is the matrix key's high part
        reqs = [(1001, 1001, 0), (1001, 1001, 1), (1, 1001 * 1001, 0)]
        packed, cap = s1 * 1001 + s2, 0
    else:  # comp_pass2: spectrum and column both from hash2's count
        reqs = [(1001, 1001, 0), (1, 1001, 1), (1001, 1001, 2)]
        packed, cap = s1 * 1001 + np.minimum(s1 + 2, 1000), 2 * 1001 + 8
    keys = packed.astype(np.int32)
    want = jstats.monotone_packed_sums(
        jnp.asarray(keys), 1001 * 1001, tuple(reqs),
        tuple(jnp.asarray(x) for x in masks), runs_cap=cap)
    return keys, masks, reqs, want


@pytest.mark.parametrize("jax_path", ["scatter"], indirect=True)
@pytest.mark.parametrize("name", ["one_hot_past_window", "all_masks_zero",
                                  "div_edges", "comp_pass1", "comp_pass2"])
def test_partition_model_matches_jax(jax_path, name):
    """The card's binned sums step by step (`bk.partition_model`: one-pass
    groups, range counts, the plan, the scatter of words tile by tile,
    the count of each range or piece) against kat_tpu and the plain
    version: every element in the last bin (past any window), all masks
    zero, n % 16 of 1 and 15 (the masks' planes unaligned), divisors of 1,
    1001 and 2^31 - 1 with mod 1, comp pass 1's and pass 2's requests; at
    the card's geometry and at TINY's."""
    keys, masks, reqs, want = _partition_case(
        name, np.random.default_rng(len(name)))
    kt, mt = _t(keys), _t(masks)
    plain = bk.packed_sums_plain(kt, mt, reqs)
    for geometry in ({}, TINY):
        got = bk.partition_model(kt, mt, reqs, **geometry)
        for g, p, w in zip(got, plain, want, strict=True):
            assert torch.equal(g, p)
            np.testing.assert_array_equal(_u64(g), _u64(w))


def test_partition_plan_and_magic_numbers():
    """`bk.plan` as csrc/binned.cu's make_plan sizes comp's requests, and
    the multiply-high division exact at the edges of int32."""
    one, parted = bk.plan(((1001, 1001, 0), (1001, 1001, 1),
                           (1, 1001 * 1001, 0)))
    assert [len(g["masks"]) for g in one] == [2]
    assert [(g["rb"], g["nr"]) for g in parted] == [(14, 62)]
    one, parted = bk.plan([(1, 1001 * 1001, m) for m in range(3)])
    assert not one and [(g["rb"], g["nr"]) for g in parted] == [(13, 123)]
    _one, parted = bk.plan([(1, 1 << 28, 0), (3, 1 << 22, 1)])
    assert sum(g["nr"] for g in parted) <= bk.MAX_RANGES
    x = torch.tensor([0, 1, 1000, 1001, 1002000, 1 << 30, (1 << 31) - 2,
                      (1 << 31) - 1], dtype=torch.int64)
    for d in (1, 2, 3, 7, 1000, 1001, 1 << 20, (1 << 30) + 1, (1 << 31) - 1):
        m, sh = bk.magic(d)
        assert 0 <= m < 1 << 32
        for mod in (1, 3, 1001, (1 << 31) - 1):
            assert torch.equal(bk.bin_of(x, d, mod), (x // d) % mod)


@pytest.mark.parametrize("jax_path,n,nb", [
    ("scatter", 4201, 13), ("scatter", 4219, 1001), ("kernel", 4229, 1001)],
    indirect=["jax_path"])
def test_spectrum_matches_jax(jax_path, n, nb):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 2 * nb, n).astype(np.int64)
    counts[:3] = BIG
    w = rng.random(n) < 0.7
    want = jstats.spectrum(jnp.asarray(counts.astype(np.uint64)),
                           jnp.asarray(w.astype(np.uint64)), nb)
    got = tstats.spectrum(_t(counts), _t(w), nb)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    np.testing.assert_array_equal(
        tstats.spectrum_bins(_t(counts), nb).numpy(),
        np.asarray(jstats.spectrum_bins(jnp.asarray(counts), nb)))


@pytest.mark.parametrize("jax_path,n,low,high,inc", [
    ("scatter", 4231, 1, 10000, 1), ("scatter", 4243, 3, 60, 4),
    ("kernel", 4253, 1, 10000, 1)], indirect=["jax_path"])
def test_hist_from_counts_matches_jax(jax_path, n, low, high, inc):
    rng = np.random.default_rng(n)
    counts = np.where(rng.random(n) < 0.8, rng.poisson(20, n),
                      rng.integers(0, 1 << 32, n)).astype(np.uint32)
    counts[rng.random(n) < 0.1] = 0  # padding slots
    counts[:3] = BIG
    base = low - 1 if low > 1 else 1
    ceil = high + 1
    nb = ceil + 1 - base
    want = jstats.hist_from_counts(jnp.asarray(counts), base, ceil, inc, nb)
    got = tstats.hist_from_counts(_t(counts.astype(np.int32)), base, ceil,
                                  inc, nb)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    assert int(got[-1]) >= 3  # the big counts land in the last bucket


def _narrow_tables(rng, k, n, capacity):
    """The same narrow table in both packages: n distinct k-mers, Poisson
    counts around 12 (with the three big counts), padding at the tail."""
    keys = rng.choice(np.arange(1 << (2 * k), dtype=np.uint64)
                      if k <= 10 else
                      rng.integers(0, 1 << (2 * k), 3 * n).astype(np.uint64),
                      size=n, replace=False)
    counts = (rng.poisson(12, n) + 1).astype(np.uint32)
    counts[:3] = BIG
    jt = jc.table_from_numpy(keys, counts, capacity=capacity)
    tt = tc.table_from_jax_numpy(np.asarray(jt.keys_hi),
                                 np.asarray(jt.keys_lo),
                                 np.asarray(jt.counts), int(jt.n_unique),
                                 device="cpu")
    return jt, tt


@pytest.mark.parametrize("jax_path,k,cap,cvg_bins,scale", [
    ("scatter", 9, 4099, 50, 1.0), ("scatter", 17, 4133, 1000, 1.0),
    ("scatter", 27, 4159, 77, 0.37), ("scatter", 31, 4177, 1000, 1e-9),
    ("kernel", 27, 4093, 1000, 1e-9)], indirect=["jax_path"])
def test_gcp_matrix_matches_jax(jax_path, k, cap, cvg_bins, scale):
    """Narrow tables carried across from kat_tpu's; scale 1e-9 puts the
    counts of 2^31 and more in columns 3 and 5, where a signed read would
    put them in column 0."""
    rng = np.random.default_rng(k)
    jt, tt = _narrow_tables(rng, k, 3000, cap)
    want = jstats.gcp_matrix(jt, k, cvg_bins, scale)
    got = tstats.gcp_matrix(tt, k, cvg_bins, scale)
    assert got.shape == (k + 1, cvg_bins + 1) and got.dtype == torch.int64
    np.testing.assert_array_equal(_u64(got), _u64(want))
    if scale == 1e-9:
        assert int(got[:, 5].sum()) >= 1 and int(got[:, 3].sum()) >= 1


@pytest.mark.parametrize("k", [41, 95])
def test_gcp_matrix_wide_matches_jax(k):
    """Wide tables (kat_tpu's u32 words, the port's 31-base int64 words)
    carried across with table_from_jax_words."""
    rng = np.random.default_rng(k)
    n = 500
    keys = [int.from_bytes(rng.bytes(32), "little") % (1 << (2 * k))
            for _ in range(n)]
    counts = (rng.poisson(8, n) + 1).astype(np.uint32)
    counts[:2] = BIG[:2]
    jt = jw.table_from_ints(keys, counts, capacity=1024,
                            n_words=jk.words_for_k(k))
    tt = tw.table_from_jax_words(tuple(np.asarray(w) for w in jt.words),
                                 np.asarray(jt.counts), jt.n_unique, k,
                                 device="cpu")
    for cvg_bins, scale in ((1000, 1.0), (40, 2.5)):
        want = jstats.gcp_matrix(jt, k, cvg_bins, scale)
        got = tstats.gcp_matrix(tt, k, cvg_bins, scale)
        np.testing.assert_array_equal(_u64(got), _u64(want))
    assert int(got[:, -1].sum()) >= 2


def test_mask_bincount_and_binned_sum_match_jax():
    rng = np.random.default_rng(11)
    n = 3000
    idx = rng.integers(0, 91, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    want = jstats.mask_bincount((91,), jnp.asarray(idx), jnp.asarray(mask))
    np.testing.assert_array_equal(
        _u64(tstats.mask_bincount(91, _t(idx), _t(mask))), _u64(want))
    np.testing.assert_array_equal(
        _u64(tstats.binned_sum(91, _t(idx), _t(mask))), _u64(want))


def test_unsigned_reads_counts_as_uint32():
    c = torch.tensor([0, 1, -1, -(1 << 31), (1 << 31) - 1],
                     dtype=torch.int32)
    assert tstats.unsigned(c).tolist() == [0, 1, (1 << 32) - 1, 1 << 31,
                                           (1 << 31) - 1]


def test_plain_versions_equal_numpy():
    """binned_sums_plain and packed_sums_plain against np.bincount /
    np.add.at, with uint8 masks that hold values above one (non-zero
    counts one)."""
    rng = np.random.default_rng(5)
    n, total = 5000, 257
    bins = rng.integers(0, total, n).astype(np.int32)
    masks = rng.integers(0, 3, (3, n)).astype(np.uint8)
    got = bk.binned_sums(_t(bins), _t(masks), total)
    assert got.shape == (3, total)
    for g, m in zip(got, masks):
        np.testing.assert_array_equal(
            g.numpy(), np.bincount(bins[m > 0], minlength=total))
    packed = rng.integers(0, 40_000, n).astype(np.int32)
    reqs = ((100, 400, 0), (7, 33, 2), (1, 40_000, 1))
    for (div, mod, mi), g in zip(reqs, bk.packed_sums(_t(packed), _t(masks),
                                                      reqs)):
        want = np.zeros(mod, np.int64)
        np.add.at(want, (packed[masks[mi] > 0] // div) % mod, 1)
        np.testing.assert_array_equal(g.numpy(), want)


def test_empty_input_gives_zero_bins():
    got = bk.binned_sums(torch.zeros(0, dtype=torch.int32),
                         torch.zeros((2, 0), dtype=torch.bool), 11)
    assert got.shape == (2, 11) and int(got.abs().sum()) == 0
    assert tstats.hist_from_counts(torch.zeros(0, dtype=torch.int32), 1,
                                   10001, 1, 10001).shape == (10001,)


def _i32(n=4):
    return torch.zeros(n, dtype=torch.int32)


def _on(*shape):
    return torch.ones(shape, dtype=torch.bool)


@pytest.mark.parametrize("what,call,exc", [
    ("int64 keys", lambda: bk.binned_sums(
        torch.zeros(4, dtype=torch.int64), _on(1, 4), 3), TypeError),
    ("float masks", lambda: bk.binned_sums(_i32(), torch.ones((1, 4)), 3),
     TypeError),
    ("four masks", lambda: bk.binned_sums(_i32(), _on(4, 4), 3), ValueError),
    ("1-D masks", lambda: bk.binned_sums(_i32(), _on(4), 3), ValueError),
    ("lengths differ", lambda: bk.binned_sums(_i32(), _on(1, 5), 3),
     ValueError),
    ("no bins", lambda: bk.binned_sums(_i32(), _on(1, 4), 0), ValueError),
    ("mod past int32", lambda: bk.packed_sums(
        _i32(), _on(1, 4), [(1, 1 << 31, 0)]), ValueError),
    ("mask index", lambda: bk.packed_sums(_i32(), _on(1, 4), [(1, 3, 1)]),
     ValueError),
    ("four requests", lambda: bk.packed_sums(
        _i32(), _on(1, 4), [(1, 3, 0)] * 4), ValueError),
    ("strided keys", lambda: bk.binned_sums(_i32(8)[::2], _on(1, 4), 3),
     ValueError),
], ids=lambda v: v if isinstance(v, str) else "")
def test_wrapper_refuses_what_the_kernel_does_not_take(what, call, exc):
    with pytest.raises(exc):
        call()


def test_gcp_matrix_ceil_is_taken_in_float64():
    """ceil(count x scale) in float64, as kat_tpu takes it: 3 x 0.1 is
    0.30000000000000004 there, so column 1; 10 x 0.1 is exactly 1."""
    keys = np.array([5, 9], np.uint64)
    counts = np.array([3, 10], np.uint32)
    tt = tc.table_from_numpy(keys, counts, capacity=4, device="cpu")
    got = tstats.gcp_matrix(tt, 3, 4, 0.1)
    cols = got.sum(0).tolist()
    assert cols[1] == 2 and math.ceil(3 * 0.1) == 1
    assert int(got.sum()) == 2
    assert tt.keys[2].item() == SENTINEL
