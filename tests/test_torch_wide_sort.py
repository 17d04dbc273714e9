"""The W-word sort on the CPU against kat_tpu's full-sort kernel in
interpret mode, as kat_tpu's own tests run it (`sort_planes_padded`):

- the plain W-word sort (what runs on the CPU) at W = 2, 3 and 4;
- the card's design step by step in plain PyTorch (`sort_words_model`:
  the 16-bit prefix histogram, two stable prefix passes, the units, each
  unit's stable sort, the fallback passes over oversize buckets), with
  the card's bucket capacity and with one of 64 keys so that oversize
  buckets occur, at every k of `workloads.WIDE_STRAIN_K` on seven kinds of
  keys (`WIDE_STRAIN` and `WIDE_SKEW`);
- the host-visible half of that design: which bits make the prefix, the
  sentinels' bucket, the fallback's digits and the plan's units; the
  sharded sort's (owner, key) shape and the value form's stability
  against the plain sort.

Keys are made from numpy seeds and cross between the packages through
kmers.to_ref_words / from_ref_words (the key's integer value).  Every
kat_tpu call here pads its uint32 planes to the 16 of a k = 255 key with
leading zero planes (which change no order), so one compile serves them
all.  Exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.ops.sort_kernel import sort_planes_padded
from kat_tpu_torch.benchmarks import workloads
from kat_tpu_torch.core.kmers import (SENTINEL, from_ref_words,
                                      ref_words_for_k, to_ref_words,
                                      top_bases, words_for_k)
from kat_tpu_torch.ops.sort_kernel import (BUCKET_CAP, PREFIX_BITS,
                                           SENTINEL_BUCKET, bucket_of,
                                           fallback_digits, plan_units,
                                           prefix_layout, sort_words,
                                           sort_words_model,
                                           sort_words_pairs_plain,
                                           sort_words_plain)

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

W_K = {2: 41, 3: 63, 4: 95}  # W -> a k with that many words
PLANES = ref_words_for_k(255)
N = 2000
KINDS = workloads.WIDE_STRAIN + workloads.WIDE_SKEW


def _jax_sort(keys: np.ndarray, k: int) -> np.ndarray:
    """kat_tpu's sort of [W, n] keys, its planes padded to PLANES."""
    ref = to_ref_words(keys, k)
    pad = np.zeros((ref.shape[0], PLANES - ref.shape[1]), np.uint32)
    planes = tuple(jnp.asarray(p) for p in np.concatenate([pad, ref], 1).T)
    out = sort_planes_padded(planes, PLANES, block_rows=8, interpret=True)
    return from_ref_words(tuple(np.asarray(p) for p in out[pad.shape[1]:]),
                          k)


def _random(k, n, rng, sent):
    words = [rng.integers(0, 1 << (2 * top_bases(k)), n)]
    words += [rng.integers(0, 1 << 62, n) for _ in range(words_for_k(k) - 1)]
    keys = np.stack(words).astype(np.int64)
    keys[:, rng.random(n) < sent] = SENTINEL
    return keys


def _keys(kind: str, k: int, n: int, rng) -> np.ndarray:
    """The numpy twin of workloads.wide_strain's keys of each kind."""
    if kind == "random":
        return _random(k, n, rng, 0.1)
    if kind == "top_equal":
        keys = _random(k, n, rng, 0.05)
        keys[0, keys[0] != SENTINEL] = 1
        return keys
    if kind == "all_sentinel":
        return np.full((words_for_k(k), n), SENTINEL, np.int64)
    if kind == "one_run":
        return np.repeat(_random(k, 1, rng, 0.0), n, axis=1)
    if kind == "half_sentinel":
        return _random(k, n, rng, 0.5)
    keys = _random(k, n, rng, 0.1 if kind == "one_hot_bucket" else 0.0)
    hot = keys[0] != SENTINEL
    if kind == "one_hot_bucket":
        hot &= rng.random(n) < 0.5
    for word, low, count in prefix_layout(keys.shape[0],
                                          2 * top_bases(k) + 1):
        keys[word, hot] &= ~(((1 << count) - 1) << low)
    return keys


@pytest.mark.parametrize("W", [2, 3, 4])
def test_sort_words_matches_jax(W):
    """Random keys, 10% SENTINEL, and half of them with one top word (so
    the lower words decide)."""
    k, n = W_K[W], 2000
    rng = np.random.default_rng(W)
    words = [rng.integers(0, 1 << (2 * top_bases(k)), n)]
    words += [rng.integers(0, 1 << 62, n) for _ in range(words_for_k(k) - 1)]
    keys = np.stack(words).astype(np.int64)
    keys[0, : n // 2] = 3
    keys[:, rng.random(n) < 0.1] = SENTINEL
    want = _jax_sort(keys, k)
    t = torch.from_numpy(keys)
    got = sort_words_plain(t)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the wrapper takes the plain version
    assert torch.equal(sort_words(t, 2 * top_bases(k) + 1), got)


@pytest.mark.parametrize("k", workloads.WIDE_STRAIN_K)
def test_sort_model_matches_jax(k):
    """The card's design, step by step, equals kat_tpu's sort and the plain
    sort on every kind of keys, with the card's bucket capacity and with
    one small enough that buckets overflow it (the fallback passes)."""
    tb = 2 * top_bases(k) + 1
    rng = np.random.default_rng(k)
    oversize = 0
    for kind in KINDS:
        keys = _keys(kind, k, N, rng)
        want = _jax_sort(keys, k)
        t = torch.from_numpy(keys)
        np.testing.assert_array_equal(sort_words_plain(t).numpy(), want)
        for cap in (64, BUCKET_CAP):
            got, _ = sort_words_model(t, None, tb, cap)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)
        b = bucket_of(t, tb)
        oversize += int((torch.bincount(b[b < SENTINEL_BUCKET],
                                        minlength=SENTINEL_BUCKET)
                         > 64).sum())
    assert oversize >= 2  # one_hot_bucket's and one_prefix's hot buckets


def _significant(keys: np.ndarray, top_bits: int) -> list[int]:
    """Each real key's significant bits as one Python integer: the top
    word's top_bits - 1 data bits, then 62 bits a lower word."""
    out = []
    for col in keys.T:
        v = int(col[0])
        for w in col[1:]:
            v = v << 62 | int(w)
        out.append(v)
    return out


# (W, top_bits): every k of the strain set, and the sharded sort's (owner,
# key) planes at 1, 2 and 8 shards (owner bits 0, 1, 3; narrow k = 31 and
# k = 41)
SHAPES = [(words_for_k(k), 2 * top_bases(k) + 1)
          for k in workloads.WIDE_STRAIN_K] + [(2, 1), (2, 2), (2, 4),
                                               (3, 4)]


@pytest.mark.parametrize("W,top_bits", SHAPES)
def test_prefix_is_the_first_16_significant_bits(W, top_bits):
    """prefix_layout's pieces take the first 16 of the key's significant
    bits, across the top word and the next where the top word holds fewer;
    bucket_of reads them so, and sends every SENTINEL to its own bucket
    past every prefix (a real key whose prefix is all ones stays out)."""
    t = top_bits - 1
    layout = prefix_layout(W, top_bits)
    assert sum(c for _w, _l, c in layout) == PREFIX_BITS
    assert [w for w, _l, _c in layout] == sorted({w for w, _l, _c in layout})
    rng = np.random.default_rng(W * 64 + top_bits)
    keys = np.stack([rng.integers(0, 1 << t, 500) if t else
                     np.zeros(500, np.int64)]
                    + [rng.integers(0, 1 << 62, 500) for _ in range(W - 1)]
                    ).astype(np.int64)
    keys[:, 0] = [(1 << t) - 1 if t else 0] + [(1 << 62) - 1] * (W - 1)
    keys[:, 1] = SENTINEL
    b = bucket_of(torch.from_numpy(keys), top_bits).numpy()
    width = t + 62 * (W - 1)
    want = [v >> (width - PREFIX_BITS) for v in _significant(keys, top_bits)]
    assert b[0] == want[0] == SENTINEL_BUCKET - 1  # all ones
    assert b[1] == SENTINEL_BUCKET
    np.testing.assert_array_equal(np.delete(b, 1), np.delete(want, 1))


@pytest.mark.parametrize("W,top_bits", SHAPES)
def test_fallback_digits_cover_every_bit_past_the_prefix(W, top_bits):
    """The oversize buckets' digits, least significant first, hold every
    significant bit the prefix does not, and none lies wholly inside it."""
    held = {(w, b) for w, low, c in prefix_layout(W, top_bits)
            for b in range(low, low + c)}
    digits = fallback_digits(W, top_bits)
    bits = {(w, b) for w, s in digits for b in range(s, s + 8)}
    width = {0: top_bits - 1, **{w: 62 for w in range(1, W)}}
    every = {(w, b) for w in range(W) for b in range(width[w])}
    assert every - held <= bits
    assert all(not {(w, b) for b in range(s, min(s + 8, width[w]))} <= held
               for w, s in digits)
    assert digits == sorted(digits, key=lambda d: (-d[0], d[1]))
    if (W, top_bits) == (2, 21):  # k = 41: 8 over the low word, 1 above
        assert digits == [(1, s) for s in range(0, 64, 8)] + [(0, 0)]


def test_plan_units_hold_at_most_the_capacity():
    """Units tile the real keys in order; a unit that is not oversize holds
    at most cap keys, and an oversize one is one bucket of more than cap."""
    rng = np.random.default_rng(5)
    counts = rng.poisson(3, SENTINEL_BUCKET)
    counts[rng.integers(0, SENTINEL_BUCKET, 40)] = rng.integers(20, 300, 40)
    counts[:3] = 0
    counts[-1] = 500
    cap = 64
    starts, oversize = plan_units(torch.from_numpy(counts), cap)
    lens = (starts[1:] - starts[:-1]).numpy()
    assert starts[0] == 0 and starts[-1] == counts.sum()
    assert (lens[~oversize.numpy()] <= cap).all()
    big = set(np.flatnonzero(counts > cap))
    assert int(oversize.sum()) == len(big)
    bstart = np.cumsum(counts) - counts
    assert set(starts[:-1][oversize].tolist()) == {int(bstart[b])
                                                   for b in big}


@pytest.mark.parametrize("W,k", [(2, 31), (3, 41)])
def test_sort_model_takes_the_sharded_shape(W, k):
    """The sharded sort's (owner, key) planes at 8 shards: the owner word
    holds 3 bits (top_bits 4), so the prefix spans it and the key's top
    word; every value rides with its key."""
    rng = np.random.default_rng(W)
    n = 3000
    key = _random(k, n, rng, 0.1) if W == 3 else np.stack(
        [rng.integers(0, 1 << (2 * k), n)]).astype(np.int64)
    if W == 2:
        key[:, rng.random(n) < 0.1] = SENTINEL
    owner = np.where(key[0] == SENTINEL, SENTINEL, rng.integers(0, 8, n))
    planes = torch.from_numpy(np.concatenate([owner[None], key]))
    vals = torch.arange(n, dtype=torch.int32)
    want = sort_words_pairs_plain(planes, vals)
    for cap in (64, BUCKET_CAP):
        got = sort_words_model(planes, vals, 4, cap)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["random", "one_hot_bucket", "one_prefix"])
def test_sort_model_value_form_is_stable(kind):
    """Every key five times with values in input order: the model keeps
    equal keys' values ascending, as the wide join needs, and equals the
    plain sort, buckets overflowing or not."""
    k = 95
    rng = np.random.default_rng(17)
    keys = np.repeat(_keys(kind, k, 400, rng), 5, axis=1)
    keys = torch.from_numpy(keys[:, rng.permutation(keys.shape[1])])
    vals = torch.arange(keys.shape[1], dtype=torch.int32)
    want = sort_words_pairs_plain(keys, vals)
    for cap in (64, BUCKET_CAP):
        gk, gv = sort_words_model(keys, vals, 2 * top_bases(k) + 1, cap)
        assert torch.equal(gk, want[0]) and torch.equal(gv, want[1])
        same = (gk[:, 1:] == gk[:, :-1]).all(0)
        assert bool((gv[1:][same] > gv[:-1][same]).all())
