"""kat_tpu_torch.core.minimizer against kat_tpu.core.minimizer on the same
numpy inputs made from a seed, exactly (integers: tolerance 0).  kat_tpu
carries (hi, lo) uint32 planes and orders key' unsigned; the port carries
one int64 (bit 63 flipped where key' takes all 64 bits), compared through
`keyp_to_planes` / `keyp_from_planes`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import minimizer as jmin
from kat_tpu_torch.core import kmers, minimizer
from kat_tpu_torch.core.kmers import SENTINEL

KS = [17, 27, 28, 29]


def _canonical_keys(rng, n, k):
    keys = kmers.canonical_np(
        rng.integers(0, 1 << (2 * k), n, dtype=np.uint64), k)
    # minimizer ties and both strands: homopolymers, dinucleotide repeats
    keys[:4] = kmers.canonical_np(np.array(
        [0, (1 << (2 * k)) - 1, int("01" * k, 2),
         int("0011" * k, 2) & ((1 << (2 * k)) - 1)], np.uint64), k)
    out = keys.astype(np.int64)
    out[5::17] = SENTINEL
    return out


def _jax_planes(keys):
    return tuple(jnp.asarray(p) for p in kmers.to_planes(keys))


def test_constants_and_ranges():
    for k in range(10, 34):
        assert minimizer.supports(k) == jmin.supports(k)
        if minimizer.supports(k):
            assert minimizer.keyp_bits(k) == jmin.keyp_bits(k)
            assert minimizer.rec_windows(k) == jmin.rec_windows(k)
    assert minimizer.keyp_bits(29) == 64 and minimizer.keyp_flip(29) < 0
    assert minimizer.keyp_flip(28) == 0 and minimizer.keyp_flip(27) == 0
    assert (minimizer.M_DEFAULT, minimizer.M26, minimizer.POS_BITS) == \
        (jmin.M_DEFAULT, jmin.M26, jmin.POS_BITS)


def test_mix26_matches_jax_and_inverts():
    x = np.random.default_rng(0).integers(0, 1 << 26, 5000)
    want = np.asarray(jmin.mix26(x.astype(np.uint32)))
    got = minimizer.mix26(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(minimizer.unmix26(got).numpy(), x)
    np.testing.assert_array_equal(
        minimizer.unmix26(torch.from_numpy(x)).numpy(),
        np.asarray(jmin.unmix26(x.astype(np.uint32))).astype(np.int64))
    assert minimizer.mix26(12345) == jmin.mix26(12345)
    assert minimizer.unmix26(minimizer.mix26(54321)) == 54321


@pytest.mark.parametrize("k", KS)
def test_encode_decode_match_jax(k):
    keys = _canonical_keys(np.random.default_rng(k), 4000, k)
    jhi, jlo = jmin.encode_keys(*_jax_planes(keys), k)
    want = minimizer.keyp_from_planes(np.asarray(jhi), np.asarray(jlo), k)
    got = minimizer.encode_keys(torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got.numpy(), want)
    hi, lo = minimizer.keyp_to_planes(got, k)
    np.testing.assert_array_equal(hi, np.asarray(jhi))
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    # sentinels pass through, and signed order is kat_tpu's unsigned order
    assert (got.numpy()[keys == SENTINEL] == SENTINEL).all()
    u = kmers.join_u64(np.asarray(jhi), np.asarray(jlo))
    np.testing.assert_array_equal(np.argsort(got.numpy(), kind="stable"),
                                  np.argsort(u, kind="stable"))
    # decode: the inverse, and kat_tpu's decode of its own planes
    back = minimizer.decode_keys(got, k)
    np.testing.assert_array_equal(back.numpy(), keys)
    dhi, dlo = jmin.decode_keys(jhi, jlo, k)
    np.testing.assert_array_equal(
        back.numpy(), kmers.from_planes(np.asarray(dhi), np.asarray(dlo)))


@pytest.mark.parametrize("k", KS)
def test_minimizer_device_matches_jax(k):
    keys = _canonical_keys(np.random.default_rng(100 + k), 2000, k)
    keys = keys[keys != SENTINEL]
    want = jmin.minimizer_device(*_jax_planes(keys), k)
    got = minimizer.minimizer_device(torch.from_numpy(keys), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int64))


def _records(rng, n, k):
    """Random supermer records as the router writes them: len windows of a
    random base string, left-aligned, zero beyond; some padding records and
    some low-complexity ones (minimizer ties on both strands)."""
    S = minimizer.rec_windows(k)
    F = 2 * (k - 1 + S)
    ln = rng.integers(0, S + 1, n)
    recs = np.zeros(n, np.uint64)
    for i in range(n):
        nb = k - 1 + int(ln[i])
        if ln[i] == 0:
            continue
        kind = i % 5
        if kind == 0:
            bases = np.zeros(nb, np.int64)                 # poly-A
        elif kind == 1:
            bases = np.arange(nb) % 2 * 3                  # ATAT..
        else:
            bases = rng.integers(0, 4, nb)
        v = 0
        for c in bases.tolist():
            v = (v << 2) | int(c)
        recs[i] = np.uint64((v << (F - 2 * nb)) | (int(ln[i]) << 61))
    return recs


@pytest.mark.parametrize("k", KS)
def test_expand_records_and_buckets_match_jax(k):
    recs = _records(np.random.default_rng(200 + k), 1500, k).reshape(3, 500)
    rhi = (recs >> np.uint64(32)).astype(np.uint32)
    rlo = (recs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    jhi, jlo, jvalid = jmin.expand_records(jnp.asarray(rhi), jnp.asarray(rlo),
                                           k)
    rec = torch.from_numpy(kmers.join_u64(rhi, rlo).view(np.int64))
    np.testing.assert_array_equal(rec.numpy(), recs.view(np.int64))
    got = minimizer.expand_records(rec, k)
    assert got.shape == (minimizer.rec_windows(k), 3, 500)
    valid = got != SENTINEL  # the slots past a record's length hold it
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    want = minimizer.keyp_from_planes(np.asarray(jhi), np.asarray(jlo), k)
    np.testing.assert_array_equal(got.numpy(), want)
    # every window's key' is the encoding of its canonical k-mer
    dec = minimizer.decode_keys(got, k)
    np.testing.assert_array_equal(minimizer.encode_keys(dec, k).numpy(),
                                  got.numpy())
    for bits in (6, 12, 14):
        jb = jmin.bucket_of_keyp(jhi, jlo, k, bucket_bits=bits)
        gb = minimizer.bucket_of_keyp(got, k, bucket_bits=bits)
        np.testing.assert_array_equal(
            gb.numpy()[valid.numpy()],
            np.asarray(jb).astype(np.int64)[valid.numpy()])


def test_opposite_strands_give_the_same_keyp():
    """Equal k-mers from opposite strands must encode the same key', tie
    storms included: a record and the record of its reverse complement
    expand to the same multiset of key'."""
    k = 27
    S = minimizer.rec_windows(k)
    F = 2 * (k - 1 + S)
    nb = k - 1 + S
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, nb) for _ in range(40)]
    seqs += [np.zeros(nb, np.int64), np.arange(nb) % 2 * 3,
             np.arange(nb) % 3 // 2 * 3]
    def pack(b):
        v = 0
        for c in b.tolist():
            v = (v << 2) | int(c)
        return np.uint64((v << (F - 2 * nb)) | (S << 61))
    fwd = np.array([pack(b) for b in seqs]).view(np.int64)
    rev = np.array([pack(3 - b[::-1]) for b in seqs]).view(np.int64)
    a = minimizer.expand_records(torch.from_numpy(fwd), k)
    b = minimizer.expand_records(torch.from_numpy(rev), k)
    assert torch.equal(a.sort(dim=0).values, b.sort(dim=0).values)


def test_unsupported_k_and_strand_raise():
    k = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        minimizer.encode_keys(k, 31)
    with pytest.raises(ValueError):
        minimizer.decode_keys(k, 13)
    with pytest.raises(ValueError):
        minimizer.expand_records(k, 27, canonical=False)
