"""kat_tpu_torch.core.kmers against kat_tpu.core.kmers and the pure-Python
oracle, exactly: the same numpy inputs (made from a seed) go through both
packages; keys are compared as int64 after joining kat_tpu's (hi, lo)
planes (tolerance 0: they are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from kat_tpu.core import kmers as jk
from kat_tpu_torch.core import counting
from kat_tpu_torch.core import kmers as tk
from kat_tpu_torch.ops.extract_kernel import extract_keys

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

ROWS, L = 6, 64


def _codes(seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (ROWS, L)).astype(np.uint8)
    codes[rng.random((ROWS, L)) < 0.02] = 4      # N
    codes[-1, L - 5:] = 255                      # padding
    return codes


def _seq(row):
    return "".join("ACGT"[c] if c < 4 else "N" for c in row)


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [1, 17, 27, 31])
def test_extract_kmers_matches_jax_and_oracle(k, canonical):
    codes = _codes(k)
    keys, valid = tk.extract_kmers(torch.from_numpy(codes), k, canonical)
    hi, lo, jvalid = jk.extract_kmers(jnp.asarray(codes), k, canonical)
    want = tk.from_planes(np.asarray(hi), np.asarray(lo))
    np.testing.assert_array_equal(keys.numpy(), want)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    for r in range(ROWS):
        got = keys[r][valid[r]].tolist()
        assert got == oracle.kmers_of(_seq(codes[r]), k, canonical)
    assert (keys[~valid] == tk.SENTINEL).all()


def _extract_case(name, k, seed):
    """Codes for the keys-only entry: ~3% invalid codes anywhere in
    4..255; `name` picks the shape or the fill."""
    rng = np.random.default_rng(seed)
    shape = {"L=k": (5, k), "L=k+1": (5, k + 1), "batch_dims": (2, 3, k + 9),
             "separators": (4, k + 6), "bytes": (3, 2 * k + 5)}[name]
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    bad = rng.random(shape) < 0.03
    codes[bad] = rng.integers(4, 256, int(bad.sum()))
    if name == "separators":  # rows of the reader's separator and padding
        codes[0], codes[1] = 4, 5
        codes[2, ::3], codes[2, 1::7] = 4, 5
    if name == "bytes":
        codes[0] = rng.integers(0, 256, shape[1])
    return codes


@pytest.mark.parametrize("name", ["L=k", "L=k+1", "batch_dims", "separators",
                                  "bytes"])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [1, 2, 13, 27, 31])
def test_extract_keys_matches_extract_kmers_and_jax(name, k, canonical):
    codes = _extract_case(name, k, 1000 * k + len(name))
    t = torch.from_numpy(codes)
    keys = extract_keys(t, k, canonical)
    kk, valid = tk.extract_kmers(t, k, canonical)
    assert keys.shape == codes.shape[:-1] + (codes.shape[-1] - k + 1,)
    assert torch.equal(keys, kk)
    assert torch.equal(valid, keys != tk.SENTINEL)
    flat = codes.reshape(-1, codes.shape[-1])
    hi, lo, jvalid = jk.extract_kmers(jnp.asarray(flat), k, canonical)
    np.testing.assert_array_equal(keys.reshape(flat.shape[0], -1).numpy(),
                                  tk.from_planes(np.asarray(hi),
                                                 np.asarray(lo)))
    np.testing.assert_array_equal(valid.reshape(flat.shape[0], -1).numpy(),
                                  np.asarray(jvalid))


@pytest.mark.parametrize("k,L", [(1, 0), (2, 1), (27, 26), (31, 3)])
def test_extract_refuses_rows_shorter_than_k(k, L):
    """Raised before any work: on the meta device, any work would raise
    something else."""
    codes = torch.zeros((3, L), dtype=torch.uint8, device="meta")
    for fn in (extract_keys, tk.extract_kmers, tk.extract_keys_plain):
        with pytest.raises(ValueError, match="shorter than k"):
            fn(codes, k)


def test_extract_keys_takes_the_plain_version_on_the_cpu():
    codes = torch.from_numpy(_extract_case("bytes", 27, 5))
    before = extract_keys.launches
    keys = extract_keys(codes, 27)
    assert torch.equal(keys, tk.extract_keys_plain(codes, 27))
    tk.extract_kmers(codes, 27, canonical=False)
    sc = counting.CodeStreamingCounter(27, initial_capacity=1 << 10,
                                       device=torch.device("cpu"))
    sc.add_codes(codes)
    sc.finish()
    assert extract_keys.launches == before == 0


def _real_keys(k, n=500, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << (2 * k), n, dtype=np.int64)


@pytest.mark.parametrize("k", [1, 17, 27, 31])
def test_revcomp_canonical_gc_match_jax(k):
    keys = np.concatenate([_real_keys(k), [tk.SENTINEL]])
    hi, lo = tk.to_planes(keys)
    jh, jl = jnp.asarray(hi), jnp.asarray(lo)
    t = torch.from_numpy(keys)

    rh, rl = jk.reverse_complement(jh, jl, k)
    got = tk.reverse_complement(t, k).numpy()
    np.testing.assert_array_equal(got[:-1], jk.join_u64(rh, rl)[:-1]
                                  .astype(np.int64))
    assert [int(v) for v in got[:20]] == [oracle.revcomp(int(v), k)
                                          for v in keys[:20]]

    ch, cl = jk.canonicalize(jh, jl, k)
    np.testing.assert_array_equal(tk.canonicalize(t, k).numpy(),
                                  tk.from_planes(np.asarray(ch),
                                                 np.asarray(cl)))

    np.testing.assert_array_equal(tk.gc_count(t).numpy(),
                                  np.asarray(jk.gc_count(jh, jl)))
    assert [int(v) for v in tk.gc_count(t)[:20]] == [
        oracle.gc_of_packed(int(v), k) for v in keys[:20]]


@pytest.mark.parametrize("k", [1, 27, 31])
def test_numpy_helpers_match_jax(k):
    keys = _real_keys(k).astype(np.uint64)
    np.testing.assert_array_equal(tk.canonical_np(keys, k),
                                  jk.canonical_np(keys, k))
    s = tk.unpack_string(int(keys[0]), k)
    assert s == jk.unpack_string(int(keys[0]), k)
    assert tk.pack_string(s) == jk.pack_string(s) == int(keys[0])
    assert tk.split_u64(keys[1]) == jk.split_u64(keys[1])
    assert tk.key_mask(k) == jk.words_to_int(jk.key_mask(k))


def test_planes_roundtrip():
    keys = np.concatenate([_real_keys(31), [tk.SENTINEL, 0]])
    hi, lo = tk.to_planes(torch.from_numpy(keys))
    assert hi[-2] == lo[-2] == 0xFFFFFFFF
    np.testing.assert_array_equal(tk.from_planes(hi, lo), keys)


def test_encode_ascii_matches_jax():
    buf = np.frombuffer(b"ACGTacgtNnRY-\x00\xff", np.uint8)
    np.testing.assert_array_equal(tk.encode_ascii(buf), jk.encode_ascii(buf))
