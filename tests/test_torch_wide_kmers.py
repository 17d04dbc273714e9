"""Wide keys (31 < k <= 255) in kat_tpu_torch's core/kmers.py against
kat_tpu's: extraction (canonical and forward, reads with N, reads shorter
than k), reverse complement, canonicalisation, GC count, and the host
conversions.  Exact (tolerance 0): keys are integers, compared through
kmers.to_ref_words / from_ref_words, which carry a key between the port's
int64 words and kat_tpu's big-first uint32 words by its integer value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.core import kmers as jk
from kat_tpu_torch.core import kmers as tk

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

WIDE_K = (33, 41, 62, 63, 94, 127, 255)


def _codes(k, seed):
    """Three rows of random codes, two of them with an N (code 4), and one
    row that holds a read shorter than k followed by padding (no valid
    window)."""
    rng = np.random.default_rng(seed)
    L = k + 90
    codes = rng.integers(0, 4, (4, L)).astype(np.uint8)
    codes[0, 40] = 4
    codes[1, L - 30] = 4
    codes[3, k - 5:] = 4  # a read of k - 5 bases, padded
    return codes


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", WIDE_K)
def test_extract_wide_matches_jax(k, canonical):
    codes = _codes(k, k)
    jw, jv = jk.extract_kmers_wide(jnp.asarray(codes), k, canonical)
    ref = np.stack([np.asarray(w).reshape(-1) for w in jw], axis=1)
    tw, tv = tk.extract_kmers_wide(torch.from_numpy(codes), k, canonical)
    assert tw.shape == (tk.words_for_k(k), 4, codes.shape[1] - k + 1)
    flat = tw.reshape(tw.shape[0], -1)
    np.testing.assert_array_equal(tk.to_ref_words(flat, k), ref)
    np.testing.assert_array_equal(tk.from_ref_words(ref, k), flat.numpy())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[3].any() and bool((tw[:, 3] == tk.SENTINEL).all())
    assert tv[:3].any()


@pytest.mark.parametrize("k", WIDE_K)
def test_reverse_complement_and_gc_words(k):
    """The words' reverse complement is kat_tpu's rc_int of each key, the
    canonical form is extraction's, GC is kat_tpu's gc_count_words."""
    codes = _codes(k, 100 + k)
    fwd, valid = tk.extract_kmers_wide(torch.from_numpy(codes), k, False)
    fw = fwd.reshape(fwd.shape[0], -1)
    ok = valid.reshape(-1).numpy()
    keys = tk.words_to_ints(fw.numpy())
    rc = tk.words_to_ints(tk.reverse_complement_words(fw, k).numpy())
    assert [r for r, o in zip(rc, ok) if o] == \
        [jk.rc_int(v, k) for v, o in zip(keys, ok) if o]
    canon, _ = tk.extract_kmers_wide(torch.from_numpy(codes), k, True)
    assert torch.equal(tk.canonicalize_words(fw, k),
                       canon.reshape(canon.shape[0], -1))
    ref = tk.to_ref_words(fw, k)
    jgc = np.asarray(jk.gc_count_words(tuple(jnp.asarray(p)
                                             for p in ref.T)))
    gc = tk.gc_count_words(fw).numpy()
    np.testing.assert_array_equal(gc[ok], jgc[ok])
    assert (gc[~ok] == 0).all()  # SENTINEL


@pytest.mark.parametrize("k", WIDE_K)
def test_word_conversions_round_trip(k):
    """ints -> words -> ints, words -> .jf bytes -> words, and one key's
    words_to_int; a key wider than 2k bits is refused."""
    rng = np.random.default_rng(k)
    keys = [int.from_bytes(rng.bytes(64), "little") >> (512 - 2 * k)
            for _ in range(50)] + [0, (1 << (2 * k)) - 1]
    words = tk.ints_to_words(keys, k)
    assert words.shape == (tk.words_for_k(k), len(keys))
    assert (words >= 0).all() and (words[1:] < 1 << 62).all()
    assert (words[0] < 1 << (2 * tk.top_bases(k))).all()
    assert tk.words_to_ints(words) == keys
    assert tk.words_to_int(words[:, 7]) == keys[7]
    key_bytes = (2 * k + 7) // 8
    raw = tk.words_to_bytes(words, key_bytes)
    assert [int.from_bytes(r.tobytes(), "little") for r in raw] == keys
    np.testing.assert_array_equal(tk.bytes_to_words(raw, k), words)
    assert tk.pack_string("ACGT" * 10 + "A") == tk.words_to_int(
        tk.ints_to_words([tk.pack_string("ACGT" * 10 + "A")], 41)[:, 0])
    with pytest.raises(ValueError, match="does not fit"):
        tk.ints_to_words([1 << (2 * k)], k)


def test_word_layout():
    """W = ceil(k / 31); the top word holds the rest; k outside (31, 255]
    is no wide k."""
    assert [tk.words_for_k(k) for k in (31, 32, 62, 63, 93, 94, 255)] == \
        [1, 2, 2, 3, 3, 4, 9]
    assert [tk.top_bases(k) for k in (33, 62, 63, 95, 255)] == \
        [2, 31, 1, 2, 7]
    for bad in (31, 256):
        with pytest.raises(ValueError):
            tk.extract_kmers_wide(torch.zeros((1, 300), dtype=torch.uint8),
                                  bad)
    with pytest.raises(ValueError, match="shorter"):
        tk.extract_kmers_wide(torch.zeros((1, 40), dtype=torch.uint8), 41)
