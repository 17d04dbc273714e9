"""The plain W-word sort (what runs on the CPU) against kat_tpu's
full-sort kernel in interpret mode, as kat_tpu's own tests run it:
`sort_words_plain` against `sort_planes_padded` at W = 2, 3 and 4 (k = 41,
63, 95), on 2000 keys made from a numpy seed, half of them sharing their
top word.  Keys cross between the packages through kmers.to_ref_words /
from_ref_words (the key's integer value).  Exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kat_tpu.ops.sort_kernel import sort_planes_padded
from kat_tpu_torch.core.kmers import (SENTINEL, from_ref_words,
                                      to_ref_words, top_bases, words_for_k)
from kat_tpu_torch.ops.sort_kernel import sort_words, sort_words_plain

W_K = {2: 41, 3: 63, 4: 95}  # W -> a k with that many words


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
    planes = tuple(jnp.asarray(p) for p in to_ref_words(keys, k).T)
    want = from_ref_words(tuple(np.asarray(p) for p in sort_planes_padded(
        planes, len(planes), block_rows=8, interpret=True)), k)
    t = torch.from_numpy(keys)
    got = sort_words_plain(t)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the CPU the wrapper takes the plain version
    assert torch.equal(sort_words(t, 2 * top_bases(k) + 1), got)
