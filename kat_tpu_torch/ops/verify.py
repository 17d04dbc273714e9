"""Self-attestation of the counting flush's kernels on the device.

Port of kat_tpu/ops/verify.py: the three flush kernels, K1 (sort_kernel.
sort_keys / sort_words), K2 (merge_kernel.merge_sorted / merge_sorted_words)
and K3 (reduce_kernel.reduce_by_key / reduce_by_key_words), each held
against its plain PyTorch version on the same inputs, on one word and on W
words, at a size that spans many of the card's tiles (a tail of SENTINEL,
a merge split that is not a power of two).  Every check ends in ONE device
scalar (outputs equal, exactly); the scalars cross to the host once, at the
end.  On the CPU the wrappers run their plain versions, so the checks hold
the plain versions against themselves.

Results carry kat_tpu's keys: {"sort", "merge", "reduce"} as "PASS" or
"FAIL", "verify_seconds", "verify_n" (and "n_words" for the wide form).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import kmers
from ..core.kmers import SENTINEL


def _device(device, interpret: bool) -> torch.device:
    """interpret=True is kat_tpu's interpret mode: here the CPU, where the
    wrappers take their plain versions."""
    if interpret:
        return torch.device("cpu")
    if device is None:
        from ..tools.common import default_device

        return default_device()
    return torch.device(device)


def _equal(got, want) -> torch.Tensor:
    """One device scalar: every output equal (shapes too)."""
    ok = torch.ones((), dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        if g.shape != w.shape:
            return torch.zeros_like(ok)
        ok = ok & (g == w.to(g.device)).all()
    return ok


def _results(checks: dict, t0: float, n: int, **extra) -> dict:
    flags = torch.stack(list(checks.values())).cpu().tolist()
    out = dict(extra)
    out.update({name: "PASS" if ok else "FAIL"
                for name, ok in zip(checks, flags)})
    out["verify_seconds"] = round(time.time() - t0, 1)
    out["verify_n"] = n
    return out


def verify_kernels(n: int = 1 << 22, seed: int = 0,
                   interpret: bool = False, device=None) -> dict:
    """K1, K2 and K3 over one-word keys (k <= 31) against their plain
    versions: {"sort", "merge", "reduce", "verify_seconds", "verify_n"}."""
    from .merge_kernel import merge_sorted, merge_sorted_plain
    from .reduce_kernel import reduce_by_key, reduce_by_key_plain
    from .sort_kernel import sort_keys, sort_keys_plain

    dev = _device(device, interpret)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    # key-shaped data: low-entropy high bits (like packed k-mers), a full
    # low word, a ~1% SENTINEL tail (invalid windows)
    keys = ((rng.integers(0, 1 << 22, n, dtype=np.int64) << 32)
            | rng.integers(0, 1 << 32, n, dtype=np.int64))
    keys[n - n // 128:] = SENTINEL
    keys = torch.from_numpy(keys).to(dev)
    checks = {}

    s = sort_keys(keys, 55)
    checks["sort"] = _equal((s,), (sort_keys_plain(keys),))

    # a split whose two sides are not powers of two
    na = (n // 8) * 5
    w = (s != SENTINEL).to(torch.int32)
    a, aw, b = s[:na], w[:na], s[na:]
    checks["merge"] = _equal(merge_sorted(a, aw, b),
                             merge_sorted_plain(a, aw, b))

    out_size = n // 2
    checks["reduce"] = _equal(reduce_by_key(s, w, out_size),
                              reduce_by_key_plain(s, w, out_size))
    return _results(checks, t0, n)


def _wide_k(n_words: int) -> int:
    """The largest k whose key kat_tpu holds in n_words uint32 words
    (n_words = 4, 8, 16: k = 63, 127, 255)."""
    k = 47 if n_words == 3 else 16 * n_words - 1
    if (k <= kmers.MAX_K or k > kmers.MAX_K_WIDE
            or kmers.ref_words_for_k(k) != n_words):
        raise ValueError(f"n_words={n_words}: no k has that many of "
                         "kat_tpu's words (3, or an even 4..16)")
    return k


def verify_kernels_wide(n_words: int = 4, n: int = 1 << 19, seed: int = 1,
                        interpret: bool = False, device=None) -> dict:
    """The W-word forms of K1, K2 and K3 against their plain versions, for
    the keys kat_tpu holds in n_words uint32 words (4/8/16: k = 63/127/255,
    W = kmers.words_for_k(k) of the port's words): {"n_words", "sort",
    "merge", "reduce", "verify_seconds", "verify_n"}."""
    from .merge_kernel import merge_sorted_words, merge_sorted_words_plain
    from .reduce_kernel import reduce_by_key_words, reduce_by_key_words_plain
    from .sort_kernel import sort_words, sort_words_plain

    k = _wide_k(n_words)
    dev = _device(device, interpret)
    t0 = time.time()
    rng = np.random.default_rng(seed)
    W = kmers.words_for_k(k)
    top = 2 * kmers.top_bases(k)
    keys = rng.integers(0, 1 << 62, (W, n), dtype=np.int64)
    keys[0] = rng.integers(0, 1 << min(top, 20), n, dtype=np.int64)
    keys[:, n - n // 128:] = SENTINEL
    keys = torch.from_numpy(keys).to(dev)
    checks = {}

    s = sort_words(keys, top + 1)
    checks["sort"] = _equal((s,), (sort_words_plain(keys),))

    na = (n // 8) * 5
    w = (s[0] != SENTINEL).to(torch.int32)
    a, aw, b = s[:, :na], w[:na], s[:, na:].contiguous()
    checks["merge"] = _equal(merge_sorted_words(a, aw, b),
                             merge_sorted_words_plain(a, aw, b))

    # out_size = n: the reduce never truncates here (truncation is held by
    # the one-word attestation at n // 2)
    checks["reduce"] = _equal(reduce_by_key_words(s, w, n),
                              reduce_by_key_words_plain(s, w, n))
    return _results(checks, t0, n, n_words=n_words)
