"""kat_tpu_torch/ops/verify.py on the CPU: the attestation's result keys
equal kat_tpu's (its interpret mode), every check passes where the
wrappers take their plain versions, and a kernel that disagrees with its
plain version is reported as FAIL."""

import numpy as np
import pytest
import torch

from kat_tpu.ops import verify as jverify
from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel
from kat_tpu_torch.ops import verify

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def test_result_keys_match_kat_tpu():
    want = jverify.verify_kernels(n=1 << 12, interpret=True)
    got = verify.verify_kernels(n=1 << 12, interpret=True)
    assert list(got) == list(want)
    assert {got[c] for c in ("sort", "merge", "reduce")} == {"PASS"}
    assert got["verify_n"] == want["verify_n"] == 1 << 12
    want = jverify.verify_kernels_wide(n_words=4, n=1 << 11, interpret=True)
    got = verify.verify_kernels_wide(n_words=4, n=1 << 11, interpret=True)
    assert list(got) == list(want)
    assert got["n_words"] == 4
    assert {got[c] for c in ("sort", "merge", "reduce")} == {"PASS"}


@pytest.mark.parametrize("n_words", [3, 4, 8, 16])
def test_wide_words_pass_on_the_cpu(n_words):
    got = verify.verify_kernels_wide(n_words=n_words, n=3000,
                                     device="cpu")
    assert got["n_words"] == n_words and got["verify_n"] == 3000
    assert {got[c] for c in ("sort", "merge", "reduce")} == {"PASS"}


def test_no_wide_k_for_other_word_counts():
    for n_words in (2, 5, 18):
        with pytest.raises(ValueError, match="n_words"):
            verify.verify_kernels_wide(n_words=n_words, n=64, device="cpu")


@pytest.mark.parametrize("check,module,name,wrong", [
    ("sort", sort_kernel, "sort_keys",
     lambda real: lambda keys, bits: real(keys, bits).flip(0)),
    ("merge", merge_kernel, "merge_sorted",
     lambda real: lambda a, aw, b: (lambda k, w: (k, w + 1))(
         *real(a, aw, b))),
    ("reduce", reduce_kernel, "reduce_by_key",
     lambda real: lambda k, w, n: (lambda a, b, c: (a, b, c + 1))(
         *real(k, w, n))),
    ("sort", sort_kernel, "sort_words",
     lambda real: lambda keys, bits: real(keys, bits)[:, :-1]),
])
def test_a_wrong_kernel_fails(monkeypatch, check, module, name, wrong):
    monkeypatch.setattr(module, name, wrong(getattr(module, name)))
    run = (verify.verify_kernels_wide if name.endswith("words")
           else verify.verify_kernels)
    got = run(n=4096, device="cpu")
    assert got[check] == "FAIL"


def test_the_tail_is_sentinel_and_keys_fit_the_sort():
    """The inputs' shape: a 1/128 SENTINEL tail, keys below 2^54."""
    seen = {}
    real = sort_kernel.sort_keys

    def spy(keys, bits):
        seen["keys"], seen["bits"] = keys.clone(), bits
        return real(keys, bits)

    sort_kernel.sort_keys, saved = spy, real
    try:
        verify.verify_kernels(n=1 << 12, device="cpu")
    finally:
        sort_kernel.sort_keys = saved
    keys = seen["keys"].numpy()
    tail = (1 << 12) // 128
    assert (keys[-tail:] == np.iinfo(np.int64).max).all()
    assert (keys[:-tail] < 1 << 54).all() and seen["bits"] == 55
