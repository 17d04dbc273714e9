"""A fixture that gets kat_tpu's native reader built once per test worker.

kat_tpu/io/native.py builds its library through one shared
`~/.cache/kat_tpu/native-<host>/libfastxio.so.tmp`.  On a cold cache the
workers of one pytest-xdist run all collect tests/test_supermer_router.py,
whose skipif asks `native.available()`, so they all build at once; a
loser's `os.replace` fails and its `_lib_failed` stays set for the whole
worker.  kat_tpu's own native tests then skip, while the port's
comparisons against kat_tpu's reader fail.

Importing `kat_tpu_native` into a test module makes it autouse there: the
worker builds kat_tpu's library once more, alone, into a directory of its
own (KAT_TPU_NATIVE_CACHE), after clearing a lost race's failure.  It
never skips: a library that does not build fails the tests.
"""

import pytest

from kat_tpu.io import native as jnative


@pytest.fixture(scope="session", autouse=True)
def kat_tpu_native(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        if jnative._lib is None:
            mp.setenv("KAT_TPU_NATIVE_CACHE",
                      str(tmp_path_factory.mktemp("kat_tpu_native")))
            mp.setattr(jnative, "_lib_failed", False)
        if jnative.get_lib() is None:
            raise RuntimeError("kat_tpu's native reader did not build "
                               "(g++ of kat_tpu/native/fastxio.cpp)")
        yield jnative
