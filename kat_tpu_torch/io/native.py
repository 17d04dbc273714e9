"""ctypes binding to the native FASTX reader, kat_tpu/native/fastxio.cpp.

The C++ file holds no JAX, so the port compiles it by path into its own
build directory instead of importing kat_tpu.io.native (which would pull
JAX in).  Only the `kat_fastx_*` reader symbols are bound; the supermer
router that the same file exports serves the bucketed flush, which is not
ported yet.

The reader parses FASTA/FASTQ(.gz) and emits densely packed, already
2-bit-encoded [rows, row_len] uint8 batches with record separators and
(k-1) seams.  Parallelism, as in kat_tpu:

  - multiple files parse concurrently (one worker per file),
  - ONE large uncompressed file splits into record-aligned byte ranges,
    each parsed by its own worker (kat_fastx_open_range syncs natively),
  - a .gz stream inflates on a dedicated native producer thread overlapped
    with the parse (kat_fastx_open_threaded).

ctypes releases the GIL during the native parse+inflate, so all of the
above genuinely parallelize.  Batch ORDER interleaves across workers: use
only for order-independent consumers (k-mer counting is).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import Iterator

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "kat_tpu", "native", "fastxio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

# Minimum bytes of one range piece: small enough to load-balance, large
# enough that the per-piece open/sync cost stays negligible.
RANGE_CHUNK = 64 << 20


class NativeReader:
    """The loaded reader library, built at first use (`get_lib`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._failed = False

    def _build(self) -> str | None:
        # -march=native objects must not be reused on a host with other
        # CPU features (SIGILL): key the file on the CPU flags and source.
        try:
            with open("/proc/cpuinfo") as f:
                flags = next((ln for ln in f if ln.startswith("flags")), "")
        except OSError:
            flags = ""
        try:
            with open(_SRC, "rb") as f:
                src = f.read()
        except OSError:
            return None
        key = hashlib.sha1(flags.encode() + src).hexdigest()[:12]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libfastxio-{key}.so")
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
               "-o", tmp, "-lz", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except (subprocess.SubprocessError, OSError):
            return None

    def get(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            so = self._build()
            if so is None:
                self._failed = True
                return None
            lib = ctypes.CDLL(so)
            lib.kat_fastx_open.restype = ctypes.c_void_p
            lib.kat_fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.kat_fastx_open_range.restype = ctypes.c_void_p
            lib.kat_fastx_open_range.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64]
            lib.kat_fastx_open_threaded.restype = ctypes.c_void_p
            lib.kat_fastx_open_threaded.argtypes = [ctypes.c_char_p,
                                                    ctypes.c_int]
            lib.kat_fastx_sniff.restype = ctypes.c_int
            lib.kat_fastx_sniff.argtypes = [ctypes.c_char_p]
            lib.kat_fastx_close.restype = None
            lib.kat_fastx_close.argtypes = [ctypes.c_void_p]
            lib.kat_fastx_next_codes.restype = ctypes.c_int64
            lib.kat_fastx_next_codes.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            self._lib = lib
            return lib


_READER = NativeReader()


def get_lib() -> ctypes.CDLL | None:
    return _READER.get()


def available() -> bool:
    return get_lib() is not None


def _open_item(lib, item) -> int:
    path, trim, start, end, kind = item
    if kind == "range":
        h = lib.kat_fastx_open_range(path.encode(), int(trim),
                                     int(start), int(end))
    elif kind == "gz-threaded":
        h = lib.kat_fastx_open_threaded(path.encode(), int(trim))
    else:
        h = lib.kat_fastx_open(path.encode(), int(trim))
    if not h:
        raise OSError(f"could not open sequence file: {path}")
    return h


def _stream_item(lib, item, k: int, rows: int, row_len: int,
                 stop: threading.Event | None = None
                 ) -> Iterator[np.ndarray]:
    buf = np.empty((rows, row_len), np.uint8)
    h = _open_item(lib, item)
    try:
        while not (stop is not None and stop.is_set()):
            n = lib.kat_fastx_next_codes(
                h, k, rows, row_len,
                buf.ctypes.data_as(ctypes.c_void_p))
            if n < 0:
                raise RuntimeError(f"native reader error on {item[0]}")
            if n == 0:
                break
            yield buf[:n].copy()
    finally:
        lib.kat_fastx_close(h)


def _trims_for(paths: list[str], trim5: list[int] | None) -> list[int]:
    trims = list(trim5) if trim5 else [0] * len(paths)
    if len(trims) == 1 and len(paths) > 1:
        trims = trims * len(paths)
    return trims


def _work_items(lib, paths, trims, threads: int,
                range_chunk: int = RANGE_CHUNK) -> list[tuple]:
    """(path, trim, start, end, kind) pieces.  Large plain files split
    into record-aligned byte ranges (finer than the thread count for
    load balance); gz files stay whole but inflate on a native producer
    thread whenever any parallelism is requested."""
    items: list[tuple] = []
    whole = 1 << 62
    for path, trim in zip(paths, trims):
        kind = lib.kat_fastx_sniff(path.encode())
        if kind in (1, 2) and threads > 1:
            size = os.path.getsize(path)
            n = min(threads * 2, max(1, size // range_chunk))
            if n > 1:
                step = -(-size // n)
                for s in range(0, size, step):
                    items.append((path, trim, s, min(s + step, size),
                                  "range"))
                continue
            items.append((path, trim, 0, whole, "plain"))
        elif kind == -1 and threads > 1:
            items.append((path, trim, 0, whole, "gz-threaded"))
        else:
            items.append((path, trim, 0, whole, "plain"))
    return items


def stream_code_batches(paths: list[str], k: int,
                        trim5: list[int] | None = None,
                        rows: int = 4096,
                        row_len: int = 1024,
                        threads: int = 1) -> Iterator[np.ndarray]:
    """Yield dense [<=rows, row_len] uint8 code batches across files.

    Records are packed back to back with invalid separators; a record split
    across rows repeats its (k-1)-base seam so every k-window appears
    exactly once.  Raises RuntimeError if the native library is missing.

    threads > 1 parallelizes the parse: across files, across byte ranges
    of a single plain file, and (for gz) across the inflate/parse pair.
    Batch ORDER then interleaves: use only for order-independent
    consumers (k-mer counting is).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastxio library unavailable")
    trims = _trims_for(paths, trim5)
    threads = max(1, int(threads))
    items = _work_items(lib, paths, trims, threads)
    threads = min(threads, len(items))
    if threads == 1 and not any(i[4] == "gz-threaded" for i in items):
        for item in items:
            yield from _stream_item(lib, item, k, rows, row_len)
        return

    q: queue.Queue = queue.Queue(maxsize=2 * threads)
    work = iter(items)
    work_lock = threading.Lock()
    # Abandonment protocol: if the consumer stops draining (generator
    # closed by an error), `stop` is set so workers blocked on the bounded
    # queue exit and close their native handles instead of leaking
    # threads/fds/gz state.
    stop = threading.Event()

    def _put(obj) -> bool:
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            while not stop.is_set():
                with work_lock:
                    item = next(work, None)
                if item is None:
                    break
                for batch in _stream_item(lib, item, k, rows, row_len,
                                          stop=stop):
                    if not _put(batch):
                        return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put(e)
        finally:
            _put(None)
            # a set stop flag may have swallowed the sentinel; the
            # consumer is gone then, so nobody waits on it

    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"kat-reader-{i}")
               for i in range(threads)]
    for t in workers:
        t.start()
    live = threads
    try:
        while live:
            item = q.get()
            if item is None:
                live -= 1
            elif isinstance(item, BaseException):
                raise item
            else:
                yield item
    finally:
        stop.set()


def reader_threads_default(n_paths: int) -> int:
    """Reader parallelism for order-independent counting consumers: up to
    half the host's cores (the rest feed the device loop), at least one
    worker per file up to 4."""
    return max(1, min(max(n_paths, 4), (os.cpu_count() or 2) // 2, 16))
