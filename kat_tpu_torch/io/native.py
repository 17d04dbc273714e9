"""ctypes binding to the native FASTX reader, kat_tpu_torch/native/fastxio.cpp.

The C++ file is the port's own copy of kat_tpu's reader (kat_tpu's
io/native.py would pull JAX in); it is compiled with g++ at first use into
the port's build directory.  Both halves of the file are bound: the
`kat_fastx_*` reader of the classic flush, and the `kat_smr_*` supermer
router that feeds the minimizer-bucketed flush (core/bucketed.py) through
`SupermerRouter` and `route_flushes`.

A failed g++ build leaves `available()` false, and the classic flush then
reads through the Python encoder as in kat_tpu; the compiler's output is
kept in `build_log()`.  The bucketed flush cannot run without the router:
`require_lib()` raises with that output instead.

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
_SRC = os.path.join(_PKG, "native", "fastxio.cpp")
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
        self.build_log = ""  # the compiler's output, kept when it fails

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
        except OSError as e:
            self.build_log = f"cannot read {_SRC}: {e}"
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
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                return None
            os.replace(tmp, so)
            return so
        except (subprocess.SubprocessError, OSError) as e:
            self.build_log = f"{' '.join(cmd)}: {e}"
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
            lib.kat_smr_open.restype = ctypes.c_void_p
            lib.kat_smr_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
            lib.kat_smr_open_range.restype = ctypes.c_void_p
            lib.kat_smr_open_range.argtypes = (
                [ctypes.c_char_p] + [ctypes.c_int] * 4 + [ctypes.c_int64] * 2)
            lib.kat_smr_close.restype = None
            lib.kat_smr_close.argtypes = [ctypes.c_void_p]
            lib.kat_smr_next_flush2.restype = ctypes.c_int64
            lib.kat_smr_next_flush2.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int]
            lib.kat_smr_attach.restype = ctypes.c_int
            lib.kat_smr_attach.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64]
            self._lib = lib
            return lib


_READER = NativeReader()


def get_lib() -> ctypes.CDLL | None:
    return _READER.get()


def available() -> bool:
    return get_lib() is not None


def build_log() -> str:
    """What g++ printed at the last build attempt of this process."""
    return _READER.build_log


def require_lib() -> ctypes.CDLL:
    """The library, or a RuntimeError that carries the compiler's output."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native fastxio library unavailable: the g++ "
                           f"build of {_SRC} failed:\n{build_log()}")
    return lib


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
    lib = require_lib()
    trims = _trims_for(paths, trim5)
    threads = max(1, int(threads))
    items = _work_items(lib, paths, trims, threads)
    threads = min(threads, len(items))
    if threads == 1 and not any(i[4] == "gz-threaded" for i in items):
        for item in items:
            yield from _stream_item(lib, item, k, rows, row_len)
        return

    work = iter(items)
    work_lock = threading.Lock()

    def batches(stop: threading.Event):
        while not stop.is_set():
            with work_lock:
                item = next(work, None)
            if item is None:
                break
            yield from _stream_item(lib, item, k, rows, row_len, stop=stop)

    yield from _fan_in(batches, threads, 2 * threads, "kat-reader")


def _fan_in(worker_iter, threads: int, maxsize: int, name: str):
    """Run the generator `worker_iter(stop)` on `threads` daemon threads and
    yield what they yield, in arrival order; a worker's exception re-raises
    here.  Abandonment protocol: if the consumer stops draining (generator
    closed by an error), `stop` is set so workers blocked on the bounded
    queue exit and their generators close their native handles instead of
    leaking threads/fds/gz state."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
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
            for item in worker_iter(stop):
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised at consumer
            _put(e)
        finally:
            _put(None)
            # a set stop flag may have swallowed the sentinel; the
            # consumer is gone then, so nobody waits on it

    workers = [threading.Thread(target=worker, daemon=True,
                                name=f"{name}-{i}")
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


class SupermerRouter:
    """Native minimizer supermer router: the host half of the bucketed
    counting flush (core/minimizer.py, native/fastxio.cpp).

    Streams one FASTX(.gz) file and yields per-flush chunk layouts:
    (records u64 [n_chunks, rec_per_chunk], hot groups int32 [n, 2]
    (start_chunk, log2_chunks), n_windows).  `chunks.view(np.int64)` is
    what core/minimizer.expand_records takes."""

    def __init__(self, path: str, k: int, m: int, bucket_bits: int,
                 trim5: int = 0, byte_range: tuple | None = None):
        self._lib = require_lib()
        if byte_range is not None:
            self._h = self._lib.kat_smr_open_range(
                path.encode(), int(k), int(m), int(bucket_bits),
                int(trim5), int(byte_range[0]), int(byte_range[1]))
        else:
            self._h = self._lib.kat_smr_open(path.encode(), int(k), int(m),
                                             int(bucket_bits), int(trim5))
        if not self._h:
            raise OSError(
                f"could not open {path} for supermer routing (k={k}, "
                f"m={m}, bucket_bits={bucket_bits})")

    def next_flush(self, max_chunks: int, rec_per_chunk: int,
                   max_groups: int = 512, finalize: bool = True):
        """One flush worth of routed records, or None.

        finalize=True (default): pack remainders at end of input (None
        thereafter means fully drained).  finalize=False: None means
        "current input exhausted, bins kept": attach() more input and keep
        calling, then drain with finalize=True.  A hot bucket past
        max_groups reported groups waits for the next flush."""
        chunks = np.empty((max_chunks, rec_per_chunk), np.uint64)
        groups = np.zeros((max_groups, 2), np.int32)
        stats = np.zeros((3,), np.int64)
        n = self._lib.kat_smr_next_flush2(
            self._h, int(max_chunks), int(rec_per_chunk),
            chunks.ctypes.data_as(ctypes.c_void_p),
            groups.ctypes.data_as(ctypes.c_void_p), int(max_groups),
            stats.ctypes.data_as(ctypes.c_void_p),
            1 if finalize else 0)
        if n < 0:
            raise RuntimeError("supermer router error (corrupt input?)")
        if n == 0:
            return None
        return (chunks[:n], groups[:int(stats[2])].copy(), int(stats[0]))

    def attach(self, path: str, trim5: int = 0,
               byte_range: tuple | None = None) -> None:
        """Attach another input, KEEPING accumulated bucket bins (used
        with next_flush(finalize=False) so many byte ranges stream into
        full flushes instead of one partial tail per range)."""
        start, end = byte_range if byte_range else (0, 1 << 62)
        ok = self._lib.kat_smr_attach(self._h, path.encode(), int(trim5),
                                      int(start), int(end))
        if not ok:
            raise OSError(f"could not attach {path} to supermer router")

    def close(self) -> None:
        if self._h:
            self._lib.kat_smr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def route_flushes(paths: list[str], k: int, m: int, bucket_bits: int,
                  max_chunks: int, rec_per_chunk: int,
                  trim5: list[int] | None = None, threads: int = 1):
    """Yield supermer flush tuples (chunks, groups, n_windows) across
    files, routed by up to `threads` parallel workers.

    Large PLAIN files split into record-aligned byte ranges; gz files stay
    whole.  Each worker owns ONE router and ATTACHES successive work items
    to it (bins accumulate across ranges and files), so fine-grained ranges
    load-balance without fragmenting the stream into partial tail flushes:
    every worker emits full flushes plus one remainder at the very end.
    Flushes from different workers merge through the count table like any
    other flush.  The GIL is released during the native parse and route.
    Flush ORDER interleaves; counting is order-independent."""
    lib = require_lib()
    trims = _trims_for(paths, trim5)
    threads = max(1, int(threads))
    items: list[tuple] = []
    whole = 1 << 62
    piece = RANGE_CHUNK // 8  # the router does more work per byte than
    #                           the plain parser: smaller pieces pay off
    for path, trim in zip(paths, trims):
        kind = lib.kat_fastx_sniff(path.encode())
        size = os.path.getsize(path) if kind in (1, 2) else 0
        if kind in (1, 2) and threads > 1 and size > 2 * piece:
            n = min(threads * 4, max(1, size // piece))
            step = -(-size // n)
            for s in range(0, size, step):
                items.append((path, trim, s, min(s + step, size), "range"))
        else:
            items.append((path, trim, 0, whole, "plain"))
    threads = min(threads, len(items))
    work = iter(items)
    work_lock = threading.Lock()

    def flushes(stop: threading.Event):
        """One worker's flushes: its router takes work items until none is
        left, then drains."""
        r = None
        try:
            while not stop.is_set():
                with work_lock:
                    item = next(work, None)
                final = item is None
                if not final:
                    path, trim, start, end, kind = item
                    rng = (start, end) if kind == "range" else None
                    if r is None:
                        r = SupermerRouter(path, k, m, bucket_bits,
                                           trim5=trim, byte_range=rng)
                    else:
                        r.attach(path, trim5=trim, byte_range=rng)
                while r is not None and not stop.is_set():
                    fl = r.next_flush(max_chunks, rec_per_chunk,
                                      finalize=final)
                    if fl is None:
                        break
                    yield fl
                if final:
                    return
        finally:
            if r is not None:
                r.close()

    if threads == 1:
        yield from flushes(threading.Event())
    else:
        yield from _fan_in(flushes, threads, threads + 1, "kat-router")
