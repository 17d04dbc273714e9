"""Build and load the Hopper kernels of kat_tpu_torch/csrc.

`nvcc` compiles every `csrc/*.cu` for sm_90a (one compiler process per
source, all started together) and links them into one shared library with
a plain C interface, at first use, into kat_tpu_torch/_build/ (named by a
hash of the sources and flags, so an edited source rebuilds).  The library
is loaded with ctypes; each C entry point launches on the stream it is
given and returns `cudaGetLastError()`, which `launch` turns into an
exception.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry point -> argtypes (pointers and the stream as c_void_p, so ctypes
# never cuts a 64-bit address to a C int).
_SIGNATURES = {
    "kat_radix_sort": [_P, _P, _P, _P, _I64, _INT, _P],
    "kat_radix_sort_scratch": [_I64, _INT],
    "kat_radix_sort_tile": [],
    "kat_radix_sort_pairs": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _P],
    "kat_radix_sort_pairs_scratch": [_I64, _INT],
    "kat_radix_sort_pairs_tile": [],
    "kat_radix_sort_words_tile": [_INT],
    "kat_radix_sort_words_bucket_cap": [],
    "kat_sort_words_split": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                             _P],
    "kat_sort_words_split_scratch": [_I64, _INT, _INT],
    "kat_sort_words_finish": [_P, _P, _P, _P, _P, _P, _I64, _INT, _INT,
                              _I64, _I64, _I64, _P, _INT, _P],
    "kat_sort_words_fallback_scratch": [_I64, _I64, _INT],
    "kat_merge_sorted": [_P, _P, _I64, _P, _I64, _P, _P, _P, _P],
    "kat_merge_sorted_payload": [_P, _P, _P, _P, _I64, _P, _P, _P, _P, _I64,
                                 _INT, _P, _P, _P, _P, _P, _P],
    "kat_merge_sorted_scratch": [_I64],
    "kat_merge_sorted_tile": [],
    "kat_merge_sorted_words": [_P, _I64, _P, _I64, _P, _I64, _I64, _INT, _P,
                               _I64, _P, _P, _P],
    "kat_merge_sorted_words_scratch": [_I64, _INT],
    "kat_merge_sorted_words_tile": [_INT],
    "kat_merge_sorted_words_payload": [_P, _I64, _P, _P, _P, _I64, _P, _I64,
                                       _P, _P, _P, _I64, _INT, _INT, _P,
                                       _I64, _P, _P, _P, _P, _P],
    "kat_compact_flagged": [_P, _P, _P, _INT, _P, _I64, _P, _P, _P, _I64, _P,
                            _P, _P],
    "kat_compact_flagged_scratch": [_I64],
    "kat_reduce_by_key": [_P, _P, _I64, _P, _P, _I64, _P, _P, _P],
    "kat_reduce_by_key_scratch": [_I64],
    "kat_reduce_by_key_tile": [],
    "kat_reduce_by_key_words": [_P, _I64, _INT, _P, _I64, _P, _I64, _P,
                                _I64, _P, _P, _P],
    "kat_merge_reduce": [_P, _P, _I64, _P, _I64, _P, _P, _I64, _P, _P, _P],
    "kat_merge_reduce_scratch": [_I64],
    "kat_merge_reduce_tile": [],
    "kat_binned_sums": [_P, _P, _INT, _I64, _P, _INT, _P, _P, _P],
    "kat_binned_sums_scratch": [_I64, _P, _INT, _INT],
    "kat_binned_sums_window": [],
    "kat_sort_chunks": [_P, _P, _I64, _INT, _P],
    "kat_merge_runs": [_P, _P, _P, _P, _I64, _I64, _P],
    "kat_merge_runs_words": [_P, _I64, _P, _P, _P, _I64, _I64, _INT, _P],
    "kat_merge_runs_scratch": [_I64, _I64, _INT],
    "kat_merge_runs_tile": [_INT],
    "kat_profile_rounds": [_P, _P, _I64, _I64, _INT, _INT, _P],
    "kat_extract_kmers": [_P, _I64, _I64, _INT, _INT, _P, _P],
}


class KernelLibrary:
    """The compiled kernels: built once per process at first `get()`.
    `extra_flags` (say `-DKAT_RS_ITEMS=12`) go to nvcc after NVCC_FLAGS and
    name a library of their own: a benchmark's variant, never the port's.
    `csrc` and `signatures` name another directory of sources (built with
    this one's headers) and its C entry points: a benchmark's own kernels."""

    def __init__(self, extra_flags: tuple[str, ...] = (), csrc: str = CSRC,
                 signatures: dict | None = None):
        self._flags = [*NVCC_FLAGS, *extra_flags]
        self._csrc = csrc
        self._signatures = _SIGNATURES if signatures is None else signatures
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: str | None = None  # the shared library, once built
        self.build_seconds: float | None = None
        self.build_log = ""

    def _nvcc(self) -> str:
        cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
        for c in cands:
            if c and os.path.exists(c):
                return c
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")

    def _build(self) -> str:
        srcs = sorted(glob.glob(os.path.join(self._csrc, "*.cu")))
        hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        h = hashlib.sha1(" ".join(self._flags).encode())
        for p in srcs + hdrs:
            with open(p, "rb") as f:
                h.update(os.path.basename(p).encode() + f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libkat_kernels-{h.hexdigest()[:12]}.so")
        if os.path.exists(so):
            self.build_seconds = 0.0
            return so
        nvcc = self._nvcc()
        tag = f"{h.hexdigest()[:12]}.{os.getpid()}"
        objs = [os.path.join(
            BUILD_DIR, f"{os.path.splitext(os.path.basename(p))[0]}-{tag}.o")
            for p in srcs]
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            procs = [subprocess.Popen(
                [nvcc, *self._flags, "-I", CSRC, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(srcs, objs)]
            logs = [proc.communicate(timeout=900)[0] for proc in procs]
            self.build_log = "".join(logs)
            failed = [p for p in procs if p.returncode != 0]
            if not failed:
                link = subprocess.run(
                    [nvcc, "-shared", "-o", tmp, *objs], capture_output=True,
                    text=True, timeout=900)
                self.build_log += link.stdout + link.stderr
                if link.returncode != 0:
                    failed = [link]
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        self.build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n"
                               f"{self.build_log}")
        os.replace(tmp, so)
        return so

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path = self._build()
                lib = ctypes.CDLL(self.path)
                for name, argtypes in self._signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int64 if name.endswith(
                        "_scratch") else ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = KernelLibrary()


def scratch_len(name: str, *args) -> int:
    """Scratch elements the C entry point `name` reports for its inputs."""
    return int(getattr(LIBRARY.get(), name)(*args))


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point `name` on `device`, on PyTorch's current
    stream there, and raise if it returns a CUDA error code."""
    lib = LIBRARY.get()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} on "
                           f"{torch.cuda.get_device_name(device)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device | None = None) -> None:
    """Check what every kernel wrapper takes: a contiguous 1-D tensor of
    `dtype` (on `device` when given)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D tensor, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


MAX_WORDS = 9  # words of a wide key at k = 255


def require_words(keys: torch.Tensor, name: str,
                  device: torch.device | None = None) -> None:
    """What the W-word kernels take: int64 [W, n] keys, 2 <= W <= 9, each
    word's plane contiguous (planes may lie apart: a table's prefix)."""
    if keys.dtype != torch.int64:
        raise TypeError(f"{name}: expected torch.int64, got {keys.dtype}")
    if keys.dim() != 2 or not 2 <= keys.shape[0] <= MAX_WORDS:
        raise ValueError(f"{name}: expected [W, n] words with 2 <= W <= "
                         f"{MAX_WORDS}, got {tuple(keys.shape)}")
    if keys.shape[1] > 1 and keys.stride(1) != 1:
        raise ValueError(f"{name}: each word's plane must be contiguous")
    if device is not None and keys.device != device:
        raise ValueError(f"{name}: on {keys.device}, expected {device}")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); anything else raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
