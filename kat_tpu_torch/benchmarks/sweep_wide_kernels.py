"""The W-word forms of K1 (csrc/sort.cu), K2 (csrc/merge.cu) and K3
(csrc/reduce.cu) over the number of words, and the reduce's blocks an SM.

    python -m kat_tpu_torch.benchmarks.sweep_wide_kernels [out.json]
    python -m kat_tpu_torch.benchmarks.sweep_wide_kernels --blocks [out.json]

Without `--blocks`: for W = 2..9 words (k = min(31 W, 255): a full top
word, the most passes the sort can take at that W), 2^24 random keys with
10% SENTINEL: K1 `sort_words` of them, K2 `merge_sorted_words` of a table
of the first quarter's distinct keys (counts 1-999) with the other three
quarters sorted, and K3 `reduce_by_key_words` of the sorted keys into 2^22
slots.  Each cell is checked exactly against the plain version and timed
(CUDA events, 5 launches after a warm-up), with its bound (every input
byte read once and every output byte written once at 3.35 TB/s) and, for
the sort, its passes' floor.

With `--blocks`: rebuilds csrc/reduce.cu with the W-word tile pass built
for 2 and for 3 blocks an SM (KAT_RD_WORDS_BLOCKS, one library each) and
times K3 W-word at the k = 41 flush's shape (83.9M -> 2^24), the
compiled-in value first and last, with the registers and spills ptxas
reports.

Writes the rows as JSON when a path is given.  Needs an NVIDIA card; the
first line names it with its power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from .profile_join import _timed_ms
from .workloads import (HBM_BYTES_PER_S, WIDE_K, wide_flush_shapes,
                        wide_keys, wide_merge_inputs, wide_reduce_inputs)

N = 1 << 24


def _ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check(got, want, what: str) -> None:
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what} differs from its plain version")


def sweep_words(dev, gen) -> list[dict]:
    from ..core.kmers import top_bases
    from ..ops import merge_kernel, reduce_kernel, sort_kernel

    rows = []
    for W in range(2, 10):
        k = min(31 * W, 255)
        tb = 2 * top_bases(k) + 1
        keys = wide_keys(k, N, dev, gen)
        out = sort_kernel.sort_words(keys, tb)
        _check((out,), (sort_kernel.sort_words_plain(keys),), f"K1 W={W}")
        row = dict(W=W, k=k, n=N, passes=sort_kernel.words_passes(W, tb),
                   sort_ms=_timed_ms(lambda: sort_kernel.sort_words(keys, tb),
                                     5),
                   sort_bound_ms=_ms(_nbytes(keys, out)),
                   sort_floor_ms=_ms(sort_kernel.words_pass_floor_bytes(
                       N, W, tb)))
        a, ac, b = wide_merge_inputs(keys, gen)
        got = merge_kernel.merge_sorted_words(a, ac, b)
        _check(got, merge_kernel.merge_sorted_words_plain(a, ac, b),
               f"K2 W={W}")
        row.update(merge_ms=_timed_ms(
            lambda: merge_kernel.merge_sorted_words(a, ac, b), 5),
            merge_bound_ms=_ms(_nbytes(a, ac, b, *got)))
        del got, a, ac, b
        sk, w = wide_reduce_inputs(keys, gen)
        got = reduce_kernel.reduce_by_key_words(sk, w, N // 4)
        _check(got, reduce_kernel.reduce_by_key_words_plain(sk, w, N // 4),
               f"K3 W={W}")
        row.update(reduce_ms=_timed_ms(
            lambda: reduce_kernel.reduce_by_key_words(sk, w, N // 4), 5),
            reduce_bound_ms=_ms(_nbytes(sk, w, got[0], got[1])))
        del got, sk, w, keys, out
        rows.append(row)
        print(f"W={W} k={k}: sort {row['sort_ms']:.3f} ms ({row['passes']} "
              f"passes, floor {row['sort_floor_ms']:.3f}, bound "
              f"{row['sort_bound_ms']:.3f}); merge {row['merge_ms']:.3f} ms "
              f"(bound {row['merge_bound_ms']:.3f}); reduce "
              f"{row['reduce_ms']:.3f} ms (bound {row['reduce_bound_ms']:.3f})")
    return rows


def _ptxas(log: str) -> list[str]:
    """'reduce_words_tiles<W>: R registers, S bytes spilled' lines."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?reduce_words_tilesILi"
                      r"(\d)E", line)
        if m:
            used = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", used)
            spill = re.search(r"(\d+) bytes spill stores", used)
            out.append(f"reduce_words_tiles<{m.group(1)}>: "
                       f"{regs.group(1) if regs else '?'} registers, "
                       f"{spill.group(1) if spill else '?'} bytes spilled")
    return out


def sweep_blocks(dev, gen) -> list[dict]:
    """Each variant's library in turn behind the wrappers (the module's
    LIBRARY is swapped for the measurement and put back)."""
    from ..ops import _cuda, reduce_kernel

    _t, _c, _f, mk, mw = wide_flush_shapes(WIDE_K, dev, gen)
    cap = 1 << 24
    want = reduce_kernel.reduce_by_key_words_plain(mk, mw, cap)
    variants = [("as compiled in", None),
                ("2 blocks an SM", ("-DKAT_RD_WORDS_BLOCKS=2",)),
                ("3 blocks an SM", ("-DKAT_RD_WORDS_BLOCKS=3",)),
                ("as compiled in", None)]
    built_in = _cuda.LIBRARY
    rows = []
    try:
        for name, flags in variants:
            _cuda.LIBRARY = (built_in if flags is None
                             else _cuda.KernelLibrary(flags))
            _cuda.LIBRARY.get()
            _check(reduce_kernel.reduce_by_key_words(mk, mw, cap), want,
                   f"K3 W-word ({name})")
            row = dict(variant=name, reduce_ms=_timed_ms(
                lambda: reduce_kernel.reduce_by_key_words(mk, mw, cap), 5),
                ptxas=[ln for ln in _ptxas(_cuda.LIBRARY.build_log)
                       if "<2>" in ln])
            rows.append(row)
            print(f"blocks {name}: K3 W-word 83.9M -> 2^24 "
                  f"{row['reduce_ms']:.4f} ms; " + "; ".join(row["ptxas"]))
    finally:
        _cuda.LIBRARY = built_in
    return rows


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("sweep_wide_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = [a for a in argv[1:] if a != "--blocks"]
    if "--blocks" in argv:
        result = dict(card=card, blocks=sweep_blocks(dev, gen))
    else:
        result = dict(card=card, words=sweep_words(dev, gen))
    if args:
        with open(args[0], "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
