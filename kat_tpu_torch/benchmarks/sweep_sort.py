"""K1 (csrc/sort.cu) over length, key distribution and tile size.

    python -m kat_tpu_torch.benchmarks.sweep_sort [out.json]
    python -m kat_tpu_torch.benchmarks.sweep_sort --tiles [out.json]

Without `--tiles`: `sort_keys` and `sort_pairs` at key_bits 55 (k = 27) for
n in 2^16 .. 2^26 and five distributions of 54-bit keys (random; random
with 10% SENTINEL; 90% one key; the second one already sorted; all
SENTINEL, where one chain of status words carries every key).  Each cell
is checked against `torch.sort` and timed beside it (CUDA events, 5
launches after a warm-up, 20 below 2^22) and gives the GB/s the sort
reaches against its pass structure's floor: 8 + 16 x passes bytes per key
read and written, 12 + 24 x passes per pair.  Then one sort of 2^26 keys,
one of 2^23 pairs and one of 2^16 pairs under torch.profiler, by kernel.

With `--tiles`: rebuilds the kernels with other threads x keys-per-thread
and other look-back depths (the KAT_RS_* macros of sort.cu, one library per
variant) and times 2^26 keys, 2^23 pairs and 2^18 pairs with each, the
compiled-in values first and last; prints each variant's registers and
spills as ptxas reports them.

Writes the rows as JSON when a path is given.  Needs an NVIDIA card; the
first line names it with its power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from ..ops.sort_kernel import pass_floor_bytes
from .profile_join import _timed_ms
from .workloads import HBM_BYTES_PER_S, device_events

KEY_BITS = 55  # k = 27: 7 passes
LENGTHS = tuple(1 << s for s in (16, 18, 20, 22, 23, 24, 26))
DISTRIBUTIONS = ("random", "sentinels_10", "one_key_90", "sorted",
                 "all_sentinel")
# threads x keys per thread; sort.cu has (512, 16) for keys and
# (384, 16) for pairs
TILE_VARIANTS = ((256, 16), (384, 16), (512, 8), (512, 10), (512, 12),
                 (512, 14), (512, 16), (640, 10), (640, 12), (768, 8),
                 (768, 10))
LOOK_BACK_VARIANTS = (1, 2, 8)  # sort.cu has 4


def make_keys(name: str, n: int, dev, gen) -> torch.Tensor:
    from ..core.kmers import SENTINEL

    if name == "all_sentinel":
        return torch.full((n,), SENTINEL, dtype=torch.int64, device=dev)
    keys = torch.randint(0, 1 << 54, (n,), dtype=torch.int64, device=dev,
                         generator=gen)
    if name == "random":
        return keys
    if name == "one_key_90":
        keys[torch.rand(n, device=dev, generator=gen) < 0.9] = 0x2AAAAAAAAAAAAA
        return keys
    keys[torch.rand(n, device=dev, generator=gen) < 0.1] = SENTINEL
    return torch.sort(keys).values if name == "sorted" else keys


def _time_cell(keys, with_values: bool) -> dict:
    from ..ops import sort_kernel

    n = keys.numel()
    reps = 5 if n >= 1 << 22 else 20
    if with_values:
        vals = torch.arange(n, dtype=torch.int32, device=keys.device)
        want, perm = torch.sort(keys, stable=True)
        got, gvals = sort_kernel.sort_pairs(keys, vals, KEY_BITS)
        ok = torch.equal(got, want) and torch.equal(gvals, perm.to(torch.int32))
        del want, perm, got, gvals
        ms = _timed_ms(lambda: sort_kernel.sort_pairs(keys, vals, KEY_BITS),
                       reps)
        lib_ms = _timed_ms(lambda: torch.sort(keys, stable=True), reps)
    else:
        ok = torch.equal(sort_kernel.sort_keys(keys, KEY_BITS),
                         torch.sort(keys).values)
        ms = _timed_ms(lambda: sort_kernel.sort_keys(keys, KEY_BITS), reps)
        lib_ms = _timed_ms(lambda: torch.sort(keys), reps)
    if not ok:
        raise AssertionError(f"sort of {n} {'pairs' if with_values else 'keys'}"
                             " differs from torch.sort")
    floor = pass_floor_bytes(n, with_values, KEY_BITS)
    return dict(ms=ms, torch_sort_ms=lib_ms,
                floor_ms=floor / HBM_BYTES_PER_S * 1e3,
                gb_per_s=floor / ms / 1e6)


def sweep(dev, gen) -> list[dict]:
    rows = []
    print("what n distribution kernel_ms torch_sort_ms floor_ms GB/s")
    for with_values in (False, True):
        what = "pairs" if with_values else "keys"
        for n in LENGTHS:
            for name in DISTRIBUTIONS:
                row = dict(what=what, n=n, distribution=name,
                           **_time_cell(make_keys(name, n, dev, gen),
                                        with_values))
                rows.append(row)
                print(f"{what} 2^{n.bit_length() - 1} {name} {row['ms']:.4f} "
                      f"{row['torch_sort_ms']:.4f} {row['floor_ms']:.4f} "
                      f"{row['gb_per_s']:.1f}")
    return rows


def profile(dev, gen) -> dict:
    """Device time by kernel of one sort of 2^26 keys, one of 2^23 pairs and
    one of 2^16 pairs (sentinels_10), in microseconds."""
    from ..ops import sort_kernel

    out = {}
    for what, n in (("keys", 1 << 26), ("pairs", 1 << 23), ("pairs", 1 << 16)):
        keys = make_keys("sentinels_10", n, dev, gen)
        vals = torch.arange(n, dtype=torch.int32, device=dev)

        def run():
            if what == "pairs":
                sort_kernel.sort_pairs(keys, vals, KEY_BITS)
            else:
                sort_kernel.sort_keys(keys, KEY_BITS)

        run()
        by_kernel = {}
        for name, us in device_events(run):
            row = by_kernel.setdefault(name[:60], dict(calls=0, us=0.0))
            row["calls"] += 1
            row["us"] += us
        out[f"{what}_2_{n.bit_length() - 1}"] = by_kernel
        print(f"profile, 2^{n.bit_length() - 1} {what}: "
              + json.dumps(by_kernel))
    return out


def _ptxas_lines(log: str) -> list[str]:
    """'keys|pairs: N registers, S bytes spill stores, L bytes spill loads'
    for sort.cu's pass kernels out of nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "radix_onesweep" in line:
            what = "pairs" if "Lb1E" in line else "keys"
            used = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", used)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", used)
            out.append(f"{what}: {regs.group(1) if regs else '?'} registers, "
                       + (f"{spill.group(1)} bytes spill stores, "
                          f"{spill.group(2)} bytes spill loads"
                          if spill else "spills not reported"))
    return out


def sweep_tiles(dev, gen) -> list[dict]:
    """Each variant's library in turn behind the wrappers (the module's
    LIBRARY is swapped for the measurement and put back)."""
    from ..ops import _cuda, sort_kernel

    keys = make_keys("sentinels_10", 1 << 26, dev, gen)
    pkeys = make_keys("sentinels_10", 1 << 23, dev, gen)
    small = make_keys("sentinels_10", 1 << 18, dev, gen)
    variants = [("as compiled in", None)]
    variants += [(f"{t} x {i}", (f"-DKAT_RS_THREADS={t}", f"-DKAT_RS_ITEMS={i}",
                                 f"-DKAT_RS_PAIR_THREADS={t}",
                                 f"-DKAT_RS_PAIR_ITEMS={i}"))
                 for t, i in TILE_VARIANTS]
    variants += [(f"look-back {b}", (f"-DKAT_RS_LOOK_BACK={b}",))
                 for b in LOOK_BACK_VARIANTS]
    variants.append(variants[0])
    built_in = _cuda.LIBRARY
    rows = []
    try:
        for name, flags in variants:
            _cuda.LIBRARY = (built_in if flags is None
                             else _cuda.KernelLibrary(flags))
            _cuda.LIBRARY.get()
            row = dict(variant=name, tile_keys=sort_kernel.tile_len(False),
                       tile_pairs=sort_kernel.tile_len(True),
                       keys_2_26=_time_cell(keys, False)["ms"],
                       pairs_2_23=_time_cell(pkeys, True)["ms"],
                       pairs_2_18=_time_cell(small, True)["ms"],
                       ptxas=_ptxas_lines(_cuda.LIBRARY.build_log))
            rows.append(row)
            print(f"tiles {name}: keys tile {row['tile_keys']} "
                  f"{row['keys_2_26']:.4f} ms at 2^26; pairs tile "
                  f"{row['tile_pairs']} {row['pairs_2_23']:.4f} ms at 2^23, "
                  f"{row['pairs_2_18']:.4f} ms at 2^18; "
                  + "; ".join(row["ptxas"]))
    finally:
        _cuda.LIBRARY = built_in
    return rows


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("sweep_sort: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = [a for a in argv[1:] if a != "--tiles"]
    if "--tiles" in argv:
        result = dict(card=card, tiles=sweep_tiles(dev, gen))
    else:
        result = dict(card=card, rows=sweep(dev, gen),
                      profile=profile(dev, gen))
    if args:
        with open(args[0], "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
