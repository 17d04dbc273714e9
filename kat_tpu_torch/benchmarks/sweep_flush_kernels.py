"""K2 (csrc/merge.cu), K3 and the fused K2 + K3 (csrc/reduce.cu) over
length, run length and tile size.

    python -m kat_tpu_torch.benchmarks.sweep_flush_kernels [out.json]
    python -m kat_tpu_torch.benchmarks.sweep_flush_kernels --tiles [--fused]
        [out.json]

Without `--tiles`: for n = 2^16 .. 2^27 and four key streams (mean run
length 1, 5 and 1000, and one run of equal keys; 10% SENTINEL at the tail
of each but the last), K3 `reduce_by_key` of the sorted stream into n / 4
slots (a table overflows when the runs outnumber the slots: the true
n_unique must still come back) and K2 `merge_sorted` of an n / 4 table
(distinct keys, counts 1-99) with 3n / 4 fresh keys cut from the same
stream.  Each cell is checked exactly against the plain version and timed
(CUDA events, 5 launches after a warm-up, 20 below 2^22), and gives its
bound (every input byte read once and every output byte written once at
3.35 TB/s) and the share of it the kernel reaches.  Then one call of each
at the main path's shapes under torch.profiler, by kernel.

With `--tiles`: rebuilds the kernels with other threads x items per thread
(the KAT_RD_* macros of reduce.cu, KAT_MG_* of merge.cu, KAT_MR_* of the
fused kernel in reduce.cu, one library per variant) and times K3 at 83.9M
-> 2^24, K2 at 2^24 + 2^26, K2 with one payload plane at 2^24 + 2^23 (the
main path's and the join's shapes), and the fused kernel at 2^24 + 2^26
and at chr14.hist's last flushes (a 2^28-slot table), the compiled-in
values first and last; prints each variant's registers and spills as
ptxas reports them; with `--fused`, the fused kernel's variants alone
(KAT_MR_THREADS, KAT_MR_ITEMS and KAT_MR_BLOCKS, the blocks an SM its
registers are bounded for).

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
from .workloads import (HBM_BYTES_PER_S, HIST_FLUSH, device_event_groups,
                        flush_shapes, table_and_fresh)

LENGTHS = tuple(1 << s for s in (16, 18, 20, 22, 24, 26, 27))
RUN_LENGTHS = (1, 5, 1000, 0)  # 0: every key equal
# threads x items per thread; reduce.cu has (256, 16), merge.cu (384, 8)
K3_TILES = ((128, 16), (128, 24), (256, 8), (256, 24), (512, 8), (512, 16))
K2_TILES = ((256, 8), (256, 16), (256, 24), (512, 8), (768, 8))
# the fused kernel's, with the blocks an SM its registers are bounded for
# (1: no bound); reduce.cu has (256, 16, 3)
MR_TILES = ((256, 12, 3), (256, 12, 4), (256, 8, 4), (256, 16, 1),
            (256, 16, 2), (128, 24, 1), (384, 12, 2), (512, 8, 2))


def stream(n: int, run: int, dev, gen) -> torch.Tensor:
    """n sorted keys in runs of `run` equal keys (0: one run), the last
    10% SENTINEL unless every key is equal."""
    from ..core.kmers import SENTINEL

    if run == 0:
        return torch.full((n,), 12345, dtype=torch.int64, device=dev)
    base = torch.randint(0, 1 << 54, (-(-n // run),), dtype=torch.int64,
                         device=dev, generator=gen)
    keys = torch.sort(base).values.repeat_interleave(run)[:n].contiguous()
    keys[n - n // 10:] = SENTINEL
    return keys


def merge_inputs(keys: torch.Tensor, gen):
    """(table keys, table counts, fresh keys) of a flush merge from one
    sorted stream: the table holds n / 4 of its distinct keys, the fresh
    side 3n / 4 of its keys, still sorted."""
    from ..core.kmers import SENTINEL

    n = keys.numel()
    table = torch.unique(keys[:n // 4])
    table = table[table != SENTINEL]
    counts = torch.randint(1, 100, (table.numel(),), dtype=torch.int32,
                           device=keys.device, generator=gen)
    return table, counts, keys[n // 4:]


def _bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _cell(keys: torch.Tensor, gen) -> dict:
    from ..ops import merge_kernel, reduce_kernel

    n = keys.numel()
    reps = 5 if n >= 1 << 22 else 20
    w = torch.randint(1, 5, (n,), dtype=torch.int32, device=keys.device,
                      generator=gen)
    out_size = n // 4
    got = reduce_kernel.reduce_by_key(keys, w, out_size)
    want = reduce_kernel.reduce_by_key_plain(keys, w, out_size)
    if not all(torch.equal(g, x) for g, x in zip(got, want)):
        raise AssertionError(f"K3 at n={n} differs from its plain version")
    runs = int(got[2])
    del got, want
    k3_ms = _timed_ms(lambda: reduce_kernel.reduce_by_key(keys, w, out_size),
                      reps)
    k3_bound = _bound_ms(12 * n + 12 * out_size)

    t_keys, t_counts, fresh = merge_inputs(keys, gen)
    got = merge_kernel.merge_sorted(t_keys, t_counts, fresh)
    want = merge_kernel.merge_sorted_plain(t_keys, t_counts, fresh)
    if not all(torch.equal(g, x) for g, x in zip(got, want)):
        raise AssertionError(f"K2 at n={n} differs from its plain version")
    m = got[0].numel()
    del got, want
    k2_ms = _timed_ms(lambda: merge_kernel.merge_sorted(t_keys, t_counts,
                                                        fresh), reps)
    k2_bound = _bound_ms(12 * t_keys.numel() + 8 * fresh.numel() + 12 * m)
    return dict(runs=runs, k3_ms=k3_ms, k3_bound_ms=k3_bound,
                k3_share=k3_bound / k3_ms, k2_n=m, k2_ms=k2_ms,
                k2_bound_ms=k2_bound, k2_share=k2_bound / k2_ms)


def sweep(dev, gen) -> list[dict]:
    rows = []
    print("n run_length runs k3_ms k3_share k2_ms k2_share")
    for n in LENGTHS:
        for run in RUN_LENGTHS:
            row = dict(n=n, run_length=run,
                       **_cell(stream(n, run, dev, gen), gen))
            rows.append(row)
            print(f"2^{n.bit_length() - 1} {run or 'all-equal'} "
                  f"{row['runs']} {row['k3_ms']:.4f} {row['k3_share']:.3f} "
                  f"{row['k2_ms']:.4f} {row['k2_share']:.3f}")
    return rows


def _time_main(shapes, hist) -> dict:
    from ..core.kmers import SENTINEL
    from ..ops import merge_kernel, merge_reduce_kernel, reduce_kernel

    t_keys, t_counts, fresh, mk, mw, q = shapes
    cap = t_keys.numel()
    n = int((t_keys != SENTINEL).sum())
    fused = [(t_keys[:n], t_counts[:n], fresh, cap), hist]
    got = reduce_kernel.reduce_by_key(mk, mw, cap)
    want = reduce_kernel.reduce_by_key_plain(mk, mw, cap)
    ok = all(torch.equal(g, x) for g, x in zip(got, want))
    got = merge_kernel.merge_sorted(t_keys, t_counts, fresh)
    ok = ok and torch.equal(got[0], mk) and torch.equal(got[1], mw)
    ap = (torch.full((cap,), -1, dtype=torch.int32, device=q.device),)
    bp = (torch.arange(q.numel(), dtype=torch.int32, device=q.device),)
    got = merge_kernel.merge_sorted_payload(t_keys, ap, q, bp)
    want = merge_kernel.merge_sorted_payload_plain(t_keys, ap, q, bp)
    ok = ok and torch.equal(got[0], want[0]) and torch.equal(got[1][0],
                                                             want[1][0])
    for args in fused:
        got = merge_reduce_kernel.merge_reduce(*args)
        want = reduce_kernel.reduce_by_key(
            *merge_kernel.merge_sorted(*args[:3]), args[3])
        ok = ok and all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want
    if not ok:
        raise AssertionError("a kernel differs from its plain version at "
                             "the main path's shapes")
    return dict(
        fused_ms=_timed_ms(lambda: merge_reduce_kernel.merge_reduce(
            *fused[0]), 5),
        fused_hist_ms=_timed_ms(lambda: merge_reduce_kernel.merge_reduce(
            *fused[1]), 5),
        k3_ms=_timed_ms(lambda: reduce_kernel.reduce_by_key(mk, mw, cap), 5),
        k2_ms=_timed_ms(lambda: merge_kernel.merge_sorted(t_keys, t_counts,
                                                          fresh), 5),
        k2_payload_ms=_timed_ms(lambda: merge_kernel.merge_sorted_payload(
            t_keys, ap, q, bp), 5))


def profile(shapes) -> dict:
    """Device time by kernel of one K3, one K2 and one payload K2 at the
    main path's and the join's shapes, in microseconds."""
    from ..ops import merge_kernel, reduce_kernel

    t_keys, t_counts, fresh, mk, mw, q = shapes
    cap = t_keys.numel()
    ap = (torch.full((cap,), -1, dtype=torch.int32, device=q.device),)
    bp = (torch.arange(q.numel(), dtype=torch.int32, device=q.device),)
    calls = (("k3", lambda: reduce_kernel.reduce_by_key(mk, mw, cap)),
             ("k2", lambda: merge_kernel.merge_sorted(t_keys, t_counts,
                                                      fresh)),
             ("k2_payload", lambda: merge_kernel.merge_sorted_payload(
                 t_keys, ap, q, bp)))
    for _what, fn in calls:
        fn()
    out = {}
    for (what, _fn), events in zip(calls, device_event_groups(
            [fn for _what, fn in calls])):
        out[what] = [(name[:60], us) for name, us in events]
        print(f"profile, {what}: " + json.dumps(out[what]))
    return out


def _ptxas_lines(log: str) -> list[str]:
    """'kernel: N registers, S bytes spill stores' for reduce_tiles,
    merge_reduce_tiles and merge_tiles out of nvcc's -Xptxas -v output."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?(merge_reduce_tiles|"
                      r"reduce_tiles|merge_tilesILi(\d)ELb(\d))", line)
        if m:
            used = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", used)
            spill = re.search(r"(\d+) bytes spill stores", used)
            what = (m.group(1) if m.group(2) is None
                    else f"merge_tiles<{m.group(2)}, {m.group(3)}>")
            out.append(f"{what}: {regs.group(1) if regs else '?'} registers, "
                       f"{spill.group(1) if spill else '?'} bytes spilled")
    return out


def sweep_tiles(dev, gen, only_fused: bool = False) -> list[dict]:
    """Each variant's library in turn behind the wrappers (the module's
    LIBRARY is swapped for the measurement and put back); `only_fused`:
    the fused kernel's variants alone."""
    from ..ops import _cuda, merge_kernel, merge_reduce_kernel, reduce_kernel

    shapes = flush_shapes(dev, gen)
    hist = (*table_and_fresh(*HIST_FLUSH, dev, gen), HIST_FLUSH[0])
    variants = [("as compiled in", None)]
    fused = [(f"fused {t} x {i}, {b} blocks", (
        f"-DKAT_MR_THREADS={t}", f"-DKAT_MR_ITEMS={i}",
        f"-DKAT_MR_BLOCKS={b}")) for t, i, b in MR_TILES]
    if only_fused:
        variants += fused
    else:
        variants += [(f"K3 {t} x {i}", (f"-DKAT_RD_THREADS={t}",
                                        f"-DKAT_RD_ITEMS={i}"))
                     for t, i in K3_TILES]
        variants += [(f"K2 {t} x {i}", (f"-DKAT_MG_THREADS={t}",
                                        f"-DKAT_MG_ITEMS={i}"))
                     for t, i in K2_TILES]
        variants += fused
    variants.append(variants[0])
    built_in = _cuda.LIBRARY
    rows = []
    try:
        for name, flags in variants:
            _cuda.LIBRARY = (built_in if flags is None
                             else _cuda.KernelLibrary(flags))
            _cuda.LIBRARY.get()
            row = dict(variant=name, k3_tile=reduce_kernel.tile_len(),
                       k2_tile=merge_kernel.tile_len(),
                       fused_tile=merge_reduce_kernel.tile_len(),
                       **_time_main(shapes, hist),
                       ptxas=_ptxas_lines(_cuda.LIBRARY.build_log))
            rows.append(row)
            print(f"tiles {name}: K3 tile {row['k3_tile']} {row['k3_ms']:.4f}"
                  f" ms; K2 tile {row['k2_tile']} {row['k2_ms']:.4f} ms, "
                  f"payload {row['k2_payload_ms']:.4f} ms; fused tile "
                  f"{row['fused_tile']} {row['fused_ms']:.4f} ms, at "
                  f"hist's last flush {row['fused_hist_ms']:.4f} ms; "
                  + "; ".join(row["ptxas"]))
    finally:
        _cuda.LIBRARY = built_in
    return rows


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("sweep_flush_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    args = [a for a in argv[1:] if a not in ("--tiles", "--fused")]
    if "--tiles" in argv:
        result = dict(card=card, tiles=sweep_tiles(dev, gen,
                                                   "--fused" in argv))
    else:
        result = dict(card=card, rows=sweep(dev, gen),
                      profile=profile(flush_shapes(dev, gen)))
    if args:
        with open(args[0], "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
