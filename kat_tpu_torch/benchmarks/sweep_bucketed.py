"""The bucketed flush's chunk geometry, swept on one NVIDIA card, and where
one flush's device time goes.

    python -m kat_tpu_torch.benchmarks.sweep_bucketed [out.json]

Reads: k = 27, reads of 1024 bases from a 2^23-base random genome plus 2%
low-complexity reads, written as FASTA to a temporary directory (the read
model of chip_smoke.py's bucketed phase, at half its depth).  For
each (slots_log, max_chunks, bucket_bits) the file is routed by ONE router
(timed: host windows/s), every flush is staged on the card, and a
BucketedCodeCounter runs over the staged flushes (best of 2 after a
warm-up: device k-mers/s); the record fill (windows per key' slot) and the
hot groups per flush come from the router's output.  The classic flush runs
over the same reads as staged code batches.  Then one flush of the default
geometry is taken stage by stage with CUDA events, and the host side alone
is timed by worker count: the router at 2^14 and 2^16 buckets and the
classic flush's code reader.  Last, count_paths_bucketed counts the file
from file to table at both bucket counts with the worker count that
tools.common.Input gives it.  Prints the card's name and power limit and one
JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..core import bucketed, counting, minimizer
from ..core.kmers import SENTINEL
from ..io import native
from ..ops.merge_kernel import merge_sorted_payload
from ..ops.reduce_kernel import reduce_by_key
from ..ops.sort_kernel import merge_runs, sort_chunks

K, LENGTH = 27, 1024
CONFIGS = [  # (slots_log, max_chunks, bucket_bits)
    (12, 8192, 16), (13, 4096, 16), (13, 4096, 14), (13, 2048, 15),
    (13, 8192, 16), (14, 2048, 15), (14, 2048, 14), (14, 4096, 16),
    (14, 1024, 14), (14, 4096, 14),
]


def write_reads(path: str, genome: np.ndarray, n_reads: int, length: int,
                rng) -> int:
    """n_reads reads of `length` bases from the genome (2-bit codes) as
    FASTA, plus 2% low-complexity reads (poly-A, AT, AAT and AAAC repeats
    and reverse complements), so that a few minimizer buckets overflow
    their chunk.  Returns the number of reads written."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    head = np.frombuffer(b">r\n", np.uint8)
    motifs = [b"A", b"AT", b"AAT", b"AAAC", b"T", b"GTTT"]
    n_low = n_reads // 50
    with open(path, "wb") as f:
        for start in range(0, n_reads, 16384):
            rows = min(16384, n_reads - start)
            offs = rng.integers(0, genome.size - length, rows)
            block = np.empty((rows, head.size + length + 1), np.uint8)
            block[:, :head.size] = head
            block[:, head.size:-1] = acgt[
                genome[offs[:, None] + np.arange(length)]]
            block[:, -1] = ord("\n")
            f.write(block.tobytes())
        for i in range(n_low):
            m = motifs[i % len(motifs)]
            f.write(b">low\n" + (m * (length // len(m) + 1))[:length] + b"\n")
    return n_reads + n_low


def _best_s(fn, reps: int = 2) -> float:
    fn()  # warm-up
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def _route(fa: str, slots_log: int, max_chunks: int, bits: int, dev):
    """Route with one router; (staged flushes, host seconds, tallies)."""
    rpc = (1 << slots_log) // minimizer.rec_windows(K)
    t0 = time.perf_counter()
    host = [(bucketed.pad_flush(c, max_chunks), g, nw)
            for c, g, nw in native.route_flushes(
                [fa], K, minimizer.M_DEFAULT, bits, max_chunks, rpc)]
    dt = time.perf_counter() - t0
    tally = dict(
        flushes=len(host), chunks=sum(c.shape[0] for c, _g, _n in host),
        groups=sum(len(g) for _c, g, _n in host),
        group_chunks=sum(int((1 << g[:, 1]).sum()) for _c, g, _n in host),
        windows=sum(nw for _c, _g, nw in host))
    tally["fill"] = tally["windows"] / (tally["chunks"] << slots_log)
    staged = [(torch.from_numpy(c.view(np.int64)).to(dev), g)
              for c, g, _nw in host]
    return staged, dt, tally


def _stages(rec: torch.Tensor, groups, table: counting.CountTable) -> dict:
    """One flush against `table`, stage by stage (ms, CUDA events)."""
    S = minimizer.rec_windows(K)
    chunk_slots = rec.shape[1] * S
    marks = [("start", torch.cuda.Event(enable_timing=True))]

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    marks[0][1].record()
    keyp = minimizer.expand_records(rec, K).transpose(0, 1).reshape(-1)
    mark("expand_records")
    stream = sort_chunks(keyp, chunk_slots)
    mark("K5 sort_chunks")
    for start, lg in groups:
        sl = stream[int(start) * chunk_slots:
                    (int(start) + (1 << int(lg))) * chunk_slots]
        sl.copy_(merge_runs(sl, chunk_slots))
    mark(f"K6 merge_runs x{len(groups)}")
    w = (stream != SENTINEL).to(torch.int32)
    fk, fc, fnu = reduce_by_key(stream, w, table.capacity)
    fnu = int(fnu)
    mark("K3 reduce (stream)")
    n = table.n_unique
    mk, (mc,) = merge_sorted_payload(table.keys[:n], (table.counts[:n],),
                                     fk[:fnu], (fc[:fnu],))
    mark("K2 merge (table)")
    reduce_by_key(mk, mc, table.capacity)
    mark("K3 reduce (table)")
    torch.cuda.synchronize()
    return {name: marks[i][1].elapsed_time(ev)
            for i, (name, ev) in enumerate(marks[1:])}


def _host_rates(fa: str, n_windows: int, dev) -> dict:
    """Host windows/s with nothing on the device: the router by worker
    count and bucket bits, and the classic flush's reader.  Then file to
    table through count_paths_bucketed by bucket bits, k-mers/s."""
    rpc = (1 << bucketed.SLOTS_LOG) // minimizer.rec_windows(K)
    out = {}
    for bits in (14, 16):
        for threads in (1, 2, 4, 8):
            t0 = time.perf_counter()
            got = sum(nw for _c, _g, nw in native.route_flushes(
                [fa], K, minimizer.M_DEFAULT, bits, bucketed.MAX_CHUNKS, rpc,
                threads=threads))
            out[f"router_b{bits}_t{threads}"] = got / (time.perf_counter()
                                                       - t0)
            if got != n_windows:
                raise AssertionError(f"router lost windows: {got}")
    for threads in (1, 4, 8):
        t0 = time.perf_counter()
        for _b in native.stream_code_batches([fa], K, threads=threads):
            pass
        out[f"reader_t{threads}"] = n_windows / (time.perf_counter() - t0)
    out["input_workers"] = native.reader_threads_default(1)
    for bits in (14, 16, 14, 16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bucketed.count_paths_bucketed([fa], K, bucket_bits=bits,
                                      initial_capacity=1 << 24, device=dev)
        torch.cuda.synchronize()
        out.setdefault(f"file_to_table_b{bits}", []).append(
            n_windows / (time.perf_counter() - t0))
    out["cpu_count"] = os.cpu_count()
    return out


def run(n_reads: int = 98_304, seed: int = 45) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_bucketed measures an NVIDIA card: "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    res: dict = {"k": K, "configs": []}
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "reads.fa")
        rng = np.random.default_rng(seed)
        genome = rng.integers(0, 4, (1 << 23) + LENGTH, dtype=np.uint8)
        n_windows = write_reads(fa, genome, n_reads, LENGTH, rng) * (
            LENGTH - K + 1)
        res["windows"] = n_windows
        batches = [torch.from_numpy(b).to(dev)
                   for b in native.stream_code_batches([fa], K)]

        def classic():
            sc = counting.CodeStreamingCounter(
                K, initial_capacity=1 << 24, flush_windows=1 << 26,
                device=dev)
            for b in batches:
                sc.add_codes(b)
            return sc.finish()

        res["classic_kmers_per_s"] = n_windows / _best_s(classic)
        n_distinct = classic().n_unique
        del batches
        for slots_log, max_chunks, bits in CONFIGS:
            staged, route_s, tally = _route(fa, slots_log, max_chunks, bits,
                                            dev)

            def count():
                sc = bucketed.BucketedCodeCounter(
                    K, initial_capacity=1 << 24, device=dev)
                for rec, groups in staged:
                    sc.add_flush(rec, groups)
                return sc.finish()

            if count().n_unique != n_distinct:
                raise AssertionError(f"{slots_log, max_chunks, bits}: wrong "
                                     "number of distinct k-mers")
            res["configs"].append(dict(
                slots_log=slots_log, max_chunks=max_chunks, bucket_bits=bits,
                kmers_per_s=n_windows / _best_s(count),
                router_windows_per_s=n_windows / route_s,
                groups_per_flush=tally["groups"] / tally["flushes"],
                group_chunks_per_flush=tally["group_chunks"]
                / tally["flushes"], **tally))
            if (slots_log, max_chunks, bits) == (
                    bucketed.SLOTS_LOG, bucketed.MAX_CHUNKS,
                    bucketed.BUCKET_BITS):
                sc = bucketed.BucketedCodeCounter(
                    K, initial_capacity=1 << 24, device=dev)
                sc.add_flush(*staged[0])
                _stages(staged[1][0], staged[1][1], sc.table)  # warm-up
                res["stages_ms"] = _stages(staged[1][0], staged[1][1],
                                           sc.table)
            del staged
        res["host_windows_per_s"] = _host_rates(fa, n_windows, dev)
    return res


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    res = run()
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(res["card"])
    line = json.dumps(res)
    print(line, flush=True)
    if argv:
        with open(argv[0], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
