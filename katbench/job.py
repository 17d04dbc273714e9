"""A cell's inputs and its job, whose kind the traffic mix names.

A traffic file (katbench/traffic/<mix>.json) gives `job`, the name of a
job kind, and the job's parameters.  A kind is a file of its own,
katbench/kinds/<job>.py, found by that name, so a later kind is a new
file and no file here changes.  It holds four functions:

    setup(job)                        inputs beyond the reads (set-up)
    run(job, rec, span)               one whole job of the program
    check(job, recs, ref_reads, ref_asm) -> {name: (number, limit)}
    control_record(job, ctrl)         the control's outputs as a JobRecord

A Job makes the reads once (`__init__`, set-up): a genome from the seed
and its reads packed as the port's native reader packs them, staged on
the card.  It runs whole jobs (`run`) and, after the window, counts the
reads again with the plain reference (`reference_tables`) for the kind's
`check`.

Every job records host spans around its calls into the program (count,
bin, compare, artifact; `job` around all of it).  In the traced job each
span is also a torch.profiler range and ends in a synchronise, so the
card's work of a span lies inside it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import re
import shutil
import time
from dataclasses import dataclass, field

import torch

from . import reads, reference
from .trace import SPAN_PREFIX, Tracer, flush_calls


def _root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kind_module(name: str, root: str | None = None):
    """The job kind katbench/kinds/<name>.py under the benchmark's root."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"no job kind {name!r}")
    path = os.path.join(root or _root(), "katbench", "kinds", name + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no job kind {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location("katbench_kind_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _next_pow2(n: int) -> int:
    return 1 << max(1, (max(int(n), 2) - 1).bit_length())


@dataclass
class JobRecord:
    """One job: when it ran, its spans (seconds), the k-mer windows it
    counted, small outputs kept for every job, and the last job's large
    ones (`heavy`, dropped before the next job starts)."""
    t0: float = 0.0
    t1: float = 0.0
    windows: int = 0
    spans: dict = field(default_factory=dict)
    out: dict = field(default_factory=dict)
    heavy: dict | None = None


class _Spans:
    def __init__(self, rec: JobRecord, dev: torch.device, traced: bool):
        self.rec, self.dev, self.traced = rec, dev, traced

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(SPAN_PREFIX + name)
               if self.traced else contextlib.nullcontext())
        with ctx:
            yield
            if (sync or self.traced) and self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        self.rec.spans[name] = (self.rec.spans.get(name, 0.0)
                                + time.perf_counter() - t0)


class Job:
    """cfg: the configuration file's contents; mix: the traffic file's;
    root: the benchmark's root, where the kind is found."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device,
                 root: str | None = None):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.kind = kind_module(mix["job"], root)
        self.k = cfg["mer_len"]
        self.canonical = cfg["canonical"]
        self.genome = reads.genome(cfg, seed, dev)
        self.windows = cfg["n_reads"] * (cfg["read_len"] - self.k + 1)
        self.batches = reads.stage_reads(cfg, seed, self.genome, self.k,
                                         mix["rows"], mix["row_len"])
        self.labels = [f"reads_{i + 1}.fq" for i in range(cfg["files"])]
        self.asm = None  # an assembly's contigs, where the kind makes one
        self.dir = reads.scratch_dir()
        self.kind.setup(self)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(self, tracer: Tracer | None = None) -> JobRecord:
        """One whole job."""
        from kat_tpu_torch.core import counting

        rec = JobRecord(windows=self.windows)
        span = _Spans(rec, self.dev, tracer is not None)
        wrap = (flush_calls(counting, tracer) if tracer is not None
                else contextlib.nullcontext())
        rec.t0 = time.perf_counter()
        with wrap, span("job"):
            self.kind.run(self, rec, span)
        rec.t1 = time.perf_counter()
        return rec

    def count(self, batches):
        """The batches counted as `Input.count` counts them
        (kat_tpu_torch/tools/common.py): start at the mix's slots, grow up
        to the user's hash size, flush every `flush_windows` windows."""
        from kat_tpu_torch.core import counting

        h = self.cfg["hash_size"]
        cap0 = self.mix["initial_capacity"]
        sc = counting.CodeStreamingCounter(
            self.k, self.canonical, initial_capacity=min(cap0, _next_pow2(h)),
            max_capacity=max(_next_pow2(h), cap0),
            flush_windows=self.mix["flush_windows"], device=self.dev)
        for b in batches:
            sc.add_codes(b)
        return sc.finish()

    # -- after the window ----------------------------------------------------
    def release(self) -> None:
        """Drop the staged inputs (the reference needs the memory)."""
        self.batches = None
        self.asm_batches = None

    def _read_blocks(self):
        for f in range(self.cfg["files"]):
            yield from reads.read_blocks(self.cfg, self.seed, self.genome, f)

    def _asm_blocks(self, per_block: int = 256):
        by_len: dict[int, list] = {}
        for p in self.asm:
            by_len.setdefault(len(p), []).append(p)
        for ps in by_len.values():
            for i in range(0, len(ps), per_block):
                yield torch.stack(ps[i:i + per_block])

    def reference_tables(self, canonical: bool | None = None):
        """The plain reference's counts of the reads (and the assembly)."""
        canon = self.canonical if canonical is None else canonical
        r = reference.count(self._read_blocks(), self.k, canon)
        a = (reference.count(self._asm_blocks(), self.k, canon)
             if self.asm is not None else None)
        return r, a

    def check(self, recs: list[JobRecord], ref=None) -> dict:
        """{name: (number, limit)} of the comparison with the reference.
        recs: every job after set-up, the last holding its `heavy`; ref:
        reference_tables() (the control passes its own)."""
        ref_reads, ref_asm = ref if ref is not None else \
            self.reference_tables()
        return self.kind.check(self, recs, ref_reads, ref_asm)

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def table_mismatch(table, ref, k: int) -> int:
    """Keys of the program's table (keys, counts, n_unique) that differ
    from the reference's, either way."""
    n = table.n_unique
    return reference.table_mismatch(table.keys[:n], table.counts[:n], ref, k)
