"""One run of one cell: set-up, the measured window, the traced job, the
comparison with the plain reference, and the result line.

Everything a cell is made of is found by name under the benchmark's root
(the directory that holds BENCHMARK.json): the cell in BENCHMARK.json's
`workloads`, its configuration at the `file` its `configs` entry names,
its traffic mix at katbench/traffic/<traffic>.json, the job kind that the
mix names at katbench/kinds/<job>.py (job.py), and each metric's reader
at katbench/metrics/<metric>.py (a `read(run)` that returns a number, or
None where it finds nothing to read).  A later cell, mix, kind or metric
is a file and an entry; no file here changes.

The window is a closed loop: whole jobs back to back, one in flight, as
one user runs `kat` on one data set at a time; after `seconds` it
finishes the job in flight.  Set-up (process start, inputs made from the
seed, one warm-up job, which builds the kernels in a fresh checkout) ends
before it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

import torch

from . import job as job_mod
from .trace import Trace, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "kat_tpu")


def root_dir() -> str:
    """The checkout's root: the directory above the katbench package."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict  # the workloads entry
    config: dict  # the configuration file's contents
    mix: dict  # the traffic file's contents
    metrics: list  # BENCHMARK.json metric entries this run reports


def find_cell(root: str, workload: str, trace: bool) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    spec = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if spec is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    mix = _load_json(os.path.join(root, "katbench", "traffic",
                                  spec["traffic"] + ".json"))
    pool = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = [m for m in pool if workload in m.get("workloads", [workload])]
    return Cell(workload, spec, config, mix, metrics)


def metric_reader(root: str, name: str):
    path = os.path.join(root, "katbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "katbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    job: job_mod.Job
    device: torch.device
    device_name: str
    setup_s: float
    jobs: list = field(default_factory=list)  # the window's JobRecords
    window_s: float = 0.0
    peak_bytes: int = 0
    trace: Trace | None = None
    traced_job: job_mod.JobRecord | None = None
    setup_parts: dict = field(default_factory=dict)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (kat_tpu_torch is not kat_tpu)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             marks: list | None = None) -> dict:
    """One run; returns the result line's object.  t_start: the run's
    first line on time.perf_counter()'s clock (the interpreter's own
    start, some 50 ms, is not counted); marks: [(phase, its end)] of the
    set-up before this call."""
    marks = [("start", t_start), *(marks or [])]
    cell = find_cell(root, workload, trace)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    torch.empty(1, device=device)  # the card's context
    sync()
    marks.append(("context", time.perf_counter()))
    job = job_mod.Job(cell.config, cell.mix, seed, device, root)
    try:
        marks.append(("inputs", time.perf_counter()))
        job.run()  # warm-up: every shape of the job, the kernels' build
        sync()
        marks.append(("warmup_job", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
        run = Run(cell, job, device, name, setup_s)
        # seconds of each phase of set-up, each named by what ends it
        run.setup_parts = {n: t - t0 for (_, t0), (n, t)
                           in zip(marks, marks[1:])}

        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        while True:
            if run.jobs:
                run.jobs[-1].heavy = None  # before the next job allocates
            run.jobs.append(job.run())
            if time.perf_counter() - t0 >= seconds:
                break
        run.window_s = run.jobs[-1].t1 - t0
        run.peak_bytes = (torch.cuda.max_memory_allocated(device)
                          if device.type == "cuda" else 0)
        done = list(run.jobs)
        if trace:
            run.jobs[-1].heavy = None
            with Tracer() as tr:
                run.traced_job = job.run(tracer=tr)
            run.trace = tr.result()
            done.append(run.traced_job)

        metrics = {}
        for m in cell.metrics:
            v = metric_reader(root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        t_check = time.perf_counter()
        job.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = job.check(done)
        check_s = time.perf_counter() - t_check
    finally:
        job.close()
    correct = all(v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": name, "count": int(cell.spec["chips"]),
           "memory_peak_bytes": int(run.peak_bytes)}
    failed = sum(v for n, (v, _lim) in checks.items()
                 if n.endswith("_jobs_wrong"))
    if not correct and failed == 0:
        failed = 1  # the last job's table or file is wrong
    out = {"correct": correct, "attempted": len(done), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops()[:10],
                            "idle_gaps": run.trace.idle_gaps()[:10]}
    out["setup_parts"] = run.setup_parts
    out["check_s"] = check_s
    out["checks"] = {n: {"value": v, "limit": lim}
                     for n, (v, lim) in checks.items()}
    return out

