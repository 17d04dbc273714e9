"""`kat hist` of the staged reads: the batches counted as `Input.count`
counts them, `stats.hist_from_counts`, `Histogram.print_to`.

Traffic keys: `low`, `high`, `inc` (hist's -l, -h, -i).  Compared with the
reference: the last job's whole table and text, every job's histogram.
"""

import io
import os

import numpy as np

from katbench import job as base
from katbench import reference


def setup(job) -> None:
    pass


def run(job, rec, span) -> None:
    from kat_tpu_torch.core import stats
    from kat_tpu_torch.tools.hist import Histogram

    m = job.mix
    h = Histogram(job.labels, low=m["low"], high=m["high"], inc=m["inc"])
    h.quiet = True
    h.output_prefix = os.path.join(job.dir, "kat-hist")
    inp = h.input
    inp.mer_len, inp.canonical = job.k, job.canonical
    inp.hash_size, inp.device = job.cfg["hash_size"], job.dev
    with span("count"):
        inp.table = job.count(job.batches)
    with span("bin"):
        h.data = stats.hist_from_counts(
            inp.table.counts, h.base, h.ceil, h.inc,
            h.nb_buckets).cpu().numpy().astype(np.uint64)
    with span("artifact"):
        buf = io.StringIO()
        h.print_to(buf)
    rec.out["hist"] = np.asarray(h.data, np.int64)
    rec.heavy = {"table": inp.table, "text": buf.getvalue()}


def _text(job, h: np.ndarray) -> str:
    """What `kat hist` writes for these counts of the job's inputs."""
    m = job.mix
    return reference.hist_text(
        h, job.k, m["low"], m["inc"],
        " ".join(os.path.basename(n) for n in job.labels),
        " ".join(job.labels))


def check(job, recs, ref_reads, ref_asm) -> dict:
    m = job.mix
    last = recs[-1].heavy
    want = reference.histogram(ref_reads, m["low"], m["high"], m["inc"])
    got_lines = last["text"].split("\n")
    ref_lines = _text(job, want).split("\n")
    lines_wrong = sum(a != b for a, b in zip(got_lines, ref_lines)) \
        + abs(len(got_lines) - len(ref_lines))
    return {
        "table_mismatch": (base.table_mismatch(last["table"], ref_reads,
                                               job.k), 0),
        "hist_jobs_wrong": (sum(not np.array_equal(r.out["hist"], want)
                                for r in recs), 0),
        "hist_lines_wrong": (lines_wrong, 0)}


def control_record(job, ctrl) -> base.JobRecord:
    c_reads, _c_asm = ctrl
    m = job.mix
    h = reference.histogram(c_reads, m["low"], m["high"], m["inc"])
    rec = base.JobRecord(windows=job.windows)
    rec.out["hist"] = h
    rec.heavy = {"table": reference.as_table(c_reads), "text": _text(job, h)}
    return rec
