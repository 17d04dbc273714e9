"""artifact_ms: host milliseconds of writing the job's text artifact
(`Histogram.print_to` / `save()`, `Comp.save()`), the median over the
window's jobs (katbench's own span)."""

import statistics


def read(run):
    ms = [1e3 * r.spans["artifact"] for r in run.jobs
          if "artifact" in r.spans]
    return statistics.median(ms) if ms else None
