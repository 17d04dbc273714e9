"""compare_ms: host milliseconds of `Comp.compare_tables` (the dual probe,
K4, the binned sums into the matrices), ending in a synchronise, the
median over the window's jobs (katbench's own span)."""

import statistics


def read(run):
    ms = [1e3 * r.spans["compare"] for r in run.jobs if "compare" in r.spans]
    return statistics.median(ms) if ms else None
