"""extract_ms_per_gwin: device milliseconds of the card events that the
program launched inside its `kat.extract` spans (the upload and
`core/kmers.extract_kmers`, from `add_codes`), per 10^9 k-mer windows of
the job (katbench/program_trace.py reads them from the traced job)."""

from katbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None:
        return None
    evs = t.launched_in("kat.extract")
    if not evs:
        return None
    return 1e3 * sum(e.seconds for e in evs) / (run.job.windows / 1e9)
