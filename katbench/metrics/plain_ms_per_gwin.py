"""plain_ms_per_gwin: device milliseconds of the traced job's card events
that are not a hand-written kernel of kat_tpu_torch/csrc (plain-torch
extraction, the flush's glue, copies), per 10^9 k-mer windows."""


def read(run):
    t = run.trace
    if t is None or not t.events:
        return None
    plain = sum(e.seconds for e in t.events if e.group is None)
    return 1e3 * plain / (run.traced_job.windows / 1e9)
