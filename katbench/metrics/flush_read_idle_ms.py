"""flush_read_idle_ms: milliseconds of the traced job's card idle gaps
that follow the flush's synchronous read of K3's run count: each gap that
begins where a device-to-host copy launched inside a `kat.read.n_unique`
span ends (katbench/program_trace.py).  The host waits on that copy, so
the card has nothing queued behind it until the host has read, returned
and launched again.  Gaps between kernels queued before the read, which
the card runs while the host waits, are not the read's."""

from katbench import program_trace

READ = "kat.read.n_unique"


def read(run):
    t = program_trace.of(run)
    if t is None or not t.events or not any(
            n == READ for n, _a, _b in t.program_spans):
        return None
    return 1e3 * sum(
        s for _start, s, last in t.gaps() if last is not None
        and last.name.startswith("Memcpy DtoH")
        and t.launch_span(last) == READ)
