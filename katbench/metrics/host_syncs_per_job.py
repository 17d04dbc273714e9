"""host_syncs_per_job: device-to-host copies in the traced job (every
`.item()`, `int(tensor)`, `.tolist()` and `.cpu()` of a card tensor, into
pinned or pageable memory: each is a read the host waits for).  A count
that repeats exactly from run to run."""


def read(run):
    t = run.trace
    if t is None or not t.events:
        return None
    return sum(1 for e in t.events if e.name.startswith("Memcpy DtoH"))
