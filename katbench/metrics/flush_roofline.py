"""flush_roofline: % of its roofline that the counting flush's kernels
(K1 sort, K2 merge, K3 reduce, with their scratch memsets) reach in the
traced job: the least time, the bytes their calls need (every input byte
read once, every output byte written once, counted by katbench around the
calls into ops) at the card's published bandwidth, over their device
time in the job's counting spans."""

from katbench import peaks, trace


def read(run):
    t = run.trace
    bw = peaks.hbm_bytes_per_s(run.device_name)
    if t is None or bw is None or not t.flush_bytes:
        return None
    counting = {n for n, _a, _b in t.spans if n.startswith("count")}
    dev = sum(e.seconds for e in t.in_spans(counting)
              if e.group in trace.FLUSH_GROUPS)
    if dev <= 0:
        return None
    least = sum(b for _kind, b in t.flush_bytes) / bw
    return 100.0 * least / dev
