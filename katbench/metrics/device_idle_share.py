"""device_idle_share: % of the traced job's span in which the card ran no
kernel, memset or copy (torch.profiler)."""


def read(run):
    t = run.trace
    if t is None or not t.events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
