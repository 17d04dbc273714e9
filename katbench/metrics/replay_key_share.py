"""replay_key_share: % of the keys merged and reduced (K2, K3) in a job
that went through a growth replay: 100 x replayed_keys / merged_keys of
the program's counters (katbench/program_trace.py; every job of a run
counts the same reads, so the share over the run's jobs is the traced
job's).  A count that repeats exactly for a seed."""

from katbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None or not t.counters.get("merged_keys"):
        return None
    return 100.0 * t.counters["replayed_keys"] / t.counters["merged_keys"]
