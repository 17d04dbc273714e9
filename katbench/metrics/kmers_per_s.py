"""kmers_per_s: the real k-mer windows of every input of every job that
the window completed, over the time from the window's start to the end of
its last job (all the work over all the time; not a median of jobs)."""


def read(run):
    return sum(r.windows for r in run.jobs) / run.window_s
