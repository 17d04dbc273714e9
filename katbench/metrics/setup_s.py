"""setup_s: from the process's start to the end of the warm-up job
(import, CUDA init, inputs made from the seed, one whole job, and in a
fresh checkout the kernels' build)."""


def read(run):
    return run.setup_s
