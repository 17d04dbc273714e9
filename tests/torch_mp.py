"""Run a function of tests/torch_mp_workers.py in N processes of one gloo
group on the CPU, each with a time limit, and collect what each returned.

Every worker is a fresh `python -c` process: it starts the group through
kat_tpu_torch.parallel.distributed.init_distributed with a `file://` store
in the test's temporary directory (no port numbers), calls
`torch_mp_workers.<name>(rank, nproc, tmp, *args)` and pickles the result.
A worker that fails or outlives `timeout` fails the test, and every worker
still running is killed, so nothing can hang the suite.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

BOOT = """
import json, pickle, sys
name, nproc, rank, tmp, args, root, tests, device = sys.argv[1:9]
sys.path[:0] = [root, tests]
import torch
torch.set_num_threads(1)
from kat_tpu_torch.parallel import distributed
nproc, rank = int(nproc), int(rank)
if nproc > 1:
    distributed.init_distributed(f"file://{tmp}/store", nproc, rank,
                                 device=device)
import torch_mp_workers
out = getattr(torch_mp_workers, name)(rank, nproc, tmp, *json.loads(args))
with open(f"{tmp}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def run(name: str, nproc: int, tmp, *args, timeout: float = 240,
        device: str = "cpu") -> list:
    """[worker rank r's return value for r in range(nproc)].  device is
    what the workers tell init_distributed ("cpu": gloo; "cuda": the
    backend that their cards allow)."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTEST_CURRENT_TEST", None)
    logs = [open(os.path.join(tmp, f"log{r}.txt"), "w+")
            for r in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", BOOT, name, str(nproc), str(r), tmp,
         json.dumps(list(args)), ROOT, TESTS, device],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if failed is not None:
        raise AssertionError(f"{name}: worker {failed} failed "
                             f"({procs[failed].returncode}):\n"
                             f"{texts[failed][-6000:]}")
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f"{name}: a worker outlived {timeout} s:\n"
                             + "\n".join(t[-2000:] for t in texts))
    res = []
    for r in range(nproc):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res
