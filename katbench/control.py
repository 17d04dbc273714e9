"""The readings that the limits of `correct` are set from, at a cell's
own size, many seeds in one process (set-up is long):

    python3 -m katbench.control --workload <cell> --seeds 1 2 3 ... \
        [--control 3] [--out FILE]

For every seed it makes the cell's inputs, runs one whole job of the
program (the timed path) and holds it against the plain reference: the
lower readings.  For the first `--control` seeds it also puts the
control in the program's place: the reference counted with the forward
k-mer only, which breaks the configuration's canonical guarantee (the
step that would tempt a change to the extraction, which takes most of
the card's time): its readings have to fail.  One JSON line a seed and
side; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    from .harness import find_cell, root_dir
    from .job import Job

    p = argparse.ArgumentParser(prog="katbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("katbench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = find_cell(root_dir(), args.workload, False)
    lines = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        job = Job(cell.config, cell.mix, seed, dev)
        try:
            rec = job.run()
            job.release()
            torch.cuda.empty_cache()
            t1 = time.perf_counter()
            ref = job.reference_tables()
            got = job.check([rec], ref)
            t2 = time.perf_counter()
            lines.append({"workload": args.workload, "seed": seed,
                          "side": "program", "readings": got,
                          "job_s": rec.t1 - rec.t0, "reference_s": t2 - t1})
            print(json.dumps(lines[-1]), flush=True)
            del rec
            if i < args.control:
                ctrl = job.reference_tables(canonical=False)
                bad = job.check([job.kind.control_record(job, ctrl)], ref)
                lines.append({"workload": args.workload, "seed": seed,
                              "side": "control", "readings": bad})
                print(json.dumps(lines[-1]), flush=True)
                del ctrl
        finally:
            job.close()
        del job, ref
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
