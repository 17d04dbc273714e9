"""Run one cell of the benchmark once and print its result line.

    python3 -m katbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, katbench/ and the
port (kat_tpu_torch/).  It needs as many CUDA cards as the cell asks for
and exits with another code than 0, printing no result, without them,
without the port, or if JAX or the JAX package (kat_tpu) was loaded.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
then `setup_parts` (set-up's seconds by phase) and `check_s` (the
comparison's seconds after the window), and last `checks` (each number
compared with the reference, beside its limit), which also close
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _fail(msg: str) -> int:
    print(f"katbench: {msg}", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="katbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from katbench import harness  # torch with it

    marks = [("imports", time.perf_counter())]
    root = harness.root_dir()
    # the program's build caches stay in the checkout, at fixed paths
    cache = os.path.join(root, ".katbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    spec = harness.find_cell(root, args.workload, bool(args.trace)).spec
    if not torch.cuda.is_available():
        return _fail("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < spec["chips"]:
        return _fail(f"the cell asks for {spec['chips']} cards, "
                     f"{torch.cuda.device_count()} visible")
    try:
        import kat_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port is not importable here: {e}")
    marks.append(("port", time.perf_counter()))

    out = harness.run_cell(root, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0), T_START,
                           marks)
    bad = harness.forbidden_modules()
    if bad:
        return _fail(f"modules loaded that the port must not load: {bad}")
    print("setup " + " ".join(f"{n} {v:.3f}"
                              for n, v in out["setup_parts"].items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
