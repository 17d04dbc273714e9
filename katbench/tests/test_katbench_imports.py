"""Nothing katbench loads has the top-level name jax, jaxlib, flax or
kat_tpu (compared whole: kat_tpu_torch is the port), and katbench reads
none of the JAX package's benchmark files."""

import os
import subprocess
import sys

from katbench import harness
from katbench.tests.tiny import REPO

SCRIPT = """
import json, sys, tempfile, torch
sys.path.insert(0, {repo!r})
torch.set_num_threads(1)
from katbench.tests import tiny
from katbench import harness, control, reference
root = tiny.make_root(tempfile.mkdtemp())
outs = [tiny.run(root, c, trace=t) for c in sorted(tiny.CELLS)
        for t in (False, True)]
print(json.dumps({{"correct": [o["correct"] for o in outs],
                   "bad": harness.forbidden_modules(),
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_and_no_kat_tpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=REPO)], capture_output=True,
        text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(got["correct"])
    assert got["bad"] == []
    assert "kat_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "kat_tpu"} & set(got["top"])


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("kat_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    before = harness.forbidden_modules()
    assert "kat_tpu" not in before and "jax" not in before
    monkeypatch.setitem(sys.modules, "kat_tpu.core", sys)
    assert "kat_tpu" in harness.forbidden_modules()


def test_katbench_reads_no_jax_benchmark_file():
    words = ("bench.py", "BENCH_", "kat_tpu_torch.benchmarks",
             "import jax", "from jax", "import kat_tpu\n", "from kat_tpu ",
             "from kat_tpu.")
    top = os.path.join(REPO, "katbench")
    for dirpath, _dirs, files in os.walk(top):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert not [w for w in words if w in src], f
