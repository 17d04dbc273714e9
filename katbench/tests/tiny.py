"""A benchmark root of tiny cells for the CPU tests: the real
BENCHMARK.json with a tiny configuration and mixes added as files and
entries, the real job kinds and metric readers copied beside them."""

from __future__ import annotations

import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {"name": "tiny", "genome_len": 20000, "read_len": 150, "files": 2,
        "n_reads": 1001, "substitution_rate": 0.01, "mer_len": 27,
        "canonical": True, "hash_size": 100000000,
        "assembly_contig_len": 3000}
STAGED = {"rows": 64, "row_len": 256, "initial_capacity": 1024,
          "flush_windows": 16384}
MIXES = {
    "tiny_hist": {"job": "hist", **STAGED, "low": 1, "high": 10000,
                  "inc": 1},
    "tiny_hist_binned": {"job": "hist", **STAGED, "low": 2, "high": 100,
                         "inc": 3},
    "tiny_comp": {"job": "comp", **STAGED, "bins": 1001},
    "tiny_comp_bins": {"job": "comp", **STAGED, "bins": 40},
}
CELLS = {"tiny.hist": "tiny_hist", "tiny.hist_binned": "tiny_hist_binned",
         "tiny.comp": "tiny_comp", "tiny.comp_bins": "tiny_comp_bins"}
CPU = torch.device("cpu")


def make_root(tmp: str, extra_cells: dict | None = None) -> str:
    """tmp as a benchmark root holding the tiny cells (and extra ones:
    {cell: (config dict, mix dict)})."""
    kb = os.path.join(tmp, "katbench")
    os.makedirs(os.path.join(kb, "configs"))
    os.makedirs(os.path.join(kb, "traffic"))
    for d in ("metrics", "kinds"):
        shutil.copytree(os.path.join(REPO, "katbench", d),
                        os.path.join(kb, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {c: (TINY, MIXES[m], m) for c, m in CELLS.items()}
    for c, (cfg, mix) in (extra_cells or {}).items():
        cells[c] = (cfg, mix, c.replace(".", "_"))
    for cell, (cfg, mix, mix_name) in cells.items():
        path = os.path.join(kb, "configs", cfg["name"] + ".json")
        if not os.path.exists(path):
            with open(path, "w") as f:
                json.dump(cfg, f)
            bench["configs"].append({
                "name": cfg["name"], "source": "test", "reduced": [],
                "file": f"katbench/configs/{cfg['name']}.json", "why": "test"})
        with open(os.path.join(kb, "traffic", mix_name + ".json"), "w") as f:
            json.dump(mix, f)
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": mix_name, "chips": 1,
                                   "why": "test"})
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def run(root: str, cell: str, seed: int = 2**31 + 17, seconds: float = 0.2,
        trace: bool = False, device=CPU) -> dict:
    import time

    from katbench import harness

    return harness.run_cell(root, cell, seed, seconds, trace, device,
                            time.perf_counter())
