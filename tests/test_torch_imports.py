"""kat_tpu_torch and chip_smoke.py import torch, never JAX and nothing of
kat_tpu: every import statement of every source file is read with `ast`.
(The path to kat_tpu/native/fastxio.cpp in io/native.py is a string, not an
import.)"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "kat_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "kat_tpu"}


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_and_no_kat_tpu_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_finds_imports():
    mods = set(_imported_modules(ROOT / "kat_tpu_torch" / "core" /
                                 "counting.py"))
    assert {"torch", "numpy"} <= mods
    assert len(SOURCES) > 25


def test_the_bucketed_slice_is_walked():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"kat_tpu_torch/core/minimizer.py", "kat_tpu_torch/core/bucketed.py",
            "kat_tpu_torch/benchmarks/profile_rounds.py"} <= rel


def test_the_gcp_comp_slice_is_walked():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"kat_tpu_torch/ops/binned_kernel.py",
            "kat_tpu_torch/core/comp_engine.py",
            "kat_tpu_torch/core/distance.py", "kat_tpu_torch/utils/fmt.py",
            "kat_tpu_torch/tools/gcp.py",
            "kat_tpu_torch/tools/comp.py"} <= rel


def test_the_cold_filter_slice_is_walked():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"kat_tpu_torch/tools/cold.py", "kat_tpu_torch/tools/filter_kmer.py",
            "kat_tpu_torch/tools/filter_seq.py",
            "kat_tpu_torch/benchmarks/sweep_lookup.py"} <= rel


def test_the_sharded_slice_is_walked():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"kat_tpu_torch/parallel/__init__.py",
            "kat_tpu_torch/parallel/sharded.py",
            "kat_tpu_torch/parallel/analysis.py",
            "kat_tpu_torch/parallel/longseq.py"} <= rel
