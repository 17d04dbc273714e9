"""kat_tpu_torch and chip_smoke.py import torch, never JAX and nothing of
kat_tpu: every import statement of every source file is read with `ast`.
Nor do they reach into kat_tpu's files by path (the native reader is the
port's own copy, kat_tpu_torch/native/fastxio.cpp): no string constant
outside a docstring is a path inside kat_tpu/, and no path is built from a
"kat_tpu" component.  A `file:line` citation of a TPU kernel, which
chip_smoke.py's kernel line carries in its "replaces" field, names a place
in the reference rather than a file to open, and passes."""

import ast
import pathlib
import re

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



def test_the_analysis_plot_and_jellyfish_slice_is_walked():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    assert {"kat_tpu_torch/analysis/distanalysis.py",
            "kat_tpu_torch/analysis/spectra.py",
            "kat_tpu_torch/analysis/peak.py",
            "kat_tpu_torch/analysis/spectra_helper.py",
            "kat_tpu_torch/plot/__init__.py", "kat_tpu_torch/plot/misc.py",
            "kat_tpu_torch/plot/cold.py", "kat_tpu_torch/plot/density.py",
            "kat_tpu_torch/plot/profile.py",
            "kat_tpu_torch/plot/spectra_cn.py",
            "kat_tpu_torch/plot/spectra_hist.py",
            "kat_tpu_torch/plot/spectra_mx.py",
            "kat_tpu_torch/jf_cli.py"} <= rel


# a path string: no whitespace, kat_tpu as one of its components, and no
# ":<line>" citation at its end
_KAT_TPU_PATH = re.compile(r"^(?:[^\s]*/)?kat_tpu(?:/[^\s]*)?$")
_CITATION = re.compile(r":\d+(?:-\d+)?$")
# the format name kat_tpu writes into its checkpoint manifests
# (io/checkpoint.py writes the same): compared as a string, never opened
_FORMAT_NAMES = {"kat_tpu/count_table"}
_PATH_CALLS = {"join", "Path", "PurePath", "joinpath", "abspath", "open",
               "realpath", "normpath"}


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                yield first.value


def _paths_into_kat_tpu(source: str, name: str = "<src>"):
    """(line, value) of every string constant that names a path inside
    kat_tpu/: a path-like constant whose components include kat_tpu, or a
    "kat_tpu" component handed to a path-building call or `/`."""
    tree = ast.parse(source, name)
    docs = {id(d) for d in _docstrings(tree)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs and node.value != "kat_tpu"
                and node.value not in _FORMAT_NAMES
                and _KAT_TPU_PATH.match(node.value)
                and not _CITATION.search(node.value)):
            yield node.lineno, node.value
        parts = []
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) \
                in _PATH_CALLS:
            parts = node.args
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            parts = [node.left, node.right]
        for a in parts:
            if isinstance(a, ast.Constant) and a.value == "kat_tpu":
                yield a.lineno, a.value


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_path_into_kat_tpu(path):
    bad = list(_paths_into_kat_tpu(path.read_text(), str(path)))
    assert not bad, f"{path.relative_to(ROOT)} names kat_tpu paths {bad}"


def test_the_path_walk_finds_paths():
    """The walk flags the way io/native.py once built kat_tpu's reader by
    path, and a path constant, and passes citations, docstrings and the
    .jf header's exe_path and the checkpoint manifest's format name."""
    flagged = list(_paths_into_kat_tpu(
        'import os\n'
        '_SRC = os.path.join(ROOT, "kat_tpu", "native", "fastxio.cpp")\n'
        'B = ROOT / "kat_tpu" / "native"\n'
        'C = "kat_tpu/native/fastxio.cpp"\n'
        'D = "/repo/kat_tpu/ops"\n'))
    assert sorted(ln for ln, _v in flagged) == [2, 3, 4, 5]
    assert not list(_paths_into_kat_tpu(
        '"""Port of kat_tpu/cli.py."""\n'
        'R = "kat_tpu/ops/sort_kernel.py:182"\n'
        'S = ("kat_tpu/ops/sort_kernel.py:182 + "\n'
        '     "kat_tpu/ops/reduce_kernel.py:147")\n'
        'H = {"exe_path": "kat_tpu"}\n'
        'F = {"format": "kat_tpu/count_table"}\n'
        'T = "kat_tpu_torch/csrc/sort.cu"\n'))


def test_the_port_builds_its_own_reader():
    from kat_tpu_torch.io import native

    src = pathlib.Path(native._SRC).resolve()
    assert src == ROOT / "kat_tpu_torch" / "native" / "fastxio.cpp"
    assert src.is_file()
