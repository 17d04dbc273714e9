"""The plain reference against brute-force Python counts at tiny sizes,
and its artifacts against the port's writers' formats."""

import io

import numpy as np
import pytest
import torch

from katbench import reference

torch.set_num_threads(1)


def _brute(rows, k, canonical=True) -> dict:
    cnt: dict = {}
    for row in rows:
        for s in range(len(row) - k + 1):
            w = row[s:s + k]
            if any(c >= 4 for c in w):
                continue
            f = 0
            for c in w:
                f = f * 4 + c
            if canonical:
                r = 0
                for c in reversed(w):
                    r = r * 4 + (3 - c)
                f = min(f, r)
            cnt[f] = cnt.get(f, 0) + 1
    return cnt


def _blocks(seed, shapes, invalid=0.02):
    g = torch.Generator().manual_seed(seed)
    out = []
    for n, L in shapes:
        c = torch.randint(0, 4, (n, L), generator=g, dtype=torch.uint8)
        bad = torch.rand((n, L), generator=g) < invalid
        out.append(torch.where(bad, 4, c).to(torch.uint8))
    return out


def _as_dict(parts) -> dict:
    d = {}
    for p in parts:
        if p is not None:
            d.update(zip(p[0].tolist(), p[1].tolist()))
    return d


@pytest.mark.parametrize("k", [3, 5, 11, 27, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_count_equals_a_dictionary_count(k, canonical):
    blocks = _blocks(k, [(40, 60), (7, 33), (1, 200)])
    want = {}
    for b in blocks:
        for key, v in _brute(b.tolist(), k, canonical).items():
            want[key] = want.get(key, 0) + v
    parts = reference.count(iter(blocks), k, canonical)
    assert _as_dict(parts) == want
    for p in parts:  # each range sorted, unique
        if p is not None:
            assert torch.all(p[0][1:] > p[0][:-1])


def test_table_mismatch_counts_each_wrong_key():
    parts = reference.count(iter(_blocks(1, [(30, 80)])), 9)
    keys = torch.cat([p[0] for p in parts if p is not None])
    counts = torch.cat([p[1] for p in parts if p is not None]).to(torch.int32)
    assert reference.table_mismatch(keys, counts, parts, 9) == 0
    c2 = counts.clone()
    c2[5] += 1
    assert reference.table_mismatch(keys, c2, parts, 9) == 1
    drop = torch.cat([keys[:3], keys[4:]]), torch.cat([counts[:3], counts[4:]])
    assert reference.table_mismatch(*drop, parts, 9) == 1
    extra = (torch.cat([keys[:1] - 1, keys]) if keys[0] > 0 else None)
    if extra is not None:
        assert reference.table_mismatch(
            extra, torch.cat([counts[:1], counts]), parts, 9) == 1


def test_histogram_and_text_match_the_ports_writer():
    from kat_tpu_torch.tools.hist import Histogram

    parts = reference.count(iter(_blocks(2, [(50, 120)], 0.0)), 7)
    counts = torch.cat([p[1] for p in parts if p is not None])
    for low, high, inc in ((1, 10000, 1), (3, 50, 2), (1, 5, 1)):
        h = reference.histogram(parts, low, high, inc)
        tool = Histogram(["a/x.fq", "b/y.fq"], low=low, high=high, inc=inc)
        base, ceil = tool.base, tool.ceil
        want = np.zeros(tool.nb_buckets, np.int64)
        for c in counts.tolist():
            b = 0 if c < base else (tool.nb_buckets - 1 if c > ceil
                                    else (c - base) // inc)
            want[b] += 1
        np.testing.assert_array_equal(h, want)
        tool.input.mer_len = 7
        tool.data = want.astype(np.uint64)
        buf = io.StringIO()
        tool.print_to(buf)
        assert reference.hist_text(h, 7, low, inc, "x.fq y.fq",
                                   "a/x.fq b/y.fq") == buf.getvalue()


def test_comp_outputs_equal_a_dictionary_comparison():
    reads = _blocks(3, [(60, 40)], 0.0)
    asm = _blocks(4, [(2, 300)], 0.0)
    k, bins = 5, 7
    r = reference.count(iter(reads), k)
    a = reference.count(iter(asm), k)
    got = reference.comp_outputs(r, a, bins, bins)
    dr, da = _as_dict(r), _as_dict(a)
    mx = np.zeros((bins, bins), np.int64)
    for key, c1 in dr.items():
        mx[min(c1, bins - 1), min(da.get(key, 0), bins - 1)] += 1
    for key, c2 in da.items():
        if key not in dr:
            mx[0, min(c2, bins - 1)] += 1
    np.testing.assert_array_equal(got["main"], mx)
    shared = dr.keys() & da.keys()
    c = got["counters"]
    assert c["hash1_total"] == sum(dr.values())
    assert c["hash2_distinct"] == len(da)
    assert c["shared_distinct"] == len(shared)
    assert c["shared_hash2_total"] == sum(da[x] for x in shared)
    assert c["hash1_only_distinct"] == len(dr) - len(shared)
    assert c["hash2_only_total"] == sum(v for x, v in da.items()
                                        if x not in dr)
    sp = np.zeros(bins, np.int64)
    for x in shared:
        sp[min(da[x], bins - 1)] += 1
    np.testing.assert_array_equal(got["shared_spectrum2"], sp)


def test_parse_matrix_reads_the_ports_matrix_file():
    from kat_tpu_torch.core.matrix import Matrix

    m = np.arange(12, dtype=np.uint64).reshape(3, 4)
    buf = io.StringIO()
    buf.write("# Title:x\n###\n")
    Matrix(m).print_matrix(buf)
    np.testing.assert_array_equal(reference.parse_matrix(buf.getvalue()),
                                  m.astype(np.int64))


def test_reference_imports_nothing_of_the_program():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(reference))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "numpy", "torch", "types"}
