"""The port's mesh across processes (kat_tpu_torch/parallel/distributed.py
with sharded.py, analysis.py, longseq.py and tools/common.Input) in gloo
process groups on the CPU, against the port's single-process mesh and
kat_tpu's single-process results: histograms, finished tables, every
shard's table, routed lookups whose number differs by process, gcp, comp
with two and three inputs, the halo path, and `hist` through cli.main on
`shard://` files.  Every worker runs under tests/torch_mp.py's time limit.
Tolerance 0: keys and counts are integers."""

import re

import numpy as np
import pytest
import torch

import torch_mp
import torch_mp_workers as W
from kat_tpu import cli as jcli
from kat_tpu.core import counting as jcounting
from kat_tpu.core import wide as jwide
from kat_tpu.parallel import analysis as janalysis
from kat_tpu.parallel import sharded as jsharded
from kat_tpu_torch.core import kmers
from kat_tpu_torch.parallel import analysis, longseq, sharded

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs


def _single(k, n, batches, **kw):
    sc = sharded.ShardedCounter(sharded.make_mesh(n, devices=["cpu"]), k,
                                **kw)
    for b in batches:
        sc.add_codes(b)
    sc.check()
    return sc


def _jax(k, n, batches, **kw):
    jc = jsharded.ShardedCounter(jsharded.make_mesh(n), k, **kw)
    for b in batches:
        jc.add_codes(b)
    jc.check()
    return jc


def _jax_table(jc, k):
    """kat_tpu's finished table as (port keys, counts)."""
    t = jc.finish()
    if k <= kmers.MAX_K:
        keys, counts = jcounting.table_to_numpy(t)
        return keys.astype(np.int64), counts.astype(np.int64)
    words, counts = jwide.table_words_to_numpy(t)
    return kmers.from_ref_words(words, k), counts.astype(np.int64)


def _assert_table(got, want):
    keys, counts, n = got
    wk, wc = want[:2]
    assert n == wc.size
    assert np.array_equal(keys, wk) and np.array_equal(counts, wc)


def _arrays(table):
    return W.table_arrays(table)


@pytest.mark.parametrize("replay", [False, True])
def test_two_processes_of_two_shards_k15(tmp_path, replay):
    """2 processes x 2 CPU shards count the schedule's halves at k = 15:
    the histogram, finish() and every shard's table equal the port's mesh
    of 4 in one process and kat_tpu's; with small shards and route slack
    the flushes replay, in step, to the same capacity."""
    kw = (dict(shard_capacity=1 << 8, route_slack=0.25) if replay
          else dict(shard_capacity=1 << 12))
    res = torch_mp.run("count_hist", 2, tmp_path, 15, 2, 6, 32, kw)
    sched = W.schedule(6, 32)
    one = _single(15, 4, sched, **kw)
    jc = _jax(15, 4, sched, shard_capacity=1 << 12)
    want_hist = one.histogram(1, 1001, 1, 1002)
    assert np.array_equal(want_hist, jc.histogram(1, 1001, 1, 1002))
    want = _arrays(one.finish())
    _assert_table(want, _jax_table(jc, 15))
    shards = {}
    for r in res:
        assert r["hist"].dtype == np.uint64
        assert np.array_equal(r["hist"], want_hist)
        _assert_table(r["table"], want[:2])
        assert r["n_unique"] == one.n_unique.tolist()
        assert r["capacity"] == one.shard_capacity and r["dropped"] == 0
        shards.update(r["shards"])
    assert sorted(shards) == [0, 1, 2, 3]
    for s, t in enumerate(one.tables):
        _assert_table(shards[s], _arrays(t)[:2])
    if replay:
        assert one.shard_capacity > 1 << 8


def test_four_processes_uneven_batches_k33(tmp_path):
    """4 processes of one shard take 3/3/2/2 of 10 batches at k = 33 (wide
    keys across process boundaries); balanced_batches pads the short ones
    with empty batches.  Histogram and table equal one process's mesh of
    4 and kat_tpu's."""
    kw = dict(shard_capacity=1 << 12, route_slack=8.0)
    res = torch_mp.run("count_uneven", 4, tmp_path, 33, 1, 10, 16, kw)
    assert [r["n_batches"] for r in res] == [3, 3, 2, 2]
    sched = W.schedule(10, 16)
    one = _single(33, 4, sched, **kw)
    jc = _jax(33, 4, sched, **kw)
    want_hist = one.histogram(1, 1001, 1, 1002)
    assert np.array_equal(want_hist, jc.histogram(1, 1001, 1, 1002))
    want = _arrays(one.finish())
    _assert_table(want, _jax_table(jc, 33))
    for r in res:
        assert np.array_equal(r["hist"], want_hist)
        _assert_table(r["table"], want[:2])


def _tree_equal(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _tree_equal(got[key], want[key])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_equal(g, w)
    else:
        assert np.array_equal(np.asarray(got).astype(np.int64),
                              np.asarray(w_ := want).astype(np.int64)), w_


def test_routed_lookups_comp_gcp_and_halo_across_processes(tmp_path):
    """2 processes x 2 shards at k = 27: routed lookups of 700 and 1300
    queries (each process gets exactly its own counts), gcp, comp with two
    and three inputs and the halo path of one contig, equal to the port's
    single-process mesh of 4 and kat_tpu's."""
    m_each = [700, 1300]
    res = torch_mp.run("analysis", 2, tmp_path, 27, 2, 6, 32, m_each)
    sched = W.schedule(6, 32)
    one = [_single(27, 4, s, shard_capacity=1 << 12)
           for s in (sched, sched[::2], sched[1::3])]
    jcs = [_jax(27, 4, s, shard_capacity=1 << 12)
           for s in (sched, sched[::2], sched[1::3])]
    svc, jsvc = analysis.ShardedLookup(one[0]), janalysis.ShardedLookup(
        jcs[0])
    kw = dict(k=27, d1_bins=1001, d2_bins=1001, dm_size=1001, d1_scale=1.0,
              d2_scale=1.0, canon2=True, canon3=True)
    comp2 = W._np(analysis.comp_sharded(one[0], one[1], None, **kw))
    comp3 = W._np(analysis.comp_sharded(*one, sorted1=True, sorted2=True,
                                        sorted3=True, **kw))
    jcomp2 = janalysis.comp_sharded(jcs[0], jcs[1], None, **kw)
    _tree_equal(comp2[0], tuple(jcomp2[0]))
    _tree_equal(comp2[1], tuple(jcomp2[1]))
    gcp = analysis.gcp_sharded(one[0], 27, 100)
    assert np.array_equal(gcp, janalysis.gcp_sharded(jcs[0], 27, 100))
    contig = W.genome()[:3000].copy()
    contig[[17, 1500]] = 4
    halo = longseq.sharded_window_profile_routed(one[0], contig, 27, True)
    for rank, r in enumerate(res):
        q = W.queries(rank, 27, m_each[rank])
        want = svc.lookup(q).numpy()
        assert r["lookup"].shape == (m_each[rank],)
        assert np.array_equal(r["lookup"], want)
        jwant = jsvc.lookup(list(kmers.to_planes(q.numpy())))
        assert np.array_equal(want.astype(np.int64), jwant.astype(np.int64))
        assert (want > 0).sum() > m_each[rank] // 4
        assert np.array_equal(r["gcp"], gcp)
        _tree_equal(r["comp2"], comp2)
        _tree_equal(r["comp3"], comp3)
        assert np.array_equal(r["halo"][0], halo[0])
        assert np.array_equal(r["halo"][1], halo[1])


def _write_fastq(path, reads):
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            s = np.frombuffer(b"ACGTN", np.uint8)[r].tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))


def _untimed(stdout: str) -> str:
    return re.sub(r"(Time taken|Total runtime): [0-9.]+s", "", stdout)


def test_cli_hist_on_shard_files_across_processes(tmp_path, monkeypatch):
    """`hist shard://<dir>/r{1,2}.fq` through cli.main in 2 processes (one
    CPU shard each; the files, of 300 and 200 reads, split one a process):
    every process writes the same .hist and stdout (but its times), equal
    to one process's `--shards 2 hist` of the same pattern and to
    kat_tpu's hist of the two files."""
    sched = W.schedule(2, 300)
    _write_fastq(tmp_path / "r1.fq", sched[0])
    _write_fastq(tmp_path / "r2.fq", sched[1][:200])
    pattern = f"shard://{tmp_path}/r{{1,2}}.fq"
    argv = ["--device", "cpu", "hist", "-m", "27", pattern]
    res = torch_mp.run("cli", 2, tmp_path / "two", argv, "h")
    one = torch_mp.run("cli", 1, tmp_path / "one",
                       ["--device", "cpu", "--shards", "2", *argv[2:]],
                       "h")[0]
    monkeypatch.setattr(jcli, "_plot", lambda *a, **kw: None)
    monkeypatch.setattr(jcli, "_analyse_peaks", lambda *a, **kw: None)
    jout = tmp_path / "j.hist"
    assert jcli.main(["hist", "-m", "27", "-o", str(jout),
                      str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]) == 0
    want = jout.read_bytes()
    assert one[0] == 0 and one[2][""] == want
    for rc, out, files, calls in res:
        assert rc == 0 and files[""] == want
        assert _untimed(out) == _untimed(res[0][1]) == _untimed(one[1])
        assert calls == one[3] == [("plot", "spectra-hist"), ("peaks",)]
    assert want.count(b"\n") > 6
