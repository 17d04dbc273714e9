"""kat_tpu_torch/parallel/distributed.py against kat_tpu/parallel/
distributed.py: `shard_files`, `balanced_batches` and
`lockstep_code_batches` in one process and in 2 gloo processes on the CPU
(kat_tpu's multi-process forms run here with its process count and its
all_gather replaced by what the other process would send), the backend
rule, and `init_distributed`'s URLs.  Exact comparisons throughout."""

import numpy as np
import pytest

import torch_mp
from kat_tpu.parallel import distributed as jdist
from kat_tpu_torch.parallel import distributed, sharded

SHAPES = [[(4, 9), (3, 12), (4, 9)], [(2, 5), (4, 9)]]
SIZES = [5, 1, 9, 3, 7]


def _files(tmp_path):
    paths = []
    for i, n in enumerate(SIZES):
        p = tmp_path / f"f{i}"
        p.write_bytes(b"x" * n)
        paths.append(str(p))
    return paths


def test_without_a_group(tmp_path):
    paths = _files(tmp_path) + [str(tmp_path / "missing")]
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert distributed.shard_files(paths) == jdist.shard_files(paths)
    for count in (1, 2, 3, 4):
        for index in range(count):
            assert (distributed.shard_files(paths, index, count)
                    == jdist.shard_files(paths, index, count))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 5, s, dtype=np.uint8) for s in SHAPES[0]]
    got = list(distributed.lockstep_code_batches(iter(batches)))
    want = list(jdist.lockstep_code_batches(iter(batches)))
    assert all(g is w for g, w in zip(got, want)) and len(got) == 3
    even = [np.resize(b, (4, 9)) for b in batches]
    got = list(distributed.balanced_batches(even, 4, 9))
    assert all(np.array_equal(g, w) for g, w in
               zip(got, jdist.balanced_batches(even, 4, 9)))
    assert len(got) == 3
    mesh = distributed.global_mesh(3, devices=["cpu"])
    assert mesh == sharded.make_mesh(3, devices=["cpu"])
    assert (mesh.n, mesh.n_local, mesh.first, mesh.multiprocess) == \
        (3, 3, 0, False)


def _jax_as_process(monkeypatch, rank, streams):
    """kat_tpu's helpers as process `rank` of len(streams) would run them:
    its process count, and an all_gather that returns every process's
    value at this step (the others' from their own streams)."""
    from jax.experimental import multihost_utils

    step = {"i": 0}

    def allgather(x, tiled=False):
        x = np.asarray(x)
        if x.size == 1:  # balanced_batches: the batch counts
            return np.asarray([[len(s)] for s in streams])
        i = step["i"]
        step["i"] += 1
        rows = []
        for r, s in enumerate(streams):
            rows.append(x if r == rank else (
                [1, *s[i].shape] if i < len(s) else [0, 0, 0]))
        return np.asarray(rows, np.int64)

    monkeypatch.setattr(jdist, "process_count", lambda: len(streams))
    monkeypatch.setattr(jdist, "process_index", lambda: rank)
    monkeypatch.setattr(multihost_utils, "process_allgather", allgather)


def test_two_processes_match_kat_tpu(tmp_path, monkeypatch):
    paths = _files(tmp_path)
    res = torch_mp.run("lockstep", 2, tmp_path, SHAPES)
    streams = [r["mine"] for r in res]
    evens = [r["even"] for r in res]
    for rank, r in enumerate(res):
        assert (r["index"], r["count"]) == (rank, 2)
        assert r["shard"] == jdist.shard_files(paths, rank, 2)
        with monkeypatch.context() as mp:
            _jax_as_process(mp, rank, streams)
            want = list(jdist.lockstep_code_batches(iter(streams[rank])))
        assert len(r["steps"]) == len(want) == 3
        for g, w in zip(r["steps"], want):
            assert g.shape == w.shape and np.array_equal(g, w)
        with monkeypatch.context() as mp:
            _jax_as_process(mp, rank, evens)
            want = list(jdist.balanced_batches(evens[rank], 4, 9))
        assert len(r["balanced"]) == len(want) == 3
        for g, w in zip(r["balanced"], want):
            assert np.array_equal(g, w)
    # the lockstep geometry: the larger of the two shapes at each step,
    # 255 where a process had no data
    assert [s.shape for s in res[0]["steps"]] == [(4, 9), (4, 12), (4, 9)]
    assert (res[1]["steps"][2] == 255).all()
    assert (res[1]["steps"][0][2:] == 255).all()


@pytest.mark.parametrize("run", range(5))
def test_four_processes_exit_cleanly(tmp_path, run):
    """4 gloo processes gather uneven lists and rank 0 reaches its exit
    first; every worker leaves through distributed.shutdown and exits 0
    (before it did, a worker could die of SIGABRT in gloo's teardown).
    torch_mp.run fails on any worker that exits otherwise.  A smoke test
    of the exit path: the abort was intermittent, so five runs do not
    prove it gone; tests/torch_mp_stress.py counts it over many."""
    res = torch_mp.run("exit_early", 4, tmp_path, 0.3)
    want = [[10 * r + i for i in range(r + 1)] for r in range(4)]
    assert res == [want] * 4


def test_shutdown_without_a_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    distributed.shutdown()
    assert not dist.is_initialized()


@pytest.mark.parametrize("every,want", [
    (["cpu", "cpu"], "gloo"),
    (["GPU-a", "cpu"], "gloo"),
    (["GPU-a", "GPU-a"], "gloo"),
    (["GPU-a,GPU-b", "GPU-b"], "gloo"),
    (["GPU-a", "GPU-b"], "nccl"),
    (["GPU-a,GPU-b", "GPU-c,GPU-d"], "nccl"),
])
def test_the_backend_follows_the_topology(every, want):
    assert distributed.choose_backend(every)[0] == want


def test_init_distributed_in_one_process(tmp_path):
    """A world of one over a file:// store: the backend is gloo on the CPU,
    a second call changes nothing, and the mesh is the local one."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        url = f"file://{tmp_path}/store"
        assert distributed.init_distributed(url, 1, 0, device="cpu") == \
            "gloo"
        assert distributed.init_distributed(url, 1, 0) == "gloo"
        assert distributed.process_count() == 1
        assert distributed.gather_ints([3, 4]).tolist() == [[3, 4]]
        assert distributed.global_mesh(2, devices=["cpu"]) == \
            sharded.make_mesh(2, devices=["cpu"])
    finally:
        dist.destroy_process_group()
    assert distributed.process_count() == 1
