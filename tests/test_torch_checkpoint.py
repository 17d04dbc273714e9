"""The port's sharded checkpoints (kat_tpu_torch/io/checkpoint.py) against
kat_tpu's (kat_tpu/io/checkpoint.py): round trips of narrow and wide
tables, shards that are disjoint and owned by the mesh's hash, a manifest
of another format refused, a manifest or shard whose `key_words`
disagrees with k refused by every loader, checkpoints written by either
package loaded by the other, and a counter saved by 2 gloo processes
loaded in one process and in two.  Tolerance 0: keys and counts are integers."""

import json
import os

import numpy as np
import pytest
import torch

import torch_mp
import torch_mp_workers as W
from kat_tpu.core import counting as jcounting
from kat_tpu.core import wide as jwide
from kat_tpu.io import checkpoint as jckpt
from kat_tpu.parallel import sharded as jsharded
from kat_tpu_torch.core import counting, kmers, wide
from kat_tpu_torch.io import checkpoint
from kat_tpu_torch.parallel import sharded

torch.set_num_threads(1)  # pytest-xdist workers share the CPUs

CPU = torch.device("cpu")
KS = (27, 41, 63)


def _tables(k, n=3000, seed=0):
    """The same random table in both packages: (port table, kat_tpu table,
    sorted port keys, counts)."""
    rng = np.random.default_rng(seed + k)
    counts = rng.integers(1, 1 << 20, n).astype(np.int64)
    if k <= kmers.MAX_K:
        keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.int64))
        counts = counts[:keys.size]
        t = counting.table_from_numpy(keys, counts, device=CPU)
        j = jcounting.table_from_numpy(keys.astype(np.uint64),
                                       counts.astype(np.uint32))
        return t, j, keys, counts
    ints = sorted({int.from_bytes(rng.bytes(32), "little") % (4 ** k)
                   for _ in range(n)})
    words = kmers.ints_to_words(ints, k)
    counts = counts[:len(ints)]
    t = wide.table_from_words(words, counts, device=CPU)
    j = jwide.table_from_words(kmers.to_ref_words(words, k),
                               counts.astype(np.uint32))
    return t, j, words, counts


def _port_arrays(table):
    n = table.n_unique
    return (table.keys[..., :n].numpy(),
            table.counts[:n].numpy().astype(np.int64))


def _jax_arrays(table, k):
    if k <= kmers.MAX_K:
        keys, counts = jcounting.table_to_numpy(table)
        return keys.astype(np.int64), counts.astype(np.int64)
    words, counts = jwide.table_words_to_numpy(table)
    return kmers.from_ref_words(words, k), counts.astype(np.int64)


def _equal(got, want):
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_shards", [1, 4])
def test_round_trip_and_disjoint_shards(tmp_path, k, n_shards):
    t, _j, keys, counts = _tables(k)
    path = str(tmp_path / "ck")
    checkpoint.save_table(path, t, k, True, n_shards=n_shards)
    got, m = checkpoint.load_table(path, device=CPU)
    _equal(_port_arrays(got), (keys, counts))
    assert m["k"] == k and m["n_shards"] == n_shards
    assert m["n_unique"] == counts.size and m["total"] == counts.sum()
    assert m["key_words"] == (2 if k <= 31 else kmers.ref_words_for_k(k))
    seen = 0
    for s in range(n_shards):
        sk, sc = checkpoint.load_shard(path, s)
        seen += sc.size
        if n_shards > 1:
            owner = sharded.owner_shard_np(checkpoint._from_file(sk, k), k,
                                           n_shards)
            assert (owner == s).all()
    assert seen == counts.size


@pytest.mark.parametrize("k", KS)
def test_kat_tpu_checkpoint_loads_in_the_port_and_back(tmp_path, k):
    t, j, keys, counts = _tables(k, seed=5)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_table(jpath, j, k, True, n_shards=3)
    checkpoint.save_table(tpath, t, k, True, n_shards=3)
    assert json.load(open(os.path.join(jpath, "manifest.json"))) == \
        json.load(open(os.path.join(tpath, "manifest.json")))
    for s in range(3):
        a, b = jckpt.load_shard(jpath, s), checkpoint.load_shard(tpath, s)
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
        assert np.array_equal(np.sort(a[0], axis=0), np.sort(b[0], axis=0))
        assert np.array_equal(np.sort(a[1]), np.sort(b[1]))
    got, _m = checkpoint.load_table(jpath, device=CPU)
    _equal(_port_arrays(got), (keys, counts))
    back, _m = jckpt.load_table(tpath)
    _equal(_jax_arrays(back, k), (keys, counts))


def test_a_manifest_of_another_format_is_refused(tmp_path):
    t, _j, _keys, _counts = _tables(27, n=100)
    path = str(tmp_path / "ck")
    checkpoint.save_table(path, t, 27, True, n_shards=2)
    mf = os.path.join(path, "manifest.json")
    m = json.load(open(mf))
    m["format"] = "something/else"
    json.dump(m, open(mf, "w"))
    for load in (lambda: checkpoint.load_table(path, device=CPU),
                 lambda: checkpoint.load_shard(path, 0),
                 lambda: checkpoint.load_sharded_counter(
                     path, sharded.make_mesh(2, devices=["cpu"]))):
        with pytest.raises(ValueError, match="not a kat_tpu count-table"):
            load()
    m["format"] = "kat_tpu/count_table"
    m["shard_hash"] = "raw-fmix32-v2"
    json.dump(m, open(mf, "w"))
    with pytest.raises(ValueError, match="mis-route"):
        checkpoint.load_shard(path, 0)
    with pytest.raises(ValueError, match="shards but the mesh has"):
        checkpoint.load_sharded_counter(
            path, sharded.make_mesh(3, devices=["cpu"]))


LOADERS = {
    "load_table": lambda p: checkpoint.load_table(p, device=CPU),
    "load_sharded_counter": lambda p: checkpoint.load_sharded_counter(
        p, sharded.make_mesh(1, devices=["cpu"])),
    "load_shard": lambda p: checkpoint.load_shard(p, 0),
}


def _raw_checkpoint(path, k, words, **manifest):
    """A one-shard checkpoint written by hand: 3 keys of `words` uint32
    words (1-D uint64 keys when words is None) under a manifest of
    kat_tpu's format with `manifest` merged over its fields."""
    os.makedirs(path)
    rng = np.random.default_rng(k)
    keys = (rng.integers(0, 1 << 40, 3).astype(np.uint64) if words is None
            else rng.integers(0, 1 << 30, (3, words)).astype(np.uint32))
    np.savez_compressed(os.path.join(path, "shard_00000.npz"), keys=keys,
                        counts=np.ones(3, np.uint32))
    m = {"format": "kat_tpu/count_table", "version": 3, "k": k,
         "canonical": True, "n_shards": 1,
         "shard_hash": checkpoint.SHARD_HASH_ID, "n_unique": 3, "total": 3}
    m.update(manifest)
    m = {f: v for f, v in m.items() if v is not None}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(m, f)
    return str(path)


# (k, words a key in the shard, the manifest's key_words; None: absent).
# Older kat_tpu wrote 4 words at 32 < k <= 47, where k needs 3.
REFUSED = {
    "k33_four_words": (33, 4, 4),
    "k33_no_key_words": (33, 3, None),
    "k63_no_key_words": (63, 4, None),
    "k27_three_words": (27, None, 3),
}


@pytest.mark.parametrize("loader", sorted(LOADERS))
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_key_words_that_k_does_not_need_are_refused(tmp_path, case,
                                                    loader):
    """A manifest whose key_words is not the width k needs (or is missing
    at k > 31) is refused before any shard is read, by every loader."""
    k, words, key_words = REFUSED[case]
    path = _raw_checkpoint(tmp_path / "ck", k, words, key_words=key_words)
    with pytest.raises(ValueError, match="key_words") as e:
        LOADERS[loader](path)
    assert f"k={k}" in str(e.value) and path in str(e.value)


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_a_shard_that_disagrees_with_its_manifest_is_refused(tmp_path,
                                                             loader):
    """Keys of 4 words under a manifest that says 3 (k = 33)."""
    path = _raw_checkpoint(tmp_path / "ck", 33, 4, key_words=3)
    with pytest.raises(ValueError, match="key_words=4") as e:
        LOADERS[loader](path)
    assert "shard 0" in str(e.value)


def test_a_narrow_manifest_without_key_words_loads(tmp_path):
    """kat_tpu reads an absent key_words as 2: a narrow checkpoint without
    the field loads in both packages."""
    path = _raw_checkpoint(tmp_path / "ck", 21, None, key_words=None)
    got, m = checkpoint.load_table(path, device=CPU)
    want, _m = jckpt.load_table(path)
    assert "key_words" not in m
    _equal(_port_arrays(got), _jax_arrays(want, 21))
    assert got.n_unique == 3


def test_sharded_save_in_two_processes_loads_everywhere(tmp_path):
    """A counter of 2 processes x 2 shards saved by save_sharded_counter
    (each process its own shards, process 0 the manifest): load_table,
    load_sharded_counter on one process's mesh of 4 and on 2 processes,
    and kat_tpu's load_table and load_sharded_counter all give the live
    table; the shards equal one process's mesh of 4."""
    res = torch_mp.run("checkpoint_save", 2, tmp_path, 27, 2, 4, 32)
    assert [r["mine"] for r in res] == [[0, 1], [2, 3]]
    live = res[0]["table"]
    _equal(res[1]["table"], live)
    path = str(tmp_path / "ckpt")
    m = checkpoint.load_manifest(path)
    assert m["n_shards"] == 4 and m["n_unique"] == live[2]
    assert m["total"] == live[1].sum()
    got, _m = checkpoint.load_table(path, device=CPU)
    _equal(_port_arrays(got), live)
    one = checkpoint.load_sharded_counter(
        path, sharded.make_mesh(4, devices=["cpu"]))
    _equal(_port_arrays(one.finish()), live)
    ref = sharded.ShardedCounter(sharded.make_mesh(4, devices=["cpu"]), 27,
                                 shard_capacity=1 << 12)
    for b in W.schedule(4, 32):
        ref.add_codes(b)
    ref.check()
    for s in range(4):
        _equal(_port_arrays(one.tables[s]), _port_arrays(ref.tables[s]))
    assert one.n_unique.tolist() == ref.n_unique.tolist()
    hist = ref.histogram(1, 1001, 1, 1002)
    for r in torch_mp.run("checkpoint_load", 2, tmp_path / "load", path, 2):
        _equal(r["table"], live)
        assert np.array_equal(r["hist"], hist)
    jt, _m = jckpt.load_table(path)
    _equal(_jax_arrays(jt, 27), live)
    jc = jckpt.load_sharded_counter(path, jsharded.make_mesh(4))
    assert np.array_equal(jc.histogram(1, 1001, 1, 1002), hist)
