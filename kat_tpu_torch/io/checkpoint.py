"""Sharded count-table checkpoints.

Port of kat_tpu/io/checkpoint.py, in its format: one .npz per shard plus a
JSON manifest carrying k, the canonical flag, the shard count and the
shard-hash identifier, so a resumed run places shards directly on a mesh of
the same size without re-routing.  The manifest (`"format":
"kat_tpu/count_table"`, version 3, SHARD_HASH_ID), the file names and the
arrays are kat_tpu's: narrow keys (k <= 31) are uint64, wide keys kat_tpu's
[n, nw] big-first uint32 words (`key_words` > 2; kmers.to_ref_words), counts
uint32.  A checkpoint written by either package loads in the other.

In the reference the .jf dump is the checkpoint (SURVEY §5); this is its
mesh-native counterpart.  Tables are rebuilt on the card unless the caller
names a device.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core import counting, kmers, wide as wide_mod

MANIFEST = "manifest.json"
# fmix32 over the CANONICAL key form: the ownership rule of the mesh
# (parallel/sharded.owner_shard), so shards place directly on a mesh even
# for canonical=False tables, whose stored keys are raw.
SHARD_HASH_ID = "canonical-fmix32-v1"
FORMAT = "kat_tpu/count_table"
VERSION = 3


def _shard_name(path: str, s: int) -> str:
    return os.path.join(path, f"shard_{s:05d}.npz")


def _device(device) -> torch.device:
    if device is None:
        from ..tools.common import default_device

        return default_device()
    return torch.device(device)


def _to_file(keys: torch.Tensor, counts: torch.Tensor, k: int):
    """A table's real (keys, counts) as the file's arrays."""
    counts = counts.cpu().numpy().astype(np.uint32)
    if k <= kmers.MAX_K:
        return keys.cpu().numpy().astype(np.uint64), counts
    return kmers.to_ref_words(keys, k), counts


def _check_key_words(m: dict, path: str) -> None:
    """Refuse a manifest whose `key_words` is not the width k needs: 2 (or
    absent, kat_tpu's default) at k <= 31, else kmers.ref_words_for_k(k).
    Older kat_tpu wrote 4 words at 32 < k <= 47; such keys are not
    converted, since a table of another width holds other keys."""
    k = int(m["k"])
    kmers.words_for_k(k)  # raises outside [1, 255]
    found = m.get("key_words")
    if k <= kmers.MAX_K:
        if found in (None, 2):
            return
        need = 2
    else:
        need = kmers.ref_words_for_k(k)
        if found == need:
            return
    raise ValueError(
        f"checkpoint {path}: manifest key_words={found!r} but k={k} needs "
        f"key_words={need}")


def _read_shard(path: str, m: dict, s: int):
    """Shard s's stored (keys, counts).  Refuses a shard whose key array
    disagrees with its manifest: 1-D uint64 keys at k <= 31, else
    [n, key_words] words."""
    with np.load(_shard_name(path, s)) as z:
        keys, counts = z["keys"], z["counts"]
    if int(m["k"]) <= kmers.MAX_K:
        ok, found = keys.ndim == 1, f"an array of shape {keys.shape}"
    else:
        ok = keys.ndim == 2 and keys.shape[1] == m["key_words"]
        found = (f"key_words={keys.shape[1]}" if keys.ndim == 2
                 else f"an array of shape {keys.shape}")
    if not ok:
        raise ValueError(
            f"checkpoint {path}: shard {s} holds {found} but the manifest "
            f"says key_words={m.get('key_words', 2)}")
    return keys, counts


def _from_file(keys: np.ndarray, k: int) -> np.ndarray:
    """The file's keys as the port's: int64 keys, or [W, n] int64 words."""
    if k <= kmers.MAX_K:
        return np.asarray(keys, np.uint64).astype(np.int64)
    return kmers.from_ref_words(np.asarray(keys, np.uint32).reshape(
        -1, kmers.ref_words_for_k(k)), k)


def _owner(keys: np.ndarray, k: int, n_shards: int) -> np.ndarray:
    from ..parallel.sharded import owner_shard_np

    return owner_shard_np(_from_file(keys, k), k, n_shards)


def _manifest(k: int, canonical: bool, n_shards: int, n_unique: int,
              total: int) -> dict:
    return {
        "format": FORMAT,
        "version": VERSION,
        "k": int(k),
        "canonical": bool(canonical),
        "n_shards": int(n_shards),
        "shard_hash": SHARD_HASH_ID,
        "key_words": 2 if k <= kmers.MAX_K else kmers.ref_words_for_k(k),
        "n_unique": int(n_unique),
        "total": int(total),
    }


def _write_manifest(path: str, m: dict) -> None:
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(m, f, indent=2)


def save_table(path: str, table, k: int, canonical: bool,
               n_shards: int = 1) -> None:
    """Checkpoint a CountTable or WideTable, partitioned into n_shards by
    the owner hash the mesh uses."""
    os.makedirs(path, exist_ok=True)
    n = table.n_unique
    keys, counts = _to_file(table.keys[..., :n], table.counts[:n], k)
    dest = (_owner(keys, k, n_shards) if n_shards > 1
            else np.zeros(len(counts), np.int64))
    for s in range(n_shards):
        m = dest == s
        np.savez_compressed(_shard_name(path, s), keys=keys[m],
                            counts=counts[m])
    _write_manifest(path, _manifest(k, canonical, n_shards, len(counts),
                                    counts.sum(dtype=np.uint64)))


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        m = json.load(f)
    if m.get("format") != FORMAT:
        raise ValueError(f"not a kat_tpu count-table checkpoint: {path}")
    return m


def _table(keys: np.ndarray, counts: np.ndarray, k: int, capacity: int,
           device):
    build = (counting.table_from_numpy if k <= kmers.MAX_K
             else wide_mod.table_from_words)
    return build(keys, counts, capacity=capacity, device=device)


def load_table(path: str, device=None):
    """A checkpoint as one table (+ its manifest), capacity the next power
    of two of its entries, on `device` (default: the card)."""
    m = load_manifest(path)
    _check_key_words(m, path)
    k = int(m["k"])
    keys, counts = [], []
    for s in range(m["n_shards"]):
        sk, sc = _read_shard(path, m, s)
        keys.append(_from_file(sk, k))
        counts.append(np.asarray(sc, np.int64))
    c = np.concatenate(counts) if counts else np.zeros(0, np.int64)
    keys = (np.concatenate(keys, axis=-1) if keys
            else _from_file(np.zeros(0, np.uint64 if k <= kmers.MAX_K
                                     else np.uint32), k))
    cap = 1 << max(1, int(np.ceil(np.log2(max(len(c), 2)))))
    return _table(keys, c, k, cap, _device(device)), m


def save_sharded_counter(path: str, counter) -> None:
    """Checkpoint a live ShardedCounter without merging its shards: each
    process writes its own shards (one .npz each, keys in the shard's
    sorted order), process 0 the manifest, then every process waits at a
    barrier.  The shards keep the counter's canonical-hash ownership, so
    `load_sharded_counter` places them back on a mesh of the same size
    with no re-routing."""
    from ..parallel import distributed

    counter.check()
    os.makedirs(path, exist_ok=True)
    mesh = counter.mesh
    total = 0
    for i, t in enumerate(counter.tables):
        n = t.n_unique
        keys, counts = _to_file(t.keys[..., :n], t.counts[:n], counter.k)
        np.savez_compressed(_shard_name(path, mesh.first + i), keys=keys,
                            counts=counts)
        total += int(counts.sum(dtype=np.uint64))
    if mesh.multiprocess:
        total = distributed.sum_int(total)
    if mesh.rank == 0:
        _write_manifest(path, _manifest(
            counter.k, counter.canonical, counter.n,
            int(counter.n_unique.sum()), total))
    if mesh.multiprocess:
        distributed.barrier()


def load_sharded_counter(path: str, mesh, **counter_kwargs):
    """A checkpoint resumed as a live ShardedCounter on `mesh`, each shard
    placed directly on its owner (this process's shards only, across
    processes): no merge, no re-routing.  Needs n_shards == mesh.n and the
    canonical-hash partition; `load_table` is the lenient fallback."""
    from ..parallel.sharded import ShardedCounter

    m = load_manifest(path)
    if m["n_shards"] != mesh.n:
        raise ValueError(
            f"checkpoint has {m['n_shards']} shards but the mesh has "
            f"{mesh.n}; load with load_table() and recount, or re-save")
    if m.get("shard_hash") != SHARD_HASH_ID:
        raise ValueError(
            f"checkpoint shard_hash {m.get('shard_hash')!r} != "
            f"{SHARD_HASH_ID!r}: direct placement would mis-route")
    _check_key_words(m, path)
    k = int(m["k"])
    sizes = []
    for s in range(mesh.n):
        with np.load(_shard_name(path, s)) as z:
            sizes.append(len(z["counts"]))
    cap = 1 << max(4, int(np.ceil(np.log2(max(max(sizes), 2)))))
    sc = ShardedCounter(mesh, k, canonical=bool(m["canonical"]),
                        shard_capacity=cap, **counter_kwargs)
    sc.tables = []
    for i, dev in enumerate(mesh.devices):
        keys, counts = load_shard(path, mesh.first + i)
        sc.tables.append(_table(_from_file(keys, k), counts, k, cap, dev))
    sc.n_unique = np.asarray(sizes, np.int64)
    sc.n_max = sc.n_unique.copy()
    return sc


def load_shard(path: str, shard: int):
    """(keys, counts) of one shard as stored: kat_tpu's uint64 keys or
    [n, nw] uint32 words, uint32 counts.  Refuses checkpoints
    partitioned under another ownership rule (version-2 raw-key hashes):
    placing those directly would route lookups to the wrong shards;
    `load_table` stays lenient, since it concatenates every shard."""
    m = load_manifest(path)
    if m.get("n_shards", 1) > 1 and m.get("shard_hash") != SHARD_HASH_ID:
        raise ValueError(
            f"checkpoint {path} was partitioned with "
            f"shard_hash={m.get('shard_hash')!r} (expected "
            f"{SHARD_HASH_ID!r}); direct shard placement would mis-route "
            "- load with load_table() and re-save to re-partition")
    _check_key_words(m, path)
    return _read_shard(path, m, shard)
