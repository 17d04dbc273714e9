"""Worker bodies of the port's multi-process tests (tests/torch_mp.py runs
each in N gloo processes on the CPU).  Each takes (rank, nproc, tmp,
*args) and returns plain Python / numpy values that the test compares with
the port's single-process mesh and kat_tpu's single-process results.

The data helpers here are also what the tests feed their single-process
references, so both sides see the same inputs.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import torch

CPU = torch.device("cpu")
GENOME_LEN = 1 << 14
READ_LEN = 128


def genome() -> np.ndarray:
    return np.random.default_rng(3).integers(0, 4, GENOME_LEN,
                                             dtype=np.uint8)


def batch(seed: int, rows: int) -> np.ndarray:
    """[rows, READ_LEN] codes: windows of the genome from `seed`, a few
    invalid codes."""
    g = genome()
    r = np.random.default_rng(100 + seed)
    offs = r.integers(0, g.size - READ_LEN, rows)
    out = g[offs[:, None] + np.arange(READ_LEN)]
    out[r.random(out.shape) < 0.002] = 4
    return np.ascontiguousarray(out)


def schedule(n_batches: int, rows: int) -> list[np.ndarray]:
    """The fixed global batch schedule, dealt round-robin to processes."""
    return [batch(s, rows) for s in range(n_batches)]


def queries(rank: int, k: int, m: int) -> torch.Tensor:
    """m canonical query keys (int64, or [W, m] words beyond k = 31) of
    process `rank`: windows of the genome (present) and of random codes
    (mostly absent), some SENTINEL."""
    from kat_tpu_torch.core import tables
    from kat_tpu_torch.core.kmers import MAX_K, SENTINEL

    r = np.random.default_rng(500 + rank)
    g = genome()
    offs = r.integers(0, g.size - k, m)
    codes = g[offs[:, None] + np.arange(k)]
    rnd = r.random(m) < 0.3
    codes[rnd] = r.integers(0, 4, (int(rnd.sum()), k), dtype=np.uint8)
    keys, _valid = tables.extract(torch.from_numpy(codes), k,
                                  canonical=True)
    keys = keys.reshape(-1) if k <= MAX_K else keys.reshape(
        keys.shape[0], -1)
    drop = torch.from_numpy(r.random(m) < 0.05)
    keys[..., drop] = SENTINEL
    return keys


def table_arrays(table) -> tuple:
    """(keys, counts, n_unique) of a table's real entries as numpy."""
    n = table.n_unique
    keys = table.keys[..., :n].numpy().copy()
    return keys, table.counts[:n].numpy().copy(), int(n)


def _mesh(n_local: int):
    from kat_tpu_torch.parallel.distributed import global_mesh

    return global_mesh(n_local, devices=["cpu"])


def _count(mesh, k: int, batches, **kw):
    """This process's batches (a list of [rows, READ_LEN] codes) counted on
    the mesh, padded by balanced_batches where the counts differ."""
    from kat_tpu_torch.parallel.distributed import balanced_batches
    from kat_tpu_torch.parallel.sharded import ShardedCounter

    sc = ShardedCounter(mesh, k, **kw)
    rows = batches[0].shape[0] if batches else 0
    for b in balanced_batches(batches, rows, READ_LEN):
        sc.add_codes(b)
    sc.check()
    return sc


def count_hist(rank, nproc, tmp, k, n_local, n_batches, rows, kw):
    """This process's slice of the schedule counted on the global mesh:
    the histogram, the finished table, this process's shards' tables, and
    the replay state."""
    mesh = _mesh(n_local)
    mine = schedule(n_batches, rows)[rank::nproc]
    sc = _count(mesh, k, mine, **kw)
    return dict(hist=sc.histogram(1, 1001, 1, 1002),
                table=table_arrays(sc.finish()),
                shards={mesh.first + i: table_arrays(t)
                        for i, t in enumerate(sc.tables)},
                n_unique=sc.n_unique.tolist(),
                capacity=sc.shard_capacity, dropped=sc.dropped)


def count_uneven(rank, nproc, tmp, k, n_local, n_batches, rows, kw):
    """Uneven batch counts per process (dealt round-robin), evened out by
    distributed.balanced_batches."""
    from kat_tpu_torch.parallel.distributed import balanced_batches
    from kat_tpu_torch.parallel.sharded import ShardedCounter

    mesh = _mesh(n_local)
    mine = schedule(n_batches, rows)[rank::nproc]
    sc = ShardedCounter(mesh, k, **kw)
    for b in balanced_batches(mine, rows, READ_LEN):
        sc.add_codes(b)
    sc.check()
    return dict(hist=sc.histogram(1, 1001, 1, 1002),
                table=table_arrays(sc.finish()), n_batches=len(mine))


def analysis(rank, nproc, tmp, k, n_local, n_batches, rows, m_each):
    """Two inputs counted on the global mesh, then routed lookups of this
    process's queries (their number differs by process), gcp, comp with
    two and three inputs, and the halo path of one long contig."""
    from kat_tpu_torch.parallel import analysis as an
    from kat_tpu_torch.parallel import longseq

    mesh = _mesh(n_local)
    sched = schedule(n_batches, rows)
    c1 = _count(mesh, k, sched[rank::nproc], shard_capacity=1 << 12)
    c2 = _count(mesh, k, sched[::2][rank::nproc], shard_capacity=1 << 12)
    c3 = _count(mesh, k, sched[1::3][rank::nproc], shard_capacity=1 << 12)
    svc = an.ShardedLookup(c1)
    q = queries(rank, k, m_each[rank])
    got = svc.lookup(q).numpy()
    gcp = an.gcp_sharded(c1, k, 100)
    kw = dict(k=k, d1_bins=1001, d2_bins=1001, dm_size=1001, d1_scale=1.0,
              d2_scale=1.0, canon2=True, canon3=True)
    comp2 = an.comp_sharded(c1, c2, None, **kw)
    comp3 = an.comp_sharded(c1, c2, c3, sorted1=True, sorted2=True,
                            sorted3=True, **kw)
    contig = genome()[: 3000].copy()
    contig[[17, 1500]] = 4
    halo = longseq.sharded_window_profile_routed(c1, contig, k, True)
    return dict(lookup=got, gcp=gcp, comp2=_np(comp2), comp3=_np(comp3),
                halo=halo)


def _np(x):
    """A structure of tensors (dicts, tuples, None) as numpy."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {key: _np(v) for key, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.cpu().numpy()


def cli(rank, nproc, tmp, argv, out_name):
    """cli.run(argv) (main, then distributed.shutdown: the group must be
    gone after it) with `-o <tmp>/<out_name><rank>` appended after the
    mode; the tools' plots and peak analysis recorded, not run.  Returns
    (rc, stdout, every written file's bytes by suffix, plot calls)."""
    import torch.distributed as dist

    from kat_tpu_torch import cli as tcli

    calls = []
    tcli._plot = lambda mode, a, quiet=False: calls.append(("plot", mode))
    tcli._analyse_peaks = lambda *a, **kw: calls.append(("peaks",))
    prefix = os.path.join(tmp, f"{out_name}{rank}")
    mode_at = next(i for i, a in enumerate(argv) if not a.startswith("-")
                   and (i == 0 or argv[i - 1] not in ("--device", "--shards",
                                                      "--flush")))
    argv = argv[:mode_at + 1] + ["-o", prefix] + argv[mode_at + 1:]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.run(argv)
    if dist.is_initialized():
        raise AssertionError("cli.run left the process group alive")
    files = {}
    for name in sorted(os.listdir(tmp)):
        if name.startswith(f"{out_name}{rank}"):
            with open(os.path.join(tmp, name), "rb") as f:
                files[name[len(f"{out_name}{rank}"):]] = f.read()
    return rc, buf.getvalue(), files, calls


def checkpoint_save(rank, nproc, tmp, k, n_local, n_batches, rows):
    """Count on the global mesh, save with save_sharded_counter, and
    return the finished table and this process's shard ids."""
    from kat_tpu_torch.io import checkpoint

    mesh = _mesh(n_local)
    sc = _count(mesh, k, schedule(n_batches, rows)[rank::nproc],
                shard_capacity=1 << 12)
    checkpoint.save_sharded_counter(os.path.join(tmp, "ckpt"), sc)
    return dict(table=table_arrays(sc.finish()),
                mine=[mesh.first + i for i in range(mesh.n_local)])


def checkpoint_load(rank, nproc, tmp, path, n_local):
    """load_sharded_counter of `path` on the global mesh: every shard's
    table, the finished table and a histogram."""
    from kat_tpu_torch.io import checkpoint

    sc = checkpoint.load_sharded_counter(path, _mesh(n_local))
    return dict(table=table_arrays(sc.finish()),
                hist=sc.histogram(1, 1001, 1, 1002))


def lockstep(rank, nproc, tmp, shapes):
    """distributed.lockstep_code_batches over this process's batches of
    the given shapes (rank r takes shapes[r]), and balanced_batches of
    them padded to one shape."""
    from kat_tpu_torch.parallel import distributed as d

    r = np.random.default_rng(rank)
    mine = [r.integers(0, 5, s, dtype=np.uint8) for s in shapes[rank]]
    steps = [b.copy() for b in d.lockstep_code_batches(iter(mine))]
    even = [np.resize(b, (4, 9)) for b in mine]
    balanced = [b.copy() for b in d.balanced_batches(even, 4, 9)]
    return dict(mine=mine, steps=steps, even=even, balanced=balanced,
                index=d.process_index(), count=d.process_count(),
                shard=d.shard_files([os.path.join(tmp, f"f{i}")
                                     for i in range(5)]))


def exit_early(rank, nproc, tmp, delay):
    """One uneven all_gather (rank r sends r + 1 numbers, padded to the
    longest), then every process but rank 0 waits `delay` seconds, so rank
    0 reaches its exit first: the exit path that aborted in gloo's
    teardown before the workers left through distributed.shutdown."""
    import time

    from kat_tpu_torch.parallel import distributed as d

    sizes = d.gather_ints([rank + 1])[:, 0]
    mine = torch.full((int(sizes.max()),), -1, dtype=torch.int64)
    mine[:rank + 1] = torch.arange(rank + 1) + 10 * rank
    got = [g[:int(n)].tolist() for g, n in zip(d.all_gather(mine), sizes)]
    if rank:
        time.sleep(delay)
    return got


def card_count(rank, nproc, tmp, k, n_batches, rows):
    """count_hist with this process's one shard on the first card: the
    histogram, the finished table (on the host), the backend, and the
    launches of K1, K6, K2 and K3 during the count."""
    import torch.distributed as dist

    from kat_tpu_torch.ops import merge_kernel, reduce_kernel, sort_kernel

    wide = k > 31
    fns = ((sort_kernel.sort_words, sort_kernel.merge_runs_words,
            merge_kernel.merge_sorted_words,
            reduce_kernel.reduce_by_key_words) if wide else
           (sort_kernel.sort_keys, sort_kernel.merge_runs,
            merge_kernel.merge_sorted, reduce_kernel.reduce_by_key))
    from kat_tpu_torch.parallel.distributed import global_mesh

    mesh = global_mesh(1, devices=["cuda:0"])
    sc = _count(mesh, k, schedule(n_batches, rows)[rank::nproc],
                shard_capacity=1 << 10)
    launches = [f.launches for f in fns]
    t = sc.finish()
    n = t.n_unique
    return dict(hist=sc.histogram(1, 1001, 1, 1002), launches=launches,
                table=(t.keys[..., :n].cpu().numpy(),
                       t.counts[:n].cpu().numpy(), int(n)),
                backend=dist.get_backend())
