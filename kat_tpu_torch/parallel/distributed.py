"""Multi-process runtime over torch.distributed: the process group, each
process's share of the input, and the few collectives the mesh runs.

Port of kat_tpu/parallel/distributed.py.  The reference has no distributed
backend at all (one shared mmap'd hash and pthreads, SURVEY §2.5 P9); this
is the port's replacement:

  - `init_distributed()` starts the torch.distributed process group, from
    torch's own `env://` (what `torchrun` sets) or from an explicit
    `host:port` (a TCP store) or `file://` URL.  The backend follows the
    topology, decided before the group starts from what each process
    publishes in the rendezvous store: NCCL where every process owns cards
    of its own, gloo on the CPU and where processes share a card (NCCL
    refuses two ranks on one device).  It is printed once per process.
  - `shard_files(paths)` splits input files over the processes.
  - `global_mesh()` is the mesh over every process's local shards,
    process-major: process p holds global shards p*L .. p*L + L - 1.
    parallel/sharded.py and analysis.py run on it unchanged in form: the
    exchange becomes one `all_to_all_single`, the sums `all_reduce`.

Every helper degrades to the one process without a group.  Collectives of
a gloo group stage tensors that lie on a card through host memory
(`_staged`): gloo runs all_to_all and all_gather on CPU tensors only, and
staging every gloo collective keeps one rule.  The shard's work itself
never leaves its card.
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this has lost a peer
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | None = None) -> str:
    """Start the process group (idempotent); returns its backend.

    coordinator_address: None takes torch's `env://` (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them); `host:port`
    becomes a `tcp://` store, whose rank 0 listens; a `file://` or
    `tcp://` URL is used as it is.  num_processes and process_id are the
    world size and this process's rank.  device="cpu" says this process
    keeps its shards on the CPU (gloo), whatever cards it sees."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    store, rank, world = next(dist.rendezvous(url, timeout=TIMEOUT, **kw))
    backend, why = _choose_backend(store, rank, world, device)
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    print(f"kat_tpu_torch: process {rank} of {world}: torch.distributed "
          f"backend {backend} ({why})", file=sys.stderr, flush=True)
    return backend


def _cards() -> str:
    """What this process publishes of its devices: 'cpu', or its visible
    cards' UUIDs."""
    if not torch.cuda.is_available():
        return "cpu"
    return ",".join(str(torch.cuda.get_device_properties(i).uuid)
                    for i in range(torch.cuda.device_count()))


def _choose_backend(store, rank: int, world: int,
                    device: str | None) -> tuple[str, str]:
    """(backend, why) from every process's published devices, read from
    the rendezvous store before the group starts."""
    mine = "cpu" if device == "cpu" else _cards()
    ps = dist.PrefixStore("kat_tpu_torch/devices", store)
    ps.set(str(rank), mine)
    every = [ps.get(str(r)).decode() for r in range(world)]
    return choose_backend(every)


def choose_backend(every: Sequence[str]) -> tuple[str, str]:
    """(backend, why) for processes that published `every` ('cpu' or
    comma-separated card UUIDs, one entry a process)."""
    if any(e == "cpu" for e in every):
        return "gloo", "a process keeps its shards on the CPU"
    sets = [set(e.split(",")) for e in every]
    if sum(len(s) for s in sets) == len(set().union(*sets)):
        return "nccl", "every process owns cards of its own"
    return "gloo", ("processes share a card; NCCL refuses two ranks on "
                    "one device")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_files(paths: Sequence[str],
                index: int | None = None,
                count: int | None = None) -> list[str]:
    """This process's slice of the input files (round-robin by size rank,
    so processes get balanced byte totals even when file sizes are
    skewed)."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(paths)
    sized = sorted(paths, key=lambda p: -os.path.getsize(p)
                   if os.path.exists(p) else 0)
    return [p for i, p in enumerate(sized) if i % count == index]


# -- collectives: host integers and tensors --------------------------------


def _comm_device() -> torch.device:
    """Where a gathered host integer lives for the group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor) -> bool:
    """Does a collective of this tensor go through host memory?  Under
    gloo, every tensor that lies on a card does."""
    return dist.get_backend() == "gloo" and t.device.type != "cpu"


def gather_ints(values: Sequence[int]) -> np.ndarray:
    """[processes, len(values)] int64: every process's values (the same
    number everywhere), in rank order."""
    mine = torch.tensor([int(v) for v in values], dtype=torch.int64,
                        device=_comm_device())
    out = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def sum_int(value: int) -> int:
    """The sum over processes of one host integer."""
    return int(gather_ints([value]).sum())


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """all_to_all_single over dim 0, split into equal chunks, chunk q to
    process q; returns the chunks received, in rank order, on x's
    device."""
    src = x.contiguous()
    if _staged(src):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src)
    return out.to(x.device)


def all_gather(x: torch.Tensor) -> list[torch.Tensor]:
    """Every process's x (equal shapes), in rank order, on x's device."""
    src = x.contiguous()
    if _staged(src):
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src)
    return [o.to(x.device) for o in out]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over processes of x, on x's device (a new tensor)."""
    src = x.contiguous().clone() if not _staged(x) else x.cpu()
    dist.all_reduce(src, op=dist.ReduceOp.SUM)
    return src.to(x.device)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def shutdown() -> None:
    """End this process's part of the group before it exits: a final
    barrier, so that no process leaves while a peer's collective still
    needs it, then `destroy_process_group`.  A gloo process that exits
    with its group alive while its peers still run can abort in its
    teardown (`terminate called without an active exception`, SIGABRT).
    Nothing without a group."""
    if not dist.is_initialized():
        return
    barrier()
    dist.destroy_process_group()


# -- lockstep batches --------------------------------------------------------


def balanced_batches(local_batches: Sequence, rows: int, length: int):
    """Yield this process's batches, then empty (all-invalid) padding
    batches so EVERY process yields the same count.

    The sharded counter's flush is a collective: all processes must call
    `add_codes` (and hence flush) in lockstep.  The global count is agreed
    by one all_gather BEFORE any batch is consumed, so no counting
    collective can interleave with it.  Batches must share one [rows,
    length] shape."""
    n_local = len(local_batches)
    n_max = (int(gather_ints([n_local]).max()) if process_count() > 1
             else n_local)
    yield from iter(local_batches)
    empty = np.full((rows, length), 255, np.uint8)
    for _ in range(n_max - n_local):
        yield empty


def lockstep_code_batches(it):
    """Yield [rows, L] uint8 code batches padded to a globally agreed shape
    each step, until EVERY process's stream is exhausted.

    The sharded counter's flushes follow batch shapes and counts; file
    slices give neither the same shapes nor the same counts.  One
    all_gather a batch of (any_left, rows, length) agrees on the step's
    [max_rows, max_len]: every process feeds that geometry, its own data
    top-left and 255 (invalid) elsewhere.  Padding adds only invalid
    windows, which the extractor masks.  One process: passthrough."""
    if process_count() <= 1:
        yield from it
        return
    it = iter(it)
    while True:
        batch = next(it, None)
        if batch is not None:
            batch = np.asarray(batch, np.uint8)
        rows, length = batch.shape if batch is not None else (0, 0)
        agg = gather_ints([int(batch is not None), rows, length])
        if not agg[:, 0].any():
            return
        rmax, lmax = int(agg[:, 1].max()), int(agg[:, 2].max())
        out = np.full((rmax, lmax), 255, np.uint8)
        if batch is not None:
            out[:rows, :length] = batch
        yield out


def global_mesh(n_local: int | None = None, devices=None):
    """The mesh over every process's local shards, process-major.  Local
    shards go round-robin over `devices` (default: this process's visible
    cards; an error without one), n_local defaulting to their number;
    every process must hold as many (checked by one all_gather).  Without
    a group this is parallel/sharded.make_mesh."""
    from .sharded import Mesh, make_mesh

    local = make_mesh(n_local, devices)
    count = process_count()
    if count <= 1:
        return local
    sizes = gather_ints([local.n])[:, 0]
    if (sizes != local.n).any():
        raise ValueError(f"every process must hold as many shards; they "
                         f"hold {sizes.tolist()}")
    return Mesh(local.devices, count, process_index())
