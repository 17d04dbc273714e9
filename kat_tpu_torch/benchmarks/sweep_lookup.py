"""Join against search over table capacity, query count and query order.

    python -m kat_tpu_torch.benchmarks.sweep_lookup [out.json]

For each capacity in 2^17 .. 2^26 (three quarters of the slots hold random
54-bit keys, the fill `tables.compact` leaves on average) and each query
count in 2^16 .. 2^24 (half present, 1% SENTINEL), times one bulk lookup
through the sort-merge join (ops/join.py) and through the binary search
(core/counting.lookup), for queries in random order and already sorted
(CUDA events, 5 launches after a warm-up), after checking that both routes
agree.  Prints one row per cell with both times, their ratio, and what
`tables._join_policy` picks there; writes the rows as JSON when a path is
given.  Needs an NVIDIA card; the first line names it with its power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .profile_join import _timed_ms

CAPACITIES = tuple(1 << s for s in (17, 20, 22, 24, 26))
QUERY_COUNTS = tuple(1 << s for s in (16, 18, 20, 22, 24))
KEY_BITS = 55  # k = 27


def _table(cap: int, dev, gen):
    from ..core import counting
    from ..core.kmers import SENTINEL

    real = torch.unique(torch.randint(0, 1 << 54, (cap * 3 // 4,),
                                      device=dev, generator=gen))
    keys = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
    keys[:real.numel()] = real
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    counts[:real.numel()] = torch.randint(
        1, 1000, (real.numel(),), dtype=torch.int32, device=dev,
        generator=gen)
    return counting.CountTable(keys, counts, real.numel())


def _queries(table, m: int, dev, gen):
    from ..core.kmers import SENTINEL

    q = torch.randint(0, 1 << 54, (m,), device=dev, generator=gen)
    q[::2] = table.keys[torch.randint(0, table.n_unique, (m // 2,),
                                      device=dev, generator=gen)]
    q[torch.rand(m, device=dev, generator=gen) < 0.01] = SENTINEL
    return q


def main(argv: list[str]) -> int:
    from ..core import tables

    if not torch.cuda.is_available():
        print("sweep_lookup: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    print("capacity queries order join_ms search_ms join/search policy")
    for cap in CAPACITIES:
        table = _table(cap, dev, gen)
        for m in QUERY_COUNTS:
            q = _queries(table, m, dev, gen)
            for order, qq in (("random", q), ("sorted", torch.sort(q).values)):
                is_sorted = order == "sorted"

                def join():
                    return tables.lookup(table, qq, assume_sorted=is_sorted,
                                         method="join", key_bits=KEY_BITS)

                def search():
                    return tables.lookup(table, qq, method="search")

                if not torch.equal(join(), search()):
                    raise AssertionError(f"join and search differ at "
                                         f"capacity {cap}, m {m}, {order}")
                join_ms, search_ms = _timed_ms(join), _timed_ms(search)
                picks = "join" if tables._join_policy(
                    m, cap, table.keys.device) else "search"
                rows.append(dict(capacity=cap, queries=m, order=order,
                                 join_ms=join_ms, search_ms=search_ms,
                                 policy=picks))
                print(f"2^{cap.bit_length() - 1} 2^{m.bit_length() - 1} "
                      f"{order} {join_ms:.4f} {search_ms:.4f} "
                      f"{join_ms / search_ms:.2f} {picks}")
        del table
    wins = [r for r in rows if r["join_ms"] < r["search_ms"]]
    print(f"the join is the faster route in {len(wins)} of {len(rows)} cells")
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
