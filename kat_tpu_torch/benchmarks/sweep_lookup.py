"""Join against search: the measurements behind core/tables._join_policy.

    python -m kat_tpu_torch.benchmarks.sweep_lookup [out.json]

For keys of 1, 2 and 4 words (k = 27, 41 and 95), tables of 2^20 and 2^24
slots (three quarters of them real keys, the fill `tables.compact` leaves
on average) and 2^16, 2^20 and 2^23 queries in random order (half present, 1% SENTINEL), one bulk lookup
through the sort-merge join (ops/join.py) and through the binary search
(counting.lookup, wide.lookup_wide); then the fused dual probe
(join.counts_join_dual) against two searches at comp's shape, two 2^24-slot
tables sharing half their keys, for 1, 2 and 4 words.  Each cell checks
that both routes agree, times both (CUDA events, 5 launches after a
warm-up) and prints what `tables._join_policy` picks there.

Writes the rows as JSON when a path is given.  Needs an NVIDIA card; the
first line names it with its power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .profile_join import _timed_ms

KS = {1: 27, 2: 41, 4: 95}  # words -> the k whose keys are drawn
ROUTE_CAPACITIES = (1 << 20, 1 << 24)
ROUTE_QUERIES = (1 << 16, 1 << 20, 1 << 23)
DUAL_CAPACITY = 1 << 24


def _random_keys(n: int, k: int, dev, gen) -> torch.Tensor:
    """n random k-mers: int64 [n] for k <= 31, [W, n] words beyond (lower
    words of 31 bases, the top word of the rest)."""
    from ..core import kmers

    if k <= kmers.MAX_K:
        return torch.randint(0, 1 << (2 * k), (n,), device=dev, generator=gen)
    W = kmers.words_for_k(k)
    top = 2 * kmers.top_bases(k)
    words = torch.randint(0, 1 << 62, (W, n), device=dev, generator=gen)
    words[0] = torch.randint(0, 1 << top, (n,), device=dev, generator=gen)
    return words


def make_table(cap: int, k: int, dev, gen, keys=None):
    """A table of `cap` slots holding 3/4 cap distinct random k-mers (or
    the distinct ones of `keys`), counts in [1, 1000)."""
    from ..core import counting, kmers, wide
    from ..core.kmers import SENTINEL
    from ..ops.sort_kernel import words_order_plain

    if keys is None:
        keys = _random_keys(cap * 3 // 4, k, dev, gen)
    if keys.dim() == 1:
        real = torch.unique(keys)
    else:
        keys = keys[:, words_order_plain(keys)]
        new = torch.ones(keys.shape[1], dtype=torch.bool, device=dev)
        new[1:] = (keys[:, 1:] != keys[:, :-1]).any(0)
        real = keys[:, new]
    n = real.shape[-1]
    out = torch.full(real.shape[:-1] + (cap,), SENTINEL, dtype=torch.int64,
                     device=dev)
    out[..., :n] = real
    counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    counts[:n] = torch.randint(1, 1000, (n,), dtype=torch.int32, device=dev,
                               generator=gen)
    if k > kmers.MAX_K:
        return wide.WideTable(out, counts, n)
    return counting.CountTable(out, counts, n)


def make_queries(table, m: int, k: int, dev, gen) -> torch.Tensor:
    """m queries: every other one a key of the table, the rest random, 1%
    SENTINEL."""
    from ..core.kmers import SENTINEL

    q = _random_keys(m, k, dev, gen)
    pick = torch.randint(0, table.n_unique, (m // 2,), device=dev,
                         generator=gen)
    q[..., ::2] = table.keys[..., pick]
    q[..., torch.rand(m, device=dev, generator=gen) < 0.01] = SENTINEL
    return q


def time_routes(table, q, k: int) -> dict:
    """Both routes of one bulk lookup, after checking that they agree."""
    from ..core import tables

    def join():
        return tables.lookup(table, q, method="join", key_bits=2 * k + 1)

    def search():
        return tables.lookup(table, q, method="search")

    if not torch.equal(join(), search()):
        raise AssertionError(f"join and search differ at capacity "
                             f"{table.capacity}, k {k}")
    return dict(join_ms=_timed_ms(join), search_ms=_timed_ms(search))


def time_dual(t_a, t_b) -> dict:
    """The fused probe against two searches, after checking that they
    agree."""
    from ..core import tables
    from ..ops.join import counts_join_dual

    def dual():
        return counts_join_dual(t_a.keys, t_a.counts, t_b.keys, t_b.counts)

    def searches():
        return (tables.lookup(t_b, t_a.keys, method="search"),
                tables.lookup(t_a, t_b.keys, method="search"))

    if not all(torch.equal(x, y) for x, y in zip(dual(), searches())):
        raise AssertionError("the dual probe and two searches differ")
    return dict(join_ms=_timed_ms(dual), search_ms=_timed_ms(searches))


def route_table(dev, gen, report=print) -> list[dict]:
    """The cells of the route table (module docstring), one dict each."""
    from ..core import tables

    rows = []
    for n_words, k in KS.items():
        for cap in ROUTE_CAPACITIES:
            table = make_table(cap, k, dev, gen)
            for m in ROUTE_QUERIES:
                q = make_queries(table, m, k, dev, gen)
                row = dict(kind="lookup", words=n_words, k=k, capacity=cap,
                           queries=m, order="random",
                           **time_routes(table, q, k))
                row["policy"] = "join" if tables._join_policy(
                    m, cap, dev, n_words) else "search"
                rows.append(row)
                report(_line(row))
            del table
        a = make_table(DUAL_CAPACITY, k, dev, gen)
        shared = a.keys[..., :a.n_unique // 2]
        b = make_table(DUAL_CAPACITY, k, dev, gen, torch.cat(
            [shared, _random_keys(DUAL_CAPACITY * 3 // 8, k, dev, gen)],
            dim=-1))
        row = dict(kind="dual", words=n_words, k=k, capacity=DUAL_CAPACITY,
                   queries=DUAL_CAPACITY, order="sorted", **time_dual(a, b))
        row["policy"] = "join" if tables._join_policy(
            DUAL_CAPACITY, DUAL_CAPACITY, dev, n_words, True) else "search"
        rows.append(row)
        report(_line(row))
        del a, b, shared
    return rows


def _line(r: dict) -> str:
    return (f"{r['kind']} W={r['words']} 2^{r['capacity'].bit_length() - 1} "
            f"2^{r['queries'].bit_length() - 1} {r['order']} "
            f"{r['join_ms']:.4f} {r['search_ms']:.4f} "
            f"{r['join_ms'] / r['search_ms']:.3f} {r['policy']}")


def main(argv: list[str]) -> int:
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
    print("kind words capacity queries order join_ms search_ms join/search "
          "policy")
    rows = route_table(dev, gen)
    wins = [r for r in rows if r["join_ms"] < r["search_ms"]]
    agree = [r for r in rows
             if (r["policy"] == "join") == (r["join_ms"] < r["search_ms"])]
    print(f"the join is the faster route in {len(wins)} of {len(rows)} "
          f"cells; the policy picks the faster route in {len(agree)}")
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
