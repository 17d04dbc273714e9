"""What the measurement scripts, chip_smoke.py and the card tests share:
the card's published rates, the main path's input (and comp's second read
set and assembly of its genome), the counting flush's shapes (narrow and
wide keys, and a table and fresh keys of any size), the binned sums' and
the dual probe's shapes, the K2, K3 and fused K2 + K3 inputs that strain a
single pass, the W-word kernels' strain inputs, a matrix shaped like
chr14.comp's, and a count of what one call runs on the card."""

from __future__ import annotations

import numpy as np
import torch

from ..core import kmers
from ..core.kmers import SENTINEL

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published

# the main path: bench.py's read model at its scale
MAIN_K, MAIN_ROWS, MAIN_LENGTH, MAIN_BATCHES = 27, 4096, 1024, 48
MAIN_GENOME_LEN = 1 << 23


def main_path_batches(dev, seed: int):
    """(genome, batches): a random genome of 2^23 bases (plus one read's
    length) as uint8 codes on `dev`, and 48 batches of 4096 reads of 1024
    bases cut from it at random offsets, 196,214,784 windows at k = 27."""
    rng = np.random.default_rng(seed)
    genome = torch.from_numpy(rng.integers(
        0, 4, MAIN_GENOME_LEN + MAIN_LENGTH, dtype=np.uint8)).to(dev)
    reads = genome.unfold(0, MAIN_LENGTH, 1)  # [genome_len + 1, length] view
    offsets = torch.from_numpy(rng.integers(
        0, MAIN_GENOME_LEN, (MAIN_BATCHES, MAIN_ROWS))).to(dev)
    return genome, [reads[offsets[i]] for i in range(MAIN_BATCHES)]


def read_draw(genome: torch.Tensor, seed: int, n_batches: int):
    """Another read set of the same genome: n_batches of MAIN_ROWS reads of
    MAIN_LENGTH bases at offsets drawn from `seed` (comp's third input)."""
    rng = np.random.default_rng(seed)
    reads = genome.unfold(0, MAIN_LENGTH, 1)
    offsets = torch.from_numpy(rng.integers(
        0, MAIN_GENOME_LEN, (n_batches, MAIN_ROWS))).to(genome.device)
    return [reads[offsets[i]] for i in range(n_batches)]


def contig_rows(genome: torch.Tensor, k: int, row: int = 1 << 16):
    """The genome's first MAIN_GENOME_LEN windows as one contig, cut into
    rows of `row` windows that overlap by k - 1 bases, as the sequence
    encoder cuts a long contig: every window once (comp's assembly)."""
    return genome[:MAIN_GENOME_LEN + k - 1].unfold(0, row + k - 1, row)


COMP_THIRD_BATCHES = 24  # comp's third input: half the main path's depth

# a chr14.comp main matrix: the reads' 2.74G windows at 42x of 101 bp reads
# (k-mer depth ~31), the assembly's 88.3M k-mers, 0.25% substitutions
COMP_MX_BINS, COMP_MX_DEPTH = 1001, 31
COMP_MX_ASM, COMP_MX_ERRORS = 88_000_000, 250_000_000


def comp_matrix(seed: int, bins: int = COMP_MX_BINS) -> np.ndarray:
    """An int64 [bins, bins] matrix shaped like chr14.comp's `-main.mx`
    (row: a k-mer's count in the reads, column: in the assembly): the
    assembly's k-mers around the reads' depth in columns 1 and 2 (7
    digits at the mode), the reads' errors in column 0 (8 digits at
    count 1), a row 0 of the assembly's k-mers the reads miss, and a
    sparse scatter of small cells; most cells 0."""
    rng = np.random.default_rng(seed)
    mx = np.zeros((bins, bins), np.int64)
    for col, share in ((1, 0.985), (2, 0.015)):
        depth = rng.poisson(col * COMP_MX_DEPTH, 1 << 20)
        mx[:, col] = np.bincount(np.minimum(depth, bins - 1),
                                 minlength=bins) * int(
            share * COMP_MX_ASM / (1 << 20))
    count = np.arange(1, bins)
    mx[1:, 0] = (COMP_MX_ERRORS * np.exp(-1.3 * count) +
                 rng.integers(0, 1000, bins - 1) * (count < 200))
    mx[0, 1:] = rng.integers(0, 10_000, bins - 1) >> rng.integers(
        0, 14, bins - 1)
    at = rng.integers(0, bins, (bins * 20, 2))
    mx[at[:, 0], at[:, 1]] += rng.integers(1, 1000, bins * 20)
    return mx


BINNED_SHAPES = ("hist", "gcp", "comp", "comp_uniform")


def binned_inputs(name: str, dev, gen):
    """(bins int32 [n], masks bool [M, n], total_bins) of a binned sum at
    the main path's table size, 2^24 slots with 8,389,530 real ones whose
    counts are Poisson at the reads' depth (196,214,784 windows over them,
    about 23.4): the histogram's (10,001 bins, one mask), gcp's (28 GC
    rows x 1001 coverage columns at k = 27, one mask), and comp pass 1's
    three matrices with three inputs (1001 x 1001 bins; rows by the reads'
    count, columns by the second read set's at half the depth; masks ends,
    mixed and middle against an assembly where each k-mer occurs once),
    at that skew and with uniform bins."""
    cap, n_real = 1 << 24, 8_389_530
    real = torch.zeros(cap, dtype=torch.bool, device=dev)
    real[:n_real] = True
    depth = 196_214_784 / n_real

    def counts(mean):
        c = torch.poisson(torch.full((cap,), mean, device=dev),
                          generator=gen).to(torch.int64)
        return torch.where(real, c, 0)

    c1 = counts(depth)
    if name == "hist":
        bins = torch.where(c1 < 1, 0, torch.where(c1 > 10_001, 10_000,
                                                   c1 - 1))
        return bins.to(torch.int32), (c1 > 0)[None], 10_001
    if name == "gcp":
        gc = torch.randint(0, 2, (27, cap), device=dev, generator=gen).sum(0)
        bins = gc * 1001 + c1.clamp_max(1000)
        return bins.to(torch.int32), (c1 > 0)[None], 28 * 1001
    s3 = counts(depth / 2).clamp_max(1000)
    s2 = torch.where(real, 1, 0)
    masks = torch.stack([real & (s2 == s3), real & (s2 != s3) & (s3 > 0),
                         real & (s2 != s3) & (s3 == 0)])
    total = 1001 * 1001
    if name == "comp":
        bins = c1.clamp_max(1000) * 1001 + s3
    else:
        bins = torch.randint(0, total, (cap,), device=dev, generator=gen)
    return bins.to(torch.int32), masks, total


PACKED_SHAPES = ("comp_pass1", "comp_pass2")
# their request sets (div, mod, mask) as comp_engine.pass1 and pass2 make
# them at the defaults under the dual probe
PACKED_REQUESTS = {
    "comp_pass1": ((1001, 1001, 0), (1001, 1001, 1), (1, 1001 * 1001, 0)),
    "comp_pass2": ((1001, 1001, 0), (1, 1001, 1), (1001, 1001, 2))}


def packed_inputs(name: str, dev, gen):
    """(packed int32 [n], masks bool [M, n], requests) of comp's packed
    binned sums (core/comp_engine.py: pass1, pass2; PACKED_REQUESTS):
    pass 1 at the main path's table size (hash1 = the reads: 2^24 slots
    with 8,389,530 real ones whose counts are Poisson at the reads' depth,
    about 23.4, against an assembly that holds half of them once; the
    column the assembly's count: requests (1001, 1001, real), (1001, 1001,
    shared), (1, 1,002,001, real)) and pass 2 under the dual
    probe (hash2 = the assembly's table, as comp_path in chip_smoke.py
    builds it from the genome: 2^23 slots, all but one real, each k-mer
    once and all but ~50 of them also in the reads; binned by its own
    count: requests (1001, 1001, real), (1, 1001, only in hash2), (1001,
    1001, shared))."""
    cap, n_real = 1 << 24, 8_389_530
    real = torch.zeros(cap, dtype=torch.bool, device=dev)
    real[:n_real] = True
    reads = torch.poisson(torch.full((cap,), 196_214_784 / n_real,
                                     device=dev), generator=gen)
    reads = torch.where(real, reads.to(torch.int64), 0)
    asm = torch.where(real & (torch.rand(cap, device=dev, generator=gen)
                              < 0.5), 1, 0)
    if name == "comp_pass1":
        packed = reads.clamp_max(1000) * 1001 + asm
        return (packed.to(torch.int32), torch.stack([real, real & (asm > 0)]),
                PACKED_REQUESTS[name])
    cap2, n_real2 = 1 << 23, (1 << 23) - 1
    real2 = torch.zeros(cap2, dtype=torch.bool, device=dev)
    real2[:n_real2] = True
    only = real2 & (torch.rand(cap2, device=dev, generator=gen)
                    < 50 / n_real2)
    packed = torch.where(real2, 1 * 1001 + 1, 0)  # count 1: bin 1, row 1
    return (packed.to(torch.int32), torch.stack([real2, only, real2 & ~only]),
            PACKED_REQUESTS[name])


def dual_probe_shapes(dev, gen):
    """The fused dual probe's inputs: two 2^24-slot tables of ~2^23
    distinct 54-bit keys each from one 1.5 x 2^23 key universe (so about
    half of each table's keys are shared), counts 1-99, each carrying its
    count and its source (1 or 2) as the merge's payload planes."""
    cap = 1 << 24
    universe = torch.randint(0, 1 << 54, (3 << 22,), dtype=torch.int64,
                             device=dev, generator=gen)
    out = []
    for src in (1, 2):
        pick = torch.randperm(universe.numel(), device=dev,
                              generator=gen)[:1 << 23]
        real = torch.unique(universe[pick])
        keys = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
        keys[:real.numel()] = real
        counts = torch.zeros(cap, dtype=torch.int32, device=dev)
        counts[:real.numel()] = torch.randint(
            1, 100, (real.numel(),), dtype=torch.int32, device=dev,
            generator=gen)
        out += [keys, (counts, torch.full((cap,), src, dtype=torch.int32,
                                          device=dev))]
    return tuple(out)


def main_path_counter(dev):
    """The counter the main path feeds its batches to."""
    from ..core import counting

    return counting.CodeStreamingCounter(
        MAIN_K, canonical=True, initial_capacity=1 << 20,
        flush_windows=1 << 26, device=dev)


def _traced(fns) -> list:
    """The card's events (kernels, memsets, copies) of `fns`, called in turn
    20 ms apart inside ONE torch.profiler window, in the order they ran."""
    import time

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
        time.sleep(0.02)
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("torch.profiler traced nothing on the card")
    return events


def device_events(fn) -> list[tuple[str, float]]:
    """(name, microseconds) of every kernel, memset and copy that one call
    of `fn` runs on the card, in the order they ran, as torch.profiler
    traces them."""
    return [(e.name, e.time_range.elapsed_us()) for e in _traced([fn])]


def device_event_groups(fns) -> list[list[tuple[str, float]]]:
    """device_events of each of `fns` (calls with no 10 ms pause of their
    own), all in one profiled window and told apart by the pauses between
    them.  (A process that had opened a dozen profiled windows lost events
    at the start of later ones; a script that counts several calls opens
    one window.)"""
    groups, last_end = [], None
    for e in _traced(fns):
        if last_end is None or e.time_range.start - last_end > 10_000:
            groups.append([])
        groups[-1].append((e.name, e.time_range.elapsed_us()))
        last_end = e.time_range.end
    if len(groups) != len(fns):
        raise RuntimeError(f"torch.profiler traced {len(groups)} calls on "
                           f"the card, expected {len(fns)}")
    return groups


def flush_shapes(dev, gen):
    """The counting flush's shapes once the main path's table has grown to
    2^24 slots, and the join's: (table keys, table counts, fresh keys,
    their merge's keys and weights, sorted queries).  A 2^24-slot table of ~2^23 distinct 54-bit
    keys with counts 1-99, 2^26 sorted fresh keys drawn from a 1.5 x 2^23
    key universe with 10% SENTINEL, their 83,886,080-element merge (by the
    plain version), and 2^23 sorted queries from the same universe."""
    from ..ops import merge_kernel

    cap, n_fresh = 1 << 24, 1 << 26
    universe = torch.randint(0, 1 << 54, (3 << 22,), dtype=torch.int64,
                             device=dev, generator=gen)
    real = torch.unique(universe[:1 << 23])
    t_keys = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
    t_keys[:real.numel()] = real
    t_counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    t_counts[:real.numel()] = torch.randint(
        1, 100, (real.numel(),), dtype=torch.int32, device=dev,
        generator=gen)
    fresh = universe[torch.randint(0, universe.numel(), (n_fresh,),
                                   device=dev, generator=gen)]
    fresh[torch.rand(n_fresh, device=dev, generator=gen) < 0.1] = SENTINEL
    fresh = torch.sort(fresh).values
    mk, mw = merge_kernel.merge_sorted_plain(t_keys, t_counts, fresh)
    q = torch.sort(universe[torch.randint(
        0, universe.numel(), (1 << 23,), device=dev, generator=gen)]).values
    return t_keys, t_counts, fresh, mk, mw, q


def _sorted_keys(n, bits, sent, dev, gen):
    k = torch.randint(0, 1 << bits, (n,), dtype=torch.int64, device=dev,
                      generator=gen)
    k[torch.rand(n, device=dev, generator=gen) < sent] = SENTINEL
    return torch.sort(k).values


REDUCE_STRAIN = ("one_run_every_tile", "equal_2_26", "all_sentinel_2_26",
                 "sum_near_2_31", "interior_sentinels", "overflow",
                 "out_size_0", "n_1", "tile_minus_1", "tile", "tile_plus_1")


def reduce_strain(name: str, tile: int, dev, gen):
    """(keys, int32 weights, out_size) of a K3 input where its single pass
    can go wrong: one run across every tile (37 tiles, and 2^26 equal
    keys), 2^26 SENTINEL, one run whose count is 2^31 - 1, sorted chunks
    with sentinel tails of their own, more runs than slots, no slots, one
    element, lengths around the tile."""
    def weights(k):
        w = torch.randint(1, 9, (k.numel(),), dtype=torch.int32, device=dev,
                          generator=gen)
        return torch.where(k == SENTINEL, 0, w).to(torch.int32)

    if name == "one_run_every_tile":
        k = torch.full((37 * tile + 11,), 99, dtype=torch.int64, device=dev)
        return k, weights(k), 4
    if name == "equal_2_26":
        k = torch.full((1 << 26,), 12345, dtype=torch.int64, device=dev)
        return k, torch.ones(1 << 26, dtype=torch.int32, device=dev), 16
    if name == "all_sentinel_2_26":
        k = torch.full((1 << 26,), SENTINEL, dtype=torch.int64, device=dev)
        return k, torch.zeros(1 << 26, dtype=torch.int32, device=dev), 256
    if name == "sum_near_2_31":
        n = 1 << 20
        k = torch.full((n,), 7, dtype=torch.int64, device=dev)
        w = torch.full((n,), (2 ** 31 - 1) // n, dtype=torch.int32,
                       device=dev)
        w[0] += 2 ** 31 - 1 - int(w.to(torch.int64).sum())
        return k, w, 2
    if name == "interior_sentinels":
        k = torch.cat([_sorted_keys(tile // 3 + 5, 10, 0.3, dev, gen)
                       for _ in range(64)])
        return k, weights(k), k.numel()
    if name == "overflow":
        k = _sorted_keys(20 * tile, 30, 0.05, dev, gen)
        return k, weights(k), 1000
    if name == "out_size_0":
        k = _sorted_keys(5 * tile + 3, 16, 0.1, dev, gen)
        return k, weights(k), 0
    if name == "n_1":
        return (torch.tensor([5], dtype=torch.int64, device=dev),
                torch.tensor([7], dtype=torch.int32, device=dev), 3)
    n = {"tile_minus_1": tile - 1, "tile": tile, "tile_plus_1": tile + 1}[name]
    k = _sorted_keys(n, 12, 0.1, dev, gen)
    return k, weights(k), n


MERGE_STRAIN = ("na_0", "nb_0", "equal_keys", "a_before_b", "b_before_a",
                "tile_minus_1", "tile", "tile_plus_1")


def merge_strain(name: str, tile: int, dev, gen):
    """(table keys, int32 table counts, fresh keys) of a K2 input where its
    tile splits can go wrong: one side empty, every key equal on both sides,
    one side wholly before the other (2^22 outputs), lengths around the
    tile."""
    if name == "equal_keys":
        a = torch.full((3 * tile + 1,), 5, dtype=torch.int64, device=dev)
        b = torch.full((5 * tile + 3,), 5, dtype=torch.int64, device=dev)
        return a, torch.arange(a.numel(), dtype=torch.int32, device=dev), b
    n = {"tile_minus_1": tile - 1, "tile": tile, "tile_plus_1": tile + 1}.get(
        name, 1 << 22)
    a = torch.unique(_sorted_keys(n // 3, 40, 0.0, dev, gen))
    b = _sorted_keys(n - a.numel(), 40, 0.1, dev, gen)
    if name == "a_before_b":
        b = torch.where(b == SENTINEL, b, b + (1 << 41))
    if name == "b_before_a":
        a = a + (1 << 41)
    if name == "na_0":
        a = a[:0]
    if name == "nb_0":
        b = b[:0]
    counts = torch.randint(1, 1000, (a.numel(),), dtype=torch.int32,
                           device=dev, generator=gen)
    return a, counts, b


MERGE_REDUCE_STRAIN = ("run_across_tiles", "runs_at_tile_edges",
                       "split_not_pow2", "sentinel_tail",
                       "table_sentinel_tail", "fresh_all_sentinel",
                       "all_sentinel", "overflow", "out_size_0", "sum_wraps",
                       "na_0", "nb_0", "both_0")


def merge_reduce_strain(name: str, tile: int, dev, gen):
    """(table keys, int32 table counts, fresh keys, out_size) of a fused
    K2 + K3 input where its tiles can go wrong: one run across ~37 tiles
    from both sides, runs of lengths around the tile, sides whose split is
    no power of two, a fresh SENTINEL tail (2^22 outputs), a table with a
    SENTINEL tail of its own, fresh keys all SENTINEL, no real key on
    either side, more runs than slots, no slots, a sum past 2^31, empty
    sides."""
    def table_of(keys):
        a = torch.unique(keys[keys != SENTINEL])
        return a, torch.randint(1, 1000, (a.numel(),), dtype=torch.int32,
                                device=dev, generator=gen)

    if name == "run_across_tiles":
        a, ac = table_of(_sorted_keys(3 * tile, 40, 0.0, dev, gen))
        x = a[a.numel() // 2]
        b = torch.sort(torch.cat([
            torch.full((37 * tile + 11,), int(x), dtype=torch.int64,
                       device=dev),
            _sorted_keys(2 * tile, 40, 0.1, dev, gen)])).values
        return a, ac, b, a.numel() + b.numel()
    if name == "runs_at_tile_edges":
        lens = torch.tensor([tile - 1, tile, tile + 1, 1, 2, tile // 2, 3],
                            device=dev).repeat(4)
        first = torch.unique(_sorted_keys(2 * lens.numel(), 40, 0.0, dev,
                                          gen))[:lens.numel()]
        b = first.repeat_interleave(lens)
        a, ac = table_of(first[::3])
        return a, ac, b, first.numel()
    if name == "split_not_pow2":
        a, ac = table_of(_sorted_keys(5 * tile + 13, 20, 0.0, dev, gen))
        b = _sorted_keys(7 * tile + 3, 20, 0.1, dev, gen)
        return a, ac, b, a.numel() + b.numel()
    if name in ("sentinel_tail", "overflow", "out_size_0"):
        n = 1 << 22
        a, ac = table_of(_sorted_keys(n // 3, 30, 0.0, dev, gen))
        b = _sorted_keys(n - a.numel(), 30, 0.26, dev, gen)
        out = {"sentinel_tail": n, "overflow": n // 8, "out_size_0": 0}
        return a, ac, b, out[name]
    if name == "table_sentinel_tail":
        a, ac = table_of(_sorted_keys(2 * tile, 30, 0.0, dev, gen))
        a = torch.cat([a, torch.full((tile + 7,), SENTINEL,
                                     dtype=torch.int64, device=dev)])
        ac = torch.cat([ac, torch.full((tile + 7,), 5, dtype=torch.int32,
                                       device=dev)])
        b = _sorted_keys(3 * tile, 30, 0.2, dev, gen)
        return a, ac, b, a.numel() + b.numel()
    if name == "fresh_all_sentinel":
        a, ac = table_of(_sorted_keys(2 * tile + 5, 40, 0.0, dev, gen))
        b = torch.full((3 * tile + 5,), SENTINEL, dtype=torch.int64,
                       device=dev)
        return a, ac, b, a.numel() + 3
    if name == "all_sentinel":  # no real key on either side: no run
        a = torch.full((2 * tile + 3,), SENTINEL, dtype=torch.int64,
                       device=dev)
        b = torch.full((3 * tile,), SENTINEL, dtype=torch.int64, device=dev)
        return a, torch.full_like(a, 5, dtype=torch.int32), b, 10
    if name == "sum_wraps":
        a, ac = table_of(_sorted_keys(tile, 12, 0.0, dev, gen))
        ac[::2] = 2 ** 31 - 1 - ac[::2] % 2  # a fresh copy wraps them
        b = _sorted_keys(5 * tile, 12, 0.05, dev, gen)
        return a, ac, b, a.numel() + b.numel()
    a, ac = table_of(_sorted_keys(3 * tile + 1, 40, 0.0, dev, gen))
    b = _sorted_keys(4 * tile + 9, 40, 0.1, dev, gen)
    if name in ("na_0", "both_0"):
        a, ac = a[:0], ac[:0]
    if name in ("nb_0", "both_0"):
        b = b[:0]
    return a, ac, b, a.numel() + b.numel() + 1


# chr14.hist's last flushes (katbench): (slots, the table's real keys,
# fresh keys of 16 batches, their SENTINEL share)
HIST_FLUSH = (1 << 28, 230_000_000, 65_404_928, 0.26)


def table_and_fresh(cap: int, n_real: int, n_fresh: int, sent: float,
                    dev, gen):
    """A flush's inputs at the benchmark's scale: a table of `n_real`
    distinct sorted 54-bit keys (counts 1-99) and `n_fresh` sorted fresh
    keys, a share `sent` of them SENTINEL, half of the rest keys of the
    table and half new; `cap` is the table's capacity, the output's slots."""
    keys = torch.randint(0, 1 << 54, (n_real + n_real // 16,),
                         dtype=torch.int64, device=dev, generator=gen)
    t_keys = torch.unique(keys)[:n_real]
    del keys
    t_counts = torch.randint(1, 100, (t_keys.numel(),), dtype=torch.int32,
                             device=dev, generator=gen)
    fresh = torch.randint(0, 1 << 54, (n_fresh,), dtype=torch.int64,
                          device=dev, generator=gen)
    old = torch.rand(n_fresh, device=dev, generator=gen) < 0.5
    fresh[old] = t_keys[torch.randint(0, t_keys.numel(),
                                      (int(old.sum()),), device=dev,
                                      generator=gen)]
    fresh[torch.rand(n_fresh, device=dev, generator=gen) < sent] = SENTINEL
    return t_keys, t_counts, torch.sort(fresh).values


# the wide main path: the same reads at k = 41 (W = 2), 193,462,272 windows
WIDE_K = 41
# boundary k of every word count W = 2..9: the top word full (31 bases) or
# nearly empty (one base), and k = 33 and 255
WIDE_STRAIN_K = (33, 62, 63, 93, 94, 124, 125, 255)
WIDE_STRAIN = ("random", "top_equal", "all_sentinel", "one_run")
# what strains the W-word sort's prefix split (sort_kernel.prefix_layout):
# half the keys in one bucket (a poly-A-like hot prefix), half SENTINEL,
# and every key in one bucket with distinct lower words
WIDE_SKEW = ("one_hot_bucket", "half_sentinel", "one_prefix")


def wide_counter(k: int, dev):
    """The counter the wide main path feeds its batches to."""
    from ..core import wide

    return wide.WideCodeStreamingCounter(
        k, canonical=True, initial_capacity=1 << 20, flush_windows=1 << 26,
        device=dev)


def wide_keys(k: int, n: int, dev, gen, sent: float = 0.1,
              top=None) -> torch.Tensor:
    """[W, n] random wide keys of k bases (every word of its width), a
    `sent` share of them SENTINEL; with `top` every top word is that."""
    W, tb = kmers.words_for_k(k), 2 * kmers.top_bases(k)
    words = [torch.full((n,), top, dtype=torch.int64, device=dev)
             if top is not None else
             torch.randint(0, 1 << tb, (n,), dtype=torch.int64, device=dev,
                           generator=gen)]
    words += [torch.randint(0, 1 << 62, (n,), dtype=torch.int64, device=dev,
                            generator=gen) for _ in range(W - 1)]
    keys = torch.stack(words)
    keys[:, torch.rand(n, device=dev, generator=gen) < sent] = SENTINEL
    return keys


def wide_strain(name: str, k: int, n: int, dev, gen) -> torch.Tensor:
    """[W, n] unsorted wide keys where a W-word kernel can go wrong: random
    (10% SENTINEL), equal in the top word and different below (a pass over
    the top word moves nothing, a compare must reach the lower words),
    all SENTINEL, and one key (one run across every tile); and WIDE_SKEW's
    three."""
    if name == "random":
        return wide_keys(k, n, dev, gen)
    if name == "top_equal":
        return wide_keys(k, n, dev, gen, sent=0.05, top=1)
    if name == "all_sentinel":
        return wide_keys(k, n, dev, gen, sent=1.0)
    if name == "one_run":
        return wide_keys(k, 1, dev, gen, sent=0.0).expand(-1, n).contiguous()
    if name == "half_sentinel":
        return wide_keys(k, n, dev, gen, sent=0.5)
    if name in ("one_hot_bucket", "one_prefix"):
        from ..ops.sort_kernel import prefix_layout

        keys = wide_keys(k, n, dev, gen,
                         sent=0.1 if name == "one_hot_bucket" else 0.0)
        hot = (keys[0] != SENTINEL) & (
            torch.rand(n, device=dev, generator=gen) < 0.5
            if name == "one_hot_bucket" else True)
        for word, low, count in prefix_layout(keys.shape[0],
                                              2 * kmers.top_bases(k) + 1):
            keys[word] = torch.where(
                hot, keys[word] & ~(((1 << count) - 1) << low), keys[word])
        return keys
    raise KeyError(name)


def wide_merge_inputs(keys: torch.Tensor, gen):
    """(table keys, int32 counts, sorted fresh keys) for the W-word merge
    from [W, n] keys: the first third's distinct keys with counts 1-999,
    the rest sorted."""
    from ..ops import reduce_kernel, sort_kernel

    n = keys.shape[1]
    a = sort_kernel.sort_words_plain(keys[:, :n // 3])
    a, _c, nu = reduce_kernel.reduce_by_key_words_plain(
        a, (a[0] != SENTINEL).to(torch.int32), a.shape[1])
    a = a[:, :int(nu)].contiguous()
    counts = torch.randint(1, 1000, (a.shape[1],), dtype=torch.int32,
                           device=a.device, generator=gen)
    return a, counts, sort_kernel.sort_words_plain(keys[:, n // 3:])


def wide_reduce_inputs(keys: torch.Tensor, gen):
    """(sorted keys, int32 weights) for the W-word reduce: weights 1-8,
    0 at SENTINEL."""
    from ..ops import sort_kernel

    keys = sort_kernel.sort_words_plain(keys)
    w = torch.randint(1, 9, (keys.shape[1],), dtype=torch.int32,
                      device=keys.device, generator=gen)
    return keys, torch.where(keys[0] == SENTINEL, 0, w).to(torch.int32)


def wide_flush_shapes(k: int, dev, gen):
    """The wide flush's shapes once the table has grown to 2^24 slots, as
    flush_shapes gives them for one-word keys: (table keys [W, 2^24] with
    ~2^23 distinct k-mers and SENTINEL padding, their counts, 2^26 sorted
    fresh keys drawn from a 1.5 x 2^23 key universe with 10% SENTINEL,
    and the 83,886,080-element merge of the two by the plain version)."""
    from ..ops import merge_kernel, reduce_kernel, sort_kernel

    cap, n_fresh = 1 << 24, 1 << 26
    universe = wide_keys(k, 3 << 22, dev, gen, sent=0.0)
    real = sort_kernel.sort_words_plain(universe[:, :1 << 23])
    t_keys, _c, nu = reduce_kernel.reduce_by_key_words_plain(
        real, torch.ones(real.shape[1], dtype=torch.int32, device=dev), cap)
    del real
    nu = int(nu)
    t_counts = torch.zeros(cap, dtype=torch.int32, device=dev)
    t_counts[:nu] = torch.randint(1, 100, (nu,), dtype=torch.int32,
                                  device=dev, generator=gen)
    fresh = universe[:, torch.randint(0, universe.shape[1], (n_fresh,),
                                      device=dev, generator=gen)]
    fresh[:, torch.rand(n_fresh, device=dev, generator=gen) < 0.1] = \
        SENTINEL
    fresh = sort_kernel.sort_words_plain(fresh)
    mk, mw = merge_kernel.merge_sorted_words_plain(t_keys, t_counts, fresh)
    return t_keys, t_counts, fresh, mk, mw


# K6, one-word and over W words: the sharded flush's arrival merge
# (parallel/sharded.py)
RUNS_WORDS_STRAIN = ("random", "top_equal", "all_equal", "all_sentinel",
                     "one_run", "unequal_runs")
SHARDED_RUNS, SHARDED_ROUTE_CAP = 8, 1 << 22


def sharded_run_real(k: int) -> int:
    """Real keys a source sends each destination in the main path's flush
    of 16 batches on SHARDED_RUNS shards: its rows' windows over the
    owners, 1,021,952 at k = 27 and 1,007,616 at k = 41, a quarter of
    SHARDED_ROUTE_CAP (the rest is SENTINEL at route slack 4)."""
    return (16 * (MAIN_ROWS // SHARDED_RUNS) * (MAIN_LENGTH - k + 1)
            // SHARDED_RUNS)


def sorted_runs(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """[W, n] keys with each run of run_len (the last may be short) sorted
    by the plain W-word sort, in place; returns keys."""
    from ..ops import sort_kernel

    for lo in range(0, keys.shape[1], run_len):
        keys[:, lo:lo + run_len] = sort_kernel.sort_words_plain(
            keys[:, lo:lo + run_len])
    return keys


def runs_words_strain(name: str, k: int, dev, gen, n_runs: int = 8,
                      run_len: int = 3000):
    """(keys [W, n], run_len): K6 W-word's input where it can go wrong, in
    n_runs ascending runs of run_len, the last 1000 keys short: random
    (10% SENTINEL), equal top words, every key equal (ties across every
    run and tile), all SENTINEL, one run (run_len = n), and runs of
    unequal real length, each with a SENTINEL tail of its own length (the
    sharded flush's buckets)."""
    n = n_runs * run_len - 1000
    if name == "all_equal":
        keys = wide_keys(k, 1, dev, gen, sent=0.0).expand(-1, n).contiguous()
        return keys, run_len
    if name == "one_run":
        return sorted_runs(wide_keys(k, n, dev, gen), n), n
    keys = wide_strain({"unequal_runs": "random"}.get(name, name), k, n, dev,
                       gen)
    if name == "unequal_runs":
        for r, lo in enumerate(range(0, n, run_len)):
            keys[:, lo + r * run_len // n_runs:lo + run_len] = SENTINEL
    return sorted_runs(keys, run_len), run_len


def sharded_runs(k: int, dev, gen, n_runs: int = SHARDED_RUNS,
                 run_len: int = SHARDED_ROUTE_CAP, real: int | None = None):
    """The arrival buffer of one shard in the main path's flush on 8
    shards: n_runs runs of run_len slots, each `real` (by default
    sharded_run_real(k)) sorted random keys of k bases, then a SENTINEL
    tail; int64 [n] at k <= 31, [W, n] words above (W = 2 at k = 41)."""
    real = sharded_run_real(k) if real is None else real
    runs = []
    for _ in range(n_runs):
        run = torch.full((kmers.words_for_k(k), run_len), SENTINEL,
                         dtype=torch.int64, device=dev)
        if real == 0:
            pass
        elif k <= kmers.MAX_K:
            run[0, :real] = torch.sort(torch.randint(
                0, 1 << (2 * k), (real,), dtype=torch.int64, device=dev,
                generator=gen)).values
        else:
            run[:, :real] = sorted_runs(
                wide_keys(k, real, dev, gen, sent=0.0), real)
        runs.append(run)
    keys = torch.cat(runs, dim=1)
    return keys if k > kmers.MAX_K else keys[0]


def sharded_counter(k: int, mesh):
    """The sharded counter the main path's batches go to on a mesh: the
    one-device counters' starting capacity (2^20 slots) split over the
    shards, growing in place; kat_tpu's flush of 16 batches and the route
    slack of tools/common.Input (4.0)."""
    from ..parallel import sharded

    return sharded.ShardedCounter(mesh, k, canonical=True,
                                  shard_capacity=max(1, (1 << 20) // mesh.n),
                                  route_slack=4.0, flush_batches=16)
