"""K1: sort of int64 k-mer keys, alone (the fresh windows of the counting
flush) or carrying one int32 value each (the queries of the sort-merge join),
and of wide keys of W int64 words, alone (`sort_words`, the fresh windows of
the wide counting flush, core/wide.py) or carrying one int32 value each
(`sort_words_pairs`, the queries of the wide join).
K5: independent sort of every aligned chunk, and K6: merge of sorted runs
(both of the minimizer-bucketed flush, core/bucketed.py; K6 also merges the
runs that arrive at a shard in the sharded flush, narrow and over W
words).

Counterpart of kat_tpu/ops/sort_kernel.py: `sort_planes_padded` (full-sort
mode of `_window_kernel`), `bitonic_sort_chunks` (chunk mode) and
`bitonic_merge_runs` (runs mode).  On a CUDA tensor `sort_keys` and
`sort_pairs` launch the one-sweep LSD radix sort of csrc/sort.cu,
`sort_words` and `sort_words_pairs` its W-word sort (a split on the key's
16-bit prefix, then a shared-memory sort of each bucket; `sort_words_model`
is that design step by step in plain PyTorch), `sort_chunks` the shared-memory bitonic sort of csrc/chunk_sort.cu and
`merge_runs` / `merge_runs_words` (K6 over W words, the arrival merge of
the sharded flush, parallel/sharded.py) the merge-path tree of
csrc/merge_runs.cu; on a CPU tensor they
take the plain versions (`*_plain`).  No padding to a power of two: the radix sort and the
run merge take any length.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda


def sort_keys_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ascending sort (SENTINEL = INT64_MAX last)."""
    return torch.sort(keys).values


def _check(keys: torch.Tensor, key_bits: int, name: str) -> None:
    _cuda.require(keys, "keys", torch.int64)
    if not 1 <= key_bits <= 63:
        raise ValueError(f"key_bits={key_bits} outside [1, 63]")
    # the kernel's status words keep a count in 30 bits
    if keys.numel() >= 1 << 30:
        raise ValueError(f"{name}: n={keys.numel()} must be < 2^30")


def tile_len(with_values: bool) -> int:
    """Keys (or pairs) one thread block of the card's sort takes, as the
    compiled library reports it."""
    lib = _cuda.LIBRARY.get()
    return int(lib.kat_radix_sort_pairs_tile() if with_values
               else lib.kat_radix_sort_tile())


def pass_floor_bytes(n: int, with_values: bool, key_bits: int) -> int:
    """Bytes the card's sort must move by its pass structure: one read of
    the keys for the histograms, then one read and one write of every key
    (and value) per 8-bit digit of key_bits."""
    passes = (key_bits + 7) // 8
    return n * ((12 + 24 * passes) if with_values else (8 + 16 * passes))


def sort_keys(keys: torch.Tensor, key_bits: int) -> torch.Tensor:
    """Ascending sort of a 1-D int64 key tensor, returned as a new tensor.

    key_bits: every non-sentinel key must be < 2^(key_bits-1), so that the
    sentinel (INT64_MAX, bit key_bits-1 set) sorts last.  Counting passes
    2k+1; the kernel then sorts only ceil(key_bits / 8) 8-bit digits.
    """
    _check(keys, key_bits, "sort_keys")
    if not _cuda.on_cuda(keys, "sort_keys"):
        return sort_keys_plain(keys)
    n = keys.numel()
    out = torch.empty_like(keys)
    if n == 0:
        return out
    alt = torch.empty_like(keys) if key_bits > 8 else None
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_scratch", n, key_bits),
        dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort", keys.device, keys.data_ptr(),
                 out.data_ptr(), alt.data_ptr() if alt is not None else None,
                 scratch.data_ptr(), n, key_bits)
    sort_keys.launches += 1
    return out


sort_keys.launches = 0  # kernel launches, read by chip_smoke.py


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version: stable ascending sort, values gathered
    through its permutation."""
    keys, perm = torch.sort(keys, stable=True)
    return keys, values[perm]


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, key_bits: int):
    """Stable ascending sort of 1-D int64 keys carrying one int32 value
    each; returns new (keys, values) tensors.  Equal keys keep their input
    order, which the join relies on.  key_bits as in `sort_keys`."""
    _check(keys, key_bits, "sort_pairs")
    _cuda.require(values, "values", torch.int32, keys.device)
    if values.numel() != keys.numel():
        raise ValueError("keys and values differ in length")
    if not _cuda.on_cuda(keys, "sort_pairs"):
        return sort_pairs_plain(keys, values)
    n = keys.numel()
    out, vout = torch.empty_like(keys), torch.empty_like(values)
    if n == 0:
        return out, vout
    alt = torch.empty_like(keys) if key_bits > 8 else None
    valt = torch.empty_like(values) if key_bits > 8 else None
    scratch = torch.empty(
        _cuda.scratch_len("kat_radix_sort_pairs_scratch", n, key_bits),
        dtype=torch.int32, device=keys.device)
    _cuda.launch("kat_radix_sort_pairs", keys.device, keys.data_ptr(),
                 values.data_ptr(), out.data_ptr(), vout.data_ptr(),
                 alt.data_ptr() if alt is not None else None,
                 valt.data_ptr() if valt is not None else None,
                 scratch.data_ptr(), n, key_bits)
    sort_pairs.launches += 1
    return out, vout


sort_pairs.launches = 0  # kernel launches, read by chip_smoke.py


MIN_CHUNK, MAX_CHUNK = 1 << 5, 1 << 14  # what csrc/chunk_sort.cu takes


def sort_chunks_plain(keys: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Plain PyTorch version: a row-wise sort of the [chunks, chunk_elems]
    view."""
    return keys.view(-1, chunk_elems).sort(dim=1).values.reshape(-1)


def sort_chunks(keys: torch.Tensor, chunk_elems: int) -> torch.Tensor:
    """Sort every aligned span of `chunk_elems` int64 keys ascending, each
    on its own, into a new tensor: sentinels (INT64_MAX) end up at each
    chunk's tail.  Keys compare as signed int64, all 64 bits (so there is
    no key_bits to pass).

    chunk_elems: a power of two in [32, 16384] (one thread block holds a
    chunk in shared memory) that divides len(keys)."""
    _cuda.require(keys, "keys", torch.int64)
    if not (MIN_CHUNK <= chunk_elems <= MAX_CHUNK) or \
            chunk_elems & (chunk_elems - 1):
        raise ValueError(f"chunk_elems={chunk_elems} must be a power of two "
                         f"in [{MIN_CHUNK}, {MAX_CHUNK}]")
    if keys.numel() % chunk_elems:
        raise ValueError(f"n={keys.numel()} must be a multiple of "
                         f"chunk_elems={chunk_elems}")
    if not _cuda.on_cuda(keys, "sort_chunks"):
        return sort_chunks_plain(keys, chunk_elems)
    out = torch.empty_like(keys)
    if keys.numel() == 0:
        return out
    _cuda.launch("kat_sort_chunks", keys.device, keys.data_ptr(),
                 out.data_ptr(), keys.numel() // chunk_elems,
                 chunk_elems.bit_length() - 1)
    sort_chunks.launches += 1
    return out


sort_chunks.launches = 0  # kernel launches, read by chip_smoke.py


def merge_runs_plain(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Plain PyTorch version: a full sort (the runs' order is no help to
    it)."""
    return torch.sort(keys).values


def merge_runs(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Merge the ascending runs keys[r*run_len : (r+1)*run_len] into one
    ascending stream, returned as a new tensor.  Any length and any
    run_len >= 1: the last run may be short."""
    _cuda.require(keys, "keys", torch.int64)
    if run_len < 1:
        raise ValueError(f"run_len={run_len} < 1")
    if keys.numel() >= 1 << 40:
        raise ValueError(f"merge_runs: n={keys.numel()} must be < 2^40")
    if not _cuda.on_cuda(keys, "merge_runs"):
        return merge_runs_plain(keys, run_len)
    n = keys.numel()
    out = torch.empty_like(keys)
    if n == 0:
        return out
    tmp = torch.empty_like(keys) if n > 2 * run_len else None
    _cuda.launch("kat_merge_runs", keys.device, keys.data_ptr(),
                 out.data_ptr(), tmp.data_ptr() if tmp is not None else None,
                 n, run_len)
    merge_runs.launches += 1
    return out


merge_runs.launches = 0  # kernel launches, read by chip_smoke.py


def merge_runs_words_plain(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Plain PyTorch version of `merge_runs_words`: the plain W-word sort
    (the runs' order is no help to it)."""
    return sort_words_plain(keys)


def merge_runs_words(keys: torch.Tensor, run_len: int) -> torch.Tensor:
    """Merge the ascending runs keys[:, r*run_len : (r+1)*run_len] of
    [W, n] int64 wide keys (word 0 most significant, 2 <= W <= 9) into one
    ascending lexicographic stream, returned as a new contiguous [W, n]
    tensor; each word's plane must be contiguous (planes may lie apart).
    Any length and any run_len >= 1: the last run may be short.  Keys
    compare as signed int64 words, so SENTINEL tails merge last."""
    _cuda.require_words(keys, "keys")
    if run_len < 1:
        raise ValueError(f"run_len={run_len} < 1")
    W, n = keys.shape
    if n >= 1 << 40:
        raise ValueError(f"merge_runs_words: n={n} must be < 2^40")
    if not _cuda.on_cuda(keys, "merge_runs_words"):
        return merge_runs_words_plain(keys, run_len)
    out = torch.empty((W, n), dtype=torch.int64, device=keys.device)
    if n == 0:
        return out
    if keys.stride(0) < n:  # planes overlap (a broadcast view)
        keys = keys.contiguous()
    tmp = torch.empty_like(out) if n > 2 * run_len else None
    _cuda.launch("kat_merge_runs_words", keys.device, keys.data_ptr(),
                 keys.stride(0), out.data_ptr(),
                 tmp.data_ptr() if tmp is not None else None, n, run_len, W)
    merge_runs_words.launches += 1
    return out


merge_runs_words.launches = 0  # kernel launches, read by chip_smoke.py


def words_order_plain(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts [W, n] keys stably: W stable torch.sort
    calls from the least significant word up, each through the last's
    order."""
    perm = None
    for w in reversed(range(keys.shape[0])):
        col = keys[w] if perm is None else keys[w][perm]
        idx = torch.sort(col, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return perm


def sort_words_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `sort_words`."""
    return keys[:, words_order_plain(keys)]


PREFIX_BITS = 16  # the W-word sort splits on a key's first 16 significant bits
SENTINEL_BUCKET = 1 << PREFIX_BITS  # the sentinels' own bucket, after all
LOWER_WORD_BITS = 62  # a lower word's bits (31 bases)
BUCKET_CAP = 4096  # keys csrc/sort.cu's bucket sort takes in one block


def prefix_layout(n_words: int, top_bits: int) -> list[tuple[int, int, int]]:
    """Which bits make the W-word sort's 16-bit prefix: (word, lowest bit,
    bit count) pieces, most significant first.  A key's significant bits are
    the top word's top_bits - 1 data bits followed by 62 bits of each lower
    word, so the prefix spans the top word and the next where the top word
    holds fewer than 16 (k = 32-38, the sharded sort's owner word)."""
    if not 2 <= n_words <= _cuda.MAX_WORDS or not 1 <= top_bits <= 63:
        raise ValueError(f"n_words={n_words}, top_bits={top_bits}")
    t = top_bits - 1
    if t >= PREFIX_BITS:
        return [(0, t - PREFIX_BITS, PREFIX_BITS)]
    rest = PREFIX_BITS - t
    head = [(0, 0, t)] if t else []
    return head + [(1, LOWER_WORD_BITS - rest, rest)]


def bucket_of(keys: torch.Tensor, top_bits: int) -> torch.Tensor:
    """Each key's bucket (int64 [n]): its prefix (`prefix_layout`), or
    SENTINEL_BUCKET where the top word is 2^(top_bits - 1) or more (the
    SENTINEL: its bit top_bits - 1 is set), so that a real key whose prefix
    is all ones shares no bucket with the sentinels."""
    b = torch.zeros(keys.shape[1], dtype=torch.int64, device=keys.device)
    for word, low, count in prefix_layout(keys.shape[0], top_bits):
        b = b << count | keys[word] >> low & ((1 << count) - 1)
    sent = keys[0] >> (top_bits - 1) != 0
    return torch.where(sent, SENTINEL_BUCKET, b)


def fallback_digits(n_words: int, top_bits: int) -> list[tuple[int, int]]:
    """(word, shift) of each 8-bit digit that a bucket too large for one
    block is sorted on by the fallback passes, least significant first:
    every digit of the lower words' 62 bits and of the top word's
    top_bits - 1 data bits, except those wholly inside the prefix (equal
    across a bucket).  Sentinels are never in such a bucket."""
    held: dict[int, set[int]] = {}
    for word, low, count in prefix_layout(n_words, top_bits):
        held.setdefault(word, set()).update(range(low, low + count))
    out = []
    for word in reversed(range(n_words)):
        width = top_bits - 1 if word == 0 else LOWER_WORD_BITS
        for shift in range(0, width, 8):
            if not set(range(shift, min(shift + 8, width))) <= held.get(
                    word, set()):
                out.append((word, shift))
    return out


def plan_units(counts: torch.Tensor, cap: int = BUCKET_CAP):
    """The bucket sort's units from the real buckets' counts (int64
    [2^16]), as csrc/sort.cu's split_plan cuts them: a bucket of more than
    cap // 2 keys is a unit alone (oversize past cap), and runs of smaller
    buckets whose starts lie in one cap // 2-aligned window share one, so a
    unit that is not oversize holds at most cap keys.  Returns (starts,
    int64 [units + 1] ending at the number of real keys; oversize, bool
    [units])."""
    small = cap // 2
    starts = torch.cumsum(counts, 0) - counts
    opens = torch.ones_like(counts, dtype=torch.bool)
    opens[1:] = ((counts[1:] > small) | (counts[:-1] > small)
                 | (starts[1:] // small != starts[:-1] // small))
    ends = counts.sum().reshape(1)
    return torch.cat([starts[opens], ends]), counts[opens] > cap


def sort_words_model(keys: torch.Tensor, values: torch.Tensor | None,
                     top_bits: int, cap: int = BUCKET_CAP):
    """csrc/sort.cu's W-word sort step by step in plain PyTorch: the
    buckets (`bucket_of`) and their histogram, two stable passes by the
    prefix's low and then high 8-bit digit (sentinels' high digit 256), the
    units of `plan_units`, each unit sorted stably, and each oversize
    bucket by stable passes over `fallback_digits`.  Returns (keys [W, n],
    values or None); equal to `sort_words_pairs_plain` for every input the
    kernels take."""
    b = bucket_of(keys, top_bits)
    order = torch.sort(b & 255, stable=True).indices
    order = order[torch.sort(b[order] >> 8, stable=True).indices]
    out, b = keys[:, order], b[order]
    vout = None if values is None else values[order]
    counts = torch.bincount(b[b < SENTINEL_BUCKET],
                            minlength=SENTINEL_BUCKET)
    starts, oversize = plan_units(counts, cap)
    digits = fallback_digits(keys.shape[0], top_bits)
    for u in range(oversize.numel()):
        lo, hi = int(starts[u]), int(starts[u + 1])
        if hi - lo < 2:
            continue
        seg = out[:, lo:hi]
        if oversize[u]:
            perm = torch.arange(hi - lo, device=keys.device)
            for word, shift in digits:
                d = seg[word][perm] >> shift & 255
                perm = perm[torch.sort(d, stable=True).indices]
        else:
            perm = words_order_plain(seg)
        out[:, lo:hi] = seg[:, perm]
        if vout is not None:
            vout[lo:hi] = vout[lo:hi][perm]
    return out, vout


def words_passes(n_words: int, top_bits: int) -> int:
    """Passes of the W-word sort over the whole array, whatever W: the two
    split passes and the bucket sort (buckets past BUCKET_CAP add passes
    over themselves)."""
    prefix_layout(n_words, top_bits)
    return 3


def words_tile_len(n_words: int) -> int:
    """Keys a tile of the card's W-word split passes takes, as the compiled
    library reports it for W words."""
    return int(_cuda.LIBRARY.get().kat_radix_sort_words_tile(n_words))


def words_bucket_cap() -> int:
    """Keys the card's bucket sort takes in one block, as the compiled
    library reports it (BUCKET_CAP)."""
    return int(_cuda.LIBRARY.get().kat_radix_sort_words_bucket_cap())


def words_pass_floor_bytes(n: int, n_words: int, top_bits: int,
                           with_values: bool = False) -> int:
    """Bytes the card's W-word sort must move by its pass structure when no
    bucket is oversize: one read of the words that hold the prefix for the
    histogram, then one read and one write of every word of every key (and
    its value) per pass."""
    hist = 8 * len({w for w, _l, _c in prefix_layout(n_words, top_bits)})
    return n * (hist + 2 * words_passes(n_words, top_bits)
                * (8 * n_words + (4 if with_values else 0)))


def _check_words(keys: torch.Tensor, top_bits: int, name: str) -> None:
    _cuda.require_words(keys, name)
    if not 1 <= top_bits <= 63:
        raise ValueError(f"top_bits={top_bits} outside [1, 63]")
    # the kernel's status words keep a count in 30 bits
    if keys.shape[1] >= 1 << 30:
        raise ValueError(f"{name}: n={keys.shape[1]} must be < 2^30")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _sort_words_launch(keys: torch.Tensor, values: torch.Tensor | None,
                       top_bits: int):
    """Both C entry points of the card's W-word sort, with the one host
    read between them (the plan's unit and oversize counts)."""
    W, n = keys.shape
    dev = keys.device
    out, alt = torch.empty_like(keys), torch.empty_like(keys)
    vout = valt = None
    if values is not None:
        vout, valt = torch.empty_like(values), torch.empty_like(values)
    scratch = torch.empty(
        _cuda.scratch_len("kat_sort_words_split_scratch", n, W, top_bits),
        dtype=torch.int32, device=dev)
    _cuda.launch("kat_sort_words_split", dev, keys.data_ptr(), _ptr(values),
                 out.data_ptr(), _ptr(vout), alt.data_ptr(), _ptr(valt),
                 scratch.data_ptr(), n, W, top_bits)
    n_units, n_over, over_tiles = scratch[:3].tolist()
    digits = [w << 8 | s for w, s in fallback_digits(W, top_bits)]
    fscratch = None if n_over == 0 else torch.empty(
        _cuda.scratch_len("kat_sort_words_fallback_scratch", n_over,
                          over_tiles, len(digits)),
        dtype=torch.int32, device=dev)
    host_digits = (ctypes.c_int32 * len(digits))(*digits)
    _cuda.launch("kat_sort_words_finish", dev, out.data_ptr(), _ptr(vout),
                 alt.data_ptr(), _ptr(valt), scratch.data_ptr(),
                 _ptr(fscratch), n, W, top_bits, n_units, n_over, over_tiles,
                 ctypes.addressof(host_digits), len(digits))
    return out, vout


def sort_words(keys: torch.Tensor, top_bits: int) -> torch.Tensor:
    """Ascending lexicographic sort of [W, n] int64 wide keys (word 0 most
    significant), returned as a new contiguous [W, n] tensor.

    top_bits: every non-sentinel key's top word is < 2^(top_bits-1), so
    that the sentinel (INT64_MAX in every word) sorts last; counting passes
    2 top_bases(k) + 1.  Lower words are < 2^62.  On the card a call reads
    the host once (`host_reads`), between the split and the bucket sort."""
    _check_words(keys, top_bits, "sort_words")
    if not _cuda.on_cuda(keys, "sort_words"):
        return sort_words_plain(keys)
    keys = keys.contiguous()
    if keys.shape[1] == 0:
        return torch.empty_like(keys)
    out, _ = _sort_words_launch(keys, None, top_bits)
    sort_words.launches += 1
    sort_words.host_reads += 1
    return out


sort_words.launches = 0  # kernel launches, read by chip_smoke.py
sort_words.host_reads = 0  # reads of the device by the host, likewise


def sort_words_pairs_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version of `sort_words_pairs`: the stable W-word
    permutation gathers keys and values."""
    perm = words_order_plain(keys)
    return keys[:, perm], values[perm]


def sort_words_pairs(keys: torch.Tensor, values: torch.Tensor,
                     top_bits: int):
    """Stable ascending lexicographic sort of [W, n] int64 wide keys
    carrying one int32 value each; returns new (keys [W, n] contiguous,
    values [n]).  Equal keys keep their input order, which the wide join
    relies on.  top_bits as in `sort_words`; one host read a call on the
    card likewise."""
    _check_words(keys, top_bits, "sort_words_pairs")
    _cuda.require(values, "values", torch.int32, keys.device)
    if values.numel() != keys.shape[1]:
        raise ValueError("keys and values differ in length")
    if not _cuda.on_cuda(keys, "sort_words_pairs"):
        return sort_words_pairs_plain(keys, values)
    keys = keys.contiguous()
    if keys.shape[1] == 0:
        return torch.empty_like(keys), torch.empty_like(values)
    out, vout = _sort_words_launch(keys, values, top_bits)
    sort_words_pairs.launches += 1
    sort_words_pairs.host_reads += 1
    return out, vout


sort_words_pairs.launches = 0  # kernel launches, read by chip_smoke.py
sort_words_pairs.host_reads = 0  # reads of the device by the host, likewise
