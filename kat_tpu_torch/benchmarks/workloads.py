"""What the measurement scripts and chip_smoke.py share: the card's
published rates, the main path's input, and a count of what one call runs
on the card."""

from __future__ import annotations

import numpy as np
import torch

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


def main_path_counter(dev):
    """The counter the main path feeds its batches to."""
    from ..core import counting

    return counting.CodeStreamingCounter(
        MAIN_K, canonical=True, initial_capacity=1 << 20,
        flush_windows=1 << 26, device=dev)


def device_events(fn) -> list[tuple[str, float]]:
    """(name, microseconds) of every kernel, memset and copy that one call
    of `fn` runs on the card, in the order they ran, as torch.profiler
    traces them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        raise RuntimeError("torch.profiler traced nothing on the card")
    return [(e.name, e.time_range.elapsed_us()) for e in events]
