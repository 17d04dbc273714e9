"""K7: per-round cost of the compare-exchange classes that the chunk sort
(K5, csrc/chunk_sort.cu) is built from, on one NVIDIA card.

    python -m kat_tpu_torch.benchmarks.profile_rounds [out.json]

Counterpart of benchmarks/profile_roll.py.  One kernel (csrc/rounds.cu)
loads a tile of 2048 int64 keys per block once, runs R rounds, and stores
once; `copy` is the floor, and (t(mode) - t(copy)) / R / N is the marginal
ns per element per round of each class: `alu` (compare and select, no
movement), `shfl-1` and `shfl-16` (__shfl_xor_sync partners), `smem-32` and
`smem-1024` (partners through shared memory, two barriers a round).  Every
mode's output is deterministic and is held exactly against the plain
PyTorch version at a small R before anything is timed.  Prints the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _cuda

TILE = 2048
MODES = ("copy", "alu", "shfl-1", "shfl-16", "smem-32", "smem-1024")
_KINDS = {"copy": 0, "alu": 1, "shfl": 2, "smem": 3}
_TOP_STRIDE = {"shfl": 16, "smem": 1024}  # the classes that take a stride


def _parse(mode: str) -> tuple[int, int]:
    """mode -> (kernel mode, log2 of the stride).  `alu` pairs a thread's
    own two keys, 1024 apart."""
    kind, _, stride = mode.partition("-")
    if kind not in _KINDS or (kind in _TOP_STRIDE) != bool(stride):
        raise ValueError(f"mode={mode!r}: expected copy, alu, shfl-<s> or "
                         "smem-<s>")
    if kind not in _TOP_STRIDE:
        return _KINDS[kind], 10 if kind == "alu" else 0
    s = int(stride)
    if s < 1 or s > _TOP_STRIDE[kind] or s & (s - 1):
        raise ValueError(f"mode={mode!r}: the stride must be a power of two "
                         f"in [1, {_TOP_STRIDE[kind]}]")
    return _KINDS[kind], s.bit_length() - 1


def profile_rounds_plain(keys: torch.Tensor, mode: str,
                         rounds: int) -> torch.Tensor:
    """Plain PyTorch version: the same rounds, one gather, compare and
    select per round over the whole array."""
    kind, sl = _parse(mode)
    if kind == 0:
        return keys + rounds
    g = torch.arange(keys.numel(), device=keys.device)
    partner = g ^ (1 << sl)
    lower = ((g >> sl) & 1) == 0
    v = keys
    for r in range(rounds):
        asc = (((g >> (sl + 1)) ^ r) & 1) == 0
        o = v[partner]
        v = torch.where(lower == asc, torch.minimum(v, o),
                        torch.maximum(v, o))
    return v


def profile_rounds(keys: torch.Tensor, mode: str, rounds: int) -> torch.Tensor:
    """`rounds` compare-exchange rounds of class `mode` on every 2048-key
    tile of `keys`, returned as a new tensor."""
    _cuda.require(keys, "keys", torch.int64)
    kind, sl = _parse(mode)
    if keys.numel() % TILE:
        raise ValueError(f"n={keys.numel()} must be a multiple of {TILE}")
    if rounds < 0:
        raise ValueError(f"rounds={rounds} < 0")
    if not _cuda.on_cuda(keys, "profile_rounds"):
        return profile_rounds_plain(keys, mode, rounds)
    out = torch.empty_like(keys)
    if keys.numel():
        _cuda.launch("kat_profile_rounds", keys.device, keys.data_ptr(),
                     out.data_ptr(), keys.numel(), kind, sl, rounds)
        profile_rounds.launches += 1
    return out


profile_rounds.launches = 0  # kernel launches, read by chip_smoke.py


def _timed_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(n: int = 1 << 24, rounds: int = 512, check_rounds: int = 6,
        reps: int = 3, seed: int = 0) -> dict:
    """Check every mode against its plain version (exactly, at
    check_rounds), then time it at `rounds`.  Needs a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rounds measures an NVIDIA card: "
                           "torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    keys = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64,
                         device=dev, generator=gen)
    res = {"n": n, "rounds": rounds, "max_abs_err": 0}
    for mode in MODES:
        got = profile_rounds(keys, mode, check_rounds)
        want = profile_rounds_plain(keys, mode, check_rounds)
        if not torch.equal(got, want):
            raise AssertionError(f"profile_rounds {mode} differs from its "
                                 "plain version")
    floor = _timed_ms(lambda: profile_rounds(keys, "copy", rounds), reps)
    res["floor_ms"] = floor
    for mode in MODES[1:]:
        t = _timed_ms(lambda: profile_rounds(keys, mode, rounds), reps)
        res[f"{mode}_ms"] = t
        res[f"{mode}_round_ns_per_elt"] = (t - floor) * 1e6 / rounds / n
    return res


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    res = run()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    res["card"] = smi
    line = json.dumps(res)
    print(line, flush=True)
    if argv:
        with open(argv[0], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
