"""K7: R compare-exchange rounds of each class at one fixed stride, the ALU
round and the copy floor, on one NVIDIA card.

    python -m kat_tpu_torch.benchmarks.profile_rounds [--variants] [out.json]

Counterpart of benchmarks/profile_roll.py, the same function: kat_tpu's
two uint32 planes (h, lo), laid out [N/128, 128], are one int64 key
((h << 32) | lo) ^ (1 << 63) an element here (`planes_to_keys`), so signed
order is the planes' unsigned lexicographic order.  For element i:

  - lane-s, row-s, rowsel-s: partner i ^ S, S = s for lane-s and 128 s for
    row-s and rowsel-s (rowsel is row's function; kat_tpu forms it another
    way).  The direction is fixed: bit 3 of the pair's lower index (kat_tpu's
    `dmi`); a pair swaps when (key of the upper < key of the lower) XOR it.
  - alu: an element swaps its own halves when (lo, h) < (h, lo) XOR bit 3
    of its index.
  - copy: each half plus 1 (mod 2^32) a round.

One kernel (csrc/rounds.cu) gives each thread its pairs for the whole
launch: one read, R rounds in registers, one write.  Every class is held
exactly against the plain PyTorch version at a few R, at 2^24 keys and at
a count that leaves the launch a partial last block, then timed.  Two
checks hold every round to running: linearity in R (t(L) - t(0) must be
twice t(L/2) - t(0) within 10%, L = R; a loop that skipped rounds fails
it), and the round loop's instructions read from the library's SASS
(`cuobjdump -sass`; a body whose rounds were folded into fewer fails it,
though its loop still runs R times).  --variants rebuilds a copy of
csrc/rounds.cu alone with another pairs a thread, block size or unroll
depth (its PR_* constants) and times them between two runs of the
library as built.  Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import torch

from ..ops import _cuda

MODES = ("copy", "alu", "lane-1", "lane-64", "row-1", "row-64", "rowsel-1",
         "rowsel-16", "rowsel-64", "rowsel-256")
LANES = 128  # kat_tpu's plane width
BR = 512  # kat_tpu's block rows: a row stride s needs 2 s <= BR
COPY, ALU, CMPX = 0, 1, 2  # the kernel's kinds
MASK32 = (1 << 32) - 1
TOP = 1 << 31


def parse_mode(mode: str) -> tuple[int, int]:
    """mode -> (kernel kind, S): copy and alu take S = 1, the
    compare-exchange classes their partner's distance."""
    if mode in ("copy", "alu"):
        return (COPY if mode == "copy" else ALU), 1
    cls, _, s = mode.partition("-")
    span = {"lane": LANES, "row": BR, "rowsel": BR}.get(cls)
    if span is None or not s.isdigit():
        raise ValueError(f"mode={mode!r}: expected copy, alu, lane-<s>, "
                         "row-<s> or rowsel-<s>")
    s = int(s)
    if s < 1 or s & (s - 1) or 2 * s > span:
        raise ValueError(f"mode={mode!r}: the stride must be a power of two "
                         f"s with 2 s <= {span}")
    return CMPX, s if cls == "lane" else LANES * s


def _check(keys: torch.Tensor, mode: str, rounds: int) -> tuple[int, int]:
    _cuda.require(keys, "keys", torch.int64)
    kind, s = parse_mode(mode)
    if keys.numel() % (2 * s):
        raise ValueError(f"n={keys.numel()} must be a multiple of {2 * s} "
                         f"for {mode}")
    if rounds < 0:
        raise ValueError(f"rounds={rounds} < 0")
    return kind, s


def planes_to_keys(h: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 keys from kat_tpu's planes (integer tensors holding uint32
    values): ((h << 32) | lo) ^ (1 << 63)."""
    top = h.to(torch.int64) ^ TOP
    top = torch.where(top >= TOP, top - (1 << 32), top)
    return top * (1 << 32) + lo.to(torch.int64)


def keys_to_planes(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, lo) int64 tensors of uint32 values: planes_to_keys undone."""
    return ((keys >> 32) & MASK32) ^ TOP, keys & MASK32


def profile_rounds_plain(keys: torch.Tensor, mode: str,
                         rounds: int) -> torch.Tensor:
    """Plain PyTorch version: the same R rounds over the whole array."""
    kind, s = _check(keys, mode, rounds)
    if kind == COPY:
        h, lo = keys_to_planes(keys)
        return planes_to_keys((h + rounds) & MASK32, (lo + rounds) & MASK32)
    i = torch.arange(keys.numel(), device=keys.device)
    if kind == ALU:
        d = ((i >> 3) & 1).bool()
        v = keys.clone()
        for _ in range(rounds):
            h, lo = keys_to_planes(v)
            sw = planes_to_keys(lo, h)
            v = torch.where((sw < v) ^ d, sw, v)
        return v
    low, high = keys.view(-1, 2, s).unbind(1)  # a pair's lower, upper key
    d = ((i.view(-1, 2, s)[:, 0] >> 3) & 1).bool()
    for _ in range(rounds):
        swap = (high < low) ^ d
        low, high = torch.where(swap, high, low), torch.where(swap, low, high)
    return torch.stack((low, high), 1).reshape(-1)


def profile_rounds(keys: torch.Tensor, mode: str, rounds: int) -> torch.Tensor:
    """`rounds` rounds of class `mode` on `keys` (n a multiple of 2 S),
    returned as a new tensor."""
    kind, s = _check(keys, mode, rounds)
    if not _cuda.on_cuda(keys, "profile_rounds"):
        return profile_rounds_plain(keys, mode, rounds)
    if keys.data_ptr() % 16:
        raise ValueError("keys must start on a 16-byte boundary")
    out = torch.empty_like(keys)
    if keys.numel():
        _cuda.launch("kat_profile_rounds", keys.device, keys.data_ptr(),
                     out.data_ptr(), keys.numel(), s, kind, rounds)
        profile_rounds.launches += 1
    return out


profile_rounds.launches = 0  # kernel launches, read by chip_smoke.py


def _timed_ms(fn, reps: int) -> float:
    """ms of one call: CUDA events around `reps` calls after a warm-up,
    queued behind a ~25 ms spin kernel so that the host's launches are not
    timed."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_keys(n: int, dev: torch.device, seed: int = 0) -> torch.Tensor:
    """The keys of n elements of two random uint32 planes, as kat_tpu's
    main() draws them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, lo = (torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device=dev,
                           generator=gen) for _ in range(2))
    return planes_to_keys(h, lo)


def _require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_rounds measures an NVIDIA card: "
                           "torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def ragged_count(mode: str) -> int:
    """A key count of class `mode` (a multiple of 2 S) that leaves the
    launch a partial last block of pairs wherever one can (2 S below a
    block's keys): 2 S (16 blocks' keys / 2 S + 1), at least 3 (2 S)."""
    c = constants()
    block = 2 * c["THREADS"] * c["PAIRS"]
    two_s = 2 * parse_mode(mode)[1]
    return two_s * (max(16 * block // two_s, 2) + 1)


def check(keys: torch.Tensor, rounds=(0, 1, 7)) -> None:
    """Every class equals its plain version exactly at each R, on `keys`
    and on `ragged_count` keys (the kernel's guarded last block)."""
    for mode in MODES:
        for ks in (keys, keys[:ragged_count(mode)]):
            for r in rounds:
                got = profile_rounds(ks, mode, r)
                if not torch.equal(got, profile_rounds_plain(ks, mode, r)):
                    raise AssertionError(
                        f"profile_rounds {mode} at R = {r} on {ks.numel()} "
                        "keys differs from its plain version")


def time_modes(keys: torch.Tensor, rounds: int, reps: int = 10,
               turns: int = 3) -> dict:
    """Per class: ms at R and the linearity in R: t(L), t(L/2) and t(0)
    (ms by R in `ms_at`, each the least of `turns` timings taken in turns)
    must give (t(L) - t(0)) / (2 (t(L/2) - t(0))) = 1 within 10%, as a
    loop that skipped rounds would not.  L = R, but 4 R for copy: its
    rounds are so cheap that other warps' rounds overlap its loads and
    stores (all of t(0)), and at R = 512 the ratio reads 1.12 with every
    round run; at 4 R t(0) is small beside them.  A body whose rounds were
    folded into fewer still scales with R: `hold_sass` fails that."""
    res, bad = {}, []
    for mode in MODES:
        lin = 4 * rounds if mode == "copy" else rounds
        rs = sorted({0, lin // 2, rounds, lin})
        ts = {r: [] for r in rs}
        for _ in range(turns):
            for r in rs:
                ts[r].append(_timed_ms(
                    lambda r=r: profile_rounds(keys, mode, r), reps))
        t = {r: min(v) for r, v in ts.items()}
        res[mode] = dict(ms=t[rounds], ms_at={str(r): t[r] for r in rs},
                         linearity_rounds=lin,
                         linearity=(t[lin] - t[0]) / (2 * (t[lin // 2] - t[0])))
        print(f"K7 {mode}: " + json.dumps(res[mode]), flush=True)
        if abs(res[mode]["linearity"] - 1) > 0.10:
            bad.append(f"{mode} {res[mode]['linearity']:.3f} at R = {lin}")
    if bad:
        raise AssertionError(f"not linear in R within 10%: {', '.join(bad)}"
                             "; rounds were skipped")
    return res


def run(n: int = 1 << 24, rounds: int = 512, reps: int = 10,
        seed: int = 0) -> dict:
    """Check every class against its plain version (R = 0, 1, 7), time
    it, and hold the round loops' SASS (`hold_sass`).  Needs a card and
    the CUDA toolkit's `cuobjdump`."""
    keys = random_keys(n, _require_card(), seed)
    check(keys)
    modes = time_modes(keys, rounds, reps)
    return {"n": n, "rounds": rounds, "max_abs_err": 0, "modes": modes,
            "sass": hold_sass(sass_loops(_cuda.LIBRARY.path))}


# -- what the compiler made of a round --------------------------------------

_KERNEL = re.compile(r"rounds_kernelILi(\d)ELb(\d)E")
_LINE = re.compile(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"(?:\s+(0x[0-9a-f]+))?")


def sass_loops(path: str) -> list[dict]:
    """Each rounds_kernel<kind, adj> of the library at `path`: its longest
    loop (a backward branch: the unrolled rounds), with its instructions by
    opcode.  Needs `cuobjdump` (the CUDA toolkit)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return parse_sass(subprocess.run([tool, "-sass", path],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(text: str) -> list[dict]:
    """`sass_loops` of cuobjdump's text."""
    out = []
    for block in re.split(r"^\s*Function : ", text, flags=re.M)[1:]:
        m = _KERNEL.search(block.split("\n", 1)[0])
        if not m:
            continue
        insns = [(int(a, 16), op, int(t, 16) if t and op.startswith("BRA")
                  else None) for a, op, t in _LINE.findall(block)]
        loops = [(t, a) for a, _, t in insns if t is not None and t < a]
        if not loops:
            continue
        lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
        ops: dict[str, int] = {}
        for a, op, _ in insns:
            if lo <= a <= hi:
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        kind = ("copy", "alu", "cmpx")[int(m.group(1))]
        out.append(dict(kernel=kind + ("-adjacent" if m.group(2) == "1"
                                       else ""),
                        loop_instructions=sum(ops.values()), opcodes=ops))
    return out


# the fewest instructions a pair-round can take, by kernel: copy 4 adds
# (each half of both keys); a compare-exchange 2 compares (the 64-bit
# key), 2 selects (the min) and 2 xors (the max); alu 6 a key (2 xors
# that swap the flipped halves, 2 compares, 2 selects)
PAIR_ROUND_INSNS = {"copy": 4, "alu": 12, "cmpx": 6}
KERNELS = ("copy-adjacent", "alu-adjacent", "cmpx", "cmpx-adjacent")
_CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "NOP", "WARPSYNC"}


def hold_sass(loops: list[dict]) -> list[dict]:
    """`sass_loops`' loops, each with `pair_rounds` (an iteration's:
    PR_PAIRS pairs x PR_UNROLL rounds, one round for copy) and `need`
    (PAIR_ROUND_INSNS a pair-round).  Fails unless each of KERNELS' round
    loop holds at least `need` instructions that do work (every one but
    branches and the uniform datapath's), so no round of an iteration was
    folded into another."""
    c, got = constants(), {loop["kernel"]: loop for loop in loops}
    bad = [f"{k}: no round loop" for k in KERNELS if k not in got]
    for name in KERNELS:
        if name not in got:
            continue
        kind, loop = name.split("-")[0], got[name]
        loop["pair_rounds"] = c["PAIRS"] * (1 if kind == "copy"
                                            else c["UNROLL"])
        loop["need"] = PAIR_ROUND_INSNS[kind] * loop["pair_rounds"]
        loop["work"] = sum(k for op, k in loop["opcodes"].items()
                           if not op.startswith("U") and op not in _CONTROL)
        if loop["work"] < loop["need"]:
            bad.append(f"{name}: {loop['work']} instructions for "
                       f"{loop['pair_rounds']} pair-rounds, at least "
                       f"{loop['need']} needed")
    if bad:
        raise AssertionError("the round loop lost rounds: " + "; ".join(bad))
    return loops


# -- the kernel's constants and build variants ------------------------------

_CONST = re.compile(r"^constexpr int PR_(\w+) = (\d+);", re.M)


def _source() -> str:
    with open(os.path.join(_cuda.CSRC, "rounds.cu")) as f:
        return f.read()


def constants() -> dict[str, int]:
    """csrc/rounds.cu's PR_THREADS, PR_PAIRS and PR_UNROLL, by name
    without the PR_."""
    return {m[1]: int(m[2]) for m in _CONST.finditer(_source())}


VARIANTS = (("PAIRS", 2), ("PAIRS", 8), ("THREADS", 128), ("THREADS", 512),
            ("UNROLL", 1), ("UNROLL", 8))
VARIANT_MODES = ("copy", "alu", "lane-1", "row-64")


def variants(keys: torch.Tensor, rounds: int, reps: int = 5) -> list[dict]:
    """A copy of csrc/rounds.cu with one of VARIANTS' constants changed,
    built alone, behind the wrapper in turn, between two runs of the
    library as built; each checked at R = 7, then VARIANT_MODES timed at
    `rounds`."""
    src = os.path.join(_cuda.BUILD_DIR, "rounds_variant")
    os.makedirs(src, exist_ok=True)
    sig = {"kat_profile_rounds": _cuda._SIGNATURES["kat_profile_rounds"]}
    built_in, rows = _cuda.LIBRARY, []
    try:
        for var in (None, *VARIANTS, None):
            _cuda.LIBRARY = built_in
            if var is not None:
                text, hits = re.subn(rf"^(constexpr int PR_{var[0]} = )\d+;",
                                     rf"\g<1>{var[1]};", _source(), flags=re.M)
                assert hits == 1, var
                with open(os.path.join(src, "rounds.cu"), "w") as f:
                    f.write(text)
                _cuda.LIBRARY = _cuda.KernelLibrary(csrc=src, signatures=sig)
            _cuda.LIBRARY.get()  # built before the next variant's source
            for mode in VARIANT_MODES:
                if not torch.equal(profile_rounds(keys, mode, 7),
                                   profile_rounds_plain(keys, mode, 7)):
                    raise AssertionError(f"{var} {mode} differs")
            row = {"variant": "as built" if var is None
                   else f"PR_{var[0]} = {var[1]}"}
            row.update({mode: _timed_ms(
                lambda mode=mode: profile_rounds(keys, mode, rounds), reps)
                for mode in VARIANT_MODES})
            rows.append(row)
            print("variant " + json.dumps(row), flush=True)
    finally:
        _cuda.LIBRARY = built_in
    return rows


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    smi = card_line()
    print(smi)
    res = run()
    res["card"] = smi
    if "--variants" in argv:
        res["variants"] = variants(random_keys(res["n"], _require_card()),
                                   res["rounds"])
    line = json.dumps(res)
    print(line, flush=True)
    paths = [a for a in argv if a != "--variants"]
    if paths:
        with open(paths[0], "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
