"""K7 (kat_tpu_torch/benchmarks/profile_rounds.py) against kat_tpu's own
K7, benchmarks/profile_roll.py's `_kernel`, run through `pl.pallas_call`
in interpret mode at its small size (KAT_TPU_ROLL_SMALL: BR = 128 rows,
N = 2^15), on the same seeded planes, for each of its nine small-size
classes at R = 0, 1 and 4.  Exact: the port's keys are kat_tpu's planes,
one int64 key an element.  Then the check that holds the card's round
loops to every round (`hold_sass`, on SASS text written here) and the
key counts that reach the kernel's partial last block."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kat_tpu_torch.benchmarks import profile_rounds as pr
from kat_tpu_torch.benchmarks.profile_rounds import (MODES, keys_to_planes,
                                                     planes_to_keys,
                                                     profile_rounds)

torch.set_num_threads(1)

ROLL = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / \
    "profile_roll.py"
# profile_roll.py's classes at BR = 128: rowsel-256 needs 2 * 256 rows
SMALL_MODES = ("copy", "alu", "lane-1", "lane-64", "row-1", "row-64",
               "rowsel-1", "rowsel-16", "rowsel-64")


@pytest.fixture(scope="module")
def roll():
    """benchmarks/profile_roll.py at its small size, under a private name."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KAT_TPU_ROLL_SMALL", "1")
        spec = importlib.util.spec_from_file_location("_kat_tpu_profile_roll",
                                                      ROLL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    assert (mod.BR, mod.N, mod.LANES) == (128, 1 << 15, 128)
    return mod


@pytest.fixture(scope="module")
def planes(roll):
    rng = np.random.default_rng(7)
    return tuple(rng.integers(0, 1 << 32, size=(roll.N // roll.LANES,
                                                roll.LANES), dtype=np.uint32)
                 for _ in range(2))


def _kat_tpu(roll, mode, rounds, h, lo):
    """profile_roll's kernel as its main() builds it, with R = rounds."""
    n, br, lanes = roll.N, roll.BR, roll.LANES
    roll.R = rounds  # read by _kernel's loop when it is traced
    call = pl.pallas_call(
        functools.partial(roll._kernel, mode),
        grid=(n // (br * lanes),),
        in_specs=[pl.BlockSpec((br, lanes), lambda i: (i, 0))] * 2,
        out_specs=[pl.BlockSpec((br, lanes), lambda i: (i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((n // lanes, lanes), jnp.uint32)] * 2,
        interpret=True)
    with jax.enable_x64(False):
        oh, ol = call(jnp.asarray(h), jnp.asarray(lo))
    return np.asarray(oh), np.asarray(ol)


def _t(a):
    return torch.from_numpy(np.asarray(a).reshape(-1).astype(np.int64))


def test_the_small_modes_are_the_ports_but_rowsel_256():
    assert SMALL_MODES + ("rowsel-256",) == MODES


@pytest.mark.parametrize("rounds", (0, 1, 4))
@pytest.mark.parametrize("mode", SMALL_MODES)
def test_rounds_match_kat_tpu(roll, planes, mode, rounds):
    h, lo = planes
    want_h, want_lo = _kat_tpu(roll, mode, rounds, h, lo)
    got = profile_rounds(planes_to_keys(_t(h), _t(lo)), mode, rounds)
    gh, glo = keys_to_planes(got)
    assert torch.equal(gh, _t(want_h))
    assert torch.equal(glo, _t(want_lo))


def test_planes_and_keys_round_trip():
    """The key's signed order is the planes' unsigned lexicographic order."""
    rng = np.random.default_rng(3)
    h = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    h[:4], lo[:4] = [0, 0, (1 << 32) - 1, (1 << 32) - 1], [0, 1, 0, 1]
    keys = planes_to_keys(_t(h), _t(lo))
    gh, glo = keys_to_planes(keys)
    assert torch.equal(gh, _t(h)) and torch.equal(glo, _t(lo))
    want = np.lexsort((lo, h))  # h major, unsigned
    assert torch.equal(keys[torch.from_numpy(want)], keys.sort().values)
    assert keys[:4].tolist() == [-(1 << 63), -(1 << 63) + 1,
                                 (1 << 63) - (1 << 32), (1 << 63) - (1 << 32)
                                 + 1]


# -- the round loops' SASS (profile_rounds.hold_sass) -------------------------

# the opcodes of each kernel's round loop in the library as built for the
# H100 (cuobjdump -sass; profile_rounds.py's "sass" on the card)
AS_BUILT = {
    (0, 1): {"UIADD3": 1, "VIADD": 13, "IADD3": 3, "ISETP": 1, "BRA": 1},
    (1, 1): {"LOP3": 64, "UIADD3": 2, "ISETP": 65, "UMOV": 1, "SEL": 64,
             "BRA": 1},
    (2, 0): {"ISETP": 33, "UIADD3": 2, "SEL": 32, "UMOV": 1, "LOP3": 32,
             "BRA": 1},
    (2, 1): {"ISETP": 33, "UIADD3": 2, "SEL": 32, "LOP3": 32, "BRA": 1},
}


def _sass(kernels):
    """cuobjdump-like text: per (kind, adj), a function whose only loop
    holds the given opcodes (its backward branch last), after a load."""
    out = []
    for (kind, adj), ops in kernels.items():
        out.append(f"\t\tFunction : _ZN41_GLOBAL__N__9_rounds_cu13rounds_"
                   f"kernelILi{kind}ELb{adj}EEEvPKlPllii")
        body = [op for op, k in ops.items() if op != "BRA" for _ in range(k)]
        out.append("        /*0000*/                   LDG.E.64 R2, "
                   "desc[UR4][R4.64] ;")
        at = 0x10
        for op in body:
            out.append(f"        /*{at:04x}*/                   {op} R1, R1, "
                       "0x1 ;")
            at += 0x10
        out.append(f"        /*{at:04x}*/              @!P4 BRA 0x0010 ;")
        out.append(f"        /*{at + 0x10:04x}*/                   EXIT ;")
    return "\n".join(out) + "\n"


def _folded(kind_adj, op, drop):
    ops = {k: dict(v) for k, v in AS_BUILT.items()}
    ops[kind_adj][op] -= drop
    return ops


@pytest.mark.parametrize("kernels,bad", [
    (AS_BUILT, None),
    # the assembler summed the +1s of copy's iteration: 13 adds for 16
    (_folded((0, 1), "VIADD", 3), "copy-adjacent"),
    # one of an iteration's four compare-exchange rounds folded away
    (_folded((2, 0), "SEL", 8), "cmpx:"),
    (_folded((2, 1), "LOP3", 8), "cmpx-adjacent"),
    (_folded((1, 1), "SEL", 16), "alu-adjacent"),
    ({k: v for k, v in AS_BUILT.items() if k != (2, 1)}, "cmpx-adjacent"),
], ids=["as_built", "copy_folded", "cmpx_round_dropped",
        "cmpx_adjacent_round_dropped", "alu_round_dropped", "kernel_missing"])
def test_hold_sass(kernels, bad):
    loops = pr.parse_sass(_sass(kernels))
    assert {loop["kernel"] for loop in loops} == {
        ("copy", "alu", "cmpx")[k] + ("-adjacent" if a else "")
        for k, a in kernels}
    for loop in loops:  # the load and the EXIT lie outside the loop
        assert "LDG" not in loop["opcodes"] and "EXIT" not in loop["opcodes"]
    if bad is None:
        held = pr.hold_sass(loops)
        assert [(h["kernel"], h["work"], h["need"]) for h in held] == [
            ("copy-adjacent", 17, 16), ("alu-adjacent", 193, 192),
            ("cmpx", 97, 96), ("cmpx-adjacent", 97, 96)]
    else:
        with pytest.raises(AssertionError, match=bad):
            pr.hold_sass(loops)


def test_ragged_counts_reach_the_partial_block():
    """Each class's ragged count is a multiple of 2 S, and leaves a partial
    last block (2 x 256 threads x 4 pairs = 2048 keys) wherever 2 S is
    below 2048; rowsel-256's is three of its 65,536-key blocks."""
    assert pr.constants() == {"THREADS": 256, "PAIRS": 4, "UNROLL": 4}
    for mode in MODES:
        n, two_s = pr.ragged_count(mode), 2 * pr.parse_mode(mode)[1]
        assert n % two_s == 0 and (n % 2048 != 0) == (two_s < 2048), mode
    assert pr.ragged_count("rowsel-256") == 3 << 16
