"""`kat comp` — k-mer comparison between two (or three) inputs (port of
kat_tpu/tools/comp.py).

Output-parity re-implementation of reference src/comp.cc.  The slice-parallel
compare with random hash probes (comp.cc:366-484) becomes three passes over
sorted tables (core/comp_engine.py); counters, spectra and the 1001x1001
matrices are sums and binned sums on the device, so the mutex+merge
machinery of ThreadedCompCounters (lib/src/comp_counters.cc:230-254)
disappears.  When every input was counted on one mesh, the passes run per
shard on the co-partitioned shard tables and their results are summed
(parallel/analysis.comp_sharded); the tables never leave their shards.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import DEFAULT_NB_BINS
from ..core import comp_engine, tables
from ..core.distance import ALL_METRICS
from ..core.matrix import Matrix
from ..io import mme
from ..utils.fmt import cpp_double
from ..utils.profiling import annotate, count
from ..utils.timer import stage
from .common import Input, InputMode, ensure_parent_dir


def _host(t: torch.Tensor) -> np.ndarray:
    """An int64 count tensor as the uint64 numpy array the writers take: a
    host read (`kat.read.comp`, counted in `host_reads`)."""
    with annotate("kat.read.comp"):
        count("host_reads")
        return t.cpu().numpy().astype(np.uint64)


class Comp:
    def __init__(self, input1: list[str], input2: list[str]):
        self.inputs = [Input(paths=list(input1), index=1),
                       Input(paths=list(input2), index=2),
                       Input(paths=[], index=3)]
        self.three_inputs = False
        self.output_prefix = "kat-comp"
        self.d1_scale = 1.0
        self.d2_scale = 1.0
        self.d1_bins = DEFAULT_NB_BINS
        self.d2_bins = DEFAULT_NB_BINS
        self.dump_hashes = False
        self.disable_hash_grow = False
        self.output_hists = False
        self.verbose = False
        self.quiet = False
        self.mer_len = None

        self.main_mx: Matrix | None = None
        self.ends_mx: Matrix | None = None
        self.middle_mx: Matrix | None = None
        self.mixed_mx: Matrix | None = None
        self.counters: dict | None = None
        self.spectrum1 = self.spectrum2 = None
        self.shared_spectrum1 = self.shared_spectrum2 = None

    # -- configuration --
    def set_third_input(self, input3: list[str]) -> None:
        self.inputs[2] = Input(paths=list(input3), index=3)
        self.three_inputs = True

    def set_mer_len(self, k: int) -> None:
        self.mer_len = k
        for inp in self.inputs:
            inp.mer_len = k

    def _active_inputs(self):
        return self.inputs[:3 if self.three_inputs else 2]

    # -- main flow (comp.cc:108-183) --
    def execute(self) -> None:
        for inp in self._active_inputs():
            inp.disable_grow = self.disable_hash_grow
            inp.validate()
        ensure_parent_dir(self.output_prefix)

        for inp in self._active_inputs():
            if inp.mode == InputMode.COUNT:
                inp.count(quiet=self.quiet)

        all_load = all(i.mode == InputMode.LOAD
                       for i in self._active_inputs())
        any_load = any(i.mode == InputMode.LOAD
                       for i in self._active_inputs())
        if any_load:
            for inp in self._active_inputs():
                if inp.mode == InputMode.LOAD:
                    inp.load(quiet=self.quiet)
        if all_load:
            self.set_mer_len(self.inputs[0].header.mer_len)
        for inp in self._active_inputs():
            inp.validate_mer_len(self.mer_len)

        with stage("Comparing hashes", quiet=self.quiet):
            active = self._active_inputs()
            if all(inp.shards is not None for inp in active):
                self._compare_sharded()
            else:
                self.compare_tables(*[inp.host_table() for inp in active])

        if self.dump_hashes:
            for inp in self._active_inputs():
                out = (f"{self.output_prefix}-hash{inp.index}"
                       f".jf{self.mer_len}")
                inp.dump(out, quiet=self.quiet)

        with stage("Merging results", quiet=self.quiet):
            pass  # device reductions are already global

    def _probe_flags(self) -> dict:
        """The passes' canonicalization and sorted-probe flags.  Probe
        streams in pass1/2 are a sorted table's own keys; they stay sorted
        whenever the applied canonicalization is an identity (none
        requested, or the probing table already stores canonical keys) —
        the join lookups then skip sort/un-permute."""
        canon1 = self.inputs[0].canonical
        canon2 = self.inputs[1].canonical
        canon3 = (self.inputs[2].canonical if self.three_inputs else True)
        return dict(canon2=canon2, canon3=canon3,
                    sorted2=(not canon2) or canon1,
                    sorted3=(not canon3) or canon1,
                    sorted1=canon2)  # pass2 always canonicalizes (§5.1.2)

    def _compare_sharded(self) -> None:
        """The three passes per shard of the inputs' mesh, summed."""
        from ..parallel.analysis import comp_sharded

        outs1, outs2, c3 = comp_sharded(
            self.inputs[0].shards, self.inputs[1].shards,
            self.inputs[2].shards if self.three_inputs else None,
            k=self.mer_len, d1_bins=self.d1_bins, d2_bins=self.d2_bins,
            dm_size=min(self.d1_bins, self.d2_bins), d1_scale=self.d1_scale,
            d2_scale=self.d2_scale, **self._probe_flags())
        self._store(outs1, outs2, c3)

    def compare_tables(self, t1, t2, t3=None) -> None:
        """The three passes over finished tables of the active inputs
        (counted or loaded, on one device): counters, spectra and matrices
        into this object, as `execute` leaves them.  t3 is the third
        input's table when there is one."""
        k = self.mer_len
        dm_size = min(self.d1_bins, self.d2_bins)
        flags = self._probe_flags()
        sorted1, sorted2 = flags["sorted1"], flags["sorted2"]

        # Compact to final fill: the passes stream over every table's
        # capacity (iteration AND sort-merge-join probes), so padding left
        # by the growth policy would be pure wasted bandwidth.
        with annotate("kat.comp.compact"):
            t1, t2 = tables.compact(t1), tables.compact(t2)
            t3 = tables.compact(t3) if self.three_inputs else None

        # both cross-probe streams sorted => pass1 and pass2 share ONE
        # table merge (tables.lookup_dual); None when the join policy keeps
        # the binary search
        with annotate("kat.comp.probe"):
            pre = (tables.lookup_dual(t1, t2) if (sorted2 and sorted1)
                   else None)
        h2_pre, h1_pre = pre if pre is not None else (None, None)
        with annotate("kat.comp.pass1"):
            outs1 = comp_engine.pass1(
                t1, t2, t3, k=k, d1_bins=self.d1_bins, d2_bins=self.d2_bins,
                dm_size=dm_size, d1_scale=self.d1_scale,
                d2_scale=self.d2_scale, canon2=flags["canon2"],
                canon3=flags["canon3"], three=self.three_inputs,
                sorted2=sorted2, sorted3=flags["sorted3"], h2_pre=h2_pre)
        with annotate("kat.comp.pass2"):
            outs2 = comp_engine.pass2(
                t2, t1, k=k, d2_bins=self.d2_bins, dm_size=dm_size,
                d2_scale=self.d2_scale, sorted1=sorted1, h1_pre=h1_pre)
        self._store(outs1, outs2,
                    comp_engine.pass3(t3) if self.three_inputs else {})

    def _store(self, outs1, outs2, c3) -> None:
        """The passes' outputs (comp_engine.pass1/2/3's structures) as the
        host counters, spectra and matrices of this object (`kat.comp.store`,
        each host read a `kat.read.comp`).  Each matrix keeps its tensor
        on the passes' device, which `save()` formats from."""
        with annotate("kat.comp.store"):
            c1, sp1, ssp1, ssp2, main_mx, ends, mixed, middle = outs1
            c2, sp2, row0, ssp2b = outs2
            sums = {**c1, **c2, **c3}
            stacked = torch.stack(list(sums.values()))
            with annotate("kat.read.comp"):
                count("host_reads")
                counters = dict(zip(sums, stacked.tolist()))
            if not self.three_inputs:
                counters["hash3_total"] = 0
                counters["hash3_distinct"] = 0
            self.counters = counters

            main = main_mx.clone()
            main[0] += row0
            self.main_mx = Matrix(_host(main), cells=main)
            if self.three_inputs:
                self.ends_mx = Matrix(_host(ends), cells=ends)
                self.mixed_mx = Matrix(_host(mixed), cells=mixed)
                self.middle_mx = Matrix(_host(middle), cells=middle)
            self.spectrum1 = _host(sp1)
            self.spectrum2 = _host(sp2)
            self.shared_spectrum1 = _host(ssp1)
            # pass1 + pass2 contributions (exactly one is nonzero — pass2's
            # when the dual probe ran, pass1's otherwise)
            self.shared_spectrum2 = _host(ssp2) + _host(ssp2b)

    # -- output (comp.cc:185-233, 305-364) --
    def print_main_matrix(self, out) -> None:
        i0, i1 = self.inputs[0], self.inputs[1]
        out.write(f"{mme.KEY_TITLE}K-mer comparison plot\n")
        out.write(f"{mme.KEY_X_LABEL}{i0.mer_len}-mer frequency for: "
                  f"{i0.file_name()}\n")
        out.write(f"{mme.KEY_Y_LABEL}{i1.mer_len}-mer frequency for: "
                  f"{i1.file_name()}\n")
        out.write(f"{mme.KEY_Z_LABEL}# distinct {i0.mer_len}-mers\n")
        out.write(f"{mme.KEY_NB_COLUMNS}{self.main_mx.n}\n")
        out.write(f"{mme.KEY_NB_ROWS}{self.main_mx.m}\n")
        out.write(f"{mme.KEY_MAX_VAL}{self.main_mx.get_max_val()}\n")
        out.write(f"{mme.KEY_TRANSPOSE}1\n")
        out.write(f"{mme.KEY_KMER}{i0.mer_len}\n")
        out.write(f"{mme.KEY_INPUT_1}{i0.path_string()}\n")
        out.write(f"{mme.KEY_INPUT_2}{i1.path_string()}\n")
        out.write(f"{mme.MX_META_END}\n")
        self.main_mx.print_matrix(out)

    def _print_aux_matrix(self, out, mx: Matrix, row_desc: str,
                          col_desc: str) -> None:
        out.write(f"# Each row represents K-mer frequency for{row_desc}\n")
        out.write(f"# Each column represents K-mer frequency for"
                  f" {col_desc}\n")
        mx.print_matrix(out)

    def print_ends_matrix(self, out) -> None:
        self._print_aux_matrix(
            out, self.ends_mx, f": {self.inputs[0].paths[0]}",
            f"sequence ends: {self.inputs[2].paths[0]}")

    def print_middle_matrix(self, out) -> None:
        self._print_aux_matrix(
            out, self.middle_mx, f": {self.inputs[0].paths[0]}",
            f"sequence middles: {self.inputs[1].paths[0]}")

    def print_mixed_matrix(self, out) -> None:
        self._print_aux_matrix(
            out, self.mixed_mx,
            f" hash file 1: {self.inputs[0].paths[0]}",
            f"mixed: {self.inputs[1].paths[0]} and "
            f"{self.inputs[2].paths[0]}")

    def print_hist(self, out, inp: Input, hist: np.ndarray) -> None:
        out.write(f"{mme.KEY_TITLE}{inp.mer_len}-mer spectra for: "
                  f"{inp.path_string()}\n")
        out.write(f"{mme.KEY_X_LABEL}{inp.mer_len}-mer frequency\n")
        out.write(f"{mme.KEY_Y_LABEL}# distinct {inp.mer_len}-mers\n")
        out.write(f"{mme.MX_META_END}\n")
        for i, v in enumerate(hist):
            out.write(f"{i} {int(v)}\n")

    def print_counters(self, out) -> None:
        c = self.counters
        # boost::filesystem::path streams with quotes (comp_counters.cc:
        # 144-150 `out << hash1_path`).
        p1 = self.inputs[0].paths[0] if self.inputs[0].paths else ""
        p2 = self.inputs[1].paths[0] if self.inputs[1].paths else ""
        p3 = self.inputs[2].paths[0] if self.inputs[2].paths else ""
        out.write("K-mer statistics for: \n")
        out.write(f' - Hash 1: "{p1}"\n')
        out.write(f' - Hash 2: "{p2}"\n')
        if c["hash3_total"] > 0:
            out.write(f' - Hash 3: "{p3}"\n')
        out.write("\n")
        out.write("Total K-mers in: \n")
        out.write(f" - Hash 1: {c['hash1_total']}\n")
        out.write(f" - Hash 2: {c['hash2_total']}\n")
        if c["hash3_total"] > 0:
            out.write(f" - Hash 3: {c['hash3_total']}\n")
        out.write("\n")
        out.write("Distinct K-mers in:\n")
        out.write(f" - Hash 1: {c['hash1_distinct']}\n")
        out.write(f" - Hash 2: {c['hash2_distinct']}\n")
        if c["hash3_total"] > 0:
            out.write(f" - Hash 3: {c['hash3_distinct']}\n")
        out.write("\n")
        out.write("Total K-mers only found in:\n")
        out.write(f" - Hash 1: {c['hash1_only_total']}\n")
        out.write(f" - Hash 2: {c['hash2_only_total']}\n")
        out.write("\n")
        out.write("Distinct K-mers only found in:\n")
        out.write(f" - Hash 1: {c['hash1_only_distinct']}\n")
        out.write(f" - Hash 2: {c['hash2_only_distinct']}\n\n")
        out.write("Shared K-mers:\n")
        out.write(f" - Total shared found in hash 1: "
                  f"{c['shared_hash1_total']}\n")
        out.write(f" - Total shared found in hash 2: "
                  f"{c['shared_hash2_total']}\n")
        out.write(f" - Distinct shared K-mers: {c['shared_distinct']}\n\n")
        out.write("Distance between spectra 1 and 2 (all k-mers):\n")
        for name, fn in ALL_METRICS:
            out.write(f" - {name} distance: "
                      f"{cpp_double(fn(self.spectrum1, self.spectrum2))}\n")
        out.write("\n")
        out.write("Distance between spectra 1 and 2 (shared k-mers):\n")
        for name, fn in ALL_METRICS:
            dist = fn(self.shared_spectrum1, self.shared_spectrum2)
            out.write(f" - {name} distance: {cpp_double(dist)}\n")
        out.write("\n")

    def save(self) -> None:
        """Every file of the comparison: `kat.save`, with a child
        `kat.save.<suffix>` per file (`kat.save.main.mx`, `kat.save.stats`,
        ...)."""
        files = [("-main.mx", self.print_main_matrix)]
        if self.three_inputs:
            files += [("-ends.mx", self.print_ends_matrix),
                      ("-middle.mx", self.print_middle_matrix),
                      ("-mixed.mx", self.print_mixed_matrix)]
        files.append((".stats", self.print_counters))
        if self.output_hists:
            files += [(".1.hist", partial(self.print_hist, inp=self.inputs[0],
                                          hist=self.spectrum1)),
                      (".2.hist", partial(self.print_hist, inp=self.inputs[1],
                                          hist=self.spectrum2))]
        with stage("Saving results to disk", quiet=self.quiet), \
                annotate("kat.save"):
            for suffix, write in files:
                with annotate("kat.save." + suffix[1:]), \
                        open(self.output_prefix + suffix, "w") as f:
                    write(f)
