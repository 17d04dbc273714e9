"""`kat comp reads assembly`, KAT's spectra-cn check of an assembly against
its reads: the reads and the assembly counted as `Input.count` counts
them, `Comp.compare_tables` (the dual probe, K4, the binned sums into the
matrices), `Comp.save()` with plots off.

The assembly is the genome cut into contigs of the configuration's
`assembly_contig_len`, staged as the reader packs a FASTA file.  Traffic
keys: `bins` (comp's -x and -y).  Compared with the reference: the last
job's two tables and main matrix file, every job's matrix, counters and
spectra.
"""

import os

import numpy as np

from katbench import job as base
from katbench import reads, reference

SPECTRA = ("spectrum1", "spectrum2", "shared_spectrum1", "shared_spectrum2")


def setup(job) -> None:
    job.asm = reads.contigs(job.cfg, job.genome)
    job.asm_batches = reads.stage_contigs(job.asm, job.k, job.mix["rows"],
                                          job.mix["row_len"])
    job.windows += reads.real_windows(map(len, job.asm), job.k)
    job.asm_label = "assembly.fa"


def run(job, rec, span) -> None:
    from kat_tpu_torch.tools.comp import Comp

    c = Comp(job.labels, [job.asm_label])
    c.quiet = True
    c.output_prefix = os.path.join(job.dir, "kat-comp")
    c.d1_bins = c.d2_bins = job.mix["bins"]
    c.set_mer_len(job.k)
    for inp in c.inputs[:2]:
        inp.canonical = job.canonical
        inp.hash_size, inp.device = job.cfg["hash_size"], job.dev
    with span("count"):
        c.inputs[0].table = job.count(job.batches)
    with span("count.asm"):
        c.inputs[1].table = job.count(job.asm_batches)
    with span("compare", sync=True):
        c.compare_tables(c.inputs[0].table, c.inputs[1].table)
    with span("artifact"):
        c.save()
    rec.out["comp"] = {
        "main": c.main_mx.data.astype(np.int64),
        "counters": dict(c.counters),
        **{n: np.asarray(getattr(c, n), np.int64) for n in SPECTRA}}
    rec.heavy = {"reads": c.inputs[0].table, "asm": c.inputs[1].table}


def _equal(got: dict, want: dict) -> bool:
    return got["counters"] == want["counters"] and all(
        np.array_equal(got[n], want[n]) for n in ("main", *SPECTRA))


def check(job, recs, ref_reads, ref_asm) -> dict:
    bins = job.mix["bins"]
    last = recs[-1].heavy
    want = reference.comp_outputs(ref_reads, ref_asm, bins, bins)
    text = last.get("matrix_text")
    if text is None:
        with open(os.path.join(job.dir, "kat-comp-main.mx")) as f:
            text = f.read()
    mx = reference.parse_matrix(text)
    cells = (int((mx != want["main"]).sum()) if mx.shape ==
             want["main"].shape else want["main"].size)
    return {
        "reads_table_mismatch": (base.table_mismatch(last["reads"], ref_reads,
                                                     job.k), 0),
        "asm_table_mismatch": (base.table_mismatch(last["asm"], ref_asm,
                                                   job.k), 0),
        "comp_jobs_wrong": (sum(not _equal(r.out["comp"], want)
                                for r in recs), 0),
        "matrix_cells_wrong": (cells, 0)}


def control_record(job, ctrl) -> base.JobRecord:
    c_reads, c_asm = ctrl
    bins = job.mix["bins"]
    out = reference.comp_outputs(c_reads, c_asm, bins, bins)
    rows = "\n".join(" ".join(map(str, r)) for r in out["main"])
    rec = base.JobRecord(windows=job.windows)
    rec.out["comp"] = out
    rec.heavy = {"reads": reference.as_table(c_reads),
                 "asm": reference.as_table(c_asm),
                 "matrix_text": "###\n" + rows + "\n"}
    return rec
