"""The harness's inputs: staged batches equal what the port's native reader
yields for the same reads written as FASTQ (and contigs as FASTA), and
the reads hold both strands and substitutions."""

import numpy as np
import pytest
import torch

from katbench import reads
from katbench.tests import fastx
from katbench.tests.tiny import CPU, TINY

torch.set_num_threads(1)


@pytest.fixture
def native():
    from kat_tpu_torch.io import native

    if not native.available():
        pytest.skip("the native reader did not build: "
                    + native.build_log()[:300])
    return native


# (k, rows, row_len, read_len): 301 = 2 x 151 - 1 ends a row on a
# record's last base, so the next row starts with its seam
@pytest.mark.parametrize("k,rows,row_len,read_len", [
    (27, 16, 64, 150), (27, 4096, 1024, 150), (27, 9, 301, 150),
    (21, 7, 151, 101), (31, 5, 200, 101), (27, 3, 1024, 101)])
def test_staged_reads_equal_the_native_reader(tmp_path, native, k, rows,
                                              row_len, read_len):
    cfg = {**TINY, "read_len": read_len}
    g = reads.genome(cfg, 11, CPU)
    staged = reads.stage_reads(cfg, 11, g, k, rows, row_len)
    got = []
    for f in range(cfg["files"]):
        p = str(tmp_path / f"r{f}.fq")
        fastx.write_fastq(p, cfg, 11, g, f)
        got += list(native.stream_code_batches([p], k, rows=rows,
                                               row_len=row_len, threads=1))
    assert len(got) == len(staged)
    for a, b in zip(got, staged):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("contig,row_len", [(3000, 64), (3000, 1024),
                                            (2974, 256), (20000, 2000)])
def test_staged_contigs_equal_the_native_reader(tmp_path, native, contig,
                                                row_len):
    cfg = {**TINY, "assembly_contig_len": contig}
    g = reads.genome(cfg, 5, CPU)
    parts = reads.contigs(cfg, g)
    staged = reads.stage_contigs(parts, 27, 8, row_len)
    p = str(tmp_path / "a.fa")
    fastx.write_fasta(p, parts)
    got = list(native.stream_code_batches([p], 27, rows=8, row_len=row_len,
                                          threads=1))
    assert len(got) == len(staged)
    for a, b in zip(got, staged):
        np.testing.assert_array_equal(a, b.numpy())


def test_row_starts_end_on_a_base_gets_a_seam_row():
    # one record of 10 bases, no separator after it (FASTA), rows of 10
    starts = reads.row_starts(lambda p: True, 10, 4, 10)
    assert starts.tolist() == [0, 7]


def _revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def test_reads_hold_both_strands_and_substitutions():
    cfg = {**TINY, "substitution_rate": 0.0}
    g = reads.genome(cfg, 3, CPU)
    gs = "".join("ACGT"[c] for c in g.tolist())
    blk = next(reads.read_blocks(cfg, 3, g, 0))
    strands = {"fwd": 0, "rev": 0}
    for r in blk[:200].tolist():
        s = "".join("ACGT"[c] for c in r)
        if s in gs:
            strands["fwd"] += 1
        else:
            assert _revcomp(s) in gs
            strands["rev"] += 1
    assert strands["fwd"] > 60 and strands["rev"] > 60
    err = next(reads.read_blocks({**cfg, "substitution_rate": 0.01}, 3, g, 0))
    changed = (err != blk).float().mean().item()
    assert 0.005 < changed < 0.02  # every hit changes the base


def test_same_seed_same_inputs_and_fastq_layout(tmp_path):
    a = reads.stage_reads(TINY, 2**31 + 99, reads.genome(TINY, 2**31 + 99,
                                                         CPU), 27, 16, 128)
    b = reads.stage_reads(TINY, 2**31 + 99, reads.genome(TINY, 2**31 + 99,
                                                         CPU), 27, 16, 128)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g = reads.genome(TINY, 1, CPU)
    p = tmp_path / "r.fq"
    fastx.write_fastq(str(p), TINY, 1, g, 1)
    lines = p.read_text().split("\n")
    n = reads.file_reads(TINY)[1]
    assert len(lines) == 4 * n + 1 and lines[-1] == ""
    assert lines[0] == f"@r{reads.file_reads(TINY)[0]:010d}"
    assert lines[2] == "+" and set(lines[3]) == {"I"}
    assert len(lines[1]) == TINY["read_len"]
