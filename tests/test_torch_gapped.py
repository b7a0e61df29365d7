"""The JAX package on the gapped index that subread-buildindex builds by
default (index_gap=3), on the CPU, at a small size of the generators
chip_smoke.py's phase 16 runs on the card: subread-align single-end on
simulated reads and subjunc paired-end with --allJunctions on spliced
pairs, through the JAX package's CLIs, scored as phase 16 scores the
card's runs.  Phase 16's floors sit below these figures (-s prints
them)."""

import pytest

jax = pytest.importorskip("jax")

import chip_smoke
from subread_tpu.tools import align as jalign_cli
from subread_tpu.tools import buildindex as jbuildindex
from subread_tpu.tools import subjunc as jsubjunc_cli
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_reads, synthetic_spliced_pairs, write_fastq,
    write_genome_fasta,
)


@pytest.fixture(scope="module")
def gapped(tmp_path_factory):
    """phase 1's generator at 2 Mb, its FASTA, and the index the JAX
    package's buildindex builds from it with default options."""
    d = tmp_path_factory.mktemp("gapped")
    g = synthetic_genome(2_000_000, seed=7, n_contigs=4)
    write_genome_fasta(str(d / "g.fa"), g)
    assert jbuildindex.main(["-o", str(d / "idx"), str(d / "g.fa")]) == 0
    return d, g


def test_single_end_meets_the_chip_floors(gapped):
    d, g = gapped
    reads = synthetic_reads(g, 4000, seed=8)
    write_fastq(str(d / "r.fq"), reads)
    assert jalign_cli.main(["-t", "1", "-i", str(d / "idx"), "-r", str(d / "r.fq"),
                            "-o", str(d / "se.sam")]) == 0
    m = chip_smoke.single_end_metrics(d / "se.sam", len(reads))
    print(f"subread-align on {len(reads)} reads, gapped index (JAX package, "
          f"CPU): {m}")
    assert m["primary"] == m["distinct"] == len(reads)
    for k, lo in chip_smoke.GAPPED_MIN.items():
        assert m[k] >= lo, (k, m[k], lo)


def test_subjunc_paired_meets_the_chip_floors(gapped):
    d, g = gapped
    r1, r2, truth = synthetic_spliced_pairs(g, 2000, seed=12)
    write_fastq(str(d / "s1.fq"), r1)
    write_fastq(str(d / "s2.fq"), r2)
    sam = d / "sjp.sam"
    assert jsubjunc_cli.main(["-i", str(d / "idx"), "-r", str(d / "s1.fq"),
                              "-R", str(d / "s2.fq"), "-o", str(sam),
                              "--allJunctions"]) == 0
    m = chip_smoke.subjunc_metrics(sam, truth, 2 * len(r1))
    m["fusions"] = chip_smoke.fusion_share(str(sam) + ".breakpoints.vcf",
                                           truth["fusions"])
    print(f"subjunc --allJunctions on {len(r1)} spliced pairs, gapped index "
          f"(JAX package, CPU): {m}")
    assert m["primary"] == m["distinct"] == 2 * len(r1)
    for k, lo in chip_smoke.GAPPED_SUBJUNC_PE_MIN.items():
        assert m[k] >= lo, (k, m[k], lo)
