"""cellCounts' FASTQ mode (`tools/cellcounts.py::cellcounts_file`) on the
card against the same call on the CPU: 4,096 10x-like read pairs on a 2 Mb
synthetic genome's default gapped index, with the sample's BAM and cell
calling; the BAM and matrix.mtx, barcodes.tsv and features.tsv are
byte-equal.  Needs no JAX, so it runs on the machine with the card:

    python -m pytest tests/test_torch_cellcounts_gpu.py -q

Elsewhere it skips (the card's path runs its CUDA kernel and graphs)."""

import pytest
import torch

from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.quant.cellcounts import BatchBarcodeMatcher, CellAnnotation
from subread_tpu_torch.synth import (
    synthetic_cell_reads, synthetic_genes, synthetic_genome, write_fastq, write_genes_gtf,
)
from subread_tpu_torch.tools import cellcounts as cli


@pytest.mark.gpu
def test_card_equals_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's path runs its kernel and graphs)")
    g = synthetic_genome(2_000_000, seed=61, n_contigs=3)
    index = build_hash_index(g, index_gap=3)
    genes = synthetic_genes(g, 40, seed=62)
    gtf = str(tmp_path / "genes.gtf")
    write_genes_gtf(gtf, genes)
    wl, r1, r2, _ = synthetic_cell_reads(g, genes, 4096, seed=63, n_cells=60,
                                         n_whitelist=2000)
    write_fastq(str(tmp_path / "r1.fq"), r1)
    write_fastq(str(tmp_path / "r2.fq"), r2)
    annotation = CellAnnotation(load_annotation(gtf), g)
    matcher = BatchBarcodeMatcher(wl)
    args = cli.build_parser().parse_args(["-i", "x", "-a", gtf, "-c", "x", "-o", "x"])
    for dev in ("cuda", "cpu"):
        aligner = Aligner(g, index, cli.aligner_config(args), device=dev)
        counter = cli.cellcounts_file(
            aligner, matcher, annotation, str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq"),
            str(tmp_path / dev), umi_len=12, cell_calling=True,
            bam=str(tmp_path / f"{dev}.bam"))
        assert counter.stats["reads"] == 4096 and counter.stats["assigned"] > 2000
    assert (tmp_path / "cuda.bam").read_bytes() == (tmp_path / "cpu.bam").read_bytes()
    for f in ("matrix.mtx", "barcodes.tsv", "features.tsv"):
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes(), f
