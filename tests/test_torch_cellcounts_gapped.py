"""cellCounts on the port against the JAX package on the gapped index that
subread-buildindex builds by default (index_gap=3: every third 16-mer, each
read's subreads probed at 3 offsets), on a 200 kb synthetic genome with
genes and 10x-like read pairs (`synth.synthetic_genes`,
`synth.synthetic_cell_reads`): FASTQ mode with cell calling writes the
JAX package's matrix.mtx, barcodes.tsv and features.tsv, byte for byte.
The tolerance is 0."""

import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.index.build import build_hash_index
from subread_tpu.tools import cellcounts as jcli
from subread_tpu_torch.synth import (
    synthetic_cell_reads, synthetic_genes, synthetic_genome, write_fastq, write_genes_gtf,
)
from subread_tpu_torch.tools import cellcounts as tcli

torch.set_num_threads(1)


def test_gapped_index_matrix_equals_jax(tmp_path):
    g = synthetic_genome(200_000, seed=51, n_contigs=2)
    prefix = str(tmp_path / "idx")
    g.save(prefix)
    idx = build_hash_index(g, index_gap=3)
    assert idx.index_gap == 3
    idx.save(prefix)
    genes = synthetic_genes(g, 10, seed=52)
    write_genes_gtf(str(tmp_path / "genes.gtf"), genes)
    wl, r1, r2, cells = synthetic_cell_reads(g, genes, 800, seed=53, n_cells=15,
                                             n_whitelist=200)
    (tmp_path / "wl.txt").write_text("\n".join(wl) + "\n")
    write_fastq(str(tmp_path / "r1.fq"), r1)
    write_fastq(str(tmp_path / "r2.fq"), r2)
    argv = ["-i", prefix, "-a", str(tmp_path / "genes.gtf"), "-c", str(tmp_path / "wl.txt"),
            "--umi-len", "12", "-r", str(tmp_path / "r1.fq"), "-R", str(tmp_path / "r2.fq"),
            "--cellCalling"]
    with jax.default_device(jax.devices("cpu")[0]):
        assert jcli.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert tcli.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    for f in ("matrix.mtx", "barcodes.tsv", "features.tsv"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    mtx = (tmp_path / "port" / "matrix.mtx").read_text().splitlines()
    assert int(mtx[1].split()[1]) >= 8 and sum(int(x.split()[2]) for x in mtx[2:]) > 100
