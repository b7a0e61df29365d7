"""cellCounts and featureCounts' scRNA mode on the port against the JAX
package, on a 400 kb synthetic genome with genes, single-cell read pairs
and a raw Illumina run made here from a seed (`synth.synthetic_genes`,
`synth.synthetic_cell_reads`, the copied `io/bcl.py::write_synthetic_run`):

  * FASTQ mode with cell calling: matrix.mtx, barcodes.tsv and
    features.tsv equal JAX's; with --sampleSheetFile, the .Annot and
    .scRNA.* set equal JAX's;
  * BCL mode (two samples demultiplexed from a CBCL run): every file of
    the output directory, the per-sample BAMs included, equal JAX's;
  * featureCounts --scSampleSheet on a SAM whose read names carry the
    barcode and UMI: the count and summary files and the .scRNA.* set
    equal JAX's.

Every output is an integer or a file: the tolerance is 0."""

import filecmp
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.index.build import build_hash_index
from subread_tpu.tools import cellcounts as jcli
from subread_tpu.tools import featurecounts as jfc
from subread_tpu_torch import dna
from subread_tpu_torch.io.bcl import ReadSegment, write_synthetic_run
from subread_tpu_torch.synth import (
    synthetic_cell_reads, synthetic_genes, synthetic_genome, write_fastq, write_genes_gtf,
)
from subread_tpu_torch.tools import cellcounts as tcli
from subread_tpu_torch.tools import featurecounts as tfc

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("cc")
    g = synthetic_genome(400_000, seed=21, n_contigs=2)
    prefix = str(d / "idx")
    g.save(prefix)
    build_hash_index(g, index_gap=1).save(prefix)
    genes = synthetic_genes(g, 12, seed=22)
    gtf = str(d / "genes.gtf")
    assert write_genes_gtf(gtf, genes) > 12 * 10
    wl, r1, r2, cells = synthetic_cell_reads(g, genes, 3000, seed=23, n_cells=40,
                                             n_whitelist=300)
    (d / "wl.txt").write_text("\n".join(wl) + "\n")
    write_fastq(str(d / "r1.fq"), r1)
    write_fastq(str(d / "r2.fq"), r2)
    (d / "sheet.csv").write_text("[Data]\nLane,Sample_ID,Sample_Name,index\n"
                                 "1,S1,SampleA,ACGTACGT\n")
    return dict(dir=d, genome=g, prefix=prefix, gtf=gtf, genes=genes, wl=wl,
                r1=r1, r2=r2, cells=cells)


def base_args(s):
    return ["-i", s["prefix"], "-a", s["gtf"], "-c", str(s["dir"] / "wl.txt"),
            "--umi-len", "12"]


def run_both(argv_of):
    """Each CLI on argv_of(side); the port's on --device cpu."""
    with jax.default_device(jax.devices("cpu")[0]):
        assert jcli.main(argv_of("jax")) == 0
    assert tcli.main(argv_of("port") + ["--device", "cpu"]) == 0


def same_tree(a, b) -> list[str]:
    """The relative paths of two directories' files, asserting the same
    set and the same bytes."""
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), b)
                           for r, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    return files


def test_fastq_mode_equals_jax(setup):
    d = setup["dir"]
    run_both(lambda side: base_args(setup) + [
        "-r", str(d / "r1.fq"), "-R", str(d / "r2.fq"), "--cellCalling",
        "-o", str(d / f"fq-{side}")])
    assert same_tree(d / "fq-jax", d / "fq-port") == [
        "barcodes.tsv", "features.tsv", "matrix.mtx"]
    called = (d / "fq-port" / "barcodes.tsv").read_text().split()
    planted = {setup["wl"][c] for c in setup["cells"]}
    assert len(set(called) & planted) >= 0.8 * len(planted)
    mtx = (d / "fq-port" / "matrix.mtx").read_text().splitlines()
    assert sum(int(line.split()[2]) for line in mtx[2:]) > 300


def test_fastq_mode_sample_sheet_equals_jax(setup):
    d = setup["dir"]
    run_both(lambda side: base_args(setup) + [
        "-r", str(d / "r1.fq"), "-R", str(d / "r2.fq"),
        "--sampleSheetFile", str(d / "sheet.csv"), "-o", str(d / f"ss-{side}")])
    names = sorted(p.name[len("ss-jax"):] for p in d.glob("ss-jax.*"))
    assert ".Annot" in names and ".scRNA.SampleTable" in names
    assert any(n.endswith("HighConf.spmtx") for n in names)
    for n in names:
        assert (d / f"ss-jax{n}").read_bytes() == (d / f"ss-port{n}").read_bytes(), n


def test_bcl_mode_equals_jax(setup):
    d = setup["dir"]
    r1, r2 = setup["r1"], setup["r2"]
    indices = ("ACGTACGT", "TTTTCCCC")
    n = 1200
    reads = [(dna.decode(r1.codes[i, :r1.lengths[i]]), indices[i % 2],
              dna.decode(r2.codes[i, :r2.lengths[i]])) for i in range(n)]
    run = str(d / "run")
    write_synthetic_run(run, {1: reads},
                        [ReadSegment(28, False), ReadSegment(8, True),
                         ReadSegment(100, False)], mode="cbcl", tiles_per_lane=2)
    sheet = d / "bcl_sheet.csv"
    sheet.write_text("[Data]\nLane,Sample_ID,Sample_Name,index\n"
                     f"*,S1,sampleA,{indices[0]}\n*,S2,sampleB,{indices[1]}\n")
    run_both(lambda side: base_args(setup) + [
        "--inputMode", "BCL", "--dataset", run, "--sampleSheetFile", str(sheet),
        "-o", str(d / f"bcl-{side}")])
    files = same_tree(d / "bcl-jax", d / "bcl-port")
    for sample in ("sampleA", "sampleB"):
        assert f"{sample}/{sample}.bam" in files and f"{sample}/matrix.mtx" in files
    table = (d / "bcl-port" / "scRNA.SampleTable").read_text().splitlines()
    assert len(table) == 3 and all(int(r.split("\t")[2]) == n // 2 for r in table[1:])


def test_featurecounts_scrna_mode_equals_jax(setup, tmp_path):
    """featureCounts --scSampleSheet: records placed inside the genes'
    exons, named `r<i>|<barcode><UMI>|<qual>|<index>|<qual>|L001`."""
    rng = np.random.default_rng(24)
    g, wl = setup["genome"], setup["wl"]
    lines = ["@HD\tVN:1.0\n"] + [f"@SQ\tSN:{n}\tLN:{int(ln)}\n"
                                 for n, ln in zip(g.names, g.lengths)]
    for i in range(2000):
        _, contig, strand, txs = setup["genes"][int(rng.integers(0, len(setup["genes"])))]
        a, b = txs[0][int(rng.integers(0, len(txs[0])))]
        pos = int(rng.integers(a, max(b - 50, a + 1))) + 1
        cb = wl[int(setup["cells"][int(rng.integers(0, 20))])] if i % 10 else wl[i % len(wl)]
        umi = dna.decode(rng.integers(0, 4, 12).astype(np.uint8))
        name = f"r{i}|{cb}{umi}|{'I' * 28}|ACGTACGT|IIIIIIII|L001"
        flag = 4 if i % 37 == 0 else 16 * int(strand == "-")
        lines.append(f"{name}\t{flag}\t{contig}\t{pos}\t30\t50M\t*\t0\t0\t*\t*\tNH:i:1\n"
                     if flag != 4 else f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")
    sam = tmp_path / "sc.sam"
    sam.write_text("".join(lines))
    argv = ["-a", setup["gtf"], "--scSampleSheet", str(setup["dir"] / "sheet.csv"),
            "--scCellBarcodeFile", str(setup["dir"] / "wl.txt"), str(sam)]
    outs = {}
    for side in ("jax", "port"):
        out = tmp_path / f"{side}.txt"
        if side == "jax":
            assert jfc.main(argv + ["-o", str(out)]) == 0
        else:
            assert tfc.main(argv + ["-o", str(out), "--device", "cpu"]) == 0
        outs[side] = {p.name[len(sam.name):]: p.read_bytes()
                      for p in tmp_path.glob(sam.name + ".scRNA.*")}
        outs[side]["counts"] = out.read_bytes()
        outs[side]["summary"] = (tmp_path / f"{side}.txt.summary").read_bytes()
        for p in tmp_path.glob(sam.name + ".scRNA.*"):
            p.unlink()
    assert outs["jax"] == outs["port"]
    assert ".scRNA.SampleTable" in outs["port"] and len(outs["port"]) > 4
