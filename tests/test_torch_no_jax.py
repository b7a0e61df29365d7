"""subread_tpu_torch must run where JAX is not installed (the machine with
the card has none) and imports nothing of the JAX package: in a subprocess
where `import jax` and `import subread_tpu` both fail, import every module
of the port, build an index with the port's own builder, and align 64
reads, then 64 pairs (-R), on the CPU through the CLI; then run subjunc
with --allJunctions on 64 spliced reads and on 64 spliced pairs, sublong on
4 long reads, featureCounts with --deviceCounts on the aligned reads, and
cellCounts on 200 read pairs.  Each new CLI refuses --device cuda where
no card is present, --deviceCounts included.  In a second such
subprocess, the host-only tools (exactSNP, subindel, globalReassembly and
the utilities) run on the port's own aligned reads, and the sharded align
step and featureCounts' mesh counting run on a mesh of the CPU named
twice."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["subread_tpu"] = None  # and so does any of the JAX package
sys.path.insert(0, sys.argv[1])
import subread_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(
    subread_tpu_torch.__path__, "subread_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_pairs, synthetic_reads,
    synthetic_spliced_pairs, synthetic_spliced_reads, write_fastq)
from subread_tpu_torch.synth import (
    synthetic_cell_reads, synthetic_genes, synthetic_long_reads, write_genes_gtf)
from subread_tpu_torch.tools import align, cellcounts, featurecounts, subjunc, sublong
d = tempfile.mkdtemp()
p = lambda name: os.path.join(d, name)
g = synthetic_genome(60_000, seed=2)
g.save(p("idx"))
build_hash_index(g, index_gap=3).save(p("idx"))
write_fastq(p("r.fq"), synthetic_reads(g, 64, seed=3))
b1, b2 = synthetic_pairs(g, 64, seed=4)
write_fastq(p("r1.fq"), b1)
write_fastq(p("r2.fq"), b2)
base = ["-t", "1", "-i", p("idx"), "--device", "cpu"]
align.main(base + ["-r", p("r.fq"), "-o", p("o.sam")])
align.main(base + ["-r", p("r1.fq"), "-R", p("r2.fq"), "-o", p("pe.sam")])
write_fastq(p("s.fq"), synthetic_spliced_reads(g, 64, seed=5)[0])
s1, s2, _ = synthetic_spliced_pairs(g, 64, seed=6)
write_fastq(p("s1.fq"), s1)
write_fastq(p("s2.fq"), s2)
sj = ["-i", p("idx"), "--device", "cpu", "--allJunctions"]
subjunc.main(sj + ["-r", p("s.fq"), "-o", p("sj.sam")])
subjunc.main(sj + ["-r", p("s1.fq"), "-R", p("s2.fq"), "-o", p("sjp.sam")])
write_fastq(p("lr.fq"), synthetic_long_reads(g, 4, seed=7, max_len=5000))
sublong.main(["-i", p("idx"), "-r", p("lr.fq"), "-o", p("lr.sam"), "--SAMoutput",
              "--device", "cpu"])
genes = synthetic_genes(g, 4, seed=8, exons=(2, 3))
write_genes_gtf(p("g.gtf"), genes)
featurecounts.main(["--deviceCounts", "--device", "cpu", "-a", p("g.gtf"),
                    "-o", p("fc.txt"), p("o.sam")])
wl, c1, c2, _ = synthetic_cell_reads(g, genes, 200, seed=9, n_cells=5, n_whitelist=20)
open(p("wl.txt"), "w").write("\n".join(wl) + "\n")
write_fastq(p("c1.fq"), c1)
write_fastq(p("c2.fq"), c2)
cellcounts.main(["-i", p("idx"), "-r", p("c1.fq"), "-R", p("c2.fq"), "-a", p("g.gtf"),
                 "-c", p("wl.txt"), "-o", p("cc"), "--umi-len", "12", "--device", "cpu"])
lr = [l for l in open(p("lr.sam")) if not l.startswith("@")]
fc_total = sum(int(l.split()[-1]) for l in open(p("fc.txt.summary"))
               if not l.startswith("Status"))
cc_umis = sum(int(l.split()[2]) for l in open(p("cc/matrix.mtx")).readlines()[2:])
print(len(lr), sum(1 for r in lr if int(r.split()[1]) & 4 == 0), fc_total, cc_umis,
      end=" ")
recs = [l for l in open(p("o.sam")) if not l.startswith("@")]
pe = [l for l in open(p("pe.sam")) if not l.startswith("@")]
sj_recs = [l for l in open(p("sj.sam")) if not l.startswith("@")]
sjp_recs = [l for l in open(p("sjp.sam")) if not l.startswith("@")]
# junction rows after the .junction.bed header
bed = lambda f: len(open(p(f + ".junction.bed")).readlines()) - 1
loaded = sorted(m for m in sys.modules
                if m in ("jax", "subread_tpu")
                or m.startswith(("jax.", "subread_tpu.")))
mapped = lambda rs: sum(1 for r in rs if int(r.split()[1]) & 4 == 0)
print(len(mods), len(recs), mapped(recs), len(pe), mapped(pe),
      sum(1 for r in pe if int(r.split()[1]) & 2), len(sj_recs), bed("sj.sam"),
      len(sjp_recs), bed("sjp.sam"), loaded)
"""


def test_port_imports_and_aligns_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, REPO], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    (n_lr, n_lr_mapped, n_fc, n_cc, n_mods, n_recs, n_mapped, n_pe, n_pe_mapped,
     n_proper, n_sj, n_bed, n_sjp, n_bed_pe, loaded) = proc.stdout.split(maxsplit=14)
    assert int(n_mods) >= 13
    # sublong, featureCounts --deviceCounts on the 64 aligned reads,
    # cellCounts' deduplicated UMIs
    assert int(n_lr) == 4 and int(n_lr_mapped) >= 3
    assert int(n_fc) == 64 and int(n_cc) > 0
    assert "deviceCounts" in proc.stderr and "counted on cpu" in proc.stderr
    assert int(n_recs) == 64 and int(n_mapped) >= 50
    assert int(n_pe) == 128 and int(n_pe_mapped) >= 100
    assert int(n_proper) >= 90
    # subjunc single-end and paired-end with --allJunctions
    assert int(n_sj) == 64 and int(n_sjp) == 128
    assert int(n_bed) > 0 and int(n_bed_pe) > 0
    # only the placeholders this script planted: nothing imported JAX or
    # any module of the JAX package
    assert loaded.strip() == "['jax', 'subread_tpu']"


NEW_CLIS = {
    "sublong": ["-i", "{d}/idx", "-r", "{d}/r.fq", "-o", "{d}/o.sam"],
    "featurecounts": ["-a", "{d}/g.gtf", "-o", "{d}/fc.txt", "{d}/r.sam"],
    "featurecounts --deviceCounts": ["--deviceCounts", "-a", "{d}/g.gtf",
                                     "-o", "{d}/fc.txt", "{d}/r.sam"],
    "cellcounts": ["-i", "{d}/idx", "-r", "{d}/r.fq", "-R", "{d}/r.fq", "-a", "{d}/g.gtf",
                   "-c", "{d}/wl.txt", "-o", "{d}/cc"],
}


@pytest.mark.parametrize("explicit", [False, True], ids=["default", "--device-cuda"])
@pytest.mark.parametrize("cli", list(NEW_CLIS))
def test_new_clis_refuse_cuda_without_a_card(tmp_path, cli, explicit):
    """sublong, featureCounts (with and without --deviceCounts) and
    cellCounts raise when the card they default to (or are given) is absent,
    before they read or write a file: nothing runs on the CPU or on the
    host counter instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from subread_tpu_torch.tools import cellcounts, featurecounts, sublong

    (tmp_path / "g.gtf").write_text('chr1\tx\texon\t10\t90\t.\t+\t.\tgene_id "G";\n')
    (tmp_path / "r.sam").write_text("@SQ\tSN:chr1\tLN:500\nr\t0\tchr1\t20\t30\t50M\t*\t0\t0\tA\tI\n")
    argv = [a.format(d=tmp_path) for a in NEW_CLIS[cli]]
    argv += ["--device", "cuda"] if explicit else []
    main = dict(sublong=sublong, featurecounts=featurecounts,
                cellcounts=cellcounts)[cli.split()[0]].main
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(argv)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["g.gtf", "r.sam"]


TOOLS_SCRIPT = r"""
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["subread_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
import subread_tpu_torch.parallel as par
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.config import aligner_config
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.quant.device_count import DeviceCounter
from subread_tpu_torch.synth import (
    synthetic_genes, synthetic_genome, synthetic_snp_sample, write_fastq,
    write_genes_gtf, write_genome_fasta)
from subread_tpu_torch.tools import align, exactsnp, globalreassembly, subindel, utilities
d = tempfile.mkdtemp()
p = lambda name: os.path.join(d, name)
g = synthetic_genome(60_000, seed=2)
g.save(p("idx"))
idx = build_hash_index(g, index_gap=1)
idx.save(p("idx"))
write_genome_fasta(p("g.fa"), g)
reads, snps = synthetic_snp_sample(g, seed=3, region_len=4000, coverage=20)
write_fastq(p("r.fq"), reads)
align.main(["-t", "1", "-i", p("idx"), "-r", p("r.fq"), "-o", p("a.bam"), "--device", "cpu"])
assert exactsnp.main(["-g", p("g.fa"), "-i", p("a.bam"), "-o", p("a.vcf")]) == 0
assert subindel.main(["-i", p("a.bam"), "-g", p("g.fa"), "-o", p("si.vcf")]) == 0
assert utilities.main(["sam2fq", "-i", p("a.bam"), "-o", p("back.fq")]) == 0
assert globalreassembly.main(["-i", p("back.fq"), "-o", p("c.fa"), "-L", "300"]) == 0
assert utilities.main(["propmapped", "-i", p("a.bam")]) == 0
al = Aligner(g, idx, aligner_config(batch_reads=128), device="cpu")
codes, ambig, lens, _ = al._pad_batch(reads)
codes, ambig, lens = codes[:256], ambig[:256], lens[:256]
res = par.sharded_align_step(par.make_mesh(devices=["cpu"] * 2), al)(codes, ambig, lens)
single = al._device_align(*al._upload_reads(codes, ambig, lens))
same = all(bool((res[k] == single[k]).all()) for k in single)
genes = synthetic_genes(g, 3, seed=4, exons=(2, 3))
write_genes_gtf(p("g.gtf"), genes)
dc = DeviceCounter(load_annotation(p("g.gtf")), device="cpu")
secs = dc.sections_from_file(p("a.bam"))
counted = dc.count_sharded(par.make_mesh(devices=["cpu"] * 2), *secs)[0].tolist() \
    == dc.count(*secs)[0].tolist()
loaded = sorted(m for m, v in sys.modules.items() if v is not None
                and (m in ("jax", "subread_tpu") or m.startswith(("jax.", "subread_tpu."))))
n_calls = sum(1 for l in open(p("a.vcf")) if not l.startswith("#"))
n_contigs = open(p("c.fa")).read().count(">")
print(len(reads), len(snps), n_calls, n_contigs, same, counted, loaded)
"""


def test_host_tools_and_parallel_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", TOOLS_SCRIPT, REPO], capture_output=True, text=True,
        timeout=300, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    *tool_out, last = proc.stdout.strip().splitlines()
    n_reads, n_snps, n_calls, n_contigs, same, counted, loaded = last.split(maxsplit=6)
    assert int(n_reads) == 800 and int(n_snps) == 4
    assert int(n_calls) >= 3 and int(n_contigs) >= 1
    assert same == "True" and counted == "True"
    assert tool_out[0] == "Sample\tNumReads\tNumMapped\tPropMapped"
    assert "exactSNP:" in proc.stderr and "subindel:" in proc.stderr
    assert loaded.strip() == "[]"
