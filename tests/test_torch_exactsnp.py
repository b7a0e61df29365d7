"""exactSNP on the port (`quant/snp.py`, `native/snppile.cpp`,
`tools/exactsnp.py`, copies of the JAX package's) against the JAX package,
on a diploid sample made here from a seed (`synth.synthetic_snp_sample`:
100 planted SNPs in a 100 kb region of a 400 kb genome, half heterozygous,
30x of 100 bp reads with 1% errors) aligned by the JAX package's CLI on
the CPU:

  * the VCFs are equal, apart from the `##exactSNP_Commandline` line, from
    BAM through the native pileup and through the Python record path, from
    SAM, with `-a` known SNPs and with a `-N` control sample;
  * the native pileup and the Python path give the same VCF on each side;
  * the JAX package's recall of homozygous and heterozygous SNPs and its
    precision on this sample are at least chip_smoke.py's phase-14 limits
    (run with -s to see the figures);
  * `fisher_exact_one_sided` gives equal values on a grid of tables.

Every output is a file or the same float from the same arithmetic: the
tolerance is 0."""

import itertools

import pytest

jax = pytest.importorskip("jax")
import torch

import chip_smoke
import subread_tpu.quant.snp as jsnp
import subread_tpu_torch.quant.snp as tsnp
from subread_tpu.tools import align as jalign_cli
from subread_tpu.tools import exactsnp as jcli
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io.bam import bam_to_sam_lines
from subread_tpu_torch.synth import (
    snp_call_metrics, synthetic_genome, synthetic_snp_sample, write_fastq,
    write_genome_fasta,
)
from subread_tpu_torch.tools import exactsnp as tcli

torch.set_num_threads(1)

SIDES = {"jax": (jcli.main, jsnp.SNPCaller), "port": (tcli.main, tsnp.SNPCaller)}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("snp")
    p = lambda name: str(d / name)
    g = synthetic_genome(400_000, seed=7, n_contigs=2)
    g.save(p("idx"))
    build_hash_index(g, index_gap=1).save(p("idx"))
    write_genome_fasta(p("g.fa"), g)
    reads, snps = synthetic_snp_sample(g, seed=8, region_len=100_000)
    write_fastq(p("r.fq"), reads)
    assert jalign_cli.main(["-t", "1", "-i", p("idx"), "-r", p("r.fq"), "-o", p("a.bam")]) == 0
    with open(p("a.sam"), "w") as f:
        f.writelines(f"@SQ\tSN:{n}\tLN:{int(ln)}\n" for n, ln in zip(g.names, g.lengths))
        f.writelines("\t".join(r) + "\n" for r in bam_to_sam_lines(p("a.bam")))
    # known SNPs: every third planted one
    with open(p("known.vcf"), "w") as f:
        f.write("##fileformat=VCFv4.0\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.writelines(f"{c}\t{pos}\t.\t{r}\t{a}\t.\t.\t.\n" for c, pos, r, a, _ in snps[::3])
    return dict(d=d, snps=snps, n_reads=len(reads))


def body(path):
    return [line for line in open(path)
            if not line.startswith("##exactSNP_Commandline")]


CASES = {
    "bam-native": ["-i", "{d}/a.bam"],
    "bam-python": ["-i", "{d}/a.bam"],
    "sam": ["-i", "{d}/a.sam"],
    "known -a": ["-i", "{d}/a.bam", "-a", "{d}/known.vcf"],
    "control -N": ["-i", "{d}/a.bam", "-N", "{d}/a.sam", "-t", "5"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_vcf_equals_jax(sample, case, tmp_path, monkeypatch):
    d = sample["d"]
    out, native = {}, []
    for side, (main, caller) in SIDES.items():
        if case == "bam-python":
            monkeypatch.setattr(caller, "_add_bam_native", lambda self, path: False)
        elif case == "bam-native":
            def spy(self, path, real=caller._add_bam_native):
                native.append(real(self, path))
                return native[-1]

            monkeypatch.setattr(caller, "_add_bam_native", spy)
        out[side] = tmp_path / f"{side}.vcf"
        argv = ["-g", f"{d}/g.fa", "-o", str(out[side])]
        argv += [a.format(d=d) for a in CASES[case]]
        assert main(argv) == 0
    assert body(out["port"]) == body(out["jax"])
    recs = [line for line in body(out["port"]) if not line.startswith("#")]
    assert len(recs) > 50
    if case == "bam-native":
        assert native == [True, True]
    if case == "control -N":
        assert all("CTRL_DP=" in r for r in recs)


def test_native_pileup_equals_python_path(sample, tmp_path, monkeypatch):
    d = sample["d"]
    for side, (main, caller) in SIDES.items():
        a, b = tmp_path / f"{side}-native.vcf", tmp_path / f"{side}-python.vcf"
        assert main(["-g", f"{d}/g.fa", "-i", f"{d}/a.bam", "-o", str(a)]) == 0
        with monkeypatch.context() as m:
            m.setattr(caller, "_add_bam_native", lambda self, path: False)
            assert main(["-g", f"{d}/g.fa", "-i", f"{d}/a.bam", "-o", str(b)]) == 0
        assert body(a) == body(b)


def test_recall_and_precision_meet_the_chip_limits(sample, tmp_path):
    """The JAX package's figures on this sample: chip_smoke.py's phase-14
    limits sit below them."""
    out = tmp_path / "jax.vcf"
    d = sample["d"]
    assert jcli.main(["-g", f"{d}/g.fa", "-i", f"{d}/a.bam", "-o", str(out)]) == 0
    m = snp_call_metrics(str(out), sample["snps"])
    print(f"exactSNP on {sample['n_reads']} reads, {len(sample['snps'])} planted SNPs "
          f"(JAX package, CPU): {m}")
    for k, lo in chip_smoke.EXACTSNP_MIN.items():
        assert m[k] >= lo, (k, m[k], lo)


def test_fisher_exact_equal():
    grid = [0, 1, 2, 3, 5, 8, 13, 30, 100, 400]
    for a, b, c, d in itertools.product(grid, repeat=4):
        assert tsnp.fisher_exact_one_sided(a, b, c, d) == \
            jsnp.fisher_exact_one_sided(a, b, c, d), (a, b, c, d)
