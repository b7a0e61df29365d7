"""The port's copies of the host-only tools against the JAX package's, on
inputs made here from a seed: each of the 14 `utilities` subcommands,
`globalReassembly` (through `utilities` and its own main) and `subindel`
write byte-equal files and print the same standard output, on a 200 kb
synthetic genome, a GTF of its genes, reads and pairs aligned by the
port's CLI on the CPU (SAM and BAM), and, for subindel, reads
soft-clipped across a planted 60-base deletion and a 25-base insertion.

Every output is a file or text: the tolerance is 0."""

import numpy as np
import pytest
import torch

from subread_tpu.tools import subindel as jsubindel
from subread_tpu.tools import utilities as jutil
from subread_tpu_torch import dna
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io import sam as samio
from subread_tpu_torch.synth import (
    synthetic_genes, synthetic_genome, synthetic_pairs, synthetic_reads,
    write_fastq, write_genes_gtf, write_genome_fasta,
)
from subread_tpu_torch.tools import align as align_cli
from subread_tpu_torch.tools import subindel as tsubindel
from subread_tpu_torch.tools import utilities as tutil

torch.set_num_threads(1)

SIDES = {"jax": (jutil.main, jsubindel.main), "port": (tutil.main, tsubindel.main)}


def _sam_to_bam(sam, bam):
    names, lens = [], []
    for line in open(sam):
        if line.startswith("@SQ"):
            d = dict(f.split(":", 1) for f in line.rstrip().split("\t")[1:])
            names.append(d["SN"])
            lens.append(int(d["LN"]))
    w = samio.make_writer(str(bam), names, lens, sam_output=False)
    for line in open(sam):
        if not line.startswith("@"):
            w.write_line(line.rstrip("\n"))
    w.close()


def _subindel_sam(path, g):
    """Reads soft-clipped across a 60-base deletion (clipped tails that
    match 60 bases on) and a 25-base insertion (tails that start with the
    inserted bases), as tests/test_subindel.py plants them on chr901."""
    seq = lambda a, b: dna.decode(g.codes[a:b])
    DEL, ins = 60, "ACGTTGCAACGTTGCAACGTTGCAA"
    lines = [f"@SQ\tSN:{n}\tLN:{int(l)}" for n, l in zip(g.names, g.lengths)]
    bp = 30_050                      # 0-based first deleted base
    for i in range(6):
        m = 50 + 8 * i
        a = g.chro_to_linear(0, bp - m)
        read = seq(a, a + m) + seq(a + m + DEL, a + 100 + DEL)
        lines.append(f"d{i}\t0\t{g.names[0]}\t{bp - m + 1}\t40\t{m}M{100 - m}S\t*\t0\t0"
                     f"\t{read}\t{'I' * 100}")
        a = g.chro_to_linear(0, 50_050 - m)
        read = (seq(a, a + m) + ins + seq(a + m, a + 100))[:100]
        lines.append(f"i{i}\t0\t{g.names[0]}\t{50_050 - m + 1}\t40\t{m}M{100 - m}S\t*\t0\t0"
                     f"\t{read}\t{'I' * 100}")
        # left-clipped reads on the deletion's right flank
        c = 30 + 5 * i
        b = g.chro_to_linear(0, bp)
        read = seq(b - c, b) + seq(b + DEL, b + DEL + 100 - c)
        lines.append(f"e{i}\t0\t{g.names[0]}\t{bp + DEL + 1}\t40\t{c}S{100 - c}M"
                     f"\t*\t0\t0\t{read}\t{'I' * 100}")
    open(path, "w").write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    p = lambda name: str(d / name)
    g = synthetic_genome(200_000, seed=31, n_contigs=2)
    write_genome_fasta(p("g.fa"), g)
    g.save(p("idx"))
    build_hash_index(g, index_gap=1).save(p("idx"))
    write_genes_gtf(p("g.gtf"), synthetic_genes(g, 6, seed=32, exons=(2, 4)))
    write_fastq(p("r.fq"), synthetic_reads(g, 1500, seed=33))
    b1, b2 = synthetic_pairs(g, 600, seed=34)
    write_fastq(p("r1.fq"), b1)
    write_fastq(p("r2.fq"), b2)
    base = ["-t", "1", "-i", p("idx"), "--device", "cpu", "--SAMoutput"]
    align_cli.main(base + ["-r", p("r.fq"), "-o", p("se.sam")])
    align_cli.main(base + ["-r", p("r1.fq"), "-R", p("r2.fq"), "-o", p("pe.sam")])
    _sam_to_bam(p("se.sam"), p("se.bam"))
    # mates scattered: every first record, then every second; one orphan
    head = [l for l in open(p("pe.sam")) if l.startswith("@")]
    body = [l for l in open(p("pe.sam")) if not l.startswith("@")]
    open(p("scrambled.sam"), "w").writelines(head + body[0::2] + body[1:-1:2])
    # duplicates: the single-end records once more
    se = open(p("se.sam")).readlines()
    open(p("dup.sam"), "w").writelines(se + [l for l in se if not l.startswith("@")][:300])
    for k in range(2):
        rows = [f"{g.names[0]}\t{1000 + 37 * i + k}\t.\tA\tG\t{10 + i}\tPASS\tDP={i}\n"
                for i in range(0, 40, 1 + k)]
        open(p(f"v{k}.vcf"), "w").write("##fileformat=VCFv4.0\n#CHROM\tPOS\tID\tREF"
                                        "\tALT\tQUAL\tFILTER\tINFO\n" + "".join(rows))
    bed = ["#chrom\tstart\tend\tname\tscore\tstrand\n"] + [
        f"{g.names[i % 2]}\t{100 * i}\t{100 * i + 500}\tJUNC{i}\t{i % 5}\t+\n"
        for i in range(30)]
    open(p("j.bed"), "w").writelines(bed)
    rng = np.random.default_rng(35)
    with open(p("asm.fq"), "w") as f:
        for s, n in ((0, 2000), (1, 900)):
            src = rng.integers(0, 4, n).astype(np.uint8)
            for k, at in enumerate(rng.permutation(range(0, n - 99, 35))):
                r = src[at:at + 100] if k % 3 else dna.revcomp(src[at:at + 100])
                f.write(f"@s{s}_{at}\n{dna.decode(r)}\n+\n{'I' * 100}\n")
    _subindel_sam(p("sub.sam"), g)
    query = dna.decode(g.codes[int(g.starts[1]) + 5000:int(g.starts[1]) + 5040])
    return dict(d=d, query=query)


CASES = {
    "propmapped": ["propmapped", "-i", "{in}/se.sam", "-o", "{out}/prop.txt"],
    "propmapped -f -p": ["propmapped", "-i", "{in}/pe.sam", "-f", "-p", "-o", "{out}/prop.txt"],
    "propmapped bam": ["propmapped", "-i", "{in}/se.bam"],
    "qualityScores": ["qualityScores", "-i", "{in}/r.fq", "-o", "{out}/q.txt", "-n", "500"],
    "removeDup": ["removeDup", "-i", "{in}/dup.sam", "-o", "{out}/rd.sam", "-r", "2"],
    "removeDup bam": ["removeDup", "-i", "{in}/se.bam", "-o", "{out}/rd.sam", "-r", "1"],
    "flattenGTF": ["flattenGTF", "-a", "{in}/g.gtf", "-o", "{out}/flat.saf"],
    "flattenGTF -C": ["flattenGTF", "-a", "{in}/g.gtf", "-o", "{out}/flat.saf", "-C"],
    "repair": ["repair", "-i", "{in}/scrambled.sam", "-o", "{out}/rep.sam"],
    "coverageCount": ["coverageCount", "-i", "{in}/se.bam", "-o", "{out}/cov"],
    "fullscan": ["fullscan", "-g", "{in}/g.fa", "-s", "{query}", "-m", "0.8"],
    "txUnique": ["txUnique", "-a", "{in}/g.gtf"],
    "sam2fq": ["sam2fq", "-i", "{in}/pe.sam", "-o", "{out}/o.fq"],
    "genRandomReads": ["genRandomReads", "-g", "{in}/g.fa", "-o", "{out}/sim", "-n", "200",
                       "-e", "0.01", "--indel-rate", "0.1", "-s", "5"],
    "genRandomReads -p": ["genRandomReads", "-g", "{in}/g.fa", "-o", "{out}/sim", "-n", "100",
                          "-p", "-s", "6"],
    "detectionCall": ["detectionCall", "-a", "{in}/g.gtf", "-G", "{in}/g.fa",
                      "-o", "{out}/dc.txt"],
    "detectionCall -I": ["detectionCall", "-a", "{in}/g.gtf", "-G", "{in}/g.fa",
                         "-o", "{out}/dc.txt", "-I"],
    "mergeVCF": ["mergeVCF", "-o", "{out}/m.vcf", "{in}/v0.vcf", "{in}/v1.vcf"],
    "samMappedBases": ["samMappedBases", "-i", "{in}/pe.sam"],
    "filterJunctionTable": ["filterJunctionTable", "-i", "{in}/j.bed", "-o", "{out}/j.bed",
                            "-n", "3"],
    "globalReassembly": ["globalReassembly", "-i", "{in}/asm.fq", "-o", "{out}/c.fa",
                         "-L", "500"],
    "subindel": ["-i", "{in}/sub.sam", "-g", "{in}/g.fa", "-o", "{out}/si.vcf", "-n", "2"],
    "subindel index": ["-i", "{in}/sub.sam", "-g", "{in}/idx", "-o", "{out}/si.vcf",
                       "-I", "80"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_tool_outputs_equal_jax(inputs, case, tmp_path, capsys):
    got = {}
    for side, (util_main, subindel_main) in SIDES.items():
        out = tmp_path / side
        out.mkdir()
        argv = [a.format(**{"in": inputs["d"], "out": out, "query": inputs["query"]})
                for a in CASES[case]]
        main = subindel_main if case.startswith("subindel") else util_main
        assert main(argv) == 0
        files = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
        got[side] = (capsys.readouterr().out.replace(str(out), "OUT"), files)
    assert got["port"] == got["jax"]
    stdout, files = got["port"]
    assert stdout or files
    assert all(files.values()) or case == "filterJunctionTable"
    if case == "globalReassembly":
        assert files["c.fa"].count(b">") == 2
    if case.startswith("subindel"):
        rows = [r.split(b"\t") for r in files["si.vcf"].splitlines()
                if not r.startswith(b"#")]
        assert any(len(r[3]) - len(r[4]) == 60 for r in rows)
        if case == "subindel":
            assert any(len(r[4]) - len(r[3]) == 25 for r in rows)


def test_globalreassembly_own_main_and_usage(inputs, tmp_path, capsys):
    from subread_tpu.tools import globalreassembly as jga
    from subread_tpu_torch.tools import globalreassembly as tga

    outs = []
    for m in (jga, tga):
        o = tmp_path / f"{m.__name__.split('.')[0]}.fa"
        assert m.main(["-i", str(inputs["d"] / "asm.fq"), "-o", str(o), "-V", "3"]) == 0
        outs.append(o.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b">") >= 1
    capsys.readouterr()
    assert jutil.main(["nope"]) == tutil.main(["nope"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] and "globalReassembly" in err[0]
    assert sorted(tutil.TOOLS) == sorted(jutil.TOOLS) and len(tutil.TOOLS) == 15
