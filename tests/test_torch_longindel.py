"""The long-indel rescue (-I > 16) on the port: reads with planted 20-40 bp
deletions and 20 bp insertions (built as the JAX package's
test_long_indel_rescue builds them), plus simulated reads with indels up
to 30 bp, aligned with -I 60 by the port's Aligner on the CPU and by the JAX
package's.  The SAM and .indel.vcf must be byte-equal, with long D and I
CIGARs in them.  Paired-end with -I 60 runs no long-indel rescue, in
either package, and must match too."""

import filecmp
import re
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu import dna
from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu.index.build import build_hash_index
from subread_tpu.io.fastq import batch_from_records
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_long_indel_reads, write_fastq,
)
from subread_tpu_torch.tools import align as align_cli

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

GENOME = dict(n_bases=200_000, seed=5, tandem_frac=0.05, segdup_len=2000)
LONG = re.compile(r"(\d+)([DI])")


@pytest.fixture(scope="module")
def genome():
    return synthetic_genome(**GENOME)


@pytest.fixture(scope="module")
def index(genome):
    return build_hash_index(genome, index_gap=1)


def config(*extra):
    args = align_cli.build_parser().parse_args(
        ["-t", "1", "-i", "x", "-r", "x", "-o", "x", "-I", "60", *extra]
    )
    return replace(align_cli.config_from_args(args), batch_reads=512)


def same_files(a, b):
    return filecmp.cmp(a, b, shallow=False)


def long_ops(sam):
    with open(sam) as f:
        cig = [line.split("\t")[5] for line in f if not line.startswith("@")]
    ops = [(int(n), op) for c in cig for n, op in LONG.findall(c)]
    return ({n for n, op in ops if op == "D" and n > 16},
            {n for n, op in ops if op == "I" and n > 16})


def test_long_indel_sam_and_vcf_match_jax(genome, index, tmp_path):
    batch = synthetic_long_indel_reads(genome, seed=77)
    fq = str(tmp_path / "li.fq")
    write_fastq(fq, batch)
    cfg = config()
    assert cfg.max_indel == 60
    JAligner(genome, index, cfg).align_file(fq, str(tmp_path / "jax.sam"))
    Aligner(genome, index, cfg, device="cpu").align_file(
        fq, str(tmp_path / "torch.sam")
    )
    assert same_files(tmp_path / "torch.sam", tmp_path / "jax.sam")
    assert same_files(str(tmp_path / "torch.sam") + ".indel.vcf",
                      str(tmp_path / "jax.sam") + ".indel.vcf")
    dels, inss = long_ops(tmp_path / "jax.sam")
    assert {20, 30, 40} <= dels, dels
    assert 20 in inss, inss
    vcf = open(str(tmp_path / "jax.sam") + ".indel.vcf").read().splitlines()
    assert any(len(v.split("\t")[3]) == 41 for v in vcf if v[0] != "#")


def test_long_indel_pe_matches_jax(genome, index, tmp_path):
    """-R with -I 60: the long-indel reads as mate 1, exact 100 bp mates
    from elsewhere in the genome as mate 2; align_file_pe runs no
    long-indel rescue."""
    b1 = synthetic_long_indel_reads(genome, seed=78)
    g, starts = genome.codes, genome.starts
    names, mates = list(b1.names), []
    rng = np.random.default_rng(5)
    for i in range(len(b1)):
        c = int(rng.integers(0, 3))
        lin = int(starts[c]) + int(rng.integers(1000, 60_000))
        mates.append(dna.decode(dna.revcomp(g[lin + 250: lin + 350])).encode())
    b2 = batch_from_records(names, mates, [b"I" * 100] * len(names), pad_to=100)
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(f1, b1)
    write_fastq(f2, b2)
    cfg = config("-R", "x")
    JAligner(genome, index, cfg).align_file_pe(f1, f2, str(tmp_path / "jax.sam"))
    Aligner(genome, index, cfg, device="cpu").align_file_pe(
        f1, f2, str(tmp_path / "torch.sam")
    )
    assert same_files(tmp_path / "torch.sam", tmp_path / "jax.sam")
    assert same_files(str(tmp_path / "torch.sam") + ".indel.vcf",
                      str(tmp_path / "jax.sam") + ".indel.vcf")
    dels, inss = long_ops(tmp_path / "jax.sam")
    assert not (dels | inss)     # no long-indel rescue on the paired path
