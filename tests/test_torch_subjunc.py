"""subjunc on the port against the JAX package, on a 200 kb synthetic genome
with spliced reads (introns at the genome's own GT..AG and CT..AC sites,
short flanks, two-intron reads, chimeras), the reads of a planted
two-intron chain and of a junction whose reads mostly have a 15-base flank:

  * the collect_batch and collect_batch_pe dicts (keys, dtypes, values),
    with and without --allJunctions, the device rescue tiers and the host
    saturation rescue exercised;
  * the SAM, .junction.bed, .indel.vcf and .breakpoints.vcf of align_file
    and align_file_pe, with --allJunctions and with -a (a GTF written here);
  * the case "gap3": the dicts and align_file's outputs with
    --allJunctions on a gapped index (index_gap=3, subread-buildindex's
    default) of the same genome;
  * `python -m subread_tpu_torch.tools.subjunc --device cpu` and
    `python -m subread_tpu_torch.tools.align --sv --device cpu`.

Every output is an integer, a bool or a file: the tolerance is 0."""

import filecmp
import os
import subprocess
import sys
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
    synthetic_genome, synthetic_spliced_pairs, synthetic_spliced_reads,
    write_fastq,
)
from subread_tpu_torch.tools import align as align_cli
from subread_tpu_torch.tools import subjunc as subjunc_cli
from torch_native_fixtures import native_mode, native_records  # noqa: F401  (fixtures)

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = dict(n_bases=200_000, seed=5, tandem_frac=0.05, segdup_len=2000)
# tandem arrays whose reads saturate the main pass and outlast the device
# tiers (see test_torch_align.py)
PLANTED = ((b"AGCT", 60, 10_000), (b"AT", 60, 20_000))
CHAIN_AT = 30_000       # contig 0 offset of the planted two-intron chain
BATCH = 512             # every aligner here: one JAX compile per config


@pytest.fixture(scope="module")
def genome():
    """The synthetic genome with the tandem arrays and, on contig 0, three
    exons [b, b+10), [b+110, b+190), [b+290, b+310) with GT..AG planted at
    both introns (the reference's 8M98N74M168N19M shape)."""
    g = synthetic_genome(**GENOME)
    for unit, copies, at in PLANTED:
        s = int(g.starts[1]) + at
        arr = np.tile(dna.encode(unit), copies)
        g.codes[s: s + len(arr)] = arr
    b = g.chro_to_linear(0, CHAIN_AT)
    assert not g.get_ambig(b - 100, b + 400).any()
    g.codes[b + 10: b + 12] = (1, 3)
    g.codes[b + 108: b + 110] = (0, 1)
    g.codes[b + 190: b + 192] = (1, 3)
    g.codes[b + 288: b + 290] = (0, 1)
    return g


@pytest.fixture(scope="module")
def index(genome):
    return build_hash_index(genome, index_gap=1)


def _seq(codes) -> bytes:
    return dna.decode(codes).encode()


def _read_seq(b, i) -> bytes:
    L = int(b.lengths[i])
    s = dna.CODE2BASE[b.codes[i, :L] & 3].copy()
    s[b.ambig[i, :L]] = ord("N")
    return s.tobytes()


def special_reads(genome):
    """(names, seqs): the chain read and its companions; 20 reads split
    50/50 and 20 split 85/15 across one GT..AG junction found by search on
    contig 2; and reads from the planted arrays."""
    g = genome.codes
    b = genome.chro_to_linear(0, CHAIN_AT)
    ex2 = g[b + 110: b + 190]
    names = ["multi"] + [f"d1_{i}" for i in range(3)] + [f"d2_{i}" for i in range(3)]
    seqs = ([_seq(np.concatenate([g[b: b + 10], ex2, g[b + 290: b + 310]]))]
            + [_seq(np.concatenate([g[b - 40: b + 10], ex2[:50]]))] * 3
            + [_seq(np.concatenate([ex2[30:], g[b + 290: b + 340]]))] * 3)
    base = genome.chro_to_linear(2, 5000)
    seg = g[base: base + 50_000]
    ag = set(np.flatnonzero((seg[:-1] == 0) & (seg[1:] == 1)).tolist())
    E = gap = None
    for d in np.flatnonzero((seg[:-1] == 1) & (seg[1:] == 3)):
        le = int(d) - 1
        for cand in range(4500, 5600):
            if le + cand - 2 in ag and not genome.get_ambig(base + le - 100, base + le + cand + 100).any():
                E, gap = base + le, cand
                break
        if E is not None:
            break
    assert E is not None
    for kind, off in (("disc", 50), ("weak", 85)):
        for i in range(20):
            names.append(f"{kind}{i}")
            seqs.append(_seq(np.concatenate([g[E - off + 1: E + 1],
                                             g[E + gap: E + gap + 100 - off]])))
    for unit, copies, at in PLANTED:
        s0 = int(genome.starts[1]) + at
        span = len(unit) * copies - 100
        for k, off in enumerate(range(0, span, max(span // 6, 1))):
            r = g[s0 + off: s0 + off + 100]
            names.append(f"planted_{unit.decode()}_{off}")
            seqs.append(_seq(dna.revcomp(r) if k % 2 else r))
    return names, seqs


@pytest.fixture(scope="module")
def data(genome, index, tmp_path_factory):
    """Index on disk, the single-end reads (special + spliced, 1000) and
    the pairs (1000) as FASTQ, and a GTF of some planted junctions plus a
    decoy gene."""
    d = tmp_path_factory.mktemp("subjunc")
    genome.save(str(d / "idx"))
    index.save(str(d / "idx"))
    names, seqs = special_reads(genome)
    sp, truth = synthetic_spliced_reads(genome, 1000 - len(names), seed=31,
                                        chimera_frac=0.05)
    names += list(sp.names)
    seqs += [_read_seq(sp, i) for i in range(len(sp))]
    se = batch_from_records(names, seqs, [b"I" * len(s) for s in seqs], pad_to=100)
    write_fastq(str(d / "se.fq"), se)
    b1, b2, ptruth = synthetic_spliced_pairs(genome, 1000, seed=32,
                                             chimera_frac=0.05)
    write_fastq(str(d / "r1.fq"), b1)
    write_fastq(str(d / "r2.fq"), b2)
    with open(d / "ann.gtf", "w") as f:
        for n, (c, le, re_, ds) in enumerate(sorted(truth["junctions"])[::3]):
            s = "-" if ds else "+"
            for a, e in ((le - 48, le + 1), (re_ + 1, re_ + 50)):
                f.write(f'{c}\tsim\texon\t{a}\t{e}\t.\t{s}\t.\tgene_id "g{n}"; '
                        f'transcript_id "t{n}";\n')
        for a, e in ((2000, 2100), (2500, 2600), (9000, 9100)):
            f.write(f'chr3\tsim\texon\t{a}\t{e}\t.\t+\t.\tgene_id "decoy"; '
                    f'transcript_id "decoy";\n')
    return dict(dir=d, se=se, pe=(b1, b2), truth=truth, ptruth=ptruth)


def config(*extra, subjunc=True):
    parser = subjunc_cli.build_parser() if subjunc else align_cli.build_parser()
    base = ["-i", "x", "-r", "x", "-o", "x"] + ([] if subjunc else ["-t", "1"])
    args = parser.parse_args(base + list(extra))
    return replace(align_cli.config_from_args(args, subjunc), batch_reads=BATCH)


@pytest.fixture(scope="module")
def aligners(genome, index):
    """One port and one JAX aligner per configuration, built once; gap=3
    puts them on the gapped index, built on first use."""
    out, indexes = {}, {1: index}

    def get(name, *extra, subjunc=True, gap=1):
        if name not in out:
            if gap not in indexes:
                indexes[gap] = build_hash_index(genome, index_gap=gap)
            cfg = config(*extra, subjunc=subjunc)
            out[name] = (Aligner(genome, indexes[gap], cfg, device="cpu"),
                         JAligner(genome, indexes[gap], cfg))
        return out[name]
    return get


def case_aligners(aligners, case):
    """subjunc's defaults ("subjunc"), --allJunctions ("allJunctions"), or
    --allJunctions on the gapped index ("gap3")."""
    if case == "gap3":
        return aligners(case, "--allJunctions", gap=3)
    return aligners(case, *(["--allJunctions"] if case != "subjunc" else []))


def assert_same_dict(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def same_outputs(a: str, b: str, breakpoints: bool):
    for suf in ("", ".junction.bed", ".indel.vcf") + (
            (".breakpoints.vcf",) if breakpoints else ()):
        assert filecmp.cmp(a + suf, b + suf, shallow=False), suf
    assert not os.path.exists(a + ".breakpoints.vcf") or breakpoints


def records(path):
    with open(path) as f:
        return [line.split("\t") for line in f if not line.startswith("@")]


@pytest.mark.parametrize("case", ["subjunc", "allJunctions", "gap3"])
def test_collect_batch_dict_matches_jax(data, aligners, case):
    al, jal = case_aligners(aligners, case)
    seen = {}
    fold, host = al._rescue_fold, al._rescue_saturated
    al._rescue_fold = lambda c, a, l, res, ul: (
        seen.__setitem__("fold", int(res["saturated"].sum())) or fold(c, a, l, res, ul))
    al._rescue_saturated = lambda b, out: (
        seen.__setitem__("host", int(out["saturated"].sum())) or host(b, out))
    try:
        t = al.align_batch(data["se"])
    finally:
        del al._rescue_fold, al._rescue_saturated
    j = jal.align_batch(data["se"])
    assert_same_dict(t, j)
    assert seen["fold"] > 0 and seen["host"] > 0
    assert t["junc"].sum() > 200 and t["seed_ok"].any() and t["alt2_ok"].any()
    assert ("vk_pos" in t and "best_k" in t) == (case != "subjunc")


@pytest.mark.parametrize("case", ["subjunc", "allJunctions", "gap3"])
def test_collect_batch_pe_dicts_match_jax(data, aligners, case):
    al, jal = case_aligners(aligners, case)
    t = al.align_batch_pe(*data["pe"])
    j = jal.align_batch_pe(*data["pe"])
    for m in (0, 1):
        assert_same_dict(t[m], j[m])
        assert t[m]["junc"].sum() > 100
        assert ("vk_pos" in t[m] and "best_k" in t[m]) == (case != "subjunc")


@pytest.mark.parametrize("case", ["allJunctions", "annotation", "gap3"])
def test_align_file_outputs_match_jax(data, aligners, case):
    """Single-end SAM, .junction.bed, .indel.vcf (and .breakpoints.vcf);
    the chain read gets its two-intron CIGAR and the 15-base-flank reads
    their junction through the event table, as the JAX package gives."""
    d = data["dir"]
    if case != "annotation":
        al, jal = case_aligners(aligners, case)
    else:
        al, jal = aligners("subjunc")
        ann = align_cli.load_annotated_junctions(
            subjunc_cli.build_parser().parse_args(
                ["-i", "x", "-r", "x", "-o", "x", "-a", str(d / "ann.gtf")]))
        assert len(ann) > 5
        al.annot_junctions = jal.annot_junctions = ann
    try:
        al.align_file(str(d / "se.fq"), str(d / f"t_{case}.sam"))
        jal.align_file(str(d / "se.fq"), str(d / f"j_{case}.sam"))
    finally:
        for a in (al, jal):
            a.annot_junctions = None
    same_outputs(str(d / f"t_{case}.sam"), str(d / f"j_{case}.sam"),
                 case != "annotation")
    got = {r[0]: r[5] for r in records(d / f"t_{case}.sam")}
    assert got["multi"] == "10M100N80M100N20M"
    assert sum("N" in got[f"weak{i}"] for i in range(20)) >= 15
    assert sum("N" in c for c in got.values()) > 300
    bed = (d / f"t_{case}.sam.junction.bed").read_text().splitlines()[1:]
    assert len(bed) > 20 and max(int(r.split("\t")[4]) for r in bed) >= 30
    if case != "annotation":
        vcf = (d / f"t_{case}.sam.breakpoints.vcf").read_text()
        assert "SVTYPE=BND" in vcf


@pytest.mark.parametrize("case", ["allJunctions", "annotation"])
def test_align_file_pe_outputs_match_jax(data, aligners, case):
    d = data["dir"]
    if case == "allJunctions":
        al, jal = aligners(case, "--allJunctions")
    else:
        al, jal = aligners("subjunc")
        ann = align_cli.load_annotated_junctions(
            subjunc_cli.build_parser().parse_args(
                ["-i", "x", "-r", "x", "-o", "x", "-a", str(d / "ann.gtf")]))
        al.annot_junctions = jal.annot_junctions = ann
    try:
        al.align_file_pe(str(d / "r1.fq"), str(d / "r2.fq"),
                         str(d / f"tp_{case}.sam"))
        jal.align_file_pe(str(d / "r1.fq"), str(d / "r2.fq"),
                          str(d / f"jp_{case}.sam"))
    finally:
        for a in (al, jal):
            a.annot_junctions = None
    same_outputs(str(d / f"tp_{case}.sam"), str(d / f"jp_{case}.sam"),
                 case == "allJunctions")
    recs = records(d / f"tp_{case}.sam")
    assert len(recs) == 2000 and sum("N" in r[5] for r in recs) > 400
    if case == "allJunctions":
        assert "SVTYPE=BND" in (d / f"tp_{case}.sam.breakpoints.vcf").read_text()


def test_cli_matches_jax(data, aligners):
    """subjunc through `python -m subread_tpu_torch.tools.subjunc` (its
    default batch size) gives the JAX aligner's files; `tools.align --sv`
    runs junction and breakpoint detection too."""
    d = data["dir"]
    _, jal = aligners("allJunctions", "--allJunctions")
    if not os.path.exists(d / "j_allJunctions.sam"):
        jal.align_file(str(d / "se.fq"), str(d / "j_allJunctions.sam"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", *a, "-i", str(d / "idx"), "-r", str(d / "se.fq"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env)
    proc = run("subread_tpu_torch.tools.subjunc", "--allJunctions",
               "-o", str(d / "cli.sam"))
    assert proc.returncode == 0, proc.stderr
    assert "Mapped:" in proc.stderr
    same_outputs(str(d / "cli.sam"), str(d / "j_allJunctions.sam"), True)
    proc = run("subread_tpu_torch.tools.align", "-t", "1", "--sv",
               "-o", str(d / "sv.sam"))
    assert proc.returncode == 0, proc.stderr
    bed = (d / "sv.sam.junction.bed").read_text().splitlines()
    assert len(bed) > 10
    assert os.path.exists(d / "sv.sam.breakpoints.vcf")
    cfg = config("--sv", subjunc=False)
    assert cfg.detect_junctions and cfg.all_junctions and cfg.min_votes == 3


def test_bam_pe_matches_jax(data, aligners, native_mode, native_records):
    """`tools.subjunc -r r1.fq -R r2.fq -o x.bam` writes the JAX aligner's
    BAM byte for byte, with the native library (every record packed by
    its BAM encoder, chained junction CIGARs in place) and without it."""
    from subread_tpu_torch.io.bam import BamReader

    d = data["dir"]
    _, jal = aligners("subjunc")
    packed = native_records
    jax_bam, port_bam = d / f"jp_{native_mode}.bam", d / f"tp_{native_mode}.bam"
    jal.align_file_pe(str(d / "r1.fq"), str(d / "r2.fq"), str(jax_bam))
    subjunc_cli.main(["-i", str(d / "idx"), "-r", str(d / "r1.fq"), "-R",
                      str(d / "r2.fq"), "-o", str(port_bam), "--device", "cpu"])
    same_outputs(str(port_bam), str(jax_bam), False)
    recs = list(BamReader(str(port_bam)))
    assert len(recs) == 2000
    assert packed[0] == (len(recs) if native_mode == "native" else 0)
    # chained junctions: records with two introns, or an intron and a clip
    assert any(sum(op == "N" for _, op in r.cigar) > 1 for r in recs)
