"""cellCounts on the port against its plain reference
(`subread_tpu_torch/reference/cellcounts.py`, numpy only), on the CPU at a
small size:

  * `cellcounts_file` (FASTQ mode, `--bam`) on a 400 kb synthetic genome's
    default gapped index, with cell calling and without: matrix.mtx,
    barcodes.tsv and features.tsv equal the reference's, worked out from
    the run's own R1 reads and BAM records, and every record's CB, UB and
    GX tags the reference's; the CLI's closing line gives the counters;
  * `select_annotated_candidates` on seeded candidate tables gives the
    reference's positions, strands and multi-mapping flags;
  * `BatchCellCounter` at whitelist indices past 2**20 (10x v3's whitelist
    holds 6,794,880), 20,000 genes and 12-base UMIs, and at 14-base UMIs
    and 70,000 genes (two words a key): no two triples share a key, and
    the counts equal the reference's;
  * the vectorised barcode matcher equals the reference's on exact,
    one-off, two-off and ambiguous barcodes.

Every value is an integer: the tolerance is 0."""

import numpy as np
import pytest
import torch

from subread_tpu_torch import dna
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io.bam import BamReader
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.quant import cellcounts as cc
from subread_tpu_torch.reference import cellcounts as ref
from subread_tpu_torch.synth import (
    synthetic_cell_reads, synthetic_genes, synthetic_genome, write_fastq, write_genes_gtf,
)
from subread_tpu_torch.tools import cellcounts as cli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("cc_ref")
    g = synthetic_genome(400_000, seed=41, n_contigs=2)
    prefix = str(d / "idx")
    g.save(prefix)
    build_hash_index(g, index_gap=3).save(prefix)
    genes = synthetic_genes(g, 14, seed=42)
    gtf = str(d / "genes.gtf")
    write_genes_gtf(gtf, genes)
    wl, r1, r2, cells = synthetic_cell_reads(g, genes, 1500, seed=43, n_cells=20,
                                             n_whitelist=400)
    # barcodes one and two bases off a whitelist entry, to rescue and to drop
    rng = np.random.default_rng(44)
    for i in rng.choice(len(r1), 100, replace=False):
        for j in rng.choice(16, 1 + int(i % 2), replace=False):
            r1.codes[i, j] = (r1.codes[i, j] + 1 + rng.integers(0, 3)) % 4
    (d / "wl.txt").write_text("\n".join(wl) + "\n")
    write_fastq(str(d / "r1.fq"), r1)
    write_fastq(str(d / "r2.fq"), r2)
    return dict(d=d, genome=g, prefix=prefix, gtf=gtf, genes=genes, wl=wl, r1=r1)


def ascii_rows(codes, width):
    return dna.CODE2BASE[codes[:, :width] & 3]


def expected(run, bam, cell_calling):
    """The reference's matrix files and tags for the run's reads and BAM."""
    g = run["genome"]
    reader = BamReader(bam)
    recs = list(reader)
    names = {n: i for i, n in enumerate(g.names)}
    ref_id = [names[reader.ref_names[r.ref_id]] if r.ref_id >= 0 else -1 for r in recs]
    exons = sorted({(names[c], s, e, k) for k, (_, c, _, txs) in enumerate(run["genes"])
                    for tx in txs for s, e in tx})
    wl = np.frombuffer("".join(run["wl"]).encode(), np.uint8).reshape(-1, 16)
    files, tags = ref.expected_outputs(
        ascii_rows(run["r1"].codes, 28), wl, [int(x) for x in g.lengths], exons,
        [x[0] for x in run["genes"]], ref_id, [r.pos for r in recs],
        [r.flag for r in recs], [len(r.seq) for r in recs], umi_len=12,
        cell_calling=cell_calling)
    return files, tags, recs


@pytest.mark.parametrize("cell_calling", [False, True])
def test_fastq_run_equals_the_reference(run, cell_calling, capsys):
    d = run["d"]
    out, bam = d / f"out{int(cell_calling)}", str(d / f"cc{int(cell_calling)}.bam")
    argv = ["-i", run["prefix"], "-a", run["gtf"], "-c", str(d / "wl.txt"),
            "--umi-len", "12", "-r", str(d / "r1.fq"), "-R", str(d / "r2.fq"),
            "-o", str(out), "--bam", bam, "--device", "cpu"]
    assert cli.main(argv + (["--cellCalling"] if cell_calling else [])) == 0
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert "barcodes exact" in line and "cellcounts.align" in line, line
    files, tags, recs = expected(run, bam, cell_calling)
    for name, text in files.items():
        assert (out / name).read_text() == text, name
    assert len(recs) == len(run["r1"])
    n_gx = 0
    for rec, (cb, ub, gx) in zip(recs, tags):
        assert rec.tags["CB"] == cb and rec.tags["UB"] == ub
        assert rec.tags.get("GX") == gx
        n_gx += gx is not None
    assert n_gx > 0.5 * len(recs)
    m = files["matrix.mtx"].splitlines()
    assert int(m[1].split()[2]) > 50 and sum(int(x.split()[2]) for x in m[2:]) > 300


def test_rescoring_equals_the_reference(run):
    g = run["genome"]
    ann = load_annotation(run["gtf"])
    weights = cc.AnnotationWeights(ann, g)
    idx = {n: i for i, n in enumerate(g.names)}
    exons_lin = [(g.chro_to_linear(idx[c], 0) + int(s), g.chro_to_linear(idx[c], 0) + int(e))
                 for c, s, e in zip(ann.feat_chro, ann.feat_start, ann.feat_end)]
    rng = np.random.default_rng(45)
    R, K = 600, 8
    centre = np.asarray([lo for lo, _ in exons_lin], np.int64)
    pick = centre[rng.integers(0, len(centre), (R, K))]
    alt = pick + rng.integers(-260, 160, (R, K))          # over, near and off exons
    off = rng.random((R, K)) < 0.3
    alt[off] = rng.integers(1000, int(g.ends[-1]) - 200, int(off.sum()))
    alt = alt.astype(np.uint32)
    alt[rng.random((R, K)) < 0.2] = 0xFFFFFFFF
    votes = rng.integers(5, 9, (R, K)).astype(np.int32)
    res = dict(alt_pos=alt, alt_strand=rng.integers(0, 2, (R, K)).astype(np.int8),
               alt_mism=rng.integers(0, 3, (R, K)).astype(np.int32), alt_votes=votes,
               alt_clip=rng.integers(0, 4, (R, K)).astype(np.int32),
               pos=np.where(alt[:, 0] != 0xFFFFFFFF, alt[:, 0], 5000).astype(np.uint32),
               strand=rng.integers(0, 2, R).astype(np.int8),
               mapped=rng.random(R) < 0.9, multi=rng.random(R) < 0.5)
    lengths = np.full(R, 90, np.int32)
    want = ref.rescore(res["alt_pos"], res["alt_strand"], res["alt_mism"], res["alt_votes"],
                       res["alt_clip"], lengths, res["pos"], res["strand"], res["mapped"],
                       res["multi"], exons_lin)
    before = res["pos"].copy()
    got = cc.select_annotated_candidates(dict(res), lengths, weights)
    for k, w in zip(("pos", "strand", "multi"), want):
        np.testing.assert_array_equal(np.asarray(got[k]), w, err_msg=k)
    moved = (np.asarray(got["pos"]) != before).sum()
    assert 20 < moved < R


class IndexMatcher:
    """A matcher of a whitelist of n barcodes whose index a read's 16
    barcode bases spell in base 4 (first base highest)."""

    barcode_len = 16

    def __init__(self, n):
        self.barcodes = range(n)

    def match_batch(self, codes):
        return cc.pack_codes_2bit(codes).astype(np.int32)


@pytest.mark.parametrize("umi_len,n_genes", [(12, 20_000), (14, 70_000)])
def test_counter_is_exact_past_20_bits(umi_len, n_genes):
    n_cells = 6_794_880
    rng = np.random.default_rng(umi_len)
    base = rng.integers(0, n_cells - (1 << 22), 40)
    cells = np.concatenate([base, base + (1 << 20), base + (1 << 21), [n_cells - 1]])
    n = 6000
    cell = cells[rng.integers(0, len(cells), n)]
    gene = rng.integers(0, n_genes, n)
    gene[: n // 2] = n_genes - 1 - (gene[: n // 2] % 3)
    umi_pool = rng.integers(0, 4, (50, umi_len)).astype(np.uint8)
    umi = umi_pool[rng.integers(0, 50, n)]
    near = rng.random(n) < 0.2                               # one base off
    col = rng.integers(0, umi_len, n)
    umi[near, col[near]] = (umi[near, col[near]] + 1) % 4
    bc = ((cell[:, None] >> (2 * (15 - np.arange(16)))) & 3).astype(np.uint8)
    codes = np.concatenate([bc, umi], axis=1)
    gene[rng.random(n) < 0.1] = -1
    counter = cc.BatchCellCounter(IndexMatcher(n_cells), [f"g{i}" for i in range(n_genes)],
                                  umi_len=umi_len)
    for k in range(0, n, 1000):
        counter.add_batch(codes[k: k + 1000], gene[k: k + 1000].astype(np.int32))
    entries, kept = counter.finalise()
    got = np.stack([entries[:, 0], np.asarray(kept)[entries[:, 1]], entries[:, 2]], axis=1)
    want = ref.umi_counts(cell, gene, ref.values(dna.CODE2BASE[umi]), umi_len)
    np.testing.assert_array_equal(got, want)
    assert len(set(kept)) == len(set(cell[gene >= 0].tolist()))
    assert max(kept) == n_cells - 1 and counter.stats["umi_merged"] > 0
    assert counter._wide == (umi_len == 14)


def test_barcode_matcher_equals_the_reference():
    rng = np.random.default_rng(47)
    wl = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (3000, 16))]
    wl = wl[np.unique(ref.values(wl), return_index=True)[1]]
    # a pair one base apart makes the reads between them ambiguous
    wl[1] = wl[0]
    wl[1, 5] = b"ACGT"[(b"ACGT".index(wl[0, 5]) + 1) % 4]
    q = wl[rng.integers(0, len(wl), 4000)].copy()
    for i in range(len(q)):
        for j in rng.choice(16, i % 3, replace=False):
            q[i, j] = b"ACGT"[(b"ACGT".index(q[i, j]) + 1 + i % 3) % 4]
    q[:50] = wl[0]
    q[:50, 5] = b"ACGT"[(b"ACGT".index(wl[0, 5]) + 2) % 4]    # one off each of 0 and 1
    m = cc.BatchBarcodeMatcher([w.tobytes().decode() for w in wl])
    codes = dna.encode(q.tobytes()).reshape(q.shape)
    got = m.match_batch(codes)
    want = ref.match_barcodes(q, wl)
    np.testing.assert_array_equal(got, want)
    assert (got[:50] == -1).all() and (got >= 0).sum() > 2000 and (got == -1).sum() > 900
    assert m.match(q[60].tobytes().decode()) == got[60]
