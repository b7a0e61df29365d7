"""The paired-end slice: the port's Aligner on the CPU against the JAX
package's — `_select_pe` on random, tie-rich score tables; the
`align_batch_pe` dicts (keys, dtypes, values) with a full index, a gapped
index, -B 3 --multiMapping and a 2-block -M index; the paired rescue fold,
the host paired rescue and its window escalation all exercised; then
`align_file_pe`'s SAM and .indel.vcf, and the same through
`python -m subread_tpu_torch.tools.align -r r1.fq -R r2.fq --device cpu`.
Every output is an integer or a bool: the tolerance is 0."""

import filecmp
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
import torch

from subread_tpu import dna
from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu.config import aligner_config
from subread_tpu.index.build import build_hash_index, split_index_blocks
from subread_tpu.io.fastq import batch_from_records
from subread_tpu.utils.simulate import simulate_reads
from subread_tpu_torch.align import indelevent as t_indelevent
from subread_tpu_torch.align import pipeline as t_pipeline
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.synth import synthetic_genome, synthetic_pairs, write_fastq
from subread_tpu_torch.tools import align as align_cli
from torch_native_fixtures import native_mode, native_records  # noqa: F401  (fixtures)

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = dict(n_bases=200_000, seed=5, tandem_frac=0.05, segdup_len=2000)
# tandem arrays of units that are their own reverse complement (see
# test_torch_align.py): pairs with a mate inside them saturate the main
# pass, outlast the device tiers and need a window above 40
PLANTED = ((b"AGCT", 60, 10_000), (b"AT", 60, 20_000))
SEN = np.uint32(0xFFFFFFFF)


@pytest.fixture(scope="module")
def genome():
    g = synthetic_genome(**GENOME)
    for unit, copies, at in PLANTED:
        s = int(g.starts[1]) + at
        arr = np.tile(dna.encode(unit), copies)
        g.codes[s: s + len(arr)] = arr
    return g


@pytest.fixture(scope="module")
def index(genome):
    return build_hash_index(genome, index_gap=1)


def _seq(codes) -> bytes:
    return dna.decode(codes).encode()


def _read_seq(b, i) -> bytes:
    """Read i of a batch as FASTQ bases, N where the ambiguity mask is set."""
    L = int(b.lengths[i])
    s = dna.CODE2BASE[b.codes[i, :L] & 3].copy()
    s[b.ambig[i, :L]] = ord("N")
    return s.tobytes()


def pairs_for(genome, n, seed):
    """Special pairs, simulated pairs (errors, indels, N) up to n pairs,
    then 512 exact pairs that fill the last 512-pair sub-batch (no host
    placement flags there).  The special pairs: mates on different
    contigs; mates 2-3 kb apart (beyond max_fragment); a mate of random
    sequence next to a mapped one; a mate inside each planted array with
    its partner 200-400 bases downstream."""
    rng = np.random.default_rng(seed)
    g = genome.codes
    names, s1, s2 = [], [], []

    def add(name, lin1, lin2, r1=None):
        names.append(name)
        s1.append(_seq(g[lin1: lin1 + 100]) if r1 is None else r1)
        s2.append(_seq(dna.revcomp(g[lin2: lin2 + 100])))

    st = [int(x) for x in genome.starts]
    for k in range(8):
        a, b = (int(x) for x in rng.integers(1000, 50_000, 2))
        add(f"diffcontig{k}", st[0] + a, st[2] + b)
        add(f"farmates{k}", st[0] + a, st[0] + a + 2000 + 100 * k)
        rand = rng.integers(0, 4, 100).astype(np.uint8)
        add(f"randmate{k}", st[1] + a, st[1] + a + 300, r1=_seq(rand))
    for unit, copies, at in PLANTED:
        s0 = st[1] + at
        span = len(unit) * copies - 100
        for k, off in enumerate(range(0, span, max(span // 6, 1))):
            add(f"planted_{unit.decode()}_{off}", s0 + off,
                s0 + span + 200 + 40 * k)
    b1, b2 = synthetic_pairs(genome, n - len(names), seed=seed)
    names += b1.names
    s1 += [_read_seq(b1, i) for i in range(len(b1))]
    s2 += [_read_seq(b2, i) for i in range(len(b2))]
    exact1, exact2 = simulate_reads(
        genome, 512, read_len=100, rng=np.random.default_rng(seed + 1),
        paired=True,
    )
    names += [f"exact{i}" for i in range(512)]
    s1 += [_seq(c) for c in exact1.codes]
    s2 += [_seq(c) for c in exact2.codes]
    quals = [b"I" * 100] * len(names)
    return (batch_from_records(names, s1, quals, pad_to=100),
            batch_from_records(names, s2, quals, pad_to=100))


def cli_config(*extra):
    args = align_cli.build_parser().parse_args(
        ["-t", "1", "-i", "x", "-r", "x", "-R", "x", "-o", "x", *extra]
    )
    return align_cli.config_from_args(args)


def assert_same_dict(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# --- _select_pe on random score tables ---------------------------------------

def score_tables(genome, rng, R, K, P):
    """A candidate-score dict for R reads x K candidates, rich in ties:
    votes descending from few values, positions from a few per read (on
    the same and on other contigs, a few hundred bases apart, SENTINEL
    where votes are 0), equal scores and equal alignments."""
    votes = -np.sort(-rng.choice([0, 2, 3, 3, 4, 5, 5, 6], (R, K)), axis=1)
    st = np.asarray(genome.starts, np.int64)
    base = st[rng.integers(0, len(genome.names), R)] + rng.integers(1000, 40_000, R)
    pool = base[:, None] + rng.choice([0, 0, 150, 300, 420, 5000], (R, 4))
    pool[:, 3] = st[rng.integers(0, len(genome.names), R)] + 2000
    pos = np.take_along_axis(pool, rng.integers(0, 4, (R, K)), 1)
    pos = np.where(votes > 0, pos, int(SEN)).astype(np.uint32)
    strand = rng.integers(0, 2, (R, K)).astype(np.int32)
    indel = rng.choice([0, 0, 0, -2, 3], (R, K)).astype(np.int32)
    split = rng.choice([0, 40, 60], (R, K)).astype(np.int32)
    mism = rng.choice([0, 0, 1, 2, 3, 4, 5], (R, K)).astype(np.int32)
    match = rng.choice([0, 95, 98, 100, 100], (R, K)).astype(np.int32)
    clip_l = rng.choice([0, 0, 0, 2], (R, K)).astype(np.int32)
    clip_r = rng.choice([0, 0, 0, 3], (R, K)).astype(np.int32)
    valid = (votes >= 1) & (pos != SEN)
    score = np.where(valid, match * 100000 + (10000 - mism), -1).astype(np.int32)
    anchor = np.where(pos != SEN, pos + rng.choice([0, 0, 1], (R, K)), SEN)
    pkv = pos[:, :, None] + rng.choice([0, 0, 0, 2, 5], (R, K, P)).astype(np.uint32)
    pkv = np.where(rng.random((R, K, P)) < 0.2, SEN, pkv).astype(np.uint32)
    return dict(
        pos_k=pos, strand_k=strand, indel_k=indel, split_k=split,
        mism_k=mism, match_k=match, votes_k=votes.astype(np.int32),
        valid_k=valid, score_k=score, probe_kv_k=pkv,
        anchor_k=anchor.astype(np.uint32), clip_l_k=clip_l, clip_r_k=clip_r,
        cov_s_k=rng.integers(0, 40, (R, K)).astype(np.int32),
        cov_e_k=rng.integers(60, 100, (R, K)).astype(np.int32),
    )


def to_torch(sc):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
            for k, v in sc.items()}


def host_out(r):
    return {k: t_pipeline._host(k, v) for k, v in r.items()}


@pytest.mark.parametrize("multi_best", [1, 3])
def test_select_pe_matches_jax(genome, index, multi_best, monkeypatch):
    cfg = aligner_config(batch_reads=512, is_rna_seq=False,
                         multi_best=multi_best,
                         report_multi_mapping=multi_best > 1)
    R, K, P = 512, 8, 20
    rng = np.random.default_rng(17 + multi_best)
    sc1, sc2 = score_tables(genome, rng, R, K, P), score_tables(genome, rng, R, K, P)
    lens1 = rng.choice([100, 100, 90, 150], R).astype(np.int32)
    lens2 = rng.choice([100, 100, 120], R).astype(np.int32)
    # rows 0-15: one mate-1 candidate and two mate-2 candidates, equal in
    # every score, making fragments of 326 and 324 bases, one either side
    # of the expected TLEN (325): the TLEN preference ties them and the
    # storage order picks the one stored first
    x = np.asarray(genome.starts[0], np.int64) + 5000 + 1000 * np.arange(16)
    for sc, offs in ((sc1, (0,)), (sc2, (226, 224))):
        for key, v in (("votes_k", 0), ("pos_k", SEN), ("indel_k", 0),
                       ("split_k", 0), ("mism_k", 0), ("match_k", 100),
                       ("clip_l_k", 0), ("clip_r_k", 0)):
            sc[key][:16] = v
        for k, off in enumerate(offs):
            sc["votes_k"][:16, k] = 5
            sc["pos_k"][:16, k] = x + off
        sc["strand_k"][:16] = 0 if len(offs) == 1 else 1
        sc["valid_k"][:16] = sc["votes_k"][:16] > 0
        sc["score_k"][:16] = np.where(sc["valid_k"][:16], 100 * 100000 + 10000, -1)
        sc["anchor_k"][:16] = sc["pos_k"][:16]
    lens1[:16] = lens2[:16] = 100
    etl = (cfg.min_fragment + cfg.max_fragment) // 2
    ja = JAligner(genome, index, cfg)
    j1, j2 = ja._select_pe(
        jnp.asarray(lens1), jnp.asarray(lens2),
        {k: jnp.asarray(v) for k, v in sc1.items()},
        {k: jnp.asarray(v) for k, v in sc2.items()}, jnp.int32(etl),
    )
    j1, j2 = jax.device_get(j1), jax.device_get(j2)
    al = Aligner(genome, index, cfg, device="cpu")
    args = (torch.from_numpy(lens1), torch.from_numpy(lens2),
            to_torch(sc1), to_torch(sc2), etl)
    t1, t2 = al._select_pe(*args)
    for t, j in ((t1, j1), (t2, j2)):
        assert_same_dict(host_out(t), {k: np.asarray(v) for k, v in j.items()})
    # the tables hold every branch: paired picks, single-end fallbacks,
    # break-even pairs and reads without any combo
    paired_like = (np.asarray(j1["mapped"]) & np.asarray(j2["mapped"])).sum()
    assert 0 < paired_like < R
    assert np.asarray(j1["multi"]).any()
    assert (~np.asarray(j1["mapped"])).any()

    # top_ok gates every use of topk's indices: scrambling the indices of
    # the invalid (-1) keys, whose order among ties torch leaves open,
    # changes nothing
    topk = torch.topk
    scr = np.random.default_rng(3)

    def scrambled_topk(x, k, dim=-1):
        vals, idx = topk(x, k, dim=dim)
        noise = torch.from_numpy(scr.integers(0, x.shape[dim], tuple(idx.shape)))
        return vals, torch.where(vals < 0, noise, idx)

    monkeypatch.setattr(torch, "topk", scrambled_topk)
    s1, s2 = al._select_pe(*args)
    for a, b in ((s1, t1), (s2, t2)):
        assert_same_dict(host_out(a), host_out(b))


# --- align_batch_pe against JAX ----------------------------------------------

@pytest.mark.parametrize("case", ["full", "gap3", "multi_best", "blocks"])
def test_align_batch_pe_matches_jax(genome, index, case, monkeypatch):
    cfg = replace(cli_config(), batch_reads=512)
    idx = index
    if case == "gap3":
        idx = build_hash_index(genome, index_gap=3)
    elif case == "blocks":
        idx = split_index_blocks(index, memory_mb=1)
        assert len(idx) == 2
    elif case == "multi_best":
        cfg = replace(cli_config("-B", "3", "--multiMapping"), batch_reads=512)
    b1, b2 = pairs_for(genome, 512, seed=11)
    al = Aligner(genome, idx, cfg, device="cpu")
    assert al.rescue_fold_cap > 0
    seen = {}
    fold, host = al._rescue_fold_pe, al._rescue_saturated_pe
    dev_align = al._device_align_pe

    def fold_spy(*a):
        r1, r2 = a[6], a[7]
        seen["fold"] = seen.get("fold", 0) + int(
            (r1["saturated"] | r2["saturated"]).sum())
        return fold(*a)

    def host_spy(b1_, b2_, o1, o2):
        seen["host"] = int((o1["saturated"] | o2["saturated"]).sum())
        return host(b1_, b2_, o1, o2)

    def align_spy(*a, **k):
        if k.get("vp") is not None and k["vp"].window > 40:
            seen["escalated"] = True
        return dev_align(*a, **k)

    monkeypatch.setattr(al, "_rescue_fold_pe", fold_spy)
    monkeypatch.setattr(al, "_rescue_saturated_pe", host_spy)
    monkeypatch.setattr(al, "_device_align_pe", align_spy)
    t1, t2 = al.align_batch_pe(b1, b2)
    j1, j2 = JAligner(genome, idx, cfg).align_batch_pe(b1, b2)
    assert_same_dict(t1, j1)
    assert_same_dict(t2, j2)
    assert seen["fold"] > 0        # pairs saturated in the main pass
    assert "probe_kv" in t1 and "probe_kv" in t2
    mapped = (t1["mapped"].mean() + t2["mapped"].mean()) / 2
    if case == "blocks":
        # paired-end votes against index block 0 only, as in the JAX
        # package: about half of the genome is out of its reach
        assert 0.3 < mapped < 0.8
    else:
        assert mapped > 0.85
    if case == "full":
        assert seen["host"] > 0    # and some still after the device tiers
        assert seen.get("escalated")   # some needing a window above 40
        assert not (t1["saturated"] | t2["saturated"]).any()
        # the exact pairs' sub-batch has no flagged read: SENTINEL rows,
        # unlike the single-end collect's zero rows
        assert (t1["probe_kv"][-512:] == SEN).all()


# --- whole files and the CLI -------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(genome, index, tmp_path_factory):
    """Index on disk, the two FASTQs (names suffixed /1 and /2), and the JAX
    aligner's SAM with the config the CLI builds."""
    d = tmp_path_factory.mktemp("align_pe")
    genome.save(str(d / "idx"))
    index.save(str(d / "idx"))
    b1, b2 = pairs_for(genome, 1536, seed=21)
    write_fastq(str(d / "r1.fq"), b1, suffix="/1")
    write_fastq(str(d / "r2.fq"), b2, suffix="/2")
    JAligner(genome, index, cli_config()).align_file_pe(
        str(d / "r1.fq"), str(d / "r2.fq"), str(d / "jax.sam")
    )
    return d


def same_files(a, b):
    return filecmp.cmp(a, b, shallow=False)


def test_align_file_pe_sam_and_vcf_match_jax(genome, index, jax_run,
                                             monkeypatch):
    d = jax_run
    seen = {}
    rum = t_indelevent.rescue_unmapped_mates

    def rum_spy(g, b1, b2, r1, r2, cfg):
        m1, m2 = np.asarray(r1["mapped"], bool), np.asarray(r2["mapped"], bool)
        seen["one_end"] = seen.get("one_end", 0) + int((m1 ^ m2).sum())
        return rum(g, b1, b2, r1, r2, cfg)

    monkeypatch.setattr(t_indelevent, "rescue_unmapped_mates", rum_spy)
    Aligner(genome, index, cli_config(), device="cpu").align_file_pe(
        str(d / "r1.fq"), str(d / "r2.fq"), str(d / "torch.sam")
    )
    assert seen["one_end"] > 0     # rescue_unmapped_mates had mates to scan
    assert same_files(d / "torch.sam", d / "jax.sam")
    assert same_files(str(d / "torch.sam") + ".indel.vcf",
                      str(d / "jax.sam") + ".indel.vcf")
    with open(d / "jax.sam") as f:
        recs = [line.split("\t") for line in f if not line.startswith("@")]
    assert len(recs) == 2 * (1536 + 512)
    flags = np.array([int(r[1]) for r in recs])
    assert (flags & 0x2).sum() > 0.8 * len(recs)           # proper pairs
    assert ((flags & 0x4) == 0).sum() > 0.9 * len(recs)    # mapped
    assert sum(1 for r in recs if r[6] not in ("=", "*")) > 0  # other contig
    assert sum(1 for r in recs if "D" in r[5] or "I" in r[5]) > 20
    assert os.path.getsize(str(d / "jax.sam") + ".indel.vcf") > 300


def test_cli_pe_matches_jax(jax_run):
    d = jax_run
    proc = subprocess.run(
        [sys.executable, "-m", "subread_tpu_torch.tools.align", "-t", "1",
         "-i", str(d / "idx"), "-r", str(d / "r1.fq"), "-R", str(d / "r2.fq"),
         "-o", str(d / "cli.sam"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "Mapped:" in proc.stderr
    assert same_files(d / "cli.sam", d / "jax.sam")
    assert same_files(str(d / "cli.sam") + ".indel.vcf",
                      str(d / "jax.sam") + ".indel.vcf")


def test_bam_pe_matches_jax(genome, index, jax_run, native_mode, native_records):
    """`tools.align -r r1.fq -R r2.fq -o x.bam` writes the JAX aligner's
    BAM byte for byte, with the native library (every record packed by
    its BAM encoder) and without it."""
    from subread_tpu_torch.io.bam import BamReader

    d = jax_run
    packed = native_records
    jax_bam, port_bam = d / f"jax_{native_mode}.bam", d / f"port_{native_mode}.bam"
    JAligner(genome, index, cli_config()).align_file_pe(
        str(d / "r1.fq"), str(d / "r2.fq"), str(jax_bam))
    align_cli.main(["-t", "1", "-i", str(d / "idx"), "-r", str(d / "r1.fq"),
                    "-R", str(d / "r2.fq"), "-o", str(port_bam), "--device", "cpu"])
    assert same_files(port_bam, jax_bam)
    assert same_files(str(port_bam) + ".indel.vcf", str(jax_bam) + ".indel.vcf")
    recs = list(BamReader(str(port_bam)))
    assert len(recs) == 2 * (1536 + 512)
    assert packed[0] == (len(recs) if native_mode == "native" else 0)
    assert any(r.tlen < 0 for r in recs) and any(r.flag & 4 for r in recs)
    assert any(r.next_ref_id not in (r.ref_id, -1) for r in recs)
