"""The port's native BAM record encoder (`native.format_bam_records`,
`BamWriter.add_records`) against the Python packer it stands in for
(`BamWriter.add_sam_fields` on the record's SAM fields), on random columns:
both strands, unmapped rows, odd lengths and rows shorter than the batch's
width, clips on either side, insertions, deletions, junctions with clips,
mate columns ("*", "=" and another contig, negative TLEN), HI/NH left out,
CIGARs given for rows in the middle of a chunk and skipped rows.  The
decompressed records, the flush points and the files are the same.  Then
the align pipeline's emitters on random result dicts, single-end and paired,
with the library and without: the same BAM, summary and indel events, with
mapped rows past a contig's end, host-rescue CIGARs and multi-mapping reads
among them."""

import numpy as np
import pytest

import subread_tpu_torch.native as tnative
from subread_tpu_torch import dna
from subread_tpu_torch.align.pipeline import AlignSummary, Aligner
from subread_tpu_torch.config import aligner_config
from subread_tpu_torch.io import bam
from subread_tpu_torch.io import sam as samio
from subread_tpu_torch.io.fastq import batch_from_records
from subread_tpu_torch.synth import synthetic_genome
from torch_native_fixtures import native_records  # noqa: F401  (fixtures)

pytestmark = pytest.mark.skipif(tnative.get_lib() is None,
                                reason="no C++ toolchain for the native library")

CONTIGS, LENGTHS = ["chr0", "chr1", "chr2"], [60_000, 50_000, 40_000]
FLUSH = 4096      # a small flush threshold: many flushes in a few hundred records


def cigar_text(L, ind, sp, jg, cl, cr):
    """The emitters' CIGAR from (split, indel, junc_gap, clips)."""
    s = f"{cl}S" if cl else ""
    if jg > 0:
        s += f"{sp}M{jg}N{L - cl - sp - cr}M"
    elif ind > 0:
        s += f"{sp - cl}M{ind}D{L - sp - cr}M"
    elif ind < 0:
        s += f"{sp - cl}M{-ind}I{L - sp + ind - cr}M"
    else:
        s += f"{L - cl - cr}M"
    return s + (f"{cr}S" if cr else "")


def random_columns(n, Lmax, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(40, Lmax + 1, n).astype(np.int32)
    lens[:4] = (Lmax, Lmax - 1, 41, 40)
    mapped = rng.random(n) < 0.85
    lens[7], mapped[7] = 1, False          # one base, quality "*"
    cl = np.where(rng.random(n) < 0.3, rng.integers(1, 6, n), 0)
    cr = np.where(rng.random(n) < 0.3, rng.integers(1, 6, n), 0)
    indel = np.where(rng.random(n) < 0.3, rng.integers(-3, 4, n), 0)
    junc = np.where(rng.random(n) < 0.2, rng.integers(50, 5000, n), 0)
    split = cl + rng.integers(5, 20, n)
    rnext = rng.integers(-2, 3, n)
    quals = rng.integers(33, 128, (n, Lmax)).astype(np.uint8)
    quals[7, 0] = ord("*")
    return dict(
        names=[f"read{i}" + "x" * int(rng.integers(0, 30)) for i in range(n)],
        codes=rng.integers(0, 4, (n, Lmax)).astype(np.uint8), quals=quals,
        lens=lens, mapped=mapped,
        flags=np.where(mapped, rng.choice([0, 16, 0x53, 0x93, 0xA3, 0x63], n),
                       rng.choice([4, 0x45, 0x85, 0x4D, 0x65], n)),
        cidx=rng.integers(0, 3, n), coff=rng.integers(0, 39_000, n),
        mapq=rng.integers(0, 256, n), indel=indel, split=split, junc_gap=junc,
        clip_l=cl, clip_r=cr, nm=rng.integers(0, 8, n),
        rnext=rnext, pnext=np.where(rnext == -1, 0, rng.integers(1, 40_000, n)),
        tlen=rng.integers(-800, 800, n),
        hi=rng.integers(1, 4, n), nh=rng.integers(0, 4, n),
    )


def sam_fields(c, i, cigar=None):
    """Row i as the emitters' SAM fields."""
    L = int(c["lens"][i])
    ok, rev = bool(c["mapped"][i]), bool(c["mapped"][i] and c["flags"][i] & 16)
    codes, qual = c["codes"][i, :L], c["quals"][i, :L].tobytes().decode()
    seq = dna.decode(dna.revcomp(codes) if rev else codes)
    qual = qual[::-1] if rev else qual
    rn = int(c["rnext"][i])
    tags = [f"HI:i:{c['hi'][i]}", f"NH:i:{c['nh'][i]}"] if c["nh"][i] > 0 else []
    if not ok:
        head = ["*", "0", "0", "*"]
    else:
        head = [CONTIGS[c["cidx"][i]], str(c["coff"][i] + 1), str(c["mapq"][i]),
                cigar or cigar_text(L, *(int(c[k][i]) for k in (
                    "indel", "split", "junc_gap", "clip_l", "clip_r")))]
        tags.append(f"NM:i:{c['nm'][i]}")
    return [c["names"][i], str(c["flags"][i]), *head,
            "*" if rn == -1 else "=" if rn == -2 else CONTIGS[rn],
            str(c["pnext"][i]), str(c["tlen"][i]), seq, qual, *tags]


def encoded(c, rows, skip, cigars):
    """The native encoder's (records, ends) for rows of c."""
    mapped = c["mapped"][rows]
    ref_id = np.where(mapped, c["cidx"][rows], -1)
    rn = c["rnext"][rows]
    cols = {k: v[rows] for k, v in c.items() if k != "names"}
    return tnative.format_bam_records(
        [c["names"][i] for i in rows], cols["codes"], cols["quals"], cols["lens"],
        cols["flags"], ref_id, np.where(mapped, cols["coff"], -1),
        np.where(mapped, cols["mapq"], 0),
        np.where(rn == -2, ref_id, np.where(rn == -1, -1, rn)), cols["pnext"] - 1,
        cols["tlen"], mapped, cols["indel"], cols["split"], cols["junc_gap"],
        cols["clip_l"], cols["clip_r"], cols["nm"], cols["hi"], cols["nh"],
        skip=skip[rows],
        cigars={j: bam.cigar_ops(cigars[i]) for j, i in enumerate(rows)
                if i in cigars},
    )


def test_encoder_matches_add_sam_fields(tmp_path, monkeypatch):
    n, Lmax = 600, 101
    c = random_columns(n, Lmax, seed=7)
    rng = np.random.default_rng(8)
    skip = rng.random(n) < 0.05
    cigars = {int(i): f"3S{20 + k}M2I10M1D{int(c['lens'][i]) - 35 - k}M100N0M"
              for k, i in enumerate(rng.choice(np.flatnonzero(c["mapped"][100:500]), 12,
                                               replace=False) + 100)}
    flushes = {}
    flush = bam.BamWriter._flush

    def spy(self):
        flushes.setdefault(self._f.name, []).append(len(self._buf))
        flush(self)

    monkeypatch.setattr(bam.BamWriter, "FLUSH_BYTES", FLUSH)
    monkeypatch.setattr(bam.BamWriter, "_flush", spy)
    py, nat = str(tmp_path / "python.bam"), str(tmp_path / "native.bam")
    w = bam.BamWriter(py, CONTIGS, LENGTHS, header_text="@HD\tVN:1.0\n")
    for i in np.flatnonzero(~skip):
        w.add_sam_fields(sam_fields(c, i, cigars.get(i)))
    w.close()
    w = bam.BamWriter(nat, CONTIGS, LENGTHS, header_text="@HD\tVN:1.0\n")
    # three chunks, the middle one holding every given CIGAR
    for rows in (np.arange(0, 100), np.arange(100, 500), np.arange(500, n)):
        records, ends = encoded(c, rows, skip, cigars)
        assert len(ends) == (~skip[rows]).sum() and ends[-1] == len(records)
        w.add_records(records, ends)
    w.close()

    assert bam.bgzf_decompress(nat) == bam.bgzf_decompress(py)
    assert len(flushes[py]) > 20 and flushes[nat] == flushes[py]
    assert open(nat, "rb").read() == open(py, "rb").read()
    recs = list(bam.BamReader(nat))
    assert len(recs) == (~skip).sum()
    assert sum(r.cigar_str in cigars.values() for r in recs) == 12
    assert {r.next_ref_id - r.ref_id for r in recs if r.ref_id >= 0} > {0, 1}
    assert min(r.tlen for r in recs) < 0 and any("HI" not in r.tags for r in recs)
    assert {len(r.seq) % 2 for r in recs} == {0, 1} and recs[7 - skip[:7].sum()].qual == b"\xff"


def test_encoder_refuses_what_the_python_packer_refuses():
    c = random_columns(20, 60, seed=9)
    skip = np.zeros(20, bool)
    assert encoded(c, np.arange(20), skip, {}) is not None
    c["quals"][3, 0] = 20                    # below "!"
    c["lens"][3] = 60
    assert encoded(c, np.arange(20), skip, {}) is None
    c = random_columns(20, 60, seed=9)
    c["mapped"][5], c["junc_gap"][5], c["split"][5] = True, 100, 70   # a negative M
    assert encoded(c, np.arange(20), skip, {}) is None
    c = random_columns(20, 60, seed=9)
    c["names"][4] += "\0x"                   # add_sam_fields keeps the NUL
    assert encoded(c, np.arange(20), skip, {}) is None
    c = random_columns(20, 60, seed=9)
    c["quals"] = c["quals"][:, :50]
    with pytest.raises(ValueError):
        encoded(c, np.arange(20), skip, {})


# --- the emitters: native against Python on random result dicts --------------

@pytest.fixture(scope="module")
def genome():
    return synthetic_genome(30_000, seed=3, n_contigs=3)


def random_result(g, n, L, seed):
    """A batch of n reads and a result dict the emitters take: mapped and
    unmapped reads, reads past a contig's end, multi-mapping reads,
    indels, junctions with clips and host-rescue CIGARs mid-chunk."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(L - 30, L + 1, n)
    seqs = [dna.decode(rng.integers(0, 4, k)).encode() for k in lens]
    quals = [bytes(rng.integers(35, 75, k).astype(np.uint8)) for k in lens]
    batch = batch_from_records([f"r{seed}_{i}" for i in range(n)], seqs, quals,
                               pad_to=L)
    ci = rng.integers(0, len(g.names), n)
    off = rng.integers(0, np.asarray(g.lengths)[ci] - L)
    pos = g.starts[ci] + off
    past = rng.random(n) < 0.05
    pos[past] = g.starts[ci[past]] + g.lengths[ci[past]] + 2
    cl = np.where(rng.random(n) < 0.3, rng.integers(1, 6, n), 0)
    cr = np.where(rng.random(n) < 0.3, rng.integers(1, 6, n), 0)
    junc = rng.random(n) < 0.15
    res = dict(
        pos=pos.astype(np.uint32), mapped=rng.random(n) < 0.9,
        strand=rng.integers(0, 2, n).astype(np.int8),
        mism=rng.integers(0, 4, n).astype(np.int16),
        mapq=rng.integers(1, 61, n).astype(np.int32),
        multi=rng.random(n) < 0.05,
        indel=np.where(rng.random(n) < 0.25, rng.integers(-3, 4, n), 0).astype(np.int32),
        split=(cl + rng.integers(10, 30, n)).astype(np.int32),
        clip_l=cl.astype(np.int16), clip_r=cr.astype(np.int16),
        junc=junc, junc_gap=np.where(junc, rng.integers(60, 900, n), 0).astype(np.int32),
    )
    mid = rng.choice(np.arange(n // 4, 3 * n // 4), 8, replace=False)
    res["cigar_override"] = {
        int(i): (f"{k + 10}M1I{int(lens[i]) - k - 21}M10N10M", 1, 3)
        for k, i in enumerate(mid)}
    res["_events_done"] = set(int(i) for i in rng.choice(n, 10, replace=False))
    return batch, res


def emit(g, cfg, mode, fmt_path, chunks):
    """Emit chunks through a BAM writer; the summary and indel events."""
    al = Aligner.__new__(Aligner)
    al.genome, al.cfg = g, cfg
    summary, events = AlignSummary(), {}
    w = samio.make_writer(fmt_path, g.names, [int(x) for x in g.lengths],
                          sam_output=False)
    for chunk in chunks:
        if mode == "se":
            al._emit_sam(w, *chunk, summary, indel_events=events)
        else:
            al._emit_sam_pe(w, *chunk, summary, indel_events=events)
    w.close()
    return summary, events


@pytest.mark.parametrize("mode", ["se", "pe"])
@pytest.mark.parametrize("opts", [{}, {"ignore_unmapped": True},
                                  {"report_multi_mapping": True}])
def test_emitters_native_matches_python(genome, tmp_path, monkeypatch, native_records,
                                        mode, opts):
    monkeypatch.setattr(bam.BamWriter, "FLUSH_BYTES", FLUSH)
    cfg = aligner_config(**opts)
    chunks = []
    for k in range(3):
        if mode == "se":
            chunks.append(random_result(genome, 300, 100, seed=20 + k))
        else:
            (b1, r1), (b2, r2) = (random_result(genome, 150, 100, seed=40 + 2 * k + m)
                                  for m in (0, 1))
            chunks.append((b1, b2, r1, r2))
    if mode == "pe":
        # two ends with the same insertion and other bases, in pairs 0 and
        # 1: the event keeps the bases of the first in output order
        b1, b2, r1, r2 = chunks[0]
        for r, i in ((r2, 0), (r1, 1)):
            r["pos"][i], r["strand"][i], r["split"][i] = genome.starts[0] + 500, 0, 20
            r["indel"][i], r["mapped"][i], r["multi"][i] = -2, True, False
            r["clip_l"][i] = r["junc"][i] = 0
            r["_events_done"].discard(i)
            r["cigar_override"].pop(i, None)
        assert (b2.codes[0, 20:22] != b1.codes[1, 20:22]).any()
    got = {}
    for side in ("native", "python"):
        if side == "python":
            monkeypatch.setattr(tnative, "_LIB", None)
            monkeypatch.setattr(tnative, "_TRIED", True)
        path = str(tmp_path / f"{side}.bam")
        got[side] = (*emit(genome, cfg, mode, path, chunks), open(path, "rb").read())
        if side == "native":
            assert native_records[0] == len(list(bam.BamReader(path))) > 600
    assert got["native"] == got["python"]
    summary, events, _ = got["native"]
    assert summary.total == 900 and summary.unmapped > 45 and summary.indels > 50
    assert len(events) > 30
