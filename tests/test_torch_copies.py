"""The port's copies of the JAX package's host modules against their
originals, on the same seeded inputs: FASTA and genome, the hash index
(full, gapped, split into blocks), index files written by either package
and read by the other, read sources, the read simulator, SAM text and the
native host library (through it and through its pure-Python fallback),
read packing, the indel DP and the command-line options; featureCounts'
host engine (native and pure Python, SAM and BAM, single-end and paired)
and its native wrappers; cellCounts' barcode matcher, UMI merge and cell
calling; sublong's banded alignment and chaining; exactSNP's pileup
(native `snppile.cpp` through `snp_pileup_bam`, and the Python record
path) and calls, and the host tools' helpers and assembler."""

import dataclasses
import gzip

import numpy as np
import pytest

import subread_tpu.native as jnative
from subread_tpu import dna as jdna
from subread_tpu.align import longread as jlong
from subread_tpu.align import indelevent as jindel
from subread_tpu.index import build as jbuild
from subread_tpu.index import genome as jgenome
from subread_tpu.index import interop as jinterop
from subread_tpu.io import fasta as jfasta
from subread_tpu.io import fastq as jfastq
from subread_tpu.io import gtf as jgtf
from subread_tpu.io import sam as jsam
from subread_tpu.quant import cellcounts as jcc
from subread_tpu.quant import featurecounts as jfc
from subread_tpu.tools import align as jalign
from subread_tpu.tools import buildindex as jbuildindex
from subread_tpu.utils import simulate as jsim
import subread_tpu_torch.native as tnative
from subread_tpu_torch import dna as tdna
from subread_tpu_torch.align import longread as tlong
from subread_tpu_torch.align import indelevent as tindel
from subread_tpu_torch.index import build as tbuild
from subread_tpu_torch.index import genome as tgenome
from subread_tpu_torch.index import interop as tinterop
from subread_tpu_torch.io import fasta as tfasta
from subread_tpu_torch.io import fastq as tfastq
from subread_tpu_torch.io import gtf as tgtf
from subread_tpu_torch.io import sam as tsam
from subread_tpu_torch.quant import cellcounts as tcc
from subread_tpu_torch.quant import featurecounts as tfc
from subread_tpu_torch.tools import align as talign
from subread_tpu_torch.tools import buildindex as tbuildindex
from subread_tpu_torch.tools import subjunc as tsubjunc
from subread_tpu_torch.utils import simulate as tsim
from torch_native_fixtures import native_mode  # noqa: F401  (fixtures)

# each package as one namespace, so a test can run either side
JAX = dict(native=jnative, dna=jdna, indel=jindel, build=jbuild,
           genome=jgenome, interop=jinterop, fasta=jfasta, fastq=jfastq,
           sam=jsam, align=jalign, buildindex=jbuildindex, sim=jsim,
           gtf=jgtf, fc=jfc, cc=jcc, long=jlong)
PORT = dict(native=tnative, dna=tdna, indel=tindel, build=tbuild,
            genome=tgenome, interop=tinterop, fasta=tfasta, fastq=tfastq,
            sam=tsam, align=talign, buildindex=tbuildindex, sim=tsim,
            gtf=tgtf, fc=tfc, cc=tcc, long=tlong)
SIDES = {"jax": JAX, "port": PORT}
BASES = np.frombuffer(b"ACGT", np.uint8)


def assert_same(a, b, what=""):
    """Equal values, recursing through dataclasses, tuples, lists and
    dicts; numpy arrays equal in dtype and content."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert a == b, f"{what}: {a!r} != {b!r}"


def assert_same_index(a, b):
    """Every stored array of two HashIndexes plus the derived device
    layout (comb rows, sub-bucket directory)."""
    assert_same(a, b, "index")
    assert_same(a.comb_rows, b.comb_rows, "comb_rows")
    assert_same(a.sub_dir, b.sub_dir, "sub_dir")


def write_fasta(path, sizes, seed=41):
    """A FASTA of random contigs with N runs, lower-case stretches, IUPAC
    letters and a tandem array (so the index has big buckets)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for c, n in enumerate(sizes):
            s = bytearray(rng.choice(BASES, size=n).tobytes())
            s[500:540] = b"N" * 40
            s[900:1300] = bytes(s[900:1300]).lower()
            s[1400:1403] = b"RYK"
            unit = rng.choice(BASES, size=13).tobytes()
            s[2000:2000 + 13 * 40] = unit * 40
            f.write(f">chr{c} contig {c}\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60].decode() + "\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    return write_fasta(tmp_path_factory.mktemp("fa") / "g.fa",
                       [40_000 + 7_000 * c for c in range(4)])


def genomes_of(path):
    return {side: m["genome"].build_genome(m["fasta"].read_fasta(path))
            for side, m in SIDES.items()}


@pytest.fixture(scope="module")
def genomes(fasta):
    return genomes_of(fasta)


@pytest.fixture(scope="module")
def small_genomes(tmp_path_factory):
    """Small enough for the reference format's writer, which is slow."""
    return genomes_of(write_fasta(tmp_path_factory.mktemp("fa") / "s.fa",
                                  [3000, 4000], seed=43))


def test_fasta_and_genome_equal(genomes):
    assert_same(genomes["jax"], genomes["port"], "genome")
    j, t = genomes["jax"], genomes["port"]
    for lo, hi in ((0, 100), (4990, 5050), (60_000, 60_300)):
        assert_same(j.get_ambig(lo, hi), t.get_ambig(lo, hi), "ambig")


@pytest.mark.parametrize("case", ["gap1", "gap3", "split"])
def test_build_hash_index_equal(genomes, case):
    idx = {}
    for side, m in SIDES.items():
        gap = 3 if case == "gap3" else 1
        idx[side] = m["build"].build_hash_index(genomes[side], index_gap=gap)
    if case == "split":
        blocks = {s: SIDES[s]["build"].split_index_blocks(idx[s], 1, overlap=200)
                  for s in SIDES}
        assert len(blocks["jax"]) == len(blocks["port"]) > 1
        for a, b in zip(blocks["jax"], blocks["port"]):
            assert_same_index(a, b)
    else:
        assert idx["jax"].max_run >= 16
        assert_same_index(idx["jax"], idx["port"])


@pytest.mark.parametrize("writer,layout", [
    ("jax", "one"), ("port", "one"), ("jax", "blocks"), ("port", "blocks"),
    ("jax", "reference"), ("port", "reference"),
])
def test_index_files_load_in_the_other_package(genomes, small_genomes, tmp_path,
                                              writer, layout):
    """An index and genome saved by one package load in the other, through
    load_index_any, with the arrays the writer's own loader gives."""
    w = SIDES[writer]
    reader = "port" if writer == "jax" else "jax"
    prefix = str(tmp_path / "idx")
    g = genomes[writer]
    if layout == "reference":
        g = small_genomes[writer]
        w["interop"].write_reference_index(g, prefix, index_gap=1)
    else:
        g.save(prefix)
        idx = w["build"].build_hash_index(g, index_gap=3 if layout == "one" else 1)
        if layout == "one":
            idx.save(prefix)
        else:
            for b, blk in enumerate(w["build"].split_index_blocks(idx, 1, overlap=200)):
                blk.save(f"{prefix}.{b:02d}")
    g_w, i_w = w["align"].load_index_any(prefix)
    g_r, i_r = SIDES[reader]["align"].load_index_any(prefix)
    assert_same(g_w, g_r, "genome")
    if isinstance(i_w, list):
        assert isinstance(i_r, list) and len(i_w) == len(i_r) > 1
        for a, b in zip(i_w, i_r):
            assert_same_index(a, b)
    else:
        assert_same_index(i_w, i_r)


def test_buildindex_cli_writes_the_same_files(fasta, tmp_path):
    for side, m in SIDES.items():
        (tmp_path / side).mkdir()
        assert m["buildindex"].main(
            ["-o", str(tmp_path / side / "idx"), "-F", fasta]) == 0
    assert ((tmp_path / "jax" / "idx.reads").read_text()
            == (tmp_path / "port" / "idx.reads").read_text())
    j = jalign.load_index_any(str(tmp_path / "jax" / "idx"))
    t = talign.load_index_any(str(tmp_path / "port" / "idx"))
    assert_same(j[0], t[0], "genome")
    assert_same_index(j[1], t[1])


@pytest.fixture(scope="module")
def read_files(genomes, tmp_path_factory):
    """The same simulated reads as FASTQ, gzip FASTQ, FASTA and SAM."""
    d = tmp_path_factory.mktemp("reads")
    r1, _ = jsim.simulate_reads(genomes["jax"], 300, rng=np.random.default_rng(3),
                                error_rate=0.02, indel_rate=0.05)
    seqs = [jdna.decode(r1.codes[i, :r1.lengths[i]]) for i in range(len(r1))]
    seqs = [s[:40] + "N" + s[41:] if i % 7 == 0 else s for i, s in enumerate(seqs)]
    quals = ["".join(chr(33 + (i + j) % 40) for j in range(len(s)))
             for i, s in enumerate(seqs)]
    fq = "".join(f"@{n} extra\n{s}\n+\n{q}\n" for n, s, q in zip(r1.names, seqs, quals))
    (d / "r.fq").write_text(fq)
    with gzip.open(d / "r.fq.gz", "wt") as f:
        f.write(fq)
    (d / "r.fa").write_text("".join(f">{n}\n{s}\n" for n, s in zip(r1.names, seqs)))
    sam = "@HD\tVN:1.0\n" + "".join(
        f"{n}\t{16 if i % 3 == 0 else 0}\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}\n"
        for i, (n, s, q) in enumerate(zip(r1.names, seqs, quals)))
    (d / "r.sam").write_text(sam)
    return d


def _batches(reader, n=64):
    out = []
    while (b := reader.next_batch(n)) is not None:
        out.append(b)
    return out


@pytest.mark.parametrize("name,trim", [
    ("r.fq", False), ("r.fq.gz", False), ("r.fa", False), ("r.sam", False),
    ("r.fq", True),
])
def test_read_sources_equal(read_files, name, trim):
    got = {}
    for side, m in SIDES.items():
        tf = m["fastq"].make_trim_transform(3, 5, False) if trim else None
        got[side] = _batches(m["fastq"].open_read_source(
            str(read_files / name), transform=tf))
    assert len(got["jax"]) == 5
    assert_same(got["jax"], got["port"], name)
    if name == "r.fq" and not trim:
        direct = _batches(tfastq.FastqReader(str(read_files / name)))
        assert_same(got["jax"], direct, "FastqReader")


@pytest.mark.parametrize("paired", [False, True])
def test_simulate_reads_equal(genomes, paired):
    got = {side: m["sim"].simulate_reads(
        genomes[side], 200, rng=np.random.default_rng(9), error_rate=0.01,
        indel_rate=0.05, paired=paired) for side, m in SIDES.items()}
    assert_same(got["jax"], got["port"], "reads")
    assert (got["port"][1] is not None) == paired


def _sam_inputs(n=50, L=100):
    rng = np.random.default_rng(17)
    lens = rng.integers(60, L + 1, size=n).astype(np.int32)
    return dict(
        names=[f"read{i}_x" for i in range(n)],
        codes=rng.integers(0, 4, size=(n, L)).astype(np.uint8),
        quals=rng.integers(35, 74, size=(n, L)).astype(np.uint8),
        lens=lens, flags=rng.choice([0, 16, 4, 256], size=n).astype(np.int32),
        cidx=rng.integers(0, 3, size=n).astype(np.int32),
        pos1=rng.integers(1, 50_000, size=n).astype(np.int32),
        mapqs=rng.integers(0, 61, size=n).astype(np.int32),
        indel=rng.integers(-3, 4, size=n).astype(np.int32),
        split=rng.integers(10, 50, size=n).astype(np.int32),
        junc_gap=np.where(rng.random(n) < 0.2, rng.integers(60, 900, size=n), 0).astype(np.int32),
        clip_l=rng.integers(0, 6, size=n).astype(np.int32),
        clip_r=rng.integers(0, 6, size=n).astype(np.int32),
        mapped=(rng.random(n) < 0.9), nm=rng.integers(0, 5, size=n).astype(np.int32),
        contig_names=["chr0", "chr1", "chr2"],
        suppress=(rng.random(n) < 0.1),
        rnext_cidx=rng.integers(-2, 3, size=n).astype(np.int32),
        pnext=rng.integers(0, 50_000, size=n).astype(np.int32),
        tlen=rng.integers(-500, 500, size=n).astype(np.int32),
        hi=rng.integers(0, 3, size=n).astype(np.int32),
        nh=rng.integers(0, 3, size=n).astype(np.int32),
    )


def test_sam_text_equal(native_mode, tmp_path):
    """SamWriter output and the native formatter's bytes, both packages."""
    kw = _sam_inputs()
    se = {k: v for k, v in kw.items()
          if k not in ("rnext_cidx", "pnext", "tlen", "hi", "nh")}
    texts = {}
    for side, m in SIDES.items():
        blobs = (m["native"].format_sam_records(**kw),
                 m["native"].format_sam_records(**se))
        if native_mode == "native":
            assert all(b is not None and len(b) > 0 for b in blobs)
        else:
            assert blobs == (None, None)
        path = tmp_path / f"{side}.sam"
        with m["sam"].make_writer(str(path), ["chr0", "chr1"], [1000, 2000],
                                  sam_output=True, rg_id="g1",
                                  rg_extra=["SM:x"]) as w:
            for i in range(20):
                w.write(m["sam"].SamRecord(
                    f"r{i}", 16 * (i % 2), "chr0", i + 1, 60, "10M2I88M",
                    seq=jdna.decode(kw["codes"][i]), qual="I" * 100,
                    tags=[f"NM:i:{i % 4}"]))
            if blobs[0] is not None:
                w.write_bytes(blobs[0])
        texts[side] = (blobs, path.read_bytes())
    assert texts["jax"] == texts["port"]


def test_bam_written_and_read_back_equal(tmp_path, native_mode):
    """A BAM from each package's writer: the same bytes, read back the
    same by either package's BAM read source."""
    kw = _sam_inputs(40)
    for side, m in SIDES.items():
        with m["sam"].make_writer(str(tmp_path / f"{side}.bam"), ["chr0", "chr1"],
                                  [60_000, 60_000], sam_output=False) as w:
            for i in range(40):
                L = int(kw["lens"][i])
                w.write(m["sam"].SamRecord(
                    f"r{i}", 4 if i % 5 == 0 else 16 * (i % 2),
                    "*" if i % 5 == 0 else "chr1", 0 if i % 5 == 0 else 100 + i,
                    0 if i % 5 == 0 else 60, "*" if i % 5 == 0 else f"{L}M",
                    seq=jdna.decode(kw["codes"][i, :L]), qual="I" * L))
    assert (tmp_path / "jax.bam").read_bytes() == (tmp_path / "port.bam").read_bytes()
    got = {side: _batches(m["fastq"].open_read_source(str(tmp_path / "jax.bam")))
           for side, m in SIDES.items()}
    assert sum(len(b) for b in got["jax"]) == 40
    assert_same(got["jax"], got["port"], "bam reads")


def test_pack_reads_host_equal(native_mode):
    rng = np.random.default_rng(5)
    for L in (100, 150, 250):
        codes = rng.integers(0, 4, size=(300, L)).astype(np.uint8)
        for ambig in (np.zeros((300, L), bool), rng.random((300, L)) < 0.01):
            assert_same(jdna.pack_reads_host(codes, ambig),
                        tdna.pack_reads_host(codes, ambig), f"pack L={L}")


def _dp_jobs(n=60):
    rng = np.random.default_rng(23)
    jobs, metas = [], []
    for k in range(n):
        g = rng.integers(0, 4, size=int(rng.integers(30, 70))).astype(np.uint8)
        r = g[3: 3 + int(rng.integers(20, 40))].copy()
        if k % 3 == 0:          # a deletion
            r = np.concatenate([r[:8], r[8 + int(rng.integers(1, 4)):]])
        elif k % 3 == 1:        # an insertion
            r = np.concatenate([r[:9], rng.integers(0, 4, size=2).astype(np.uint8), r[9:]])
        r[int(rng.integers(0, len(r)))] ^= np.uint8(k % 2)
        jobs.append((r, g, int(rng.integers(-3, 4))))
        metas.append((int(rng.integers(0, 10_000)), int(rng.integers(0, 50))))
    return jobs, metas


def test_dp_align_and_events_batches_equal(native_mode):
    jobs, metas = _dp_jobs()
    for max_indel in (5, 16):
        a = jindel.dp_align_jobs(jobs, max_indel)
        b = tindel.dp_align_jobs(jobs, max_indel)
        assert a == b and any(m is not None for m in a)
        a = jindel.dp_events_jobs(jobs, metas, max_indel)
        b = tindel.dp_events_jobs(jobs, metas, max_indel)
        assert a == b and any(e for e in a if e)


ARGVS = [
    ["-i", "idx", "-r", "r.fq", "-o", "o.sam"],
    ["-i", "idx", "-r", "r1.fq", "-R", "r2.fq", "-o", "o.bam", "-t", "1",
     "-I", "20", "-M", "5", "-B", "3", "--multiMapping", "-d", "80", "-D",
     "700", "-S", "rf", "-P", "6", "-J", "--SAMoutput", "--rg-id", "g",
     "--rg", "SM:a", "--rg", "PL:b", "-5", "2", "-3", "4", "--sv", "-a",
     "genes.gtf", "-F", "SAF", "-A", "alias.csv", "--gtfFeature", "gene",
     "--maxVoteSimples", "7", "--fast", "-n", "12", "-m", "2", "-p", "1"],
]


@pytest.mark.parametrize("argv", ARGVS + [["--bad-option"]],
                         ids=["minimal", "many", "refused"])
@pytest.mark.parametrize("subjunc", [False, True])
def test_build_parser_same_namespace(argv, subjunc):
    if subjunc and "-t" in argv:
        argv = [a for i, a in enumerate(argv)
                if a != "-t" and (i == 0 or argv[i - 1] != "-t")]
    j = jalign.build_parser(subjunc=subjunc)
    t = talign.option_parser(subjunc=subjunc)
    if argv == ["--bad-option"]:
        for p in (j, t):
            with pytest.raises(SystemExit):
                p.parse_args(argv)
        return
    assert vars(j.parse_args(argv)) == vars(t.parse_args(argv))
    # the port's CLIs add --device (default cuda) and nothing else to it
    full = (tsubjunc if subjunc else talign).build_parser().parse_args(argv)
    extra = {k: v for k, v in vars(full).items() if k not in vars(j.parse_args(argv))}
    assert extra.get("device") == "cuda"


@pytest.fixture(scope="module")
def fc_inputs(tmp_path_factory):
    """test_torch_device_count's random GTF and SAMs, and each SAM as BAM."""
    from test_torch_device_count import write_gtf, write_sam

    d = tmp_path_factory.mktemp("fc")
    rng = np.random.default_rng(31)
    out = dict(gtf=write_gtf(d / "g.gtf", rng), se=write_sam(d / "se.sam", rng, n=1500),
               pe=write_sam(d / "pe.sam", rng, n=800, paired=True))
    for kind in ("se", "pe"):
        lines = [ln.rstrip("\n").split("\t") for ln in open(out[kind])]
        sq = [f for f in lines if f[0] == "@SQ"]
        with tsam.make_writer(str(d / f"{kind}.bam"), [f[1][3:] for f in sq],
                              [int(f[2][3:]) for f in sq], sam_output=False) as w:
            for f in lines:
                if f[0].startswith("@"):
                    continue
                w.write(tsam.SamRecord(f[0], int(f[1]), f[2], int(f[3]), int(f[4]), f[5],
                                       f[6], int(f[7]), int(f[8]), "A" * 75 if f[5] != "*" else "*",
                                       "I" * 75 if f[5] != "*" else "*", f[11:]))
        out[kind + "-bam"] = str(d / f"{kind}.bam")
    return out


FC_OPTS = {
    "default": {},
    "stranded-mapq": dict(strand=1, min_mapq=10, primary_only=True),
    "python-only": dict(strand=2, allow_multi_overlap=True, count_multi=True,
                        fraction=True, min_overlap=5),
}


@pytest.mark.parametrize("opts", list(FC_OPTS))
@pytest.mark.parametrize("kind", ["se", "pe", "se-bam", "pe-bam"])
def test_feature_counter_equal(fc_inputs, native_mode, kind, opts):
    """FeatureCounter's counts and summary, through the native passes and
    through the pure-Python engine."""
    paired = kind.startswith("pe")
    got = {}
    for side, m in SIDES.items():
        fc = m["fc"].FeatureCounter(
            m["gtf"].load_annotation(fc_inputs["gtf"]),
            m["fc"].FCOptions(paired=paired, count_read_pairs=paired, **FC_OPTS[opts]))
        fc.count_file(fc_inputs[kind])
        got[side] = (fc.counts, dict(fc.summary))
    assert_same(got["jax"], got["port"], kind)
    assert got["port"][0].sum() > 0


def test_fc_native_wrappers_equal(fc_inputs, native_mode):
    """Each fc_* wrapper on the arguments FeatureCounter and DeviceCounter
    give it (recorded from the JAX package's engine), in both packages."""
    calls = []

    def recording(name, fn):
        def wrapper(*a, **kw):
            calls.append((name, a, kw))
            return fn(*a, **kw)
        return wrapper

    import subread_tpu.quant.device_count as jdc
    names = ["fc_count_sam_simple", "fc_count_bam_simple", "fc_count_sam_pe",
             "fc_count_bam_pe", "fc_read_sections_sam", "fc_read_sections_bam"]
    saved = {n: getattr(jnative, n) for n in names}
    try:
        for n in names:
            setattr(jnative, n, recording(n, saved[n]))
        for kind in ("se", "pe", "se-bam", "pe-bam"):
            paired = kind.startswith("pe")
            kind_file = fc_inputs[kind]
            ann = jgtf.load_annotation(fc_inputs["gtf"])
            jfc.FeatureCounter(ann, jfc.FCOptions(
                paired=paired, count_read_pairs=paired)).count_file(fc_inputs[kind])
            if native_mode == "native" or kind_file.endswith(".sam"):
                # without the library, DeviceCounter parses SAM text only
                dc = jdc.DeviceCounter(ann)
                (dc.fragments_from_file if paired else dc.sections_from_file)(fc_inputs[kind])
    finally:
        for n in names:
            setattr(jnative, n, saved[n])
    if native_mode == "native":
        assert {c[0] for c in calls} == set(names)
    for name, a, kw in calls:
        assert_same(getattr(jnative, name)(*a, **kw), getattr(tnative, name)(*a, **kw), name)
    from subread_tpu_torch.io.bam import BamReader
    rd = BamReader(fc_inputs["se-bam"])
    cuts = [m["native"].fc_bam_split_offsets(rd._data, rd._off, 3) for m in SIDES.values()]
    assert cuts[0] == cuts[1]
    assert (cuts[1] is None) == (native_mode == "fallback")


def test_barcode_matcher_umi_merge_and_cell_calling_equal():
    rng = np.random.default_rng(37)
    wl = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(300)]
    queries = [wl[int(i)] for i in rng.integers(0, 300, 400)]
    queries = [q[:j] + "ACGT"[(("ACGT".index(q[j])) + 1) % 4] + q[j + 1:]
               if k % 3 == 0 else q
               for k, (q, j) in enumerate(zip(queries, rng.integers(0, 16, 400)))]
    queries += ["".join(rng.choice(list("ACGT"), 16)) for _ in range(50)]
    got = {side: [m["cc"].BarcodeMatcher(wl).match(q) for q in queries]
           for side, m in SIDES.items()}
    assert got["jax"] == got["port"] and min(got["port"]) == -1
    codes = np.asarray([[jdna.encode(q)[i] for i in range(16)] for q in queries], np.uint8)
    assert_same(jcc.BatchBarcodeMatcher(wl).match_batch(codes),
                tcc.BatchBarcodeMatcher(wl).match_batch(codes), "match_batch")
    umis = {"".join(rng.choice(list("ACGT"), 10)): int(rng.integers(1, 9)) for _ in range(200)}
    base = list(umis)[:20]
    for u in base:      # hamming-1 neighbours to merge
        umis[u[:-1] + ("A" if u[-1] != "A" else "C")] = 1
    assert jcc.hamming1_umi_merge(dict(umis)) == tcc.hamming1_umi_merge(dict(umis))
    cells = {i: int(10_000 + rng.integers(0, 2000)) for i in range(50)}
    cells.update({i: int(rng.integers(10, 70)) for i in range(50, 950)})
    cells.update({950: 600, 951: 520})
    for cut in (None, 500):
        assert_same(jcc.call_cells(dict(cells), cut), tcc.call_cells(dict(cells), cut), "call")


def test_banded_align_and_chain_read_equal(genomes):
    g = genomes["jax"].codes
    rng = np.random.default_rng(41)
    for k in range(30):
        a = int(rng.integers(0, len(g) - 500))
        gen = g[a: a + int(rng.integers(50, 400))]
        read = np.delete(gen, rng.integers(0, len(gen), int(rng.integers(0, 6))))
        read = np.insert(read, rng.integers(0, len(read), int(rng.integers(0, 6))), 2)
        assert jlong.banded_align(read, gen) == tlong.banded_align(read, gen)
        assert (jlong.banded_align(read, gen, extra_band=40)
                == tlong.banded_align(read, gen, extra_band=40))
    # chain_read over a hand-made window result: two strands, a chain with
    # a 300-base gap, a decoy window and an unmapped one
    n = 40
    wins = np.arange(n)
    st = (rng.random(n) < 0.15).astype(np.int8)
    pos = np.where(wins < 20, 10_000 + 100 * wins, 10_300 + 100 * wins)
    pos = np.where(st == 1, 90_000 - 100 * wins, pos).astype(np.uint32)
    res = dict(mapped=rng.random(n) < 0.95, pos=pos, strand=st,
               votes=rng.integers(2, 10, n).astype(np.int16),
               clip_l=rng.integers(0, 3, n).astype(np.int16))
    L = n * 100 + 37
    codes = rng.integers(0, 4, L).astype(np.uint8)
    for kw in ({}, dict(codes=codes, gcodes=g)):
        hit = {side: m["long"].chain_read(res, np.arange(n), wins, L, 2, **kw)
               for side, m in SIDES.items()}
        assert hit["jax"].__dict__ == hit["port"].__dict__
        assert hit["port"].mapped and hit["port"].n_windows >= 20


@pytest.mark.parametrize("argv", [
    ["-a", "g.gtf", "-o", "c.txt", "in.sam"],
    ["-a", "g.saf", "-F", "SAF", "-o", "c.txt", "-p", "--countReadPairs", "-B", "-C",
     "-P", "-d", "40", "-D", "900", "-M", "--primary", "-Q", "7", "-s", "1,2", "-f",
     "-O", "--minOverlap", "3", "--fracOverlap", "0.2", "--largestOverlap",
     "--read2pos", "5", "--readExtension5", "4", "--readExtension3", "2",
     "--ignoreDup", "--fraction", "--maxMOp", "12", "--splitOnly", "-J", "-G", "g.fa",
     "-T", "4", "--extraAttributes", "gene_name", "--byReadGroup", "-R", "CORE",
     "--Rpath", "d", "--deviceCounts", "--scSampleSheet", "s.csv", "--scCellBarcodeFile",
     "b.txt", "a.sam", "b.bam"],
], ids=["minimal", "many"])
def test_featurecounts_parser_same_namespace(argv):
    from subread_tpu.tools import featurecounts as jfcli
    from subread_tpu_torch.tools import featurecounts as tfcli

    j = vars(jfcli.build_parser().parse_args(argv))
    t = vars(tfcli.build_parser().parse_args(argv))
    assert t.pop("device") == "cuda" and j == t


def _snp_bam(fasta, path, n=400, seed=51):
    """Reads from the FASTA's first contig with substitutions, soft clips,
    short insertions and deletions, both strands, some low-quality bases,
    unmapped records and a record on a contig the FASTA lacks, as BAM."""
    rng = np.random.default_rng(seed)
    contigs = tfasta.read_fasta(fasta)
    g = contigs[0].codes
    w = tsam.make_writer(str(path), [c.name for c in contigs] + ["chrX"],
                         [len(c.codes) for c in contigs] + [5000], sam_output=False)
    for i in range(n):
        p = int(rng.integers(2000, len(g) - 200))
        kind = i % 5
        if kind == 0:
            seg, cigar = g[p:p + 100], "100M"
        elif kind == 1:
            seg, cigar = np.concatenate([g[p:p + 50], g[p + 53:p + 103]]), "50M3D50M"
        elif kind == 2:
            ins = rng.integers(0, 4, 2).astype(np.uint8)
            seg, cigar = np.concatenate([g[p:p + 40], ins, g[p + 40:p + 98]]), "40M2I58M"
        elif kind == 3:
            seg, cigar = np.concatenate([rng.integers(0, 4, 5).astype(np.uint8),
                                         g[p:p + 95]]), "5S95M"
        else:
            seg, cigar = g[p:p + 100], "100M"
        seg = seg.copy()
        err = rng.random(len(seg)) < 0.03
        seg[err] = (seg[err] + 1) % 4
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 41, len(seg)))
        flag = 16 if i % 2 else 0
        name = contigs[0].name
        if i % 37 == 0:
            w.write(tsam.SamRecord(f"u{i}", 4, "*", 0, 0, "*", "*", 0, 0,
                                   tdna.decode(seg), qual))
            continue
        if i % 41 == 0:
            name = "chrX"
        w.write(tsam.SamRecord(f"r{i}", flag, name, p + 1, 40, cigar, "*", 0, 0,
                               tdna.decode(seg), qual))
    w.close()
    return str(path)


def test_snp_pileup_and_calls_equal(fasta, tmp_path, native_mode):
    """SNPCaller.add_sam on a BAM: through snp_pileup_bam (native) or the
    Python record path (fallback); equal piles, indel tables and calls."""
    from subread_tpu.quant import snp as jsnp
    from subread_tpu_torch.quant import snp as tsnp

    bam = _snp_bam(fasta, tmp_path / "s.bam")
    callers = []
    for mod in (jsnp, tsnp):
        c = mod.SNPCaller(fasta)
        assert c._add_bam_native(bam) is (native_mode == "native")
        c = mod.SNPCaller(fasta)
        c.add_sam(bam)
        callers.append(c)
    j, t = callers
    assert j.piles.keys() == t.piles.keys()
    for name in j.piles:
        assert_same(j.piles[name].votes, t.piles[name].votes, name)
        assert j.piles[name].indels == t.piles[name].indels, name
        assert list(j.call_chrom(name)) == list(t.call_chrom(name)), name
    first = next(iter(t.piles))
    assert t.piles[first].votes.sum() > 20_000 and t.piles[first].indels


def test_host_tool_helpers_equal(fasta, tmp_path):
    """utilities' SAM/BAM record and header readers, globalReassembly's
    k-mer keys and assembler, on the same inputs."""
    from subread_tpu.tools import globalreassembly as jga
    from subread_tpu.tools import utilities as jutil
    from subread_tpu_torch.tools import globalreassembly as tga
    from subread_tpu_torch.tools import utilities as tutil

    bam = _snp_bam(fasta, tmp_path / "s.bam", n=120)
    sam = tmp_path / "s.sam"
    sam.write_text("\n".join(tutil._sam_header(bam)) + "\n" + "".join(
        "\t".join(f) + "\n" for f in tutil._sam_records(bam)))
    for path in (bam, str(sam)):
        assert list(jutil._sam_records(path)) == list(tutil._sam_records(path))
        assert jutil._sam_header(path) == tutil._sam_header(path)
    rng = np.random.default_rng(5)
    src = rng.integers(0, 4, 1500).astype(np.uint8)
    reads = [src[p:p + 100] for p in rng.permutation(range(0, 1401, 30))]
    assert_same(jga._kmer_keys(reads[0]), tga._kmer_keys(reads[0]))
    contigs = []
    for mod in (jga, tga):
        asm = mod.Assembler(reads, 2, 2)
        contigs.append([asm.assemble_from(i) for i in range(0, len(reads), 7)])
    assert_same(contigs[0], contigs[1])
    assert max(len(c) for c in contigs[1] if c is not None) > 1000

