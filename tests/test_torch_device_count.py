"""featureCounts' device counter and CLI on the port against the JAX
package, on a random GTF and SAM made here from a numpy seed (overlapping
genes on both strands, spliced, unmapped, NH>1 and secondary reads, a
chromosome absent from the annotation; paired records in arbitrary
order):

  * `DeviceCounter` sections and `count` outputs (counts, summary and
    per-read status, values and dtypes) equal JAX's, single-end and
    paired fragments, strand 0/1/2; single-end they equal the host
    `FeatureCounter`'s; paired, they differ from it as the JAX package's
    do (see `check_pe_vote_gap`);
  * an empty span table, and sections whose span ranges hold 1, 2**k - 1,
    2**k and 2**k + 1 spans (the RMQ's level edges);
  * `device.floor_log2` against JAX's `31 - lax.clz` for every n up to
    2**20 and across [2**20, 2**31);
  * the featureCounts CLI's count and summary files byte-equal to the JAX
    CLI's, with and without --deviceCounts, and an option outside the
    device subset going to the host engine.

Every output is an integer or a file: the tolerance is 0."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu.io.gtf import load_annotation as jload
from subread_tpu.quant import device_count as jdc
from subread_tpu.quant.featurecounts import FCOptions as JFCOptions
from subread_tpu.quant.featurecounts import FeatureCounter as JFeatureCounter
from subread_tpu.tools import featurecounts as jcli
from subread_tpu_torch.device import floor_log2
from subread_tpu_torch.io.gtf import load_annotation
from subread_tpu_torch.quant import device_count as tdc
from subread_tpu_torch.quant.featurecounts import FCOptions, FeatureCounter
from subread_tpu_torch.tools import featurecounts as tcli

torch.set_num_threads(1)


def write_gtf(path, rng, n_genes=40, chroms=3, span=50_000):
    """Random multi-exon genes on both strands, overlapping by chance."""
    with open(path, "w") as f:
        for g in range(n_genes):
            chro = f"chr{rng.integers(1, chroms + 1)}"
            gs = int(rng.integers(1, span))
            st = "+-"[int(rng.integers(0, 2))]
            for _ in range(int(rng.integers(1, 4))):
                s = gs + int(rng.integers(0, 2000))
                e = s + int(rng.integers(50, 900))
                f.write(f"{chro}\tx\texon\t{s}\t{e}\t.\t{st}\t."
                        f'\tgene_id "G{g:03d}";\n')
    return str(path)


def _cigar(rng):
    kind = rng.random()
    if kind < 0.2:
        return f"40M{int(rng.integers(50, 3000))}N35M"
    if kind < 0.27:
        return "20M5D30M2I23M"
    if kind < 0.3:
        return f"10M{int(rng.integers(50, 900))}N10M{int(rng.integers(50, 900))}N55M"
    return "75M"


def write_sam(path, rng, n=3000, paired=False):
    """Random records on chr1-chr4 (chr4 is absent from the annotation):
    5% unmapped, 10% NH:i:3; single-end, 3% more as secondary records;
    paired: mates share a name, pairs come interleaved in a shuffled order
    with mate 1 before mate 2 (as an aligner writes them), some mates
    unmapped."""
    head = "@HD\tVN:1.0\n" + "".join(f"@SQ\tSN:chr{c}\tLN:60000\n" for c in (1, 2, 3, 4))
    recs = []
    for i in range(n):
        chro = f"chr{rng.integers(1, 5)}"
        pos = int(rng.integers(1, 55_000))
        rev = rng.random() < 0.5
        nh = "\tNH:i:3" if rng.random() < 0.1 else ""
        if not paired:
            if rng.random() < 0.05:
                recs.append(f"r{i}\t4\t*\t0\t0\t*\t*\t0\t0\tA\tI\n")
            else:
                recs.append(f"r{i}\t{16 if rev else 0}\t{chro}\t{pos}\t30\t{_cigar(rng)}"
                            f"\t*\t0\t0\tA\tI{nh}\n")
            if rng.random() < 0.03:
                recs.append(f"r{i}\t{256 + 16 * rev}\t{chro}\t{pos + 9}\t0\t75M"
                            f"\t*\t0\t0\tA\tI{nh}\n")
            continue
        for mate, bit in ((1, 0x40), (2, 0x80)):
            flag = 0x1 | bit | ((0x10 if rev else 0x20) if mate == 1 else (0x20 if rev else 0x10))
            if rng.random() < 0.05:
                recs.append(f"p{i}\t{flag | 0x4}\t*\t0\t0\t*\t*\t0\t0\tA\tI\n")
                continue
            p = pos + (0 if mate == 1 else int(rng.integers(50, 400)))
            recs.append(f"p{i}\t{flag}\t{chro}\t{p}\t30\t{_cigar(rng)}\t=\t{pos}\t0\tA\tI{nh}\n")
    order = np.arange(len(recs))
    if paired:
        order = rng.permutation(len(recs))
        # mate 1 takes the earlier of its pair's two places
        first = {}
        for k, r in enumerate(order):
            first.setdefault(recs[r].split("\t", 1)[0], []).append(k)
        for a, b in first.values():
            if "\t" in recs[order[a]] and int(recs[order[a]].split("\t")[1]) & 0x80:
                order[a], order[b] = order[b], order[a]
    with open(path, "w") as f:
        f.write(head)
        f.writelines(recs[k] for k in order)
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fc")
    rng = np.random.default_rng(7)
    return dict(gtf=write_gtf(d / "g.gtf", rng),
                se=write_sam(d / "se.sam", rng),
                pe=write_sam(d / "pe.sam", rng, n=1500, paired=True),
                dir=d)


def assert_same_arrays(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (what, i, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what}[{i}]")
        else:
            assert x == y, (what, i)


def jax_count(dc, *arrs):
    with jax.default_device(jax.devices("cpu")[0]):
        return dc.count(*arrs)


def check_pe_vote_gap(counts, summary, fc):
    """The JAX package's device counter and host engine differ on paired
    fragments in one way (a behaviour of that package the port keeps):
    the host engine lets a gene hit by both ends (vote 2) beat one hit by
    a single end (vote 1), the device counter calls every fragment over
    two genes ambiguous.  So every other summary row is equal, and the
    host engine assigns exactly the fragments the device calls ambiguous
    beyond its own ambiguous ones, each to a gene, never fewer per gene."""
    names = tdc.STATUS_NAMES
    host = {n: fc.summary[n] for n in names}
    dev = dict(zip(names, summary.tolist()))
    moved = host["Assigned"] - dev["Assigned"]
    assert moved == dev["Unassigned_Ambiguity"] - host["Unassigned_Ambiguity"] >= 0
    for n in names[1:4]:
        assert host[n] == dev[n], n
    assert (fc.counts >= counts).all() and fc.counts.sum() - counts.sum() == moved
    return moved


def host_counts(gtf, sam, strand, paired):
    fc = FeatureCounter(load_annotation(gtf), FCOptions(
        strand=strand, paired=paired, count_read_pairs=paired))
    fc.count_file(sam)
    return fc


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("strand", [0, 1, 2])
def test_count_equals_jax_and_host_engine(data, strand, paired):
    sam = data["pe" if paired else "se"]
    S = 20 if paired else 10
    j = jdc.DeviceCounter(jload(data["gtf"]), strand=strand, max_sections=S)
    t = tdc.DeviceCounter(load_annotation(data["gtf"]), strand=strand,
                          max_sections=S, device="cpu")
    for a, b in zip(j._tables + [tuple(r[:3]) for r in j._rmq],
                    t._tables + [tuple(r[:3]) for r in t._rmq]):
        assert_same_arrays(a, b, "tables")
    parse = ("fragments_from_" if paired else "sections_from_")
    for src in ("sam", "file"):
        secs_j = getattr(j, parse + src)(sam)
        secs_t = getattr(t, parse + src)(sam)
        assert_same_arrays(secs_j, secs_t, f"sections {src}")
        out_j = jax_count(j, *secs_j)
        out_t = t.count(*secs_t)
        assert_same_arrays(out_j, out_t, f"count {src}")
    counts, summary, status, overflow = out_t
    assert overflow == 0 and len(status) == len(secs_t[0])
    assert len(set(status.tolist())) >= 4
    fc = host_counts(data["gtf"], sam, strand, paired)
    assert counts.sum() > 0
    if paired:
        # the same gap between the JAX package's own two engines
        jfc = JFeatureCounter(jload(data["gtf"]), JFCOptions(
            strand=strand, paired=True, count_read_pairs=True))
        jfc.count_file(sam)
        assert check_pe_vote_gap(*out_j[:2], jfc) == check_pe_vote_gap(
            counts, summary, fc) > 0
        return
    np.testing.assert_array_equal(counts, fc.counts.astype(np.int64))
    for i, name in enumerate(tdc.STATUS_NAMES):
        assert summary[i] == fc.summary[name], name


def test_empty_table_and_no_sections(tmp_path):
    """-s 1 with every feature on '+': the reverse strand's table is empty,
    so reverse reads find no span (NoFeatures), forward reads count."""
    gtf = tmp_path / "plus.gtf"
    gtf.write_text("".join(f'chr1\tx\texon\t{s}\t{s + 99}\t.\t+\t.\tgene_id "G{k}";\n'
                           for k, s in enumerate(range(1000, 5000, 500))))
    sam = tmp_path / "r.sam"
    sam.write_text("@SQ\tSN:chr1\tLN:9000\n" + "".join(
        f"r{i}\t{16 * (i % 2)}\tchr1\t{1000 + 37 * i}\t30\t50M\t*\t0\t0\tA\tI\n"
        for i in range(100)))
    j = jdc.DeviceCounter(jload(str(gtf)), strand=1)
    t = tdc.DeviceCounter(load_annotation(str(gtf)), strand=1, device="cpu")
    assert len(t._tables[1][0]) == 0 and len(t._tables[0][0]) > 0
    secs = t.sections_from_file(str(sam))
    out_t = t.count(*secs)
    assert_same_arrays(jax_count(j, *secs), out_t, "empty table")
    status = out_t[2]
    assert (status[1::2] == tdc.ST_NOFEATURES).all()
    assert (status[::2] == tdc.ST_ASSIGNED).any()
    # no records at all
    z = np.zeros((0, 2), np.int32)
    e = np.zeros(0, np.int32)
    assert_same_arrays(jax_count(j, z, z - 1, e, e), t.count(z, z - 1, e, e), "R=0")


RUNS = sorted({1, 2} | {v for k in range(2, 9) for v in (2**k - 1, 2**k, 2**k + 1)})


def test_span_ranges_at_rmq_level_edges(tmp_path):
    """Gene C: one exon; gene A: 300 exons 10 bases long, 10 apart (300
    spans of one label); gene B: one exon after them.  Sections covering n
    spans from C's, A's first or second, or ending at B's (ambiguous when
    C or B is among them), with their ends on the spans or inside the gaps,
    for n at each level edge of the RMQ."""
    gtf = tmp_path / "runs.gtf"
    exons = [(61, 90, "C")]
    exons += [(101 + 20 * e, 110 + 20 * e, "A") for e in range(300)]
    exons.append((101 + 20 * 300, 150 + 20 * 300, "B"))
    gtf.write_text("".join(f'chr1\tx\texon\t{s}\t{e}\t.\t+\t.\tgene_id "{g}";\n'
                           for s, e, g in exons))
    j = jdc.DeviceCounter(jload(str(gtf)))
    t = tdc.DeviceCounter(load_annotation(str(gtf)), device="cpu")
    assert len(t._tables[0][0]) == len(exons) == 302
    off = t._windows[0]["chr1"].offset
    starts, ends = [], []
    for n in RUNS:
        for first in (0, 1, 2, 302 - n):        # spans first .. first + n - 1
            a = off + exons[first][0]
            b = off + exons[first + n - 1][1]
            starts += [a, a - 5, a + 3]
            ends += [b, b + 5, b - 2]
    R = len(starts)
    ss = np.asarray(starts, np.int32)[:, None]
    se = np.asarray(ends, np.int32)[:, None]
    z = np.zeros(R, np.int32)
    out_t = t.count(ss, se, z, z)
    assert_same_arrays(jax_count(j, ss, se, z, z), out_t, "runs")
    status = out_t[2].reshape(len(RUNS), 4, 3)
    assert (status[:, 1:3] == tdc.ST_ASSIGNED).all()
    assert (status[1:, 0] == tdc.ST_AMBIGUITY).all()
    assert (status[1:, 3] == tdc.ST_AMBIGUITY).all()


def test_floor_log2_equals_clz():
    n = np.arange(1, 2**20 + 1, dtype=np.int32)
    big = np.unique(np.concatenate([
        2 ** np.arange(20, 31, dtype=np.int64) + d for d in (-1, 0, 1)
    ] + [np.random.default_rng(3).integers(2**20, 2**31, 100_000)]))
    for v in (n, big.astype(np.int32)):
        want = 31 - np.asarray(jax.lax.clz(v))
        got = floor_log2(torch.from_numpy(v))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _cli_outputs(main, argv, out):
    assert main(argv + ["-o", str(out)]) == 0
    return out.read_bytes(), (out.parent / (out.name + ".summary")).read_bytes()


@pytest.mark.parametrize("case", ["se-s0", "se-s1", "se-s2", "pe-s0", "pe-s2"])
def test_cli_files_equal_jax(data, tmp_path, case, capfd):
    """The port's count and summary files equal the JAX CLI's, from the host
    engine and with --deviceCounts; single-end the two engines' files are
    equal too (paired, they differ as check_pe_vote_gap says)."""
    kind, strand = case.split("-s")
    argv = ["-a", data["gtf"], "-s", strand]
    if kind == "pe":
        argv += ["-p", "--countReadPairs"]
    argv.append(data[kind])
    files = {}
    for engine, extra in (("host", []), ("device", ["--deviceCounts"])):
        with jax.default_device(jax.devices("cpu")[0]):
            jax_files = _cli_outputs(jcli.main, argv + extra,
                                     tmp_path / f"jax-{engine}.txt")
        capfd.readouterr()
        files[engine] = _cli_outputs(tcli.main, argv + extra + ["--device", "cpu"],
                                     tmp_path / f"{engine}.txt")
        err = capfd.readouterr().err
        assert (f"// deviceCounts: {data[kind]} counted on cpu" in err) == bool(extra)
        assert files[engine] == jax_files, engine
    assert int(files["host"][1].split(b"\n")[1].split(b"\t")[1]) > 0
    assert (files["host"] == files["device"]) == (kind == "se")


def test_ineligible_option_goes_to_the_host_engine(data, tmp_path, capfd):
    """-Q 10 lies outside the device subset: _try_device_count declines,
    and the CLI counts on the host engine (the JAX package's rule)."""
    ann = load_annotation(data["gtf"])
    fc = FeatureCounter(ann, FCOptions(min_mapq=10))
    assert not tcli._try_device_count(fc, ann, data["se"], torch.device("cpu"))
    assert fc.counts.sum() == 0
    argv = ["-a", data["gtf"], "-Q", "10", data["se"], "--device", "cpu"]
    dev = _cli_outputs(tcli.main, argv + ["--deviceCounts"], tmp_path / "d.txt")
    err = capfd.readouterr().err
    assert "falling back to the host counter" in err and "counted on" not in err
    assert dev == _cli_outputs(tcli.main, argv, tmp_path / "h.txt")
    with jax.default_device(jax.devices("cpu")[0]):
        assert dev == _cli_outputs(jcli.main, argv[:-2], tmp_path / "j.txt")

