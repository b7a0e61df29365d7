"""The whole single-end slice: the port's Aligner on the CPU against the JAX
package's Aligner — the same collect_batch dict (keys, dtypes, values), a
record-equal SAM and an identical .indel.vcf — with the device rescue
tiers and the host saturation rescue (and its window escalation) all
exercised; then once more through `python -m subread_tpu_torch.tools.align
--device cpu`."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch

from subread_tpu import dna
from subread_tpu.align.pipeline import Aligner as JAligner
from subread_tpu.index.build import build_hash_index
from subread_tpu.io.fastq import batch_from_records
from subread_tpu.utils.simulate import simulate_reads
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.synth import synthetic_genome, synthetic_reads, write_fastq
from subread_tpu_torch.tools import align as align_cli
from torch_native_fixtures import native_mode, native_records  # noqa: F401  (fixtures)

# the test workers share the machine's cores: one torch thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME = dict(n_bases=200_000, seed=5, tandem_frac=0.05, segdup_len=2000)
# short tandem arrays of units that are their own reverse complement, so
# both strand scans hit them: reads inside give candidate streams longer
# than the last device tier's cut (both) and clusters wider than its
# window (period 2), so the host rescue and its window doubling run
PLANTED = ((b"AGCT", 60, 10_000), (b"AT", 60, 20_000))


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


def reads_for(genome, n, seed):
    """Simulated reads (errors, indels, N) + reads from the planted arrays,
    both strands, + a last block of exact reads (no host placement flags)."""
    b = synthetic_reads(genome, n, seed=seed)
    names = list(b.names)
    seqs = [dna.decode(b.codes[i, : b.lengths[i]]).encode() for i in range(n)]
    for i in np.flatnonzero(b.ambig.any(1)):
        s = bytearray(seqs[i])
        s_amb = b.ambig[i, : b.lengths[i]]
        for j in np.flatnonzero(s_amb):
            s[j] = ord("N")
        seqs[i] = bytes(s)
    for unit, copies, at in PLANTED:
        s0 = int(genome.starts[1]) + at
        span = len(unit) * copies - 100
        for k, off in enumerate(range(0, span, max(span // 6, 1))):
            r = genome.codes[s0 + off: s0 + off + 100]
            if k % 2:
                r = dna.revcomp(r)
            names.append(f"planted_{unit.decode()}_{off}")
            seqs.append(dna.decode(r).encode())
    exact, _ = simulate_reads(
        genome, 512, read_len=100, rng=np.random.default_rng(seed + 1)
    )
    names += [f"exact{i}" for i in range(len(exact))]
    seqs += [dna.decode(c).encode() for c in exact.codes]
    quals = [b"I" * len(s) for s in seqs]
    return batch_from_records(names, seqs, quals, pad_to=100)


def cli_config(*extra):
    args = align_cli.build_parser().parse_args(
        ["-t", "1", "-i", "x", "-r", "x", "-o", "x", *extra]
    )
    return align_cli.config_from_args(args)


def assert_same_dict(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def collect_matches_jax(genome, idx, cfg, monkeypatch):
    """align_batch on the port and on the JAX package with index idx and
    config cfg: the same dict, with reads saturated in the main pass.
    Returns the port's dict and what the spies saw."""
    # 1024 - 14 planted reads: the 512 exact reads fill the last sub-batch
    batch = reads_for(genome, 1010, seed=11)
    al = Aligner(genome, idx, cfg, device="cpu")
    assert al.rescue_fold_cap > 0
    seen = {}
    fold, host = al._rescue_fold, al._rescue_saturated

    def fold_spy(codes, ambig, lens, res, ul):
        seen["fold"] = seen.get("fold", 0) + int(res["saturated"].sum())
        return fold(codes, ambig, lens, res, ul)

    def host_spy(batch_, out):
        seen["host"] = int(out["saturated"].sum())
        return host(batch_, out)

    dev_align = al._device_align

    def align_spy(*a, **k):
        if k.get("vp") is not None and k["vp"].window > 40:
            seen["escalated"] = True
        return dev_align(*a, **k)

    monkeypatch.setattr(al, "_rescue_fold", fold_spy)
    monkeypatch.setattr(al, "_rescue_saturated", host_spy)
    monkeypatch.setattr(al, "_device_align", align_spy)
    t = al.align_batch(batch)
    j = JAligner(genome, idx, cfg).align_batch(batch)
    assert_same_dict(t, j)
    assert seen["fold"] > 0        # reads saturated in the main pass
    assert "probe_kv" in t
    return t, seen


def collect_config(**kw):
    from dataclasses import replace

    return replace(cli_config(), batch_reads=512, **kw)


@pytest.mark.parametrize("case", ["full", "multi_best"])
def test_collect_batch_dict_matches_jax(genome, index, case, monkeypatch):
    cfg = (collect_config(multi_best=3, report_multi_mapping=True)
           if case == "multi_best" else collect_config())
    t, seen = collect_matches_jax(genome, index, cfg, monkeypatch)
    if case == "full":
        assert seen["host"] > 0    # and some still after the device tiers
        assert seen.get("escalated")   # some needing a window above 40
        # the exact-read sub-batch has no flagged read: zero rows
        assert (t["probe_kv"][-512:] == 0).all()
        assert not t["saturated"].any()


@pytest.fixture(scope="module")
def jax_run(genome, index, tmp_path_factory):
    """Index on disk, FASTQ, and the JAX aligner's SAM with the config the
    CLI builds."""
    d = tmp_path_factory.mktemp("align")
    genome.save(str(d / "idx"))
    index.save(str(d / "idx"))
    write_fastq(str(d / "reads.fq"), reads_for(genome, 2000, seed=21))
    JAligner(genome, index, cli_config()).align_file(
        str(d / "reads.fq"), str(d / "jax.sam")
    )
    return d


def same_files(a, b):
    return filecmp.cmp(a, b, shallow=False)


def test_align_file_sam_and_vcf_match_jax(genome, index, jax_run):
    d = jax_run
    Aligner(genome, index, cli_config(), device="cpu").align_file(
        str(d / "reads.fq"), str(d / "torch.sam")
    )
    assert same_files(d / "torch.sam", d / "jax.sam")
    assert same_files(str(d / "torch.sam") + ".indel.vcf",
                      str(d / "jax.sam") + ".indel.vcf")
    with open(d / "jax.sam") as f:
        recs = [line.split("\t") for line in f if not line.startswith("@")]
    assert len(recs) == 2000 + 512 + 14
    assert sum(1 for r in recs if "D" in r[5] or "I" in r[5]) > 20
    assert sum(1 for r in recs if "S" in r[5]) > 0
    assert os.path.getsize(str(d / "jax.sam") + ".indel.vcf") > 300


def test_cli_matches_jax(jax_run):
    d = jax_run
    proc = subprocess.run(
        [sys.executable, "-m", "subread_tpu_torch.tools.align", "-t", "1",
         "-i", str(d / "idx"), "-r", str(d / "reads.fq"),
         "-o", str(d / "cli.sam"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "Mapped:" in proc.stderr
    assert same_files(d / "cli.sam", d / "jax.sam")
    assert same_files(str(d / "cli.sam") + ".indel.vcf",
                      str(d / "jax.sam") + ".indel.vcf")


def test_unported_options_raise(genome, index):
    """Every subread-align option is ported; what raises is --device cuda
    without a card."""
    from dataclasses import replace

    # --sv/--longDel/--SVdetection switch on junction and breakpoint
    # detection, as subread_tpu's run_align does; -a is taken
    for extra in (["--sv"], ["--longDel"], ["--SVdetection"]):
        cfg = cli_config(*extra)
        assert cfg.detect_junctions and cfg.all_junctions
    assert not cli_config("-a", "x.gtf").detect_junctions
    al = Aligner(genome, index, replace(cli_config(), detect_junctions=True),
                 device="cpu")
    assert al.cfg.detect_junctions
    # paired-end input and the long-indel rescue (-I > 16) are ported
    assert cli_config("-R", "r2.fq").max_indel == 5
    al = Aligner(genome, index, cli_config("-I", "20"), device="cpu")
    assert al.vote_params.indel_tolerance == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Aligner(genome, index, cli_config(), device="cuda")
        with pytest.raises(RuntimeError):
            align_cli.main(["-t", "1", "-i", "x", "-r", "x", "-o", "x"])


def test_bam_matches_jax(genome, index, jax_run, native_mode, native_records):
    """`tools.align -o x.bam` writes the JAX aligner's BAM byte for byte,
    with the native library (every record packed by its BAM encoder,
    the host rescues' CIGARs in place) and without it."""
    from subread_tpu_torch.io.bam import BamReader

    d = jax_run
    packed = native_records
    jax_bam, port_bam = d / f"jax_{native_mode}.bam", d / f"port_{native_mode}.bam"
    JAligner(genome, index, cli_config()).align_file(str(d / "reads.fq"), str(jax_bam))
    align_cli.main(["-t", "1", "-i", str(d / "idx"), "-r", str(d / "reads.fq"),
                    "-o", str(port_bam), "--device", "cpu"])
    assert same_files(port_bam, jax_bam)
    assert same_files(str(port_bam) + ".indel.vcf", str(jax_bam) + ".indel.vcf")
    recs = list(BamReader(str(port_bam)))
    assert len(recs) == 2000 + 512 + 14
    assert packed[0] == (len(recs) if native_mode == "native" else 0)
    # a host rescue's CIGAR (override) is the mapped record without HI/NH
    overrides = [r for r in recs if not r.flag & 4 and "HI" not in r.tags]
    assert any(sum(op in "ID" for _, op in r.cigar) > 1 for r in overrides)
