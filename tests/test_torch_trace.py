"""The port's span and counter recorder (subread_tpu_torch.timing) around
the align pipeline, on the CPU: nothing is listed outside a profiler
session; inside one, align_file and align_file_pe give each chunk one
submit, collect and emit span, children lie inside their parents, emit
splits into its own time, the packing counted in it and the deflates
nested in it, the records the native encoder and the Python packer count
add up to each BAM chunk's, the bgzf.bytes_in counter matches the BAM
file, the outputs are the same bytes with and without recording, and a
profiler op run inside a span lies inside it (one clock)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subread_tpu_torch import native, timing
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.config import aligner_config
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io import bam
from subread_tpu_torch.synth import (
    synthetic_genome, synthetic_pairs, synthetic_reads, write_fastq,
)
from subread_tpu_torch.tools import align as align_cli

torch.set_num_threads(1)

N_READS, N_PAIRS, CHUNK = 2500, 1000, 1024


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    g = synthetic_genome(200_000, seed=41, n_contigs=2)
    ix = build_hash_index(g, index_gap=1)
    g.save(str(d / "idx"))
    ix.save(str(d / "idx"))
    write_fastq(str(d / "r.fq"), synthetic_reads(g, N_READS, seed=42))
    b1, b2 = synthetic_pairs(g, N_PAIRS, seed=43)
    write_fastq(str(d / "r1.fq"), b1)
    write_fastq(str(d / "r2.fq"), b2)
    al = Aligner(g, ix, aligner_config(batch_reads=512), device="cpu")
    return d, al


def align(setup, mode, out):
    d, al = setup
    if mode == "pe":
        al.align_file_pe(str(d / "r1.fq"), str(d / "r2.fq"), out,
                         chunk_reads=CHUNK // 2)
    else:
        al.align_file(str(d / "r.fq"), out, chunk_reads=CHUNK)


def children(spans, i):
    return [s for s in spans if s.parent == i]


def test_nothing_is_listed_outside_a_profiler(setup, tmp_path):
    timing.clear()
    align(setup, "se", str(tmp_path / "a.bam"))
    assert not timing.recording()
    assert timing.spans() == [] and timing.counters() == []
    tot = timing.totals()
    for name in ("fastq.read", "submit", "submit.upload", "submit.launch",
                 "collect", "emit", "bgzf.deflate"):
        assert tot[name] > 0, name
    align(setup, "se", str(tmp_path / "b.bam"))
    assert all(timing.totals()[k] > v for k, v in tot.items())


@pytest.mark.parametrize("mode,fmt", [("se", "bam"), ("pe", "bam"), ("se", "sam")])
def test_spans_of_a_profiled_run(setup, tmp_path, monkeypatch, mode, fmt):
    # a small flush threshold, so deflates run inside emit as well as at
    # the close
    monkeypatch.setattr(bam.BamWriter, "FLUSH_BYTES", 1 << 16)
    plain, traced = str(tmp_path / f"plain.{fmt}"), str(tmp_path / f"traced.{fmt}")
    align(setup, mode, plain)
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.recording()
        align(setup, mode, traced)
    spans, counters = timing.spans(), timing.counters()

    # the outputs are the same bytes with and without recording
    for suffix in ("", ".indel.vcf"):
        with open(plain + suffix, "rb") as a, open(traced + suffix, "rb") as b:
            assert a.read() == b.read(), suffix

    n, chunk = (N_PAIRS, CHUNK // 2) if mode == "pe" else (N_READS, CHUNK)
    for name in ("submit", "collect", "emit"):
        chunks = sorted(s.chunk for s in spans if s.name == name)
        assert chunks == list(range(-(-n // chunk))), name
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and p.chunk == s.chunk, (s, p)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    for i, s in enumerate(spans):
        kids = children(spans, i)
        if s.name == "submit":
            assert {k.name for k in kids} == {"submit.upload", "submit.launch"}
        if s.name == "emit":
            assert {k.name for k in kids} <= {"bgzf.deflate"}
    if fmt == "bam":
        assert any(spans[s.parent].name == "emit"
                   for s in spans if s.name == "bgzf.deflate" and s.parent >= 0)

    # emit is its own time plus the packing counted in it plus the
    # deflates inside it: one bam.pack_ns a BAM chunk, none for SAM
    pack = {}
    for c in counters:
        if c.name == "bam.pack_ns":
            assert c.chunk not in pack and c.value > 0, c
            pack[c.chunk] = c.value
    emits = [(i, s) for i, s in enumerate(spans) if s.name == "emit"]
    assert sorted(pack) == ([s.chunk for _, s in emits] if fmt == "bam" else [])
    for i, s in emits:
        inner = pack.get(s.chunk, 0) + sum(
            k.end_ns - k.start_ns for k in children(spans, i))
        if fmt == "bam":
            assert 0 < inner <= s.end_ns - s.start_ns, (s, inner)
        else:
            assert inner == 0, (s, inner)

    # per BAM chunk: the records packed by the native encoder and by
    # add_sam_fields add up to the chunk's records, the encoder's > 0
    # with the native library; SAM counts neither
    packed = {}
    for c in counters:
        if c.name in ("bam.records_native", "bam.records_python"):
            assert c.name not in packed.setdefault(c.chunk, {}), c
            packed[c.chunk][c.name] = c.value
    assert sorted(packed) == sorted(pack)
    for k, got in packed.items():
        per = (2 if mode == "pe" else 1) * min(chunk, n - k * chunk)
        assert got["bam.records_native"] + got["bam.records_python"] == per, got
        assert got["bam.records_native"] > 0 or native.get_lib() is None, got

    n_in = sum(c.value for c in counters if c.name == "bgzf.bytes_in")
    assert n_in == (len(bam.bgzf_decompress(traced)) if fmt == "bam" else 0)


def test_a_profiler_op_inside_a_span_lies_inside_it():
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("outer"):
            torch.arange(10_000).sum()
    (s,) = timing.spans()
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::sum"]
    assert ops
    for e in ops:
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def test_the_cli_reports_span_totals(setup, tmp_path, capsys):
    d, _ = setup
    run = align_cli.run_align(align_cli.build_parser().parse_args(
        ["-t", "1", "-i", str(d / "idx"), "--device", "cpu", "-r", str(d / "r.fq"),
         "-o", str(tmp_path / "cli.bam")]))
    for name in ("index.load", "index.upload", "submit", "collect", "emit"):
        assert run["spans"][name] > 0, name
    assert {"time_load", "time_upload", "time_align"} <= set(run)
    assert not {"time_voting", "time_io", "time_realign"} & set(run)
    err = capsys.readouterr().err
    assert "host seconds in " in err and "index.load " in err
