"""sublong_file's reader path and its spans and counters, on the CPU:

  * with `reader=` (the port's FastqReader, or one that hands over three
    reads a call) it writes the BAM it writes without one, byte for byte;
  * outside a profiler session nothing is listed and the span totals
    grow; inside one, each chunk gives sublong.windows, sublong.align
    (holding submit and collect), sublong.chain (holding one sublong.dp,
    the chunk's batched refinement, where the chunk has stretches to
    refine) and sublong.emit (holding the deflates) spans, the reader's
    calls sublong.read spans, and the counters add up to the windows and
    bases of the reads fed, with one sublong.dp_cells and one
    sublong.dp_jobs count a refinement;
  * the BAM is the same bytes with and without recording."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from subread_tpu_torch import timing
from subread_tpu_torch.align import longread
from subread_tpu_torch.align.pipeline import Aligner
from subread_tpu_torch.index.build import build_hash_index
from subread_tpu_torch.io import bam
from subread_tpu_torch.io.fastq import FastqReader, read_fastq
from subread_tpu_torch.synth import synthetic_genome, synthetic_long_reads, write_fastq
from subread_tpu_torch.tools import sublong as cli

torch.set_num_threads(1)

N_READS = 12


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sublong_trace")
    g = synthetic_genome(300_000, seed=91, n_contigs=2)
    args = cli.build_parser().parse_args(["-i", "x", "-r", "y", "-o", "z"])
    # 256-window chunks, so the reads make several
    cfg = dataclasses.replace(cli.sublong_config(args), batch_reads=256)
    al = Aligner(g, build_hash_index(g, index_gap=3), cfg, device="cpu")
    lr = synthetic_long_reads(g, N_READS, seed=92, min_len=1500, max_len=5000)
    fq = str(d / "long.fq")
    write_fastq(fq, lr)
    return d, al, fq


class Threes:
    """A FastqReader that hands over at most three reads a call."""

    def __init__(self, path):
        self.r = FastqReader(path)

    def next_batch(self, max_reads, pad_to=None):
        return self.r.next_batch(min(max_reads, 3), pad_to=pad_to)

    def close(self):
        self.r.close()


def test_reader_path_writes_the_same_bam(setup):
    d, al, fq = setup
    outs = {}
    for how, reader in (("path", None), ("reader", FastqReader(fq)), ("threes", Threes(fq))):
        out = str(d / f"{how}.bam")
        assert longread.sublong_file(al, fq if how == "path" else "-", out,
                                     reader=reader)[1] == N_READS
        outs[how] = open(out, "rb").read()
    assert outs["path"] == outs["reader"] == outs["threes"]


def test_nothing_is_listed_outside_a_profiler(setup):
    d, al, fq = setup
    timing.clear()
    longread.sublong_file(al, fq, str(d / "a.bam"))
    assert timing.spans() == [] and timing.counters() == []
    tot = timing.totals()
    for name in ("sublong.read", "sublong.windows", "sublong.align", "sublong.chain",
                 "sublong.dp", "sublong.emit", "submit", "collect", "bgzf.deflate"):
        assert tot[name] > 0, name
    longread.sublong_file(al, fq, str(d / "b.bam"))
    assert all(timing.totals()[k] > v for k, v in tot.items())


def test_spans_and_counters_of_a_profiled_run(setup, monkeypatch):
    d, al, fq = setup
    # a small flush threshold, so deflates run inside the emit spans
    monkeypatch.setattr(bam.BamWriter, "FLUSH_BYTES", 1 << 14)
    plain, traced = str(d / "plain.bam"), str(d / "traced.bam")
    longread.sublong_file(al, fq, plain)
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        longread.sublong_file(al, fq, traced)
    assert open(plain, "rb").read() == open(traced, "rb").read()
    spans = timing.spans()
    name = lambda i: spans[i].name if i >= 0 else None
    by = {}
    for i, s in enumerate(spans):
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        by.setdefault(s.name, []).append(s)
    assert {name(s.parent) for s in by["sublong.dp"]} == {"sublong.chain"}
    assert {name(s.parent) for s in by["submit"] + by["collect"]} == {"sublong.align"}
    assert {name(s.parent) for s in by["bgzf.deflate"]} == {"sublong.emit"}
    assert {name(s.parent) for s in by["fastq.read"]} == {"sublong.read"}
    for top in ("sublong.read", "sublong.windows", "sublong.align", "sublong.chain",
                "sublong.emit"):
        assert {name(s.parent) for s in by[top]} == {None}, top
    chunks = {s.chunk for s in by["sublong.chain"]}
    assert len(chunks) >= 2 and chunks == {s.chunk for s in by["sublong.windows"]}
    # one emit a chunk, and the BAM's close
    assert len(by["sublong.emit"]) == len(chunks) + 1
    reads = read_fastq(fq)
    lens = reads.lengths.astype(np.int64)
    total = lambda k: sum(c.value for c in timing.counters() if c.name == k)
    assert total("sublong.windows") == int(np.maximum(lens // 100, 1).sum())
    assert total("sublong.bases") == int(lens.sum())
    cells = [c.value for c in timing.counters() if c.name == "sublong.dp_cells"]
    assert len(cells) == len(by["sublong.dp"]) and min(cells) > 0
    jobs = [c.value for c in timing.counters() if c.name == "sublong.dp_jobs"]
    assert len(jobs) == len(by["sublong.dp"]) and min(jobs) > 0
    # one refinement a chunk at most
    assert len(by["sublong.dp"]) <= len(chunks)
    assert len({s.chunk for s in by["sublong.dp"]}) == len(by["sublong.dp"])
