"""The cellCounts cell's own pieces on the CPU: the generator, the frozen
copy of the port's plain reference, the check's tag reader, the workloads
lists of the per-layer metrics, the span shares that read nothing on a
program without the spans, and runs of the cell on a small genome with a
200,000-barcode whitelist: sound (untraced and traced), each planted
fault, and the control (--minVotesPerRead raised to the limits file's
control_min_votes), which must read false on `missed`."""

import time
from pathlib import Path

import numpy as np
import pytest

from benchmark.frozen.synth import revcomp, synthetic_genome
from benchmark.generators import cell_reads
from benchmark.harness import run_cell
from benchmark.spec import ROOT, Spec

CELL = "cellcounts-10xv3.wbcel235"
SMALL = {"config": {"genome": {"contigs": [["chrI", 700000], ["chrII", 500000],
                                           ["chrM", 13794]],
                               "seed": 235, "segdup_frac": 0.02, "segdup_len": 10000,
                               "tandem_frac": 0.01, "n_runs_per_contig": 3}},
         "pool": 6000, "chunk_reads": 2048, "batch_reads": 1024, "whitelist": 200_000}


@pytest.fixture(scope="module")
def genome():
    return synthetic_genome([("chrA", 700_000), ("chrB", 500_000), ("chrM", 13_794)], 7)


def test_generator(genome):
    traffic = Spec.traffic("10xv3-3p")
    a = dict(traffic["annotation"])
    ann = cell_reads.annotation(genome, 240, a.pop("seed"),
                                **{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in a.items() if k != "genes"})
    assert len(ann.genes) == 240
    for c in range(3):
        spans = sorted((ch[0][0], ch[-1][1]) for (_, cc, _, _), ch in zip(ann.genes, ann.chains)
                       if cc == c)
        assert all(b[0] > a[1] for a, b in zip(spans[:-1], spans[1:]))
    for (_, c, ds, txs), ch in zip(ann.genes, ann.chains):
        assert 2 <= len(ch) and 1 <= len(txs) <= 3 and txs[0] == ch
        bases = genome.contig(c)
        for (_, e), (s, _) in zip(ch[:-1], ch[1:]):
            assert 50 <= s - e <= 5000
            assert (bases[e: e + 2].tobytes(), bases[s - 2: s].tobytes()) == \
                ((b"GT", b"AG") if ds == 0 else (b"CT", b"AC"))
    wl = cell_reads.whitelist(100_000, 2018)
    assert wl.shape == (100_000, 16) and len(np.unique(wl.view("S16"))) == 100_000
    kw = {k: v for k, v in traffic.items() if k not in ("generator", "pool", "annotation")}
    p = cell_reads.generate(genome, 20_000, 31, ann=ann, wl=wl, **kw)
    q = cell_reads.generate(genome, 20_000, 31, ann=ann, wl=wl, **kw)
    assert (p.r1 == q.r1).all() and (p.r2.seqs[0] == q.r2.seqs[0]).all()
    assert p.r1.shape == (20_000, 28) and p.r2.seqs[0].shape == (20_000, 90)
    share = np.bincount(p.kind, minlength=3) / len(p)
    assert abs(share[0] - 0.75) < 0.03 and abs(share[1] - 0.2) < 0.03
    bc_ok = (p.r1[:, :16] == wl[p.cell]).all(axis=1)
    assert 0.955 < bc_ok.mean() < 0.985
    # an exonic read is its transcript's bases on the sense strand
    r = int(np.flatnonzero((p.kind == 0) & (p.r2.introns[0] == 0))[0])
    o = int(genome.offsets[p.r2.contig[0][r]])
    seq = p.r2.seqs[0][r]
    seq = revcomp(seq) if p.r2.reverse[0][r] else seq
    assert (seq != genome.bases[o + p.r2.start[0][r]: o + p.r2.end[0][r]]).sum() <= 3
    assert (p.r2.introns[0][p.kind == 0] > 0).mean() > 0.05


def test_frozen_reference_is_the_ports():
    assert ((ROOT / "benchmark/frozen/cellcounts.py").read_bytes()
            == (ROOT / "subread_tpu_torch/reference/cellcounts.py").read_bytes())


def test_workloads_lists():
    data = Spec().data
    for m in data["per_layer"]:
        if m["name"].startswith("cellcounts."):
            assert m["workloads"] == [CELL] and m["moves"] == "reads_per_s"
    with_new = {m["name"] for m in data["per_layer"] if CELL in m["workloads"]}
    assert {"device.idle", "probe_hits_roofline", "setup.index_load_s",
            "host.rescue_share", "cellcounts.umis_per_s"} <= with_new


def test_span_shares_read_nothing_without_spans():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.cell_spans import share_or_none
    from subread_tpu_torch import timing

    timing.clear()
    assert share_or_none({"window_s": 1.0}, "cellcounts.align") is None
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("cellcounts.align"):
            time.sleep(0.02)
        torch.zeros(1)
    assert share_or_none({"window_s": 1.0}, "cellcounts.align") >= 0.02
    timing.clear()


def run(cache, trace=False, **kw):
    import torch

    torch.set_num_threads(4)
    return run_cell(Spec(), CELL, 4216000017, 1.0, trace, time.perf_counter(),
                    device="cpu", overrides=SMALL, cache=Path(cache),
                    log=lambda s: None, **kw)


def test_sound_run_and_control(index_cache):
    r = run(index_cache)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s", "true_placed"}
    assert r["metrics"]["true_placed"]["value"] > 0.9
    r = run(index_cache, control=True)
    assert not r["correct"] and r["checks"]["missed"][0] > r["checks"]["missed"][1]


@pytest.mark.parametrize("fault", ["barcode", "umi"])
def test_fault_is_caught(index_cache, fault):
    r = run(index_cache, fault=fault)
    assert not r["correct"] and r["checks"]["matrix_errors"][0] > 0, r["checks"]


def test_traced_run_reports_the_cellcounts_metrics(index_cache):
    from subread_tpu_torch import timing

    timing.clear()
    r = run(index_cache, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    shares = ["cellcounts.align_share", "cellcounts.assign_share",
              "cellcounts.barcode_share", "cellcounts.emit_share",
              "cellcounts.finalise_share"]
    for name in shares + ["cellcounts.umis_per_s", "host.rescue_share",
                          "host.emit.deflate_share", "setup.index_load_s"]:
        assert m.get(name, 0) > 0, (name, sorted(m))
    assert 0.9 < sum(m[s] for s in shares) <= 1.0
    timing.clear()
