"""cellCounts: 10x Chromium 3' v3 read pairs in FASTQ, the sample's BAM and
its matrix out, as cellCounts' FASTQ mode runs them.

Set-up makes the genome from the configuration's fixed seed and loads (or,
in a checkout's first run, builds) its index as the aligners' runs do; makes
the whitelist and the annotation from their fixed seeds
(`generators/cell_reads.py`) and writes them as the files users hand the
CLI; makes the traffic's pool of read pairs from the seed as two FASTQ
files; parses the cell's options as the CLI does; uploads the index, loads
the whitelist and the annotation and builds the barcode matcher as the CLI
does; and counts one batch of the pool to warm up.  The window is one call
of `cellcounts_file` on a reader of the two files that re-reads the pool
from its start and ends the input once the deadline has passed; the call
counts the batches it read, closes the BAM and writes the matrix.  The
check holds the BAM, its tags, the matrix and the index against the plain
reference (`reference/cellcheck.py`, `reference/check.py`).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time

import numpy as np

from benchmark.aligner import AlignerTool, CyclicReader, Gate, genome_of, index_prefix, \
    reference_keys
from benchmark.frozen.synth import write_fastq
from benchmark.generators import cell_reads
from benchmark.reference import check
from benchmark.reference.bam import read_bam
from benchmark.reference.cellcheck import cell_checks

# at most one gene a 5 kb of genome: binds only a genome cut below the
# configuration's, as the CPU tests run
BASES_PER_GENE = 5000


class PairReader:
    """R1 and R2 on cyclic readers of their files: R1's decides whether the
    next batch is read, R2's follows.  reads counts the pairs handed out."""

    def __init__(self, r1: str, r2: str, gate: Gate):
        self.r1 = CyclicReader(r1, gate, lead=True)
        self.r2 = CyclicReader(r2, gate, lead=False)

    def next_batch(self, max_pairs: int, pad_to: int | None = None):
        b1 = self.r1.next_batch(max_pairs)
        if b1 is None:
            return None
        return b1, self.r2.next_batch(max_pairs, pad_to=pad_to)

    @property
    def reads(self) -> int:
        return self.r1.reads

    def close(self):
        self.r1.close()
        self.r2.close()


class CellCountsTool(AlignerTool):
    """The aligners' tracing and summary, with cellCounts' own set-up,
    window, spans, faults, release, check and context."""

    faults = ("barcode", "umi")

    def setup(self, run) -> None:
        from subread_tpu_torch.align.pipeline import Aligner
        from subread_tpu_torch.io.bcl import parse_cell_barcodes
        from subread_tpu_torch.quant.cellcounts import BatchBarcodeMatcher
        from subread_tpu_torch.tools import cellcounts as cli
        from subread_tpu_torch.tools.align import load_index_any

        entry = getattr(cli, "cellcounts_file", None)
        if entry is None or "reader" not in inspect.signature(entry).parameters:
            raise RuntimeError("this program has no cellcounts_file taking a reader: "
                               "a window cannot end at a deadline")
        config, ov, steps = run.config, run.overrides, run.steps
        traffic = {**run.traffic, **ov.get("cell_traffic", {})}
        t = time.perf_counter()
        run.genome = genome_of(config)
        steps["genome"] = time.perf_counter() - t
        run.prefix, run.build_s = index_prefix(config, run.genome, run.cache, run.log)
        t = time.perf_counter()
        run.sorted_keys = reference_keys(config, run.genome, run.prefix)
        steps["reference keys"] = time.perf_counter() - t
        t = time.perf_counter()
        wl_cfg, reads = config["whitelist"], config["reads"]
        run.wl = cell_reads.whitelist(ov.get("whitelist", wl_cfg["barcodes"]), wl_cfg["seed"],
                                      wl_cfg["barcode_len"])
        run.wl_path = os.path.join(run.tmp, "whitelist.txt")
        with open(run.wl_path, "wb") as f:
            f.write(np.concatenate([run.wl, np.full((len(run.wl), 1), ord("\n"), np.uint8)],
                                   axis=1).tobytes())
        steps["whitelist"] = time.perf_counter() - t
        t = time.perf_counter()
        a = dict(traffic["annotation"])
        n_genes = min(a.pop("genes"), int(run.genome.lengths.sum()) // BASES_PER_GENE)
        run.ann = cell_reads.annotation(run.genome, n_genes, a.pop("seed"),
                                        **{k: tuple(v) if isinstance(v, list) else v
                                           for k, v in a.items()})
        run.gtf = os.path.join(run.tmp, "genes.gtf")
        cell_reads.write_gtf(run.gtf, run.genome, run.ann)
        steps["annotation"] = time.perf_counter() - t
        t = time.perf_counter()
        kw = {k: v for k, v in traffic.items() if k not in ("generator", "pool", "annotation")}
        run.pool = cell_reads.generate(
            run.genome, ov.get("pool", traffic["pool"]), run.key, ann=run.ann, wl=run.wl,
            barcode_len=reads["barcode_len"], umi_len=reads["umi_len"],
            r2_len=reads["r2_len"], **kw)
        steps["pool"] = time.perf_counter() - t
        t = time.perf_counter()
        run.fq = [os.path.join(run.tmp, f"pool_R{m}.fq") for m in (1, 2)]
        q1 = (traffic.get("qual_char", "F") * run.pool.r1.shape[1]).encode()
        write_fastq(run.fq[0], run.pool.r2.names, run.pool.r1, q1)
        write_fastq(run.fq[1], run.pool.r2.names, run.pool.r2.seqs[0], run.pool.r2.qual)
        steps["fastq"] = time.perf_counter() - t
        run.out = os.path.join(run.tmp, "window.bam")
        run.out_dir = os.path.join(run.tmp, "window")
        control = (["--minVotesPerRead", str(run.limits["control_min_votes"])]
                   if run.control else [])
        run.args = cli.build_parser().parse_args(
            list(config["cli"]) + control + [
                "-i", run.prefix, "-r", run.fq[0], "-R", run.fq[1], "-a", run.gtf,
                "-c", run.wl_path, "-o", run.out_dir, "--bam", run.out,
                "--device", run.device])
        cfg = cli.aligner_config(run.args)
        if "batch_reads" in ov:
            cfg = dataclasses.replace(cfg, batch_reads=ov["batch_reads"])
        run.batch_pairs = ov.get("chunk_reads", cli.PAIRS_PER_BATCH)
        t = time.perf_counter()
        pgenome, run.index = load_index_any(run.prefix)
        run.index_load_s = time.perf_counter() - t
        t = time.perf_counter()
        run.aligner = Aligner(pgenome, run.index, cfg, device=run.device)
        run.sync()
        run.upload_s = time.perf_counter() - t
        t = time.perf_counter()
        run.matcher = BatchBarcodeMatcher(parse_cell_barcodes(run.wl_path))
        run.annotation = cli.cell_annotation(run.args, pgenome)
        steps["matcher and annotation"] = time.perf_counter() - t
        # warm-up: one batch of the pool, counted and written
        t = time.perf_counter()
        self._count(run, Gate(chunks=1), os.path.join(run.tmp, "warm"),
                    os.path.join(run.tmp, "warm.bam"))
        run.sync()
        steps["warm"] = time.perf_counter() - t

    def _count(self, run, gate: Gate, out_dir: str, bam: str) -> PairReader:
        from subread_tpu_torch.tools import cellcounts as cli

        reader = PairReader(run.fq[0], run.fq[1], gate)
        a = run.args
        cli.cellcounts_file(run.aligner, run.matcher, run.annotation, a.reads, a.reads2,
                            out_dir, umi_len=a.umi_len, cell_calling=a.cellCalling,
                            umi_cutoff=a.umiCutoff, bam=bam, reader=reader,
                            batch_pairs=run.batch_pairs)
        return reader

    def window(self, run, deadline: float) -> None:
        run.gate = Gate(deadline=deadline)
        reader = self._count(run, run.gate, run.out_dir, run.out)
        run.n_fed = run.reads = reader.reads

    def spans(self):
        """The benchmark's spans around the port's host steps, which label
        the card's idle gaps and give host.rescue_share: (owner, method,
        span name)."""
        from subread_tpu_torch.align import pipeline
        from subread_tpu_torch.quant import cellcounts as cc

        A, C = pipeline.Aligner, cc.BatchCellCounter
        return [
            (CyclicReader, "next_batch", "fastq.read"),
            (A, "submit_batch", "submit"), (A, "collect_batch", "collect"),
            (A, "_rescue_saturated", "rescue"),
            (cc, "select_annotated_candidates", "select_annotated_candidates"),
            (cc, "assign_genes_batch", "assign_genes_batch"),
            (C, "add_batch", "BatchCellCounter.add_batch"),
            (C, "finalise", "BatchCellCounter.finalise"),
        ]

    def plant(self, run, fault: str):
        """Break the timed path underneath, for the fault tests: `barcode`,
        the hamming-1 rescue of barcodes off (exact matches only); `umi`,
        no UMI merge (every distinct UMI a molecule).  Returns a function
        that takes the fault out again."""
        from subread_tpu_torch.quant import cellcounts as cc

        if fault == "barcode":
            owner, name = cc.BatchBarcodeMatcher, "match_batch"
            orig = owner.match_batch

            def patched(self, codes):
                out = orig(self, codes)
                exact = self._wl_keys[np.maximum(out, 0)] == cc.pack_codes_2bit(codes)
                return np.where(exact, out, -1).astype(np.int32)
        elif fault == "umi":
            owner, name = cc.BatchCellCounter, "finalise"
            orig = owner.finalise

            def patched(self):
                if not self._packed:
                    return orig(self)
                cell, gene, _ = self._fields(np.unique(np.concatenate(self._packed)))
                cg, n = np.unique(np.stack([cell, gene], axis=1), axis=0,
                                  return_counts=True)
                cells, rank = np.unique(cg[:, 0], return_inverse=True)
                return np.stack([cg[:, 1], rank.ravel(), n], axis=1), cells.tolist()
        else:
            raise ValueError(f"unknown fault {fault!r}")
        setattr(owner, name, patched)

        def undo():
            setattr(owner, name, orig)
        return undo

    def release(self, run) -> None:
        """Free the program's state, keeping the index arrays the check
        reads."""
        run.index_arrays = (run.index.keys, run.index.positions, run.index.orient)
        run.aligner = run.index = run.matcher = run.annotation = None

    def check(self, run) -> dict:
        """The numbers compared for `correct` (their limits are the cell's
        limits file's); run.failed is the read pairs whose record is
        missing, extra or misnamed."""
        limits, pool = run.limits, run.pool
        t = time.perf_counter()
        run.records = rec = read_bam(run.out)
        run.steps["check.bam"] = time.perf_counter() - t
        order_errors, run.ids = check.window_records(rec, pool.r2, run.n_fed)
        run.failed = order_errors
        rng = np.random.default_rng([run.key, 1])
        n_s = min(limits["sample_reads"], run.n_fed)
        sample = np.sort(rng.choice(run.n_fed, size=n_s, replace=False))
        t = time.perf_counter()
        cc = cell_checks(rec, run.ids, pool, run.genome, sample, run.out_dir, run.wl,
                         run.ann.exons(), [g[0] for g in run.ann.genes],
                         run.args.umi_len, run.args.cellCalling)
        run.steps["check.records and matrix"] = time.perf_counter() - t
        for e in cc["examples"]:
            run.log("bench: failed " + " ".join(str(x) for x in e))
        run.log(f"bench: {cc['easy']} easy exonic reads judged; the reference's matrix: "
                f"{cc['cells']} cells, {cc['entries']} entries before cell calling")
        checks = dict(order_errors=order_errors, bad_records=cc["bad_records"],
                      nm_errors=cc["nm_errors"], tag_errors=cc["tag_errors"],
                      matrix_errors=cc["matrix_errors"], missed=cc["missed"])
        t = time.perf_counter()
        keys, positions, orient = run.index_arrays
        checks["index_errors"] = check.index_errors(
            run.genome, keys, positions, orient, run.prefix + ".reads",
            run.config["index"]["index_gap"], run.config["index"]["repeat_threshold"],
            run.sorted_keys, limits["index_sample"], run.key)
        run.steps["check.index"] = time.perf_counter() - t
        return checks

    def context(self, run) -> dict:
        """What the metric readers read: true_placed's reads R2 alone (the
        pool's R2 and its truth, one mate)."""
        return dict(reads=run.reads, n_fed=run.n_fed, index_load_s=run.index_load_s,
                    upload_s=run.upload_s, records=run.records, ids=run.ids,
                    pool=run.pool.r2, genome=run.genome, out=run.out)


TOOL = CellCountsTool("subread_tpu_torch.tools.cellcounts", subjunc=False)
