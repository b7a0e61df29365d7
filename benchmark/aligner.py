"""The runs of a short-read aligner configuration (`subread-align`,
`subjunc`): what harness.run_cell asks of a tool, for the port's Aligner.

Set-up makes the genome from the configuration's fixed seed, builds the
index the way a user does (`subread-buildindex` with its defaults, on the
genome's FASTA) into `benchmark/cache/` the first time a checkout runs the
configuration and loads it in every run, parses the cell's options as the
CLI does, uploads the index, makes the traffic's pool of reads from the seed
as FASTQ, and aligns two sub-batches of it to warm up every shape the window
uses.  The window is one call of `Aligner.align_file` (single-end) or
`align_file_pe` (paired), as the tool's CLI makes it, on a reader that
re-reads the pool from its start and ends the input once the deadline has
passed; the call drains the chunk in flight and closes the BAM.  The check
holds the BAM, the junction table (subjunc) and the index against the plain
reference under `reference/`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

from .frozen import synth
from .frozen.probe_bytes import bound_ms, probe_hits_bytes
from .reference import check
from .reference.bam import read_bam
from .traffic import make_pool

HERE = Path(__file__).resolve().parent
PORT = HERE.parent / "subread_tpu_torch"
# the port's files that decide what an index build writes: a change to one
# of them builds the cached index anew
INDEX_SOURCES = ("index/build.py", "index/genome.py", "tools/buildindex.py",
                 "io/fasta.py", "dna.py")


def genome_of(config: dict) -> synth.Genome:
    g = config["genome"]
    return synth.synthetic_genome(
        [tuple(c) for c in g["contigs"]], g["seed"],
        segdup_frac=g["segdup_frac"], segdup_len=g["segdup_len"],
        tandem_frac=g["tandem_frac"], n_runs_per_contig=g["n_runs_per_contig"])


def index_prefix(config: dict, genome: synth.Genome, cache: Path,
                 log=print) -> tuple[str, float]:
    """The prefix of the configuration's index in the cache, built with
    subread-buildindex's defaults on the genome's FASTA when it is not there
    yet; and the seconds the build took (0 when it was there)."""
    h = hashlib.sha256(json.dumps(config["genome"], sort_keys=True).encode())
    h.update(json.dumps(config["index"]["buildindex"]).encode())
    for f in INDEX_SOURCES:
        h.update((PORT / f).read_bytes())
    d = cache / "index" / h.hexdigest()[:16]
    prefix = str(d / "index")
    if (d / "done").exists():
        return prefix, 0.0
    from subread_tpu_torch.tools import buildindex

    t = time.perf_counter()
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    fasta = d / "genome.fa"
    synth.write_fasta(str(fasta), genome)
    rc = buildindex.main([*config["index"]["buildindex"], "-o", prefix, str(fasta)])
    if rc != 0:
        raise RuntimeError(f"subread-buildindex exited with {rc}")
    fasta.unlink()
    (d / "done").write_text("")
    secs = time.perf_counter() - t
    log(f"bench: built the index of {config['name']}'s genome in {secs:.1f}s")
    return prefix, secs


def reference_keys(config: dict, genome: synth.Genome, prefix: str) -> np.ndarray:
    """The reference's sorted table of the genome's indexed 16-mers
    (check.stepped_keys), worked out once beside the cached index."""
    path = Path(prefix).parent / "reference_keys.npy"
    if not path.exists():
        keys = check.stepped_keys(genome, config["index"]["index_gap"])
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, keys)
        os.replace(tmp, path)
        return keys
    return np.load(path)


class Gate:
    """Whether the next chunk is read: the first mate's reader decides, the
    second follows it."""

    def __init__(self, deadline: float | None = None, chunks: int | None = None):
        self.deadline, self.chunks, self.go, self.n = deadline, chunks, True, 0
        self.times: list[float] = []

    def decide(self) -> bool:
        now = time.perf_counter()
        self.times.append(now)
        self.go = ((self.deadline is None or now < self.deadline)
                   and (self.chunks is None or self.n < self.chunks))
        self.n += self.go
        return self.go


class CyclicReader:
    """The port's FastqReader on a pool's file, re-opened at its end, that
    ends the input when its gate closes.  reads counts what it handed out."""

    def __init__(self, path: str, gate: Gate, lead: bool):
        from subread_tpu_torch.io.fastq import FastqReader

        self._open = lambda: FastqReader(path)
        self._r = self._open()
        self.gate, self.lead, self.reads = gate, lead, 0

    def next_batch(self, max_reads: int, pad_to: int | None = None):
        if not (self.gate.decide() if self.lead else self.gate.go):
            return None
        parts, need, fresh = [], max_reads, False
        while need > 0:
            b = self._r.next_batch(need, pad_to=pad_to)
            if b is None:
                if fresh:
                    raise ValueError("empty read pool")
                self._r.close()
                self._r, fresh = self._open(), True
                continue
            parts.append(b)
            need -= len(b)
            fresh = False
        batch = parts[0] if len(parts) == 1 else _concat(parts)
        self.reads += len(batch)
        return batch

    def close(self):
        self._r.close()


def _concat(parts):
    from subread_tpu_torch.io.fastq import ReadBatch

    w = max(p.codes.shape[1] for p in parts)
    pad = lambda a: np.pad(a, ((0, 0), (0, w - a.shape[1])))
    return ReadBatch(
        names=[n for p in parts for n in p.names],
        codes=np.concatenate([pad(p.codes) for p in parts]),
        lengths=np.concatenate([p.lengths for p in parts]),
        quals=np.concatenate([pad(p.quals) for p in parts]),
        ambig=np.concatenate([pad(p.ambig) for p in parts]),
    )


def _align(aligner, fq: list[str], out: str, chunk: int, gate: Gate):
    """align_file or align_file_pe as run_align calls it, on cyclic readers;
    returns the first mate's reader."""
    readers = [CyclicReader(p, gate, lead=(j == 0)) for j, p in enumerate(fq)]
    if len(fq) == 2:
        aligner.align_file_pe(fq[0], fq[1], out, chunk_reads=chunk // 2,
                              readers=tuple(readers))
    else:
        aligner.align_file(fq[0], out, chunk_reads=chunk, reader=readers[0])
    return readers[0]


class ProbeLaunches:
    """While active, keeps the inputs of every probe_hits call the vote
    makes, so their bytes can be counted once the window has closed."""

    def __enter__(self):
        from subread_tpu_torch.ops import vote

        self.calls, self._vote = [], vote
        self._orig = vote.probe_hits

        def kept(keys, valid, orient, off, *ix_h):
            self.calls.append(((keys, valid, orient, off), ix_h[:7], ix_h[7]))
            return self._orig(keys, valid, orient, off, *ix_h)

        vote.probe_hits = kept
        return self

    def __exit__(self, *exc):
        self._vote.probe_hits = self._orig

    def bound_s(self) -> float:
        return sum(bound_ms(probe_hits_bytes(a, ix, h)) for a, ix, h in self.calls) / 1e3


class AlignerTool:
    """A short-read aligner configuration's runs.  cli names the port's
    module whose build_parser() parses the tool's options; subjunc says
    whether the tool is subjunc (config_from_args' flag, and the junction
    table is checked)."""

    kernel = "probe_hits_kernel"
    faults = ("unchanged", "half", "altered")

    def __init__(self, cli: str, subjunc: bool):
        self.cli, self.subjunc = cli, subjunc

    def setup(self, run) -> None:
        from subread_tpu_torch.align.pipeline import Aligner
        from subread_tpu_torch.tools import align as align_cli

        config, ov, steps = run.config, run.overrides, run.steps
        t = time.perf_counter()
        run.genome = genome_of(config)
        steps["genome"] = time.perf_counter() - t
        run.prefix, run.build_s = index_prefix(config, run.genome, run.cache, run.log)
        t = time.perf_counter()
        run.sorted_keys = reference_keys(config, run.genome, run.prefix)
        steps["reference keys"] = time.perf_counter() - t
        t = time.perf_counter()
        run.pool = make_pool(run.genome, run.traffic, run.key, ov.get("pool"))
        steps["pool"] = time.perf_counter() - t
        t = time.perf_counter()
        run.fq = [os.path.join(run.tmp, f"pool_{m + 1}.fq")
                  for m in range(run.pool.mates)]
        for m, path in enumerate(run.fq):
            synth.write_fastq(path, run.pool.names, run.pool.seqs[m], run.pool.qual)
        steps["fastq"] = time.perf_counter() - t
        run.out = os.path.join(run.tmp, "window.bam")
        cli = list(config["cli"]) + (
            ["-M", str(run.limits["control_max_mismatches"])] if run.control else [])
        argv = cli + ["-i", run.prefix, "-r", run.fq[0], "-o", run.out,
                      "--device", run.device]
        if run.pool.mates == 2:
            argv += ["-R", run.fq[1]]
        args = importlib.import_module(self.cli).build_parser().parse_args(argv)
        cfg = align_cli.config_from_args(args, self.subjunc)
        if "batch_reads" in ov:
            cfg = dataclasses.replace(cfg, batch_reads=ov["batch_reads"])
        run.chunk = ov.get("chunk_reads", config["chunk_reads"])
        t = time.perf_counter()
        pgenome, run.index = align_cli.load_index_any(run.prefix)
        run.index_load_s = time.perf_counter() - t
        t = time.perf_counter()
        run.aligner = Aligner(pgenome, run.index, cfg, device=run.device)
        run.sync()
        run.upload_s = time.perf_counter() - t
        # warm-up: two sub-batches of the pool, chunk by chunk
        t = time.perf_counter()
        _align(run.aligner, run.fq, os.path.join(run.tmp, "warm.bam"),
               cfg.batch_reads * run.pool.mates, Gate(chunks=2))
        run.sync()
        steps["warm"] = time.perf_counter() - t

    def window(self, run, deadline: float) -> None:
        run.gate = Gate(deadline=deadline)
        reader = _align(run.aligner, run.fq, run.out, run.chunk, run.gate)
        run.n_fed = reader.reads
        run.reads = run.n_fed * run.pool.mates

    def spans(self):
        """The benchmark's spans around the port's host steps: (owner,
        method, span name).  A nested call counts in each span around it."""
        from subread_tpu_torch.align import indelevent, pipeline

        A = pipeline.Aligner
        return [
            (CyclicReader, "next_batch", "fastq.read"),
            (A, "submit_batch", "submit"), (A, "submit_batch_pe", "submit"),
            (A, "collect_batch", "collect"), (A, "collect_batch_pe", "collect"),
            (A, "_rescue_saturated", "rescue"), (A, "_rescue_saturated_pe", "rescue"),
            (indelevent, "rescue_unmapped_mates", "rescue"),
            (indelevent, "propose_and_apply", "indel"),
            (pipeline, "refine_multi_indels", "indel"),
            (A, "rescue_with_events", "junction"),
            (A, "chain_clipped_junctions", "junction"),
            (A, "_emit_sam", "emit"), (A, "_emit_sam_pe", "emit"),
        ]

    def traced(self, run):
        """Kept while a traced window runs: the probe_hits launches, whose
        byte bound trace_extra counts once the window has closed."""
        run.probes = ProbeLaunches()
        return run.probes

    def trace_extra(self, run) -> dict:
        bound = run.probes.bound_s()
        run.probes = None
        return {"bound_s": bound}

    def plant(self, run, fault: str):
        """Break the timed path underneath, for the fault tests: `unchanged`,
        a device step whose results come back as it found them (nothing
        mapped); `half`, every other record left out of the BAM; `altered`,
        every 50th read's position moved by one base where the device step
        produces it.  Returns a function that takes the fault out again."""
        from subread_tpu_torch.align import pipeline
        from subread_tpu_torch.io import bam

        saved = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            saved.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def on_results(change):
            def make(orig):
                def f(self, state):
                    out = orig(self, state)
                    for o in (out if isinstance(out, tuple) else (out,)):
                        change(o)
                    return out
                return f
            return make

        if fault == "unchanged":
            def clear(o):
                o["mapped"] = np.zeros_like(np.asarray(o["mapped"], bool))
            patch(pipeline.Aligner, "collect_batch", on_results(clear))
            patch(pipeline.Aligner, "collect_batch_pe", on_results(clear))
        elif fault == "altered":
            def move(o):
                o["pos"] = np.asarray(o["pos"]).copy()
                o["pos"][::50] += 1
            patch(pipeline.Aligner, "collect_batch", on_results(move))
            patch(pipeline.Aligner, "collect_batch_pe", on_results(move))
        elif fault == "half":
            def make(orig):
                n = [0]

                def f(self, fields):
                    n[0] += 1
                    if n[0] % 2:
                        orig(self, fields)
                return f
            patch(bam.BamWriter, "add_sam_fields", make)
        else:
            raise ValueError(f"unknown fault {fault!r}")

        def undo():
            for owner, name, orig in reversed(saved):
                setattr(owner, name, orig)
        return undo

    def release(self, run) -> None:
        """Free the program's state, keeping the index arrays the check
        reads."""
        run.index_arrays = (run.index.keys, run.index.positions, run.index.orient)
        run.aligner = run.index = None

    def check(self, run) -> dict:
        """The numbers compared for `correct` (their limits are the cell's
        limits file's); run.failed is the reads whose record is missing,
        extra or misnamed."""
        limits, pool, log = run.limits, run.pool, run.log
        t = time.perf_counter()
        run.records = rec = read_bam(run.out)
        run.steps["check.bam"] = time.perf_counter() - t
        order_errors, run.ids = check.window_records(rec, pool, run.n_fed)
        run.failed = order_errors
        rng = np.random.default_rng([run.key, 1])
        n_s = min(limits["sample_reads"], run.n_fed)
        sample = np.sort(rng.choice(run.n_fed, size=n_s, replace=False))
        rc = check.record_checks(rec, run.ids, pool, run.genome, sample,
                                 run.config["guarantees"]["max_mismatches"])
        for e in rc["examples"]:
            log("bench: failed " + " ".join(str(x) for x in e))
        checks = dict(order_errors=order_errors, bad_records=rc["bad_records"],
                      nm_errors=rc["nm_errors"],
                      over_mismatch_limit=rc["over_mismatch_limit"],
                      easy_missed=rc["easy_missed"])
        if pool.mates == 2:
            checks["mate_errors"] = rc["mate_errors"]
        if self.subjunc:
            checks["junction_table_errors"] = check.junction_table_errors(
                rec, run.out + ".junction.bed")
        t = time.perf_counter()
        keys, positions, orient = run.index_arrays
        checks["index_errors"] = check.index_errors(
            run.genome, keys, positions, orient, run.prefix + ".reads",
            run.config["index"]["index_gap"], run.config["index"]["repeat_threshold"],
            run.sorted_keys, limits["index_sample"], run.key)
        run.steps["check.index"] = time.perf_counter() - t
        return checks

    def context(self, run) -> dict:
        """What the metric readers read besides the harness's own fields."""
        return dict(reads=run.reads, n_fed=run.n_fed, index_load_s=run.index_load_s,
                    upload_s=run.upload_s, records=run.records, ids=run.ids,
                    pool=run.pool, genome=run.genome, out=run.out)

    def summary(self, run) -> str:
        return (f"index build {run.build_s:.1f}s, load {run.index_load_s:.3f}s, "
                f"upload {run.upload_s:.3f}s; chunks read at "
                + ", ".join(f"{x - run.w0:.2f}" for x in run.gate.times) + "s")
