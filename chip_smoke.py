#!/usr/bin/env python3
"""Smoke run of the PyTorch port (subread_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 100] [--reads 200000] [--pairs 100000]
                          [--spliced-reads 100000] [--spliced-pairs 50000]
                          [--long-reads 300] [--cell-pairs 200000]
                          [--snp-region-mb 2]
                          [--seed 7]

Phases; each one passes or ends the run with a non-zero exit:

  0. toolchain facts: the card (nvidia-smi), torch and CUDA versions, nvcc,
     whether triton imports, whether the port's native host library built
     (else SAM formatting, read packing and the indel DP run their
     pure-Python fallbacks, and every host time below measured those);
  1. build the CUDA kernel (subread_tpu_torch/csrc/probe_hits.cu) with nvcc;
     set-up: a synthetic genome (contigs, segmental duplications, tandem
     arrays of 20-60 copies, N runs), its full hash index (index_gap=1)
     saved under build/smoke/ uncompressed (np.savez in the layout of the
     port's own writer, which load_index_any reads unchanged), and
     simulated 100 bp reads (1% errors, indels, some N) written as FASTQ;
     then the genome as FASTA and the index a user builds from it by
     default: `python -m subread_tpu_torch.tools.buildindex` with no -F
     (every third 16-mer, index_gap=3), saved compressed by the port's
     writer and loaded back, its index_gap checked; the seconds of the
     FASTA write, the build and the save, and the gapped index's entries,
     max_run, bucket_bits, sub_bits and search_steps;
  2. the kernel against its plain PyTorch version on the same CUDA tensors,
     at the main path's shape (8192 reads x 20 probes, H=16) and at the
     rescue tiers' wide shapes (H = rescue_hits; the shapes are
     subread_tpu_torch.probe_bench.smoke_shapes): bit-equal (tolerance 0:
     the outputs are integers), and the median of 20 CUDA-event timings of
     each call (the wrapper's host time included), then the card's own
     time per call of each with a cold L2 and the host's launch time taken
     out (timing.device_ms); beside them the index's bucket_bits, sub_bits
     and search_steps, the bytes the function must move on these inputs,
     the time that takes at the card's memory rate (the bound) and the
     kernel's share of it on the card;
  3. the main path: subread-align through the CLI (run_align, what
     `python -m subread_tpu_torch.tools.align ... --device cuda` runs) on
     all reads; one primary record per read, mapped fraction >= 0.9, at
     least 98% of the mapped reads within 1200 bp of the position their
     simulated name records, and the kernel's launch count > 0 for that run;
  4. the first 8192 reads aligned on the CPU and on the card: identical SAM
     records and .indel.vcf (this holds the CUDA path to the CPU port, which
     the CPU tests hold to the JAX package);
  5. the paired-end path: simulated 100 bp pairs (fragments of 150-500
     bases) through the CLI with -r/-R; two primary records per pair,
     mapped fraction >= 0.9 of reads, proper-pair fraction >= 0.8 of pairs,
     at least 98% of the mapped mates within 1200 bp of their simulated
     position, the kernel launched in that run; and the time of the paired
     selection (_select_pe) and of the whole _device_align_pe on one
     8192-pair sub-batch, each call timed by CUDA events and by the host's
     clock to a synchronise;
  6. the first 8192 pairs aligned on the CPU and on the card: identical SAM
     records and .indel.vcf;
  7. the long-indel rescue (-I 60) on reads across planted 20-40 base
     deletions and 20 base insertions, on the CPU and on the card:
     identical records, with long D and I CIGARs among them;
  8. subjunc, single-end, through the CLI (run_align with subjunc's
     defaults, what `python -m subread_tpu_torch.tools.subjunc ... --device
     cuda` runs) on spliced 100 bp reads (introns at the genome's own
     GT..AG and CT..AC sites, short flanks, two-intron reads, 2% chimeras;
     subread_tpu_torch.synth): one primary record per read, the mapped
     fraction, the share of reads across planted introns whose CIGAR has
     each of them as an N at its planted edges, the .junction.bed's recall
     and precision against the planted junctions, the kernel launched; then,
     on an aligner with the run's options and one sub-batch of its reads,
     the kernel against its plain version at subjunc's shapes (8192 reads
     x 28 probes, H=16, and the tiers' wide shapes), as in phase 2, and
     `_select_se_junc`, the whole `_device_align` and one
     `rescue_with_events` call against the run's junction table, each
     timed by CUDA events and by the host's clock;
  9. subjunc, paired-end, with --allJunctions on spliced pairs: the same
     checks per mate, the proper-pair fraction, and the share of planted
     fusions that .breakpoints.vcf holds;
 10. subjunc with --allJunctions and -a (a GTF of planted junctions) on the
     first 8192 spliced reads and 4096 spliced pairs, on the CPU and on the
     card: identical SAM records, .junction.bed, .breakpoints.vcf and
     .indel.vcf;
 11. sublong through its CLI (`python -m subread_tpu_torch.tools.sublong
     ... --device cuda`) on long reads of 2-20 kb (2% substitutions and
     one-base indels, both strands, a fifth across a planted 300-base
     deletion; synth.synthetic_long_reads): every read in the SAM, the
     mapped share, the share within 1200 bp of its simulated start, the
     share of planted deletions written as a D or an N of at least 250
     bases, both kernels launched (probe_hits, and banded_dp once a chunk
     with stretches to refine); the probe_hits kernel against its plain
     version at sublong's shapes (2048 windows x 20 probes, H=16, and its
     tiers' wide shapes), as in phase 2; reads/s, windows/s and the host
     seconds of chaining and of the batched refinement; the banded_dp
     kernel against its plain version and banded_align on the CLI run's
     largest chunk of stretches, op for op, with its device ms (CUDA
     events, cold L2), its band cells, the bound of its traceback bytes at
     3.35 TB/s and the longest segment's rows (the serial chain that
     bounds it); then the first 25 reads through sublong_file on the CPU
     and on the card, with sublong's options and with -X's: identical SAM
     records (the CPU refining with banded_dp's plain version, the card
     with the kernel);
 12. featureCounts on a GTF of synthetic genes at GENCODE's density
     (about 20 genes and 500 exon rows per Mb, multi-exon transcripts,
     genes overlapping on both strands; synth.synthetic_genes): phase 3's
     SAM with -s 0 and -s 1, phase 5's with -p --countReadPairs, through
     the CLI with the host engine, with --deviceCounts --device cuda and
     with --deviceCounts --device cpu.  The card's count and summary files
     equal the CPU's, single-end they equal the host engine's, and the
     stderr line shows the device counted; paired, the two engines differ
     as the JAX package's do (a gene hit by both mates beats one hit by
     one in the host engine; the device counter calls such fragments
     ambiguous), and only so.  DeviceCounter.count on the card equals it
     on the CPU in counts, summary and per-read status; its time on
     phase 3's sections repeated 10 times, by CUDA events and by the
     host clock on the same calls, beside the host engine's seconds on
     the same records;
 13. cellCounts in FASTQ mode through its CLI (`python -m
     subread_tpu_torch.tools.cellcounts ... --cellCalling --device cuda`)
     on single-cell read pairs (R1 a 16-base barcode and a 12-base UMI,
     cells drawn from a whitelist five times their number, R2 100 bases
     of phase 12's transcripts, 1% errors; synth.synthetic_cell_reads):
     cells called, the share of the planted cells called, the share of
     R2 reads assigned to a gene, the kernel launched; the kernel against
     its plain version at cellCounts' shapes (2048 reads x 28 probes,
     H=16, and its tiers' wide shapes); then the first 4096 pairs on the
     CPU and on the card: identical matrix.mtx, barcodes.tsv and
     features.tsv;
 14. exactSNP on a diploid sample (synth.synthetic_snp_sample: one planted
     SNP per kb in 2 Mb of the first contig, half heterozygous, 30x of
     100 bp reads with 1% errors from either haplotype, about 600,000
     reads): aligned through the CLI on the card with BAM out (the
     kernel launched), phase 1's FASTA of the genome, `python -m
     subread_tpu_torch.tools.exactsnp` over the whole BAM (its seconds),
     the recall of homozygous and of heterozygous planted SNPs and the
     precision; on the first 20,000 reads, over the first contig, the
     native pileup's VCF equal to the Python record path's; subindel's
     output on the whole BAM; propmapped (whose counts must equal the
     phase's own), qualityScores, removeDup, sam2fq and repair on the first
     20,000 reads' BAM;
 15. the multi-device paths (subread_tpu_torch.parallel) on a mesh that
     names cuda:0 four times (2 x 2 for the index mesh) and, where the
     machine has more cards, on the first two: sharded_align_step on 8192
     of phase 3's reads bit-equal to _device_align on every key, with the
     times of both; index_sharded_vote on 4096 reads against an index
     split into 2 position-range shards, bit-equal to the block fold on
     one device on every field of VoteResult (phase 1's gapped index,
     split and stacked on the host, its seconds printed); DeviceCounter.count_sharded
     on phase 3's sections equal to count; map_long_reads_sharded on 20 of
     phase 11's long reads equal to map_long_reads (each path's launches
     counted over its one checked pass, apart from the timing repeats);
     then torch.distributed at world size 1 over NCCL: init, psum_stats,
     allgather_event_table, a barrier, destroy;
 16. the gapped index of phase 1 (subread-buildindex's default): the
     kernel against its plain version on it at subread-align's three
     shapes and subjunc's main shape (H=16; the vote probes each subread
     at its 3 offsets, so [8192 x 60] and [8192 x 84]), bit-equal and
     timed as in phase 2; subread-align through the CLI on phase 3's
     reads (one primary record per read, mapped fraction and the share
     within 1200 bp of the truth against GAPPED_MIN, the kernel
     launched); subjunc with --allJunctions through the CLI on phase 9's
     pairs (the checks of phase 9 against GAPPED_SUBJUNC_PE_MIN, the
     kernel launched); then phase 4's 8192 reads and phase 10's 4096
     pairs (subjunc --allJunctions) on the CPU and on the card: identical
     SAM records and .indel.vcf, and for the pairs .junction.bed and
     .breakpoints.vcf.

The thresholds of phases 8, 9, 11, 13, 14 and 16 come from a CPU run of the
package on the same seeds or generator at a small size (PERF.md).  Every
path's kernel launches are counted from 0 just before it is driven and
read just after; the counts are printed on one line.  It prints the
seconds of every phase as one JSON line ({"phase_seconds": {...}}), the
card's `nvidia-smi --query-gpu=name,power.limit` line and a JSON line
describing the kernels: probe_hits, whose launches are those of the four
main paths (phases 3, 5, 8 and 9; sublong's, cellCounts', phase 14's
alignment, phase 15's multi-device paths and phase 16's runs on the card
are beside them under launches_by_path) and whose times and bound are
phase 2's at the main shape: ms and plain_ms per call, device_ms and
plain_device_ms on the card (library_ms is null: no single PyTorch call
computes this function); and banded_dp, with phase 11's CLI run's
launches and its check's figures; then as its last line {"ok": true,
"device": {...}}.  With no card it exits non-zero at
once.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "subread_tpu_torch/csrc/probe_hits.cu"
KERNEL_REPLACES = "subread_tpu/ops/pallas_probe.py:36"
DP_SOURCE = "subread_tpu_torch/csrc/banded_dp.cu"   # replaces no TPU kernel
# lower bounds of phases 8 (subjunc) and 9 (paired subjunc, --allJunctions),
# set below the JAX package's figures on the same seeds (PERF.md)
SUBJUNC_MIN = dict(mapped=0.9, spliced_share=0.8, recall=0.9, precision=0.9)
SUBJUNC_PE_MIN = dict(mapped=0.9, proper=0.4, spliced_share=0.8, recall=0.9,
                      precision=0.9, fusions=0.6)
# lower bounds of phases 11 (sublong) and 13 (cellCounts), set below the
# port's figures on the CPU on the same generators (PERF.md)
SUBLONG_MIN = dict(mapped=0.95, near_truth=0.9, deletions=0.6)
CELLCOUNTS_MIN = dict(cells_found=0.9, assigned=0.5)
# lower bounds of phase 14 (exactSNP), set below the JAX package's figures
# on the same generator at a small size (tests/test_torch_exactsnp.py)
EXACTSNP_MIN = dict(hom_recall=0.85, het_recall=0.85, precision=0.9)
# lower bounds of phase 3 (subread-align on the full index)
SINGLE_END_MIN = dict(mapped=0.9, near_truth=0.98)
# lower bounds of phase 16 (the gapped index: subread-align single-end,
# subjunc paired-end with --allJunctions), set below the JAX package's
# figures on the same generators at a small size (tests/test_torch_gapped.py)
GAPPED_MIN = dict(mapped=0.9, near_truth=0.98)
GAPPED_SUBJUNC_PE_MIN = dict(mapped=0.9, proper=0.4, spliced_share=0.8,
                             recall=0.9, precision=0.9, fusions=0.6)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sh(*cmd: str) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


def kernel_against_plain(phase, al, batch, vp, shapes):
    """probe_hits against its plain version on the card at each of shapes
    (subread_tpu_torch.probe_bench.probe_shapes).  Bit-equal (tolerance 0)
    or the run fails.  Returns each shape's (kernel ms, plain ms, kernel
    device ms, plain device ms, bound ms) and the largest |kernel - plain|:
    ms is the median of 20 CUDA-event timings of one call, the wrapper's
    host time included; device ms is the card's own time per call with a
    cold L2 (timing.device_ms)."""
    import torch
    from subread_tpu_torch.ops import probe
    from subread_tpu_torch.probe_bench import bound_ms, probe_hits_bytes, probe_shapes
    from subread_tpu_torch.timing import device_ms, stage_ms

    timings, max_err = {}, 0
    for name, r, p, H, a, ix in probe_shapes(al, batch, vp, shapes):
        kv_k, tr_k = probe.probe_hits(*a, *ix, H)
        kv_r, tr_r = probe.probe_hits_reference(*a, *ix, H)
        torch.cuda.synchronize()
        err = int((kv_k - kv_r).abs().max().item()) if kv_k.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(kv_k, kv_r) and torch.equal(tr_k, tr_r),
              f"probe_hits kernel differs from plain at {name} (max |err| {err})")
        kernel = lambda: probe.probe_hits(*a, *ix, H)
        plain = lambda: probe.probe_hits_reference(*a, *ix, H)
        call_k, call_r = stage_ms(kernel)[0], stage_ms(plain)[0]
        dev_k, dev_r = device_ms(kernel), device_ms(plain)
        nbytes = probe_hits_bytes(a, ix, H)
        bound = bound_ms(nbytes)
        timings[name] = (call_k, call_r, dev_k, dev_r, bound)
        hits = int((kv_k != 0xFFFFFFFF).sum().item())
        print(f"{phase}: {name} [{r} x {p}] H={H} (bucket_bits {ix[4]}, "
              f"sub_bits {ix[5]}, search_steps {ix[6]}): "
              f"bit-equal (tolerance 0), {hits} hits, {int(tr_k.sum().item())} "
              f"truncated; per call kernel {call_k:.4f} ms, plain {call_r:.4f} "
              f"ms; on the card with a cold L2 kernel {dev_k:.4f} ms, plain "
              f"{dev_r:.4f} ms, plain/kernel {dev_r / dev_k:.2f}; {nbytes} "
              f"bytes, bound {bound * 1e3:.2f} us, {bound / dev_k:.3f} of the "
              f"bound on the card")
    return timings, max_err


def sam_records(path: Path) -> list[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("@")]


def head_fastq(src: Path, dst: Path, n: int) -> None:
    """The first n records of a FASTQ."""
    with open(src) as f, open(dst, "w") as out:
        for _ in range(4 * n):
            out.write(f.readline())


def cpu_cuda_agree(phase: str, run, n: int, side=(".indel.vcf",)) -> int:
    """run(device) aligns on that device and returns its SAM's path; the
    CPU's and the card's SAM records and side files (SAM path + each
    suffix) must be identical.  Returns the card's run's kernel launches."""
    outs, n_launched = {}, {}
    for d in ("cpu", "cuda"):
        t = time.time()
        outs[d], n_launched[d] = launched(lambda: run(d))
        print(f"{phase}: {n} on {d} in {time.time() - t:.1f}s")
    check(sam_records(outs["cpu"]) == sam_records(outs["cuda"]),
          f"{phase}: SAM records differ between cpu and cuda")
    for suf in side:
        check(Path(str(outs["cpu"]) + suf).read_text()
              == Path(str(outs["cuda"]) + suf).read_text(),
              f"{phase}: {suf} differs between cpu and cuda")
    print(f"{phase}: cpu and cuda agree on {len(sam_records(outs['cpu']))} "
          f"SAM records and the {', '.join(side)}")
    return n_launched["cuda"]


def single_end_metrics(sam, n_reads: int) -> dict:
    """What phases 3 and 16 check on a subread-align SAM of simulated reads:
    the primary records and their distinct names, the mapped fraction of
    the n_reads reads, and the share of mapped reads within 1200 bp of the
    position their name records (contig_pos1_...; synth.synthetic_reads)."""
    primary = [r.split("\t", 4) for r in sam_records(sam)]
    primary = [f for f in primary if int(f[1]) & 0x900 == 0]
    mapped = [f for f in primary if not int(f[1]) & 4]
    near = sum(1 for f in mapped if f[2] == f[0].split("_")[0]
               and abs(int(f[3]) - int(f[0].split("_")[1])) <= 1200)
    return dict(primary=len(primary), distinct=len({f[0] for f in primary}),
                mapped=len(mapped) / n_reads,
                near_truth=near / max(len(mapped), 1))


def banded_dp_against_plain(segments):
    """The banded_dp kernel against its plain version and banded_align on
    segments (one chunk's stretches), op for op, or the run fails.  Returns
    the segments, their band cells, the longest segment's rows, the
    kernel's device ms per call (timing.device_ms: CUDA events, cold L2,
    the uploaded batch), the bound of its traceback bytes (a byte a band
    cell written, at 3.35 TB/s) and the device us a row of the longest
    segment, the serial chain that bounds it."""
    import numpy as np
    import torch
    from subread_tpu_torch.align.longread import banded_align
    from subread_tpu_torch.ops import banded_dp
    from subread_tpu_torch.timing import device_ms

    got = banded_dp.refine(segments, "cuda")
    torch.cuda.synchronize()
    check(got == banded_dp.refine(segments, "cpu"),
          "phase 11: the banded_dp kernel differs from its plain version")
    check(all(ops == banded_align(r, g, extra_band=e)
              for (r, g, e), ops in zip(segments, got)),
          "phase 11: the banded_dp kernel differs from banded_align")
    buf, order, n_wide, cells, slots = banded_dp.pack(segments)
    S = len(order)
    table = buf[: S * len(banded_dp.COLS) * 8].view(np.int64).reshape(S, -1)
    t, r, g = banded_dp.unpack(torch.from_numpy(buf).cuda(), S, int(table[:, 2].sum()))
    ms = device_ms(lambda: banded_dp.banded_dp(t, r, g, n_wide, cells, slots))
    rows = int(table[:, 2].max())
    out = dict(segments=S, wide=n_wide, cells=cells, longest_rows=rows,
               device_ms=ms, bound_ms=cells / 3.35e12 * 1e3,
               us_per_row=ms * 1e3 / max(rows, 1))
    print(f"phase 11: banded_dp kernel equals its plain version and banded_align on "
          f"{S} stretches ({n_wide} wide), {cells} band cells; {ms:.4f} ms on the "
          f"card; traceback bytes at 3.35 TB/s {out['bound_ms']:.4f} ms; longest "
          f"segment {rows} rows, {out['us_per_row']:.3f} us a row")
    return out


def launched(fn):
    """fn() with probe_hits' launches counted from 0 to a synchronise after
    it: (its result, the launches)."""
    import torch
    from subread_tpu_torch.ops import probe

    probe.probe_hits.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, probe.probe_hits.launches


def steps_line(secs: dict) -> str:
    return ", ".join(f"{n} {t:.2f}s" for n, t in secs.items())


def cigar_junctions(contig: str, pos1: int, cigar: str) -> set:
    """(contig, left_edge0, right_edge0) of each N of a CIGAR placed at the
    1-based pos1: the 0-based last base before the intron and first after."""
    out, ref = set(), pos1 - 1
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        if op == "N":
            out.add((contig, ref - 1, ref + int(n)))
        if op in "MDN=X":
            ref += int(n)
    return out


def truth_junctions(name: str, mate: int) -> set:
    """The planted introns a spliced read (or mate 1 / 2 of a spliced pair)
    crosses, from the truth its name records (synth.synthetic_spliced_*)."""
    f = name.split("_")
    if f[0].startswith("sjp"):
        return cigar_junctions(f[1], int(f[2 * mate]), f[2 * mate + 1])
    if f[0].startswith("sj"):
        return cigar_junctions(f[1], int(f[2]), f[4])
    return set()


def bed_junctions(path) -> set:
    """The .junction.bed's rows as (contig, left_edge0, right_edge0,
    donor_strand) keys, the planted truth's format."""
    out = set()
    for line in open(path):
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        start, left = int(f[1]), int(f[10].split(",")[0])
        out.add((f[0], start + left - 1, start + int(f[11].split(",")[1]),
                 int(f[5] == "-")))
    return out


def subjunc_metrics(sam, truth: dict, n_reads: int) -> dict:
    """What phases 8 and 9 check on a subjunc SAM and its .junction.bed:
    the primary records and their distinct (name, mate)s, the mapped
    fraction of the n_reads reads, the share of reads (mates) across
    planted introns whose record has each of them as an N at its planted
    edges, the share of pairs flagged proper, and the .junction.bed's
    recall of the planted junctions with a supporter whose both flanks are
    at least 17 bases and its precision (rows that are planted
    junctions)."""
    primary, mates = 0, set()
    mapped = spliced = hit = proper = 0
    for r in sam_records(sam):
        f = r.split("\t", 6)
        flag = int(f[1])
        if flag & 0x900:
            continue
        primary += 1
        mate = 2 if flag & 0x80 else 1
        mates.add((f[0], mate))
        proper += mate == 1 and bool(flag & 0x2)
        mapped += not flag & 4
        want = truth_junctions(f[0], mate)
        if want:
            spliced += 1
            hit += not flag & 4 and want <= cigar_junctions(
                f[2], int(f[3]), f[5])
    bed = bed_junctions(str(sam) + ".junction.bed")
    planted = {k for k, (_, strong) in truth["junctions"].items() if strong}
    return dict(
        primary=primary, distinct=len(mates), mapped=mapped / n_reads,
        spliced=spliced, spliced_share=hit / max(spliced, 1),
        proper=2 * proper / n_reads, bed_rows=len(bed),
        recall=len(bed & planted) / max(len(planted), 1),
        precision=len(bed & set(truth["junctions"])) / max(len(bed), 1),
    )


def fusion_share(vcf, fusions, tol: int = 10) -> float:
    """The share of planted fusions ((contig, pos1), (contig, pos1)) with a
    breakend pair of the .breakpoints.vcf within tol bases of both ends."""
    ends: dict = {}
    for line in open(vcf):
        if line.startswith("#"):
            continue
        f = line.split("\t")
        m = re.search(r"[\[\]]([^:\[\]]+):(\d+)[\[\]]", f[4])
        if m:
            ends.setdefault((f[0], m.group(1)), []).append(
                (int(f[1]), int(m.group(2))))
    found = 0
    for (ca, pa), (cb, pb) in fusions:
        found += any(
            abs(x - p) <= tol and abs(y - q) <= tol
            for (a, b), (p, q) in (((ca, cb), (pa, pb)), ((cb, ca), (pb, pa)))
            for x, y in ends.get((a, b), ())
        )
    return found / max(len(fusions), 1)


def write_gtf(path, junctions) -> None:
    """A GTF with one two-exon transcript across every third planted
    junction (-a)."""
    with open(path, "w") as f:
        for n, (c, le, re_, ds) in enumerate(sorted(junctions)[::3]):
            s = "-" if ds else "+"
            for a, e in ((le - 48, le + 1), (re_ + 1, re_ + 50)):
                f.write(f'{c}\tsim\texon\t{a}\t{e}\t.\t{s}\t.\t'
                        f'gene_id "g{n}"; transcript_id "t{n}";\n')


def long_read_metrics(sam, n_reads: int) -> dict:
    """What phase 11 checks on a sublong SAM: the records, the mapped
    share, the share of mapped reads within 1200 bp of the start their
    name records (synth.synthetic_long_reads), and the share of reads
    across a planted deletion whose CIGAR has a D or an N of at least 250
    bases."""
    recs = [r.split("\t", 6) for r in sam_records(sam)]
    mapped = [f for f in recs if not int(f[1]) & 4]
    near = dels = planted = 0
    for f in recs:
        _, contig, pos1, _, dl = f[0].split("_")
        planted += dl != "0"
        if int(f[1]) & 4:
            continue
        near += f[2] == contig and abs(int(f[3]) - int(pos1)) <= 1200
        gap = any(int(n) >= 250 for n, op in re.findall(r"(\d+)([DN])", f[5]))
        dels += dl != "0" and gap
    return dict(records=len(recs), mapped=len(mapped) / n_reads,
                near_truth=near / max(len(mapped), 1),
                deletions=dels / max(planted, 1), planted=planted)


def fc_files(out: Path) -> tuple[list[int], dict]:
    """A featureCounts run's per-gene counts (the count file's last column)
    and its summary rows."""
    counts = [int(r.rsplit("\t", 1)[1]) for r in out.read_text().splitlines()[2:]]
    summary = {}
    for r in Path(str(out) + ".summary").read_text().splitlines()[1:]:
        k, v = r.split("\t")
        summary[k] = int(v)
    return counts, summary


def pe_vote_gap(host: Path, device: Path) -> int:
    """How the JAX package's two engines differ on paired fragments, and
    the port's with them: the host engine lets a gene hit by both mates
    beat one hit by a single mate, the device counter calls every fragment
    over two genes ambiguous.  Fails unless every other summary row is
    equal and the host engine assigns exactly the fragments the device
    calls ambiguous beyond its own ambiguous ones, never fewer per gene;
    returns their number."""
    hc, hs = fc_files(host)
    dc, ds = fc_files(device)
    moved = hs["Assigned"] - ds["Assigned"]
    check(moved == ds["Unassigned_Ambiguity"] - hs["Unassigned_Ambiguity"] >= 0
          and all(hs[k] == ds[k] for k in hs
                  if k not in ("Assigned", "Unassigned_Ambiguity"))
          and all(a >= b for a, b in zip(hc, dc)) and sum(hc) - sum(dc) == moved,
          "phase 12: paired host and device counts differ beyond the "
          "two-mates vote rule")
    return moved


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name set to value for the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def first_contig(genome):
    """A Genome of `genome`'s first contig alone."""
    from subread_tpu_torch.index.genome import build_genome
    from subread_tpu_torch.io.fasta import Contig

    lo = int(genome.starts[0])
    hi = lo + int(genome.lengths[0])
    return build_genome([Contig(name=genome.names[0], codes=genome.codes[lo:hi],
                                ambig=genome.get_ambig(lo, hi))])


def bam_head(src: Path, dst: Path, n: int, genome) -> int:
    """The first n records of a BAM as a BAM; returns how many are mapped."""
    from subread_tpu_torch.io import sam as samio
    from subread_tpu_torch.io.bam import bam_to_sam_lines

    w = samio.make_writer(str(dst), list(genome.names),
                          [int(x) for x in genome.lengths], sam_output=False)
    mapped = 0
    for k, f in enumerate(bam_to_sam_lines(str(src))):
        if k == n:
            break
        mapped += not int(f[1]) & 4
        w.write_line("\t".join(f))
    w.close()
    return mapped


def run_quiet(main, argv) -> str:
    """main(argv) with its stderr captured (and echoed); fails unless it
    returns 0.  Returns the stderr text."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"{main.__module__} returned {rc}")
    return err.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--spliced-reads", type=int, default=100_000)
    ap.add_argument("--spliced-pairs", type=int, default=50_000)
    ap.add_argument("--long-reads", type=int, default=300)
    ap.add_argument("--cell-pairs", type=int, default=200_000)
    ap.add_argument("--snp-region-mb", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    t_start = time.time()
    phase_seconds, t_phase = {}, [t_start]

    def done(phase: int) -> None:
        # the seconds of a phase, from the end of the one before
        phase_seconds[phase] = time.time() - t_phase[0]
        t_phase[0] = time.time()
        print(f"chip_smoke: phase {phase} took {phase_seconds[phase]:.1f}s",
              flush=True)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from subread_tpu_torch import cuda_build, dna, native
    from subread_tpu_torch.align import longread
    from subread_tpu_torch.align.pipeline import (
        Aligner, junction_event_arrays, uniform_length,
    )
    from subread_tpu_torch.config import subjunc_config
    from subread_tpu_torch.device import resolve_device, upload
    from subread_tpu_torch.index import build as index_build
    from subread_tpu_torch.index.build import HashIndex, build_hash_index
    from subread_tpu_torch.index.genome import Genome
    from subread_tpu_torch.io.fastq import ReadBatch, batch_from_records
    from subread_tpu_torch.io.gtf import load_annotation
    from subread_tpu_torch.ops import banded_dp, probe
    from subread_tpu_torch.ops.vote import merge_vote_results, vote_batch
    from subread_tpu_torch.parallel import distributed, index_shard
    from subread_tpu_torch.parallel import mesh as pmesh
    from subread_tpu_torch.probe_bench import smoke_shapes
    from subread_tpu_torch.quant import cellcounts, snp
    from subread_tpu_torch.quant.device_count import STATUS_NAMES, DeviceCounter
    from subread_tpu_torch.quant.featurecounts import FCOptions, FeatureCounter
    from subread_tpu_torch.synth import (
        snp_call_metrics, synthetic_cell_reads, synthetic_genes,
        synthetic_genome, synthetic_long_indel_reads, synthetic_long_reads,
        synthetic_pairs, synthetic_reads, synthetic_snp_sample,
        synthetic_spliced_pairs, synthetic_spliced_reads, write_fastq,
        write_genes_gtf, write_genome_fasta,
    )
    from subread_tpu_torch.timing import first_block_vote, host_seconds, stage_ms
    from subread_tpu_torch.tools import align as align_cli
    from subread_tpu_torch.tools import buildindex as buildindex_cli
    from subread_tpu_torch.tools import cellcounts as cc_cli
    from subread_tpu_torch.tools import exactsnp as exactsnp_cli
    from subread_tpu_torch.tools import featurecounts as fc_cli
    from subread_tpu_torch.tools import subjunc as subjunc_cli
    from subread_tpu_torch.tools import subindel as subindel_cli
    from subread_tpu_torch.tools import sublong as sublong_cli
    from subread_tpu_torch.tools import utilities

    # ---- phase 0: toolchain facts ------------------------------------
    card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    card = card.splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvcc: {sh(cuda_build.nvcc(), '--version').splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError:
        print("triton does not import")
    if native.get_lib() is None:
        print("native host library: not built; SAM formatting, read packing "
              "and the indel DP use their pure-Python fallbacks")
    else:
        print(f"native host library: built ({native._build().name})")
    print(f"disk free under the checkout: "
          f"{shutil.disk_usage(ROOT).free / 1e9:.1f} GB")
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    done(0)

    # ---- phase 1: build the kernel, set-up data ----------------------
    t = time.time()
    lib_path, log = cuda_build.build("probe_hits", probe.SOURCES)
    print(f"phase 1: built {lib_path.name} in {time.time() - t:.2f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    work = ROOT / "build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    prefix = str(work / "idx")
    t = time.time()
    genome = synthetic_genome(int(args.genome_mb * 1_000_000), seed=args.seed,
                              n_contigs=4)
    t_gen = time.time() - t
    t = time.time()
    index = build_hash_index(genome, index_gap=1)
    t_index = time.time() - t
    t = time.time()
    # written uncompressed in the port's own layout, which load_index_any
    # reads unchanged: its compressed save and each CLI's load of it were
    # the run's largest fixed costs (PERF.md); phase 16's index goes
    # through the real writer
    with patched(np, "savez_compressed", np.savez):
        genome.save(prefix)
        index.save(prefix)
    t_save = time.time() - t
    t = time.time()
    reads = synthetic_reads(genome, args.reads, seed=args.seed + 1)
    fq = work / "reads.fq"
    write_fastq(str(fq), reads)
    t_reads = time.time() - t
    t = time.time()
    pairs = synthetic_pairs(genome, args.pairs, seed=args.seed + 2)
    fq1, fq2 = work / "r1.fq", work / "r2.fq"
    write_fastq(str(fq1), pairs[0])
    write_fastq(str(fq2), pairs[1])
    t_pairs = time.time() - t
    print(f"set-up: genome {genome.total} bases ({t_gen:.1f}s), index "
          f"{index.n_items} entries, max_run {index.max_run} ({t_index:.1f}s), "
          f"saved uncompressed ({t_save:.1f}s, "
          f"{Path(prefix + '.hash.npz').stat().st_size} bytes); "
          f"{len(reads)} reads ({t_reads:.1f}s); "
          f"{args.pairs} pairs ({t_pairs:.1f}s)")
    # the index a user builds by default: the genome as FASTA, then
    # subread-buildindex with no -F (every third 16-mer, index_gap=3),
    # saved compressed by the port's own writer
    fa = work / "genome.fa"
    t = time.time()
    write_genome_fasta(str(fa), genome)
    t_fa = time.time() - t
    prefix3 = str(work / "idx3")
    steps = [(index_build, "build_hash_index", "build"),
             (HashIndex, "save", "save"), (Genome, "save", "save")]
    t = time.time()
    with host_seconds(steps) as secs1:
        run_quiet(buildindex_cli.main, ["-o", prefix3, str(fa)])
    t_bi = time.time() - t
    t = time.time()
    genome3, index3 = align_cli.load_index_any(prefix3)
    t_load3 = time.time() - t
    check(isinstance(index3, HashIndex) and index3.index_gap == 3,
          f"phase 1: buildindex's default index has index_gap "
          f"{getattr(index3, 'index_gap', None)}, not 3")
    _, _, sub_bits3, steps3 = index3.sub_dir
    print(f"phase 1: gapped index: FASTA written ({t_fa:.1f}s); "
          f"tools.buildindex with default options {t_bi:.1f}s (build "
          f"{secs1['build']:.1f}s, compressed save {secs1['save']:.1f}s); "
          f"loaded ({t_load3:.1f}s): index_gap {index3.index_gap}, "
          f"{index3.n_items} entries, max_run {index3.max_run}, bucket_bits "
          f"{index3.bucket_bits}, sub_bits {sub_bits3}, search_steps {steps3}")
    done(1)

    # ---- phase 2: kernel against plain on the card -------------------
    cfg = align_cli.config_from_args(
        align_cli.build_parser().parse_args(
            ["-t", "1", "-i", prefix, "-r", str(fq), "-o", "-"]
        )
    )
    al_cuda = Aligner(genome, index, cfg, device=dev)
    R = 8192
    batch = al_cuda._upload_reads(
        reads.codes[:R], reads.ambig[:R], reads.lengths[:R]
    )
    vp = al_cuda.vote_params
    timings, max_err = kernel_against_plain(
        "phase 2", al_cuda, batch, vp, smoke_shapes(al_cuda, R, subjunc=False))
    del batch
    torch.cuda.empty_cache()
    done(2)

    # ---- phase 3: the main path through the CLI ----------------------
    sam = work / "out.sam"
    argv = ["-t", "1", "-i", prefix, "-r", str(fq), "-o", str(sam),
            "--device", "cuda"]
    launches = {}
    run, launches["single-end (phase 3)"] = launched(
        lambda: align_cli.run_align(align_cli.build_parser().parse_args(argv)))
    m3 = single_end_metrics(sam, len(reads))
    check(m3["primary"] == len(reads) and m3["distinct"] == len(reads),
          f"{m3['primary']} primary records for {len(reads)} reads")
    for k, lo in SINGLE_END_MIN.items():
        check(m3[k] >= lo, f"phase 3: {k} {m3[k]:.4f} < {lo}")
    check(launches["single-end (phase 3)"] > 0,
          "the single-end path never launched the probe_hits kernel")
    rps = len(reads) / run["time_align"]
    print(f"phase 3: {len(reads)} reads, mapped fraction {m3['mapped']:.4f}, "
          f"{m3['near_truth']:.4f} of them within 1200 bp of the truth, "
          f"{launches['single-end (phase 3)']} kernel launches; "
          f"{rps:.1f} reads/s over align_file "
          f"({run['time_align']:.2f}s); host seconds in {steps_line(run['spans'])}")
    done(3)

    # ---- phase 4: CUDA against CPU ------------------------------------
    n4 = min(8192, len(reads))
    fq4 = work / "reads8k.fq"
    head_fastq(fq, fq4, n4)

    def run4(d):
        al = al_cuda if d == "cuda" else Aligner(genome, index, cfg, device=d)
        al.align_file(str(fq4), str(work / f"p4_{d}.sam"))
        return work / f"p4_{d}.sam"

    cpu_cuda_agree("phase 4", run4, n4)
    done(4)

    # ---- phase 5: the paired-end path through the CLI ------------------
    sam5 = work / "pe.sam"
    argv = ["-t", "1", "-i", prefix, "-r", str(fq1), "-R", str(fq2),
            "-o", str(sam5), "--device", "cuda"]
    run, launches["paired-end (phase 5)"] = launched(
        lambda: align_cli.run_align(align_cli.build_parser().parse_args(argv)))
    n_pairs = args.pairs
    primary = [r.split("\t", 4) for r in sam_records(sam5)]
    primary = [f for f in primary if int(f[1]) & 0x900 == 0]
    first = [f for f in primary if int(f[1]) & 0x40]
    second = [f for f in primary if int(f[1]) & 0x80]
    check(len(first) == n_pairs and len(second) == n_pairs
          and [f[0] for f in first] == [f[0] for f in second]
          and len(primary) == 2 * n_pairs,
          f"{len(primary)} primary records for {n_pairs} pairs")
    mapped = [(f, m) for m, part in ((1, first), (2, second))
              for f in part if not int(f[1]) & 4]
    frac = len(mapped) / (2 * n_pairs)
    check(frac >= 0.9, f"paired-end mapped fraction {frac:.4f} < 0.9")
    proper = sum(1 for f in first if int(f[1]) & 0x2) / n_pairs
    check(proper >= 0.8, f"proper-pair fraction {proper:.4f} < 0.8")
    # the name records contig_pos1_pos2_...: mate 1 at pos1, mate 2 at pos2
    correct = sum(
        1 for f, m in mapped
        if f[2] == f[0].split("_")[0]
        and abs(int(f[3]) - int(f[0].split("_")[m])) <= 1200
    ) / len(mapped)
    check(correct >= 0.98,
          f"only {correct:.4f} of mapped mates at their truth")
    check(launches["paired-end (phase 5)"] > 0,
          "the paired-end path never launched the probe_hits kernel")
    rps_pe = 2 * n_pairs / run["time_align"]
    print(f"phase 5: {n_pairs} pairs, mapped fraction {frac:.4f} of reads, "
          f"proper-pair fraction {proper:.4f} of pairs, {correct:.4f} of "
          f"mapped mates within 1200 bp of the truth, "
          f"{launches['paired-end (phase 5)']} kernel launches; "
          f"{rps_pe:.1f} reads/s ({rps_pe / 2:.1f} pairs/s) over align_file_pe "
          f"({run['time_align']:.2f}s; host seconds in {steps_line(run['spans'])})")
    # the paired selection alone on one sub-batch of the main pass
    bs = cfg.batch_reads
    p1, p2 = pairs
    m1 = al_cuda._upload_reads(p1.codes[:bs], p1.ambig[:bs], p1.lengths[:bs])
    m2 = al_cuda._upload_reads(p2.codes[:bs], p2.ambig[:bs], p2.lengths[:bs])
    vp8 = al_cuda.vote_params._replace(top_k=max(al_cuda.vote_params.top_k, 8))
    scs = []
    for c, a, ln in (m1, m2):
        v = first_block_vote(al_cuda, c, a, ln, vp8, 100)
        scs.append(al_cuda._score_candidates(c, a, ln, v, cfg.min_votes_second, 100))
    etl = (cfg.min_fragment + cfg.max_fragment) // 2
    sel_ev, sel_wall = stage_ms(
        lambda: al_cuda._select_pe(m1[2], m2[2], *scs, etl))
    ul1 = uniform_length(p1.lengths[:bs])
    ul2 = uniform_length(p2.lengths[:bs])
    all_ev, all_wall = stage_ms(
        lambda: al_cuda._device_align_pe(*m1, *m2, ul1=ul1, ul2=ul2), 10)
    print(f"phase 5: one {bs}-pair sub-batch, medians of the same timed calls "
          f"(CUDA events / host clock to a synchronise): _select_pe "
          f"[{bs} x {vp8.top_k} x {vp8.top_k}] {sel_ev:.4f} / {sel_wall:.4f} ms "
          f"(20 calls); whole _device_align_pe {all_ev:.4f} / "
          f"{all_wall:.4f} ms (10 calls); _select_pe's share "
          f"{sel_ev / all_ev:.4f} / {sel_wall / all_wall:.4f}")
    del m1, m2, scs
    torch.cuda.empty_cache()
    done(5)

    # ---- phase 6: paired-end, CUDA against CPU -------------------------
    n6 = min(8192, n_pairs)
    f61, f62 = work / "r1_8k.fq", work / "r2_8k.fq"
    head_fastq(fq1, f61, n6)
    head_fastq(fq2, f62, n6)

    def run6(d):
        al = al_cuda if d == "cuda" else Aligner(genome, index, cfg, device=d)
        al.align_file_pe(str(f61), str(f62), str(work / f"p6_{d}.sam"))
        return work / f"p6_{d}.sam"

    launches["paired-end 8k pairs (phase 6)"] = cpu_cuda_agree("phase 6", run6, n6)
    check(launches["paired-end 8k pairs (phase 6)"] > 0,
          "phase 6 never launched the probe_hits kernel")
    done(6)

    # ---- phase 7: the long-indel rescue (-I 60), CUDA against CPU -----
    li = synthetic_long_indel_reads(genome, n_sites=12, n_sim=300,
                                    seed=args.seed + 3)
    fq7 = work / "longindel.fq"
    write_fastq(str(fq7), li)
    cfg7 = align_cli.config_from_args(align_cli.build_parser().parse_args(
        ["-t", "1", "-i", prefix, "-r", str(fq7), "-o", "-", "-I", "60"]
    ))

    def run7(d):
        al = Aligner(genome, index, cfg7, device=d)
        al.align_file(str(fq7), str(work / f"p7_{d}.sam"))
        return work / f"p7_{d}.sam"

    launches["long-indel -I 60 (phase 7)"] = cpu_cuda_agree("phase 7", run7, len(li))
    ops = [(int(n), op) for r in sam_records(work / "p7_cuda.sam")
           for n, op in re.findall(r"(\d+)([DI])", r.split("\t")[5])]
    n_del = sum(1 for n, op in ops if op == "D" and n > 16)
    n_ins = sum(1 for n, op in ops if op == "I" and n > 16)
    check(n_del > 0 and n_ins > 0,
          f"phase 7: {n_del} long D and {n_ins} long I CIGAR operations")
    check(launches["long-indel -I 60 (phase 7)"] > 0,
          "phase 7 never launched the probe_hits kernel")
    print(f"phase 7: {len(li)} reads with -I 60: {n_del} long D and {n_ins} "
          f"long I CIGAR operations")
    del al_cuda
    torch.cuda.empty_cache()
    done(7)

    # ---- phase 8: subjunc single-end through the CLI -------------------
    t = time.time()
    sp, sp_truth = synthetic_spliced_reads(genome, args.spliced_reads,
                                           seed=args.seed + 4)
    fq8 = work / "spliced.fq"
    write_fastq(str(fq8), sp)
    print(f"phase 8: set-up: {len(sp)} spliced reads across "
          f"{len(sp_truth['junctions'])} planted junctions, "
          f"{len(sp_truth['fusions'])} chimeras ({time.time() - t:.1f}s)")
    sam8 = work / "sj.sam"
    argv = ["-i", prefix, "-r", str(fq8), "-o", str(sam8), "--device", "cuda"]
    run, launches["subjunc (phase 8)"] = launched(lambda: align_cli.run_align(
        subjunc_cli.build_parser().parse_args(argv), subjunc=True))
    m8 = subjunc_metrics(sam8, sp_truth, len(sp))
    check(m8["primary"] == len(sp) and m8["distinct"] == len(sp),
          f"phase 8: {m8['primary']} primary records for {len(sp)} reads")
    for k, lo in SUBJUNC_MIN.items():
        check(m8[k] >= lo, f"phase 8: {k} {m8[k]:.4f} < {lo}")
    check(launches["subjunc (phase 8)"] > 0,
          "subjunc never launched the probe_hits kernel")
    print(f"phase 8: {len(sp)} spliced reads, mapped fraction "
          f"{m8['mapped']:.4f}; {m8['spliced_share']:.4f} of the "
          f"{m8['spliced']} reads across planted introns have them as N; "
          f".junction.bed {m8['bed_rows']} rows, recall {m8['recall']:.4f}, "
          f"precision {m8['precision']:.4f}; "
          f"{launches['subjunc (phase 8)']} kernel launches; "
          f"{len(sp) / run['time_align']:.1f} reads/s over align_file "
          f"({run['time_align']:.2f}s; host seconds in "
          f"{steps_line(run['spans'])})")

    # the kernel against plain at subjunc's shapes, and the junction
    # stages, on one sub-batch, on an aligner with the run's options
    cfg8 = align_cli.config_from_args(subjunc_cli.build_parser().parse_args(
        ["-i", prefix, "-r", "-", "-o", "-"]), subjunc=True)
    al8 = Aligner(genome, index, cfg8, device=dev)
    vp = al8.vote_params
    bs = cfg8.batch_reads
    c8, a8, l8 = al8._upload_reads(sp.codes[:bs], sp.ambig[:bs], sp.lengths[:bs])
    t8, err8 = kernel_against_plain(
        "phase 8", al8, (c8, a8, l8), vp, smoke_shapes(al8, bs, subjunc=True))
    timings.update(t8)
    max_err = max(max_err, err8)
    v8 = first_block_vote(al8, c8, a8, l8, vp, 100)
    sc8 = al8._score_candidates(c8, a8, l8, v8, uniform_len=100)
    sel_ev, sel_wall = stage_ms(
        lambda: al8._select_se_junc(c8, l8, v8, sc8, 100), 10)
    all_ev, all_wall = stage_ms(
        lambda: al8._device_align(c8, a8, l8, uniform_len=100), 10)
    sub = ReadBatch(sp.names[:bs], sp.codes[:bs], sp.lengths[:bs],
                    sp.quals[:bs], sp.ambig[:bs])
    res8 = al8.align_batch(sub)
    table = {k: (0, 0, 0) for k in bed_junctions(str(sam8) + ".junction.bed")}
    ev_l, ev_r, al8._ev_donor = junction_event_arrays(genome, table)
    rwe_ev, rwe_wall = stage_ms(
        lambda: al8.rescue_with_events(sub, res8, ev_l, ev_r), 5)
    print(f"phase 8: one {bs}-read sub-batch, medians of the same timed calls "
          f"(CUDA events / host clock to a synchronise): _select_se_junc "
          f"{sel_ev:.4f} / {sel_wall:.4f} ms, whole _device_align "
          f"{all_ev:.4f} / {all_wall:.4f} ms (10 calls each; share "
          f"{sel_ev / all_ev:.4f} / {sel_wall / all_wall:.4f}); "
          f"rescue_with_events against {len(ev_l)} events "
          f"{rwe_ev:.4f} / {rwe_wall:.4f} ms (5 calls)")
    del al8, c8, a8, l8, v8, sc8, res8
    torch.cuda.empty_cache()
    done(8)

    # ---- phase 9: subjunc paired-end with --allJunctions ---------------
    t = time.time()
    sp1, sp2, spp_truth = synthetic_spliced_pairs(genome, args.spliced_pairs,
                                                  seed=args.seed + 5)
    f91, f92 = work / "sp1.fq", work / "sp2.fq"
    write_fastq(str(f91), sp1)
    write_fastq(str(f92), sp2)
    print(f"phase 9: set-up: {len(sp1)} spliced pairs across "
          f"{len(spp_truth['junctions'])} planted junctions, "
          f"{len(spp_truth['fusions'])} chimeric mates ({time.time() - t:.1f}s)")
    sam9 = work / "sjp.sam"
    argv = ["-i", prefix, "-r", str(f91), "-R", str(f92), "-o", str(sam9),
            "--allJunctions", "--device", "cuda"]
    run, launches["subjunc-pe (phase 9)"] = launched(lambda: align_cli.run_align(
        subjunc_cli.build_parser().parse_args(argv), subjunc=True))
    n9 = 2 * len(sp1)
    m9 = subjunc_metrics(sam9, spp_truth, n9)
    m9["fusions"] = fusion_share(str(sam9) + ".breakpoints.vcf",
                                 spp_truth["fusions"])
    check(m9["primary"] == n9 and m9["distinct"] == n9,
          f"phase 9: {m9['primary']} primary records for {len(sp1)} pairs")
    for k, lo in SUBJUNC_PE_MIN.items():
        check(m9[k] >= lo, f"phase 9: {k} {m9[k]:.4f} < {lo}")
    check(launches["subjunc-pe (phase 9)"] > 0,
          "paired-end subjunc never launched the probe_hits kernel")
    print(f"phase 9: {len(sp1)} spliced pairs, mapped fraction "
          f"{m9['mapped']:.4f} of reads, proper-pair fraction "
          f"{m9['proper']:.4f}; {m9['spliced_share']:.4f} of the "
          f"{m9['spliced']} mates across planted introns have them as N; "
          f".junction.bed {m9['bed_rows']} rows, recall {m9['recall']:.4f}, "
          f"precision {m9['precision']:.4f}; .breakpoints.vcf holds "
          f"{m9['fusions']:.4f} of {len(spp_truth['fusions'])} planted fusions; "
          f"{launches['subjunc-pe (phase 9)']} kernel launches; "
          f"{n9 / run['time_align']:.1f} reads/s over align_file_pe "
          f"({run['time_align']:.2f}s; host seconds in "
          f"{steps_line(run['spans'])})")
    done(9)

    # ---- phase 10: subjunc --allJunctions -a, CUDA against CPU ---------
    n10, n10p = min(8192, len(sp)), min(4096, len(sp1))
    fq10, f101, f102 = work / "sp8k.fq", work / "sp1_4k.fq", work / "sp2_4k.fq"
    head_fastq(fq8, fq10, n10)
    head_fastq(f91, f101, n10p)
    head_fastq(f92, f102, n10p)
    gtf = work / "ann.gtf"
    write_gtf(gtf, sp_truth["junctions"])
    sj_args = subjunc_cli.build_parser().parse_args(
        ["-i", prefix, "-r", "-", "-o", "-", "--allJunctions", "-a", str(gtf)])
    cfg_sj = align_cli.config_from_args(sj_args, subjunc=True)
    annot = align_cli.load_annotated_junctions(sj_args)
    outs = {}
    for d in ("cpu", "cuda"):
        al = Aligner(genome, index, cfg_sj, device=dev if d == "cuda" else d)
        al.annot_junctions = annot
        t = time.time()
        _, n = launched(lambda: (
            al.align_file(str(fq10), str(work / f"p10_{d}.sam")),
            al.align_file_pe(str(f101), str(f102), str(work / f"p10pe_{d}.sam"))))
        if d == "cuda":
            launches["subjunc -a, 8k reads + 4k pairs (phase 10)"] = n
        outs[d] = (work / f"p10_{d}.sam", work / f"p10pe_{d}.sam")
        print(f"phase 10: {n10} reads and {n10p} pairs on {d} in "
              f"{time.time() - t:.1f}s")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        check(sam_records(a) == sam_records(b),
              f"phase 10: SAM records of {a.name} differ between cpu and cuda")
        for suf in (".junction.bed", ".breakpoints.vcf", ".indel.vcf"):
            check(Path(str(a) + suf).read_text() == Path(str(b) + suf).read_text(),
                  f"phase 10: {a.name}{suf} differs between cpu and cuda")
    check(launches["subjunc -a, 8k reads + 4k pairs (phase 10)"] > 0,
          "phase 10 never launched the probe_hits kernel")
    print(f"phase 10: cpu and cuda agree on "
          f"{sum(len(sam_records(a)) for a in outs['cpu'])} SAM records, the "
          f".junction.bed ({len(bed_junctions(str(outs['cpu'][0]) + '.junction.bed'))} "
          f"and {len(bed_junctions(str(outs['cpu'][1]) + '.junction.bed'))} rows), "
          f".breakpoints.vcf and .indel.vcf")
    done(10)

    # ---- phase 11: sublong through its CLI -----------------------------
    t = time.time()
    lr = synthetic_long_reads(genome, args.long_reads, seed=args.seed + 6)
    fq11 = work / "long.fq"
    write_fastq(str(fq11), lr)
    n_win = int((lr.lengths // 100).clip(min=1).sum())
    print(f"phase 11: set-up: {len(lr)} long reads, {int(lr.lengths.sum())} "
          f"bases, {n_win} windows, "
          f"{sum(not n.endswith('_0') for n in lr.names)} across a planted "
          f"deletion ({time.time() - t:.1f}s)")
    sam11 = work / "long.sam"
    argv = ["-i", prefix, "-r", str(fq11), "-o", str(sam11), "--SAMoutput",
            "--device", "cuda"]
    steps = [(Aligner, "submit_batch", "submit_batch"),
             (Aligner, "collect_batch", "collect_batch"),
             (longread, "chain_reads", "chain_reads"),
             (banded_dp, "refine", "banded_dp.refine")]
    # the chunk with the most stretches, for the kernel's own check below
    jobs11 = []

    def keep_largest(segments, device):
        if len(segments) > len(jobs11):
            jobs11[:] = segments
        return refine(segments, device)

    banded_dp.banded_dp.launches = 0
    with host_seconds(steps) as secs11:
        refine = banded_dp.refine
        banded_dp.refine = keep_largest
        try:
            run, launches["sublong (phase 11)"] = launched(lambda: sublong_cli.run_sublong(
                sublong_cli.build_parser().parse_args(argv)))
        finally:
            banded_dp.refine = refine
    dp_launches = banded_dp.banded_dp.launches
    m11 = long_read_metrics(sam11, len(lr))
    check(m11["records"] == len(lr) and run["total"] == len(lr),
          f"phase 11: {m11['records']} records for {len(lr)} long reads")
    for k, lo in SUBLONG_MIN.items():
        check(m11[k] >= lo, f"phase 11: {k} {m11[k]:.4f} < {lo}")
    check(launches["sublong (phase 11)"] > 0,
          "sublong never launched the probe_hits kernel")
    check(dp_launches > 0 and jobs11, "sublong never launched the banded_dp kernel")
    print(f"phase 11: {len(lr)} long reads, mapped {m11['mapped']:.4f}, "
          f"{m11['near_truth']:.4f} of them within 1200 bp of the truth, "
          f"{m11['deletions']:.4f} of {m11['planted']} planted 300-base "
          f"deletions as a D or N >= 250; "
          f"{launches['sublong (phase 11)']} probe_hits and {dp_launches} "
          f"banded_dp launches; "
          f"{len(lr) / run['time_map']:.1f} reads/s, "
          f"{n_win / run['time_map']:.1f} windows/s over sublong_file "
          f"({run['time_map']:.2f}s; index load and upload "
          f"{run['time_load']:.2f}s); host seconds in {steps_line(secs11)}")
    al11 = Aligner(genome, index, sublong_cli.sublong_config(
        sublong_cli.build_parser().parse_args(argv)), device=dev)
    bs = al11.cfg.batch_reads
    win = [lr.codes[i, w * 100:(w + 1) * 100]
           for i in range(len(lr)) for w in range(int(lr.lengths[i]) // 100)][:bs]
    wb = batch_from_records([f"w{k}" for k in range(len(win))],
                            [dna.decode(c).encode() for c in win],
                            [b"I" * 100] * len(win), pad_to=al11.cfg.pad_read_len)
    cap = al11.rescue_fold_cap
    t11, err11 = kernel_against_plain(
        "phase 11", al11, al11._upload_reads(wb.codes, wb.ambig, wb.lengths),
        al11.vote_params, smoke_shapes(al11, bs, subjunc=False, tag="sublong-",
                                       tier_rows=(cap, max(cap // 8, 256))))
    timings.update(t11)
    max_err = max(max_err, err11)
    del al11
    torch.cuda.empty_cache()
    dp11 = banded_dp_against_plain(jobs11)
    dp11["launches"] = dp_launches
    n11 = min(25, len(lr))
    fq11h = work / "long25.fq"
    head_fastq(fq11, fq11h, n11)
    for rna in ([], ["-X"]):
        cfg11 = sublong_cli.sublong_config(sublong_cli.build_parser().parse_args(
            ["-i", prefix, "-r", "-", "-o", "-", *rna]))
        outs = {}
        for d in ("cpu", "cuda"):
            t = time.time()
            outs[d] = work / f"p11{''.join(rna)}_{d}.sam"
            longread.sublong_file(Aligner(genome, index, cfg11,
                                          device=dev if d == "cuda" else d),
                                  str(fq11h), str(outs[d]), sam_output=True)
            print(f"phase 11: {n11} long reads {' '.join(rna)} on {d} in "
                  f"{time.time() - t:.1f}s")
        # the CPU refines with banded_dp's plain version, the card with the kernel
        check(sam_records(outs["cpu"]) == sam_records(outs["cuda"]),
              f"phase 11: SAM records {' '.join(rna)} differ between cpu and cuda")
        print(f"phase 11: cpu and cuda agree on {len(sam_records(outs['cpu']))} "
              f"SAM records {' '.join(rna)}")
    done(11)

    # ---- phase 12: featureCounts, host engine and --deviceCounts ---------
    t = time.time()
    genes = synthetic_genes(genome, max(int(20 * args.genome_mb), 20),
                            seed=args.seed + 7)
    gtf12 = work / "genes.gtf"
    n_rows = write_genes_gtf(str(gtf12), genes)
    ann = load_annotation(str(gtf12))
    print(f"phase 12: set-up: {len(genes)} genes, {n_rows} exon rows "
          f"({time.time() - t:.1f}s)")
    fc_runs = {"single-end -s 0": (sam, ["-s", "0"], 0, False),
               "single-end -s 1": (sam, ["-s", "1"], 1, False),
               "paired-end -p --countReadPairs": (
                   sam5, ["-p", "--countReadPairs"], 0, True)}
    for k, (name, (inp, extra, strand, paired)) in enumerate(fc_runs.items()):
        outs, secs = {}, {}
        for engine in ("host", "cuda", "cpu"):
            outs[engine] = work / f"fc{k}_{engine}.txt"
            flags = (["--device", "cuda"] if engine == "host"
                     else ["--deviceCounts", "--device", engine])
            t = time.time()
            err = run_quiet(fc_cli.main, ["-a", str(gtf12), "-o", str(outs[engine]),
                                          *extra, *flags, str(inp)])
            secs[engine] = time.time() - t
            if engine == "host":
                check("counted on" not in err,
                      f"phase 12: {name}: the host engine's run counted on a device")
            else:
                line = f"// deviceCounts: {inp} counted on {resolve_device(engine)}"
                check(line in err, f"phase 12: {name}: the {engine} run's stderr "
                      f"lacks {line!r}")
        files = {e: (o.read_bytes(), Path(str(o) + ".summary").read_bytes())
                 for e, o in outs.items()}
        check(files["cuda"] == files["cpu"],
              f"phase 12: {name}: --deviceCounts files differ between cuda and cpu")
        if paired:
            moved = pe_vote_gap(outs["host"], outs["cuda"])
            verdict = (f"equal to the cpu's; against the host engine {moved} "
                       f"fragments move from Assigned to Ambiguity (the two-mates "
                       f"vote rule), nothing else differs")
        else:
            check(files["cuda"] == files["host"],
                  f"phase 12: {name}: --deviceCounts files differ from the host engine's")
            verdict = "byte-equal to the host engine's and to the cpu's"
        dcs = [DeviceCounter(ann, strand=strand, max_sections=20 if paired else 10,
                             device=d) for d in (dev, "cpu")]
        secs12 = (dcs[0].fragments_from_file if paired else dcs[0].sections_from_file)(str(inp))
        got = [dc.count(*secs12) for dc in dcs]
        for a, b in zip(*got):
            check(np.array_equal(a, b) and getattr(a, "dtype", 0) == getattr(b, "dtype", 0),
                  f"phase 12: {name}: DeviceCounter.count differs between cuda and cpu")
        summary12 = fc_files(outs["cuda"])[1]
        print(f"phase 12: {name}: --deviceCounts --device cuda files {verdict}; "
              f"DeviceCounter.count equal on cuda and cpu in counts, summary and "
              f"{len(got[0][2])} statuses; assigned {summary12['Assigned']} of "
              f"{sum(summary12.values())}; seconds host engine {secs['host']:.2f}, "
              f"--deviceCounts cuda {secs['cuda']:.2f}, cpu {secs['cpu']:.2f}")
    # DeviceCounter.count on phase 3's sections repeated 10 times
    dc = DeviceCounter(ann, device=dev)
    base = dc.sections_from_file(str(sam))
    rep = tuple(np.ascontiguousarray(np.tile(a, (10,) + (1,) * (a.ndim - 1)))
                for a in base)
    R12 = len(rep[2])
    cnt_ev, cnt_wall = stage_ms(lambda: dc.count(*rep), 10)
    up = tuple(upload(a, dev) for a in rep)
    ker_ev, ker_wall = stage_ms(lambda: dc._kernel(*up), 10)
    del up
    sam10 = work / "x10.sam"
    with open(sam, "rb") as f:
        raw = f.read()
    cut = raw.index(b"\n", raw.rindex(b"\n@")) + 1 if raw.startswith(b"@") else 0
    with open(sam10, "wb") as f:
        f.write(raw[:cut])
        for _ in range(10):
            f.write(raw[cut:])
    del raw
    t = time.time()
    fc = FeatureCounter(ann, FCOptions())
    fc.count_file(str(sam10))
    host_s = time.time() - t
    t = time.time()
    secs_x10 = dc.sections_from_file(str(sam10))
    parse_s = time.time() - t
    out_x10 = dc.count(*secs_x10)
    check(np.array_equal(out_x10[0], fc.counts.astype(np.int32))
          and out_x10[1].tolist() == [fc.summary[n] for n in STATUS_NAMES],
          "phase 12: DeviceCounter on the 10x records differs from the host engine")
    print(f"phase 12: DeviceCounter.count on {R12} records x {rep[0].shape[1]} "
          f"sections (phase 3's, 10 times), medians of the same timed calls (CUDA "
          f"events / host clock to a synchronise): count with upload and read-back "
          f"{cnt_ev:.4f} / {cnt_wall:.4f} ms, _kernel on tensors on the card "
          f"{ker_ev:.4f} / {ker_wall:.4f} ms (10 calls each); on the same records "
          f"from a SAM: the host engine (FeatureCounter, native "
          f"{native.get_lib() is not None}) {host_s:.3f}s, the device path's "
          f"parse (sections_from_file) {parse_s:.3f}s; counts equal")
    del rep, secs_x10
    sam10.unlink()
    done(12)

    # ---- phase 13: cellCounts, FASTQ mode, through its CLI -------------
    t = time.time()
    wl, c1, c2, cells = synthetic_cell_reads(genome, genes, args.cell_pairs,
                                             seed=args.seed + 8)
    wl13 = work / "whitelist.txt"
    wl13.write_text("\n".join(wl) + "\n")
    f131, f132 = work / "cell_r1.fq", work / "cell_r2.fq"
    write_fastq(str(f131), c1)
    write_fastq(str(f132), c2)
    print(f"phase 13: set-up: {len(c1)} read pairs, {len(cells)} cells of a "
          f"{len(wl)}-barcode whitelist ({time.time() - t:.1f}s)")
    cc_args = ["-i", prefix, "-a", str(gtf12), "-c", str(wl13), "--umi-len", "12"]
    steps = [(Aligner, "submit_batch", "submit_batch"),
             (Aligner, "collect_batch", "collect_batch"),
             (cellcounts, "select_annotated_candidates", "select_annotated_candidates"),
             (cellcounts, "assign_genes_batch", "assign_genes_batch"),
             (cellcounts.BatchCellCounter, "add_batch", "barcode match (add_batch)"),
             (cellcounts.BatchCellCounter, "write_matrix", "UMI merge, cell calling, write")]
    t = time.time()
    with host_seconds(steps) as secs13:
        err, launches["cellCounts (phase 13)"] = launched(lambda: run_quiet(
            cc_cli.main, cc_args + ["-r", str(f131), "-R", str(f132), "-o",
                                    str(work / "cc"), "--cellCalling", "--device", "cuda"]))
    t13 = time.time() - t
    st = re.search(r"(\d+) reads, (\d+) barcode-matched, (\d+) assigned", err)
    n_reads, n_bc, n_assigned = (int(x) for x in st.groups())
    called = (work / "cc" / "barcodes.tsv").read_text().split()
    planted = {wl[c] for c in cells}
    m13 = dict(cells_found=len(planted & set(called)) / len(planted),
               assigned=n_assigned / n_reads)
    check(n_reads == len(c1), f"phase 13: {n_reads} reads counted of {len(c1)}")
    for k, lo in CELLCOUNTS_MIN.items():
        check(m13[k] >= lo, f"phase 13: {k} {m13[k]:.4f} < {lo}")
    check(launches["cellCounts (phase 13)"] > 0,
          "cellCounts never launched the probe_hits kernel")
    print(f"phase 13: {n_reads} read pairs, {n_bc / n_reads:.4f} barcode-matched, "
          f"{m13['assigned']:.4f} of R2 reads assigned to a gene; {len(called)} "
          f"cells called, {m13['cells_found']:.4f} of the {len(planted)} planted "
          f"cells among them ({len(planted & set(called)) / max(len(called), 1):.4f} "
          f"of the called are planted); "
          f"{launches['cellCounts (phase 13)']} kernel launches; "
          f"{n_reads / t13:.1f} pairs/s through the CLI ({t13:.2f}s with the index "
          f"load); host seconds in {steps_line(secs13)}")
    cfg13 = subjunc_config(batch_reads=2048, report_multi_mapping=True, multi_best=8)
    al13 = Aligner(genome, index, cfg13, device=dev)
    bs, cap = cfg13.batch_reads, al13.rescue_fold_cap
    t13k, err13 = kernel_against_plain(
        "phase 13", al13, al13._upload_reads(c2.codes[:bs], c2.ambig[:bs],
                                             c2.lengths[:bs]),
        al13.vote_params, smoke_shapes(al13, bs, subjunc=True, tag="cellcounts-",
                                       tier_rows=(cap, max(cap // 8, 256))))
    timings.update(t13k)
    max_err = max(max_err, err13)
    del al13
    torch.cuda.empty_cache()
    n13 = min(4096, len(c1))
    f1h, f2h = work / "cell_r1_4k.fq", work / "cell_r2_4k.fq"
    head_fastq(f131, f1h, n13)
    head_fastq(f132, f2h, n13)
    for d in ("cpu", "cuda"):
        t = time.time()
        run_quiet(cc_cli.main, cc_args + ["-r", str(f1h), "-R", str(f2h),
                                          "-o", str(work / f"p13_{d}"),
                                          "--cellCalling", "--device", d])
        print(f"phase 13: {n13} pairs on {d} in {time.time() - t:.1f}s")
    for f in ("matrix.mtx", "barcodes.tsv", "features.tsv"):
        check((work / "p13_cpu" / f).read_bytes() == (work / "p13_cuda" / f).read_bytes(),
              f"phase 13: {f} differs between cpu and cuda")
    print(f"phase 13: cpu and cuda agree on matrix.mtx, barcodes.tsv and "
          f"features.tsv ({len((work / 'p13_cpu' / 'barcodes.tsv').read_text().split())} "
          f"cells)")
    done(13)
    # ---- phase 14: exactSNP on an aligned diploid sample ----------------
    t = time.time()
    snp_reads, snps = synthetic_snp_sample(
        genome, seed=args.seed + 9, region_len=int(args.snp_region_mb * 1_000_000))
    fq14, fa14 = work / "snp.fq", fa
    write_fastq(str(fq14), snp_reads)
    print(f"phase 14: set-up: {len(snp_reads)} reads over {len(snps)} planted SNPs "
          f"({sum(s[4] for s in snps)} heterozygous) in {args.snp_region_mb:g} Mb of "
          f"{genome.names[0]} ({time.time() - t:.1f}s); the genome's FASTA is "
          f"phase 1's")
    bam14 = work / "snp.bam"
    argv = ["-t", "1", "-i", prefix, "-r", str(fq14), "-o", str(bam14),
            "--device", "cuda"]
    run14, launches["exactSNP align (phase 14)"] = launched(
        lambda: align_cli.run_align(align_cli.build_parser().parse_args(argv)))
    check(run14["total"] == len(snp_reads),
          f"phase 14: {run14['total']} reads aligned of {len(snp_reads)}")
    check(launches["exactSNP align (phase 14)"] > 0,
          "phase 14: the alignment never launched the probe_hits kernel")
    vcf14 = work / "snp.vcf"
    t = time.time()
    run_quiet(exactsnp_cli.main, ["-g", str(fa14), "-i", str(bam14), "-o", str(vcf14)])
    t_snp = time.time() - t
    m14 = snp_call_metrics(str(vcf14), snps)
    for k, lo in EXACTSNP_MIN.items():
        check(m14[k] >= lo, f"phase 14: {k} {m14[k]:.4f} < {lo}")
    print(f"phase 14: {len(snp_reads)} reads, mapped {run14['mapped'] / run14['total']:.4f}, "
          f"{launches['exactSNP align (phase 14)']} kernel launches, "
          f"{len(snp_reads) / run14['time_align']:.1f} reads/s over align_file with BAM "
          f"out ({run14['time_align']:.2f}s; host seconds in "
          f"{steps_line(run14['spans'])}); "
          f"exactSNP over the whole BAM {t_snp:.2f}s (native pileup "
          f"{native.get_lib() is not None}): {m14['called']} SNVs called, recall "
          f"homozygous {m14['hom_recall']:.4f}, heterozygous {m14['het_recall']:.4f}, "
          f"precision {m14['precision']:.4f}")
    # the native pileup against the Python record path on the first 20,000
    # reads, over the SNP region's contig
    n14 = min(20_000, len(snp_reads))
    bam14h, fa14c = work / "snp20k.bam", work / "chr1.fa"
    write_genome_fasta(str(fa14c), first_contig(genome))
    n_mapped_head = bam_head(bam14, bam14h, n14, genome)
    vcfs = {}
    for path in ("native", "python"):
        vcfs[path] = work / f"snp20k_{path}.vcf"
        t = time.time()
        with contextlib.ExitStack() as stack:
            if path == "python":
                stack.enter_context(patched(snp.SNPCaller, "_add_bam_native",
                                            lambda self, p: False))
            run_quiet(exactsnp_cli.main, ["-g", str(fa14c), "-i", str(bam14h),
                                          "-o", str(vcfs[path])])
        print(f"phase 14: exactSNP on the first {n14} reads, {path} pileup, "
              f"{time.time() - t:.2f}s")
    body = lambda f: [x for x in open(f) if not x.startswith("##exactSNP_Commandline")]
    check(native.get_lib() is not None, "phase 14: the native pileup did not build")
    check(body(vcfs["native"]) == body(vcfs["python"]),
          "phase 14: the native pileup's VCF differs from the Python path's")
    print(f"phase 14: native and Python pileups give the same VCF "
          f"({len([x for x in body(vcfs['native']) if not x.startswith('#')])} records)")
    t = time.time()
    err = run_quiet(subindel_cli.main, ["-i", str(bam14), "-g", str(fa14),
                                        "-o", str(work / "subindel.vcf")])
    print(f"phase 14: subindel over the whole BAM ({time.time() - t:.2f}s): "
          f"{err.strip()}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_quiet(utilities.main, ["propmapped", "-i", str(bam14h)])
        run_quiet(utilities.main, ["qualityScores", "-i", str(fq14), "-n", "3"])
    lines = out.getvalue().splitlines()
    _, n_rec, n_map, share = lines[1].split("\t")
    check(int(n_rec) == n14 and int(n_map) == n_mapped_head,
          f"phase 14: propmapped counts {n_map} of {n_rec}, the phase "
          f"{n_mapped_head} of {n14}")
    print(f"phase 14: propmapped on the first {n14} reads' BAM: {lines[1]}; "
          f"qualityScores, first 3 reads: "
          f"{' | '.join(x[:40] for x in lines[2:])}")
    for tool, extra in (("removeDup", ["-o", str(work / "rd.sam")]),
                        ("sam2fq", ["-o", str(work / "back.fq")]),
                        ("repair", ["-o", str(work / "rep.sam")])):
        t = time.time()
        err = run_quiet(utilities.main, [tool, "-i", str(bam14h), *extra])
        out_lines = sum(1 for _ in open(extra[1]))
        print(f"phase 14: {tool} on the first {n14} reads' BAM "
              f"({time.time() - t:.2f}s): {err.strip() or '-'}; "
              f"{out_lines} lines written")
    done(14)

    # ---- phase 15: the multi-device paths --------------------------------
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    meshes = [("cuda:0 x 4", [dev] * 4, (2, 2))]
    if len(devs) > 1:
        meshes.append(("cuda:0, cuda:1", devs[:2], (1, 2)))
    al_cuda = Aligner(genome, index, cfg, device=dev)
    R15 = min(8192, len(reads))
    c15, a15, l15, _ = al_cuda._pad_batch(ReadBatch(
        list(reads.names[:R15]), reads.codes[:R15], reads.lengths[:R15],
        reads.quals[:R15], reads.ambig[:R15]))
    single15 = al_cuda._device_align(*al_cuda._upload_reads(c15, a15, l15))
    one_ev, one_wall = stage_ms(
        lambda: al_cuda._device_align(*al_cuda._upload_reads(c15, a15, l15)), 5)
    t = time.time()
    shards = index_shard.split_index_shards(index3, 2)
    t_split = time.time() - t
    t = time.time()
    bs15, cb15, sb15, sl15, bits15, sbits15 = index_shard.stack_shards(shards)
    t_stack = time.time() - t
    r15 = synthetic_reads(genome, 4096, seed=args.seed + 11)
    vp15 = al_cuda.vote_params._replace(index_gap=index3.index_gap)
    up15 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    fold = None
    for s_ in range(2):
        v = vote_batch(up15(r15.codes), up15(r15.ambig), up15(r15.lengths.astype(np.int32)),
                       up15(bs15[s_].astype(np.int32)), up15(cb15[s_].view(np.int32)),
                       bits15, vp15, sub_base=up15(sb15[s_].astype(np.int32)),
                       sub_lo=up15(sl15[s_].astype(np.int32)), sub_bits=sbits15)
        fold = v if fold is None else merge_vote_results(fold, v, vp15)
    print(f"phase 15: set-up: phase 1's gapped index of {index3.n_items} entries split into 2 "
          f"position-range shards of {[sh.n_items for sh in shards]} entries, "
          f"bucket_bits {bits15}, sub_bits {sbits15} ({t_split:.1f}s), stacked "
          f"({t_stack:.1f}s)")
    dc15 = DeviceCounter(ann, device=dev)
    secs15 = dc15.sections_from_file(str(sam))
    c_one, s_one, _, ov_one = dc15.count(*secs15)
    n_lr15 = min(20, len(lr))
    lr15 = [lr.codes[i, :lr.lengths[i]] for i in range(n_lr15)]
    al15 = Aligner(genome, index, sublong_cli.sublong_config(
        sublong_cli.build_parser().parse_args(["-i", prefix, "-r", "-", "-o", "-"])),
        device=dev)
    t = time.time()
    hits_one = longread.map_long_reads(al15, lr15)
    t_long_one = time.time() - t
    md_launches = {}

    def counted(path, fn):
        # one checked pass of a mesh path, its launches counted from 0;
        # the timing repeats run outside
        out, n = launched(fn)
        md_launches[path] = md_launches.get(path, 0) + n
        return out

    for label, mdevs, (nr, ni) in meshes:
        mesh = pmesh.make_mesh(devices=mdevs)
        step = pmesh.sharded_align_step(mesh, al_cuda)
        got = counted("sharded_align_step", lambda: step(c15, a15, l15))
        bad = [k for k in single15 if not torch.equal(got[k].to(dev), single15[k])]
        check(sorted(got) == sorted(single15) and not bad,
              f"phase 15 [{label}]: sharded_align_step differs from _device_align on {bad}")
        sh_ev, sh_wall = stage_ms(lambda: step(c15, a15, l15), 5)
        print(f"phase 15 [{label}]: sharded_align_step on {R15} of phase 3's reads "
              f"bit-equal to _device_align on all {len(single15)} keys "
              f"({int(single15['saturated'].sum())} still saturated after the tiers); "
              f"medians of 5 calls (CUDA events / host clock): sharded "
              f"{sh_ev:.4f} / {sh_wall:.4f} ms, one device {one_ev:.4f} / "
              f"{one_wall:.4f} ms")
        m2 = index_shard.make_mesh_2d(nr, ni, mdevs)
        placed = index_shard.place_sharded_index(m2, bs15, cb15, sb15, sl15)
        vstep = index_shard.index_sharded_vote(m2, bits15, vp15, sub_bits=sbits15)
        vgot = counted("index_sharded_vote", lambda: vstep(
            r15.codes, r15.ambig, r15.lengths.astype(np.int32), *placed))
        bad = [f for f in fold._fields if not torch.equal(getattr(vgot, f).to(dev),
                                                         getattr(fold, f))]
        check(not bad, f"phase 15 [{label}]: index_sharded_vote differs from the "
                       f"block fold on {bad}")
        print(f"phase 15 [{label}]: index_sharded_vote on a {nr} x {ni} mesh, 4096 "
              f"reads, bit-equal to the block fold on one device on every field; "
              f"{int((vgot.votes[:, 0] > 0).sum())} reads with a candidate")
        c_sh, s_sh, ov_sh = counted("count_sharded",
                                    lambda: dc15.count_sharded(mesh, *secs15))
        check(np.array_equal(c_sh, c_one) and np.array_equal(s_sh, s_one)
              and ov_sh == ov_one,
              f"phase 15 [{label}]: count_sharded differs from count")
        t = time.time()
        hits_sh = counted("map_long_reads_sharded",
                          lambda: longread.map_long_reads_sharded(al15, lr15, mesh))
        t_long_sh = time.time() - t
        check([h.__dict__ for h in hits_sh] == [h.__dict__ for h in hits_one],
              f"phase 15 [{label}]: map_long_reads_sharded differs from map_long_reads")
        print(f"phase 15 [{label}]: count_sharded on phase 3's {len(secs15[2])} "
              f"records equal to count ({int(s_one[0])} assigned); "
              f"map_long_reads_sharded on {n_lr15} long reads equal to "
              f"map_long_reads ({sum(h.mapped for h in hits_one)} mapped; "
              f"{t_long_sh:.2f}s against {t_long_one:.2f}s)")
    launches["multi-device (phase 15)"] = sum(md_launches.values())
    for path in ("sharded_align_step", "index_sharded_vote", "map_long_reads_sharded"):
        check(md_launches[path] > 0,
              f"phase 15: {path} never launched the probe_hits kernel")
    print(f"phase 15: probe_hits launches of one checked pass of each mesh path "
          f"(summed over {len(meshes)} mesh(es)): {json.dumps(md_launches)}")
    del al_cuda, al15, single15, fold, vgot, placed, shards, cb15
    torch.cuda.empty_cache()
    # torch.distributed at world size 1 over NCCL
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    t = time.time()
    check(distributed.init_distributed(f"127.0.0.1:{port}", num_processes=1,
                                       process_id=0, device=dev),
          "phase 15: init_distributed did not start a process group")
    backend = torch.distributed.get_backend()
    check(backend == "nccl", f"phase 15: backend {backend}, not nccl")
    stats = {"mapped": int(run14["mapped"]), "total": int(run14["total"])}
    check(distributed.psum_stats(stats) == stats, "phase 15: psum_stats changed the counts")
    ev = distributed.allgather_event_table(
        np.array([10, 10, 20], np.int64), np.array([50, 50, 70], np.int64),
        np.array([2, 3, 1], np.int64))
    check([a.tolist() for a in ev] == [[10, 20], [50, 70], [5, 1]],
          f"phase 15: allgather_event_table gave {ev}")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"phase 15: torch.distributed over {backend} at world size 1: init, "
          f"psum_stats, allgather_event_table, barrier, destroy "
          f"({time.time() - t:.2f}s); {launches['multi-device (phase 15)']} kernel "
          f"launches on the multi-device paths")
    done(15)

    # ---- phase 16: the default gapped index --------------------------
    cfg16 = align_cli.config_from_args(align_cli.build_parser().parse_args(
        ["-t", "1", "-i", prefix3, "-r", "-", "-o", "-"]))
    cfg16j = align_cli.config_from_args(subjunc_cli.build_parser().parse_args(
        ["-i", prefix3, "-r", "-", "-o", "-", "--allJunctions"]), subjunc=True)
    al16 = Aligner(genome3, index3, cfg16, device=dev)
    al16j = Aligner(genome3, index3, cfg16j, device=dev)
    t16, err16 = kernel_against_plain(
        "phase 16", al16, al16._upload_reads(reads.codes[:R], reads.ambig[:R],
                                             reads.lengths[:R]),
        al16.vote_params, smoke_shapes(al16, R, subjunc=False, tag="gap3-"))
    timings.update(t16)
    max_err = max(max_err, err16)
    t16, err16 = kernel_against_plain(
        "phase 16", al16j, al16j._upload_reads(sp.codes[:R], sp.ambig[:R],
                                               sp.lengths[:R]),
        al16j.vote_params,
        smoke_shapes(al16j, R, subjunc=True, tag="gap3-subjunc-")[:1])
    timings.update(t16)
    max_err = max(max_err, err16)
    torch.cuda.empty_cache()
    # subread-align single-end through the CLI on phase 3's reads
    sam16 = work / "gap3.sam"
    argv = ["-t", "1", "-i", prefix3, "-r", str(fq), "-o", str(sam16),
            "--device", "cuda"]
    run, n_se = launched(lambda: align_cli.run_align(
        align_cli.build_parser().parse_args(argv)))
    m16 = single_end_metrics(sam16, len(reads))
    check(m16["primary"] == len(reads) and m16["distinct"] == len(reads),
          f"phase 16: {m16['primary']} primary records for {len(reads)} reads")
    for k, lo in GAPPED_MIN.items():
        check(m16[k] >= lo, f"phase 16: {k} {m16[k]:.4f} < {lo}")
    check(n_se > 0, "phase 16: subread-align never launched the probe_hits kernel")
    print(f"phase 16: subread-align on the gapped index, {len(reads)} reads, "
          f"mapped fraction {m16['mapped']:.4f}, {m16['near_truth']:.4f} of "
          f"them within 1200 bp of the truth, {n_se} kernel launches; "
          f"{len(reads) / run['time_align']:.1f} reads/s over align_file "
          f"({run['time_align']:.2f}s); index load {run['time_load']:.2f}s, "
          f"upload {run['time_upload']:.2f}s")
    # subjunc paired-end with --allJunctions through the CLI on phase 9's pairs
    sam16p = work / "gap3_sjp.sam"
    argv = ["-i", prefix3, "-r", str(f91), "-R", str(f92), "-o", str(sam16p),
            "--allJunctions", "--device", "cuda"]
    run, n_sj = launched(lambda: align_cli.run_align(
        subjunc_cli.build_parser().parse_args(argv), subjunc=True))
    m16p = subjunc_metrics(sam16p, spp_truth, n9)
    m16p["fusions"] = fusion_share(str(sam16p) + ".breakpoints.vcf",
                                   spp_truth["fusions"])
    check(m16p["primary"] == n9 and m16p["distinct"] == n9,
          f"phase 16: {m16p['primary']} primary records for {len(sp1)} pairs")
    for k, lo in GAPPED_SUBJUNC_PE_MIN.items():
        check(m16p[k] >= lo, f"phase 16: subjunc {k} {m16p[k]:.4f} < {lo}")
    check(n_sj > 0, "phase 16: subjunc never launched the probe_hits kernel")
    print(f"phase 16: subjunc --allJunctions on the gapped index, {len(sp1)} "
          f"spliced pairs, mapped fraction {m16p['mapped']:.4f} of reads, "
          f"proper-pair fraction {m16p['proper']:.4f}; "
          f"{m16p['spliced_share']:.4f} of the {m16p['spliced']} mates across "
          f"planted introns have them as N; .junction.bed {m16p['bed_rows']} "
          f"rows, recall {m16p['recall']:.4f}, precision "
          f"{m16p['precision']:.4f}; .breakpoints.vcf holds "
          f"{m16p['fusions']:.4f} of the planted fusions; {n_sj} kernel "
          f"launches; {n9 / run['time_align']:.1f} reads/s over align_file_pe "
          f"({run['time_align']:.2f}s); index load {run['time_load']:.2f}s")
    # the CPU against the card: phase 4's reads, phase 10's pairs
    def run16(d):
        al = al16 if d == "cuda" else Aligner(genome3, index3, cfg16, device=d)
        al.align_file(str(fq4), str(work / f"p16_{d}.sam"))
        return work / f"p16_{d}.sam"

    def run16pe(d):
        al = al16j if d == "cuda" else Aligner(genome3, index3, cfg16j, device=d)
        al.align_file_pe(str(f101), str(f102), str(work / f"p16pe_{d}.sam"))
        return work / f"p16pe_{d}.sam"

    n_cmp = cpu_cuda_agree("phase 16", run16, n4) + cpu_cuda_agree(
        "phase 16 subjunc --allJunctions", run16pe, n10p,
        side=(".junction.bed", ".breakpoints.vcf", ".indel.vcf"))
    check(n_cmp > 0, "phase 16: the card's runs never launched the probe_hits kernel")
    launches["gapped-index (phase 16)"] = n_se + n_sj + n_cmp
    print(f"phase 16: {launches['gapped-index (phase 16)']} kernel launches on "
          f"the gapped index")
    del al16, al16j
    torch.cuda.empty_cache()
    done(16)
    print(f"probe_hits launches per path: {json.dumps(launches)}")
    shutil.rmtree(work, ignore_errors=True)

    ms_k, ms_r, dev_k, dev_r, bound_ms = timings["main"]
    # the kernels line counts the main paths' runs only (phases 3, 5, 8, 9)
    main_paths = {"single-end": launches["single-end (phase 3)"],
                  "paired-end": launches["paired-end (phase 5)"],
                  "subjunc": launches["subjunc (phase 8)"],
                  "subjunc-pe": launches["subjunc-pe (phase 9)"]}
    print(f"chip_smoke: phases 0-16 passed in {time.time() - t_start:.1f}s")
    print(json.dumps({"phase_seconds": phase_seconds}))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "probe_hits", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(main_paths.values()),
        "launches_by_path": {**main_paths,
                             "sublong": launches["sublong (phase 11)"],
                             "cellcounts": launches["cellCounts (phase 13)"],
                             "exactsnp-align": launches["exactSNP align (phase 14)"],
                             "multi-device": launches["multi-device (phase 15)"],
                             "gapped-index (phase 16)":
                                 launches["gapped-index (phase 16)"]},
        "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_r,
        "device_ms": dev_k, "plain_device_ms": dev_r,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    }, {
        "name": "banded_dp", "route": "cuda", "source": DP_SOURCE,
        "replaces": None, "launches": dp11["launches"],
        "device_ms": dp11["device_ms"], "bound_ms": dp11["bound_ms"],
        "bound_by": "the longest segment's rows, one after another",
        "segments": dp11["segments"], "wide": dp11["wide"],
        "cells": dp11["cells"], "longest_rows": dp11["longest_rows"],
        "us_per_row": dp11["us_per_row"], "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
