#!/usr/bin/env python3
"""Smoke run of the PyTorch port (subread_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--genome-mb 100] [--reads 200000] [--pairs 100000]
                          [--seed 7]

Phases; each one passes or ends the run with a non-zero exit:

  0. toolchain facts: the card (nvidia-smi), torch and CUDA versions, nvcc,
     whether triton imports;
  1. build the CUDA kernel (subread_tpu_torch/csrc/probe_hits.cu) with nvcc;
     set-up: a synthetic genome (contigs, segmental duplications, tandem
     arrays of 20-60 copies, N runs), its full hash index (index_gap=1)
     saved under build/smoke/, and simulated 100 bp reads (1% errors,
     indels, some N) written as FASTQ;
  2. the kernel against its plain PyTorch version on the same CUDA tensors,
     at the main path's shape (8192 reads x 20 probes, H=16) and at the
     rescue tiers' wide shapes (H = rescue_hits): bit-equal (tolerance 0:
     the outputs are integers), and the median of 20 CUDA-event timings of
     each;
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
     identical records, with long D and I CIGARs among them.

Every path's kernel launches are counted from 0 just before it is driven
and read just after; the counts are printed on one line.  It prints the
card's `nvidia-smi --query-gpu=name,power.limit` line and a JSON line
describing the kernel, whose launches are those of the two main paths
(phases 3 and 5), then as its last line {"ok": true, "device": {...}}.
With no card it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "subread_tpu_torch/csrc/probe_hits.cu"
KERNEL_REPLACES = "subread_tpu/ops/pallas_probe.py:36"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sh(*cmd: str) -> str:
    return subprocess.run(
        cmd, capture_output=True, text=True, check=True
    ).stdout.strip()


def timed_ms(fn, n: int = 20) -> tuple[float, float]:
    """Medians of n timings of fn(), after one warm-up call, each call
    timed both ways: CUDA events around it on the card, and the host's
    clock from a synchronised start to the synchronise after it."""
    import torch

    fn()
    ev, wall = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(wall)


def cuda_ms(fn, n: int = 20) -> float:
    """Median of n CUDA-event timings of fn(), after one warm-up call."""
    return timed_ms(fn, n)[0]


def sam_records(path: Path) -> list[str]:
    with open(path) as f:
        return [line for line in f if not line.startswith("@")]


def head_fastq(src: Path, dst: Path, n: int) -> None:
    """The first n records of a FASTQ."""
    with open(src) as f, open(dst, "w") as out:
        for _ in range(4 * n):
            out.write(f.readline())


def cpu_cuda_agree(phase: str, run, n: int) -> None:
    """run(device) aligns on that device and returns its SAM's path; the
    CPU's and the card's SAM records and .indel.vcf must be identical."""
    outs = {}
    for d in ("cpu", "cuda"):
        t = time.time()
        outs[d] = run(d)
        print(f"{phase}: {n} on {d} in {time.time() - t:.1f}s")
    check(sam_records(outs["cpu"]) == sam_records(outs["cuda"]),
          f"{phase}: SAM records differ between cpu and cuda")
    check(Path(str(outs["cpu"]) + ".indel.vcf").read_text()
          == Path(str(outs["cuda"]) + ".indel.vcf").read_text(),
          f"{phase}: .indel.vcf differs between cpu and cuda")
    print(f"{phase}: cpu and cuda agree on {len(sam_records(outs['cpu']))} "
          f"SAM records and the .indel.vcf")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=100.0)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--pairs", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(ROOT))
    from subread_tpu.index.build import build_hash_index
    from subread_tpu_torch import cuda_build
    from subread_tpu_torch.align.pipeline import Aligner, uniform_length
    from subread_tpu_torch.ops import probe
    from subread_tpu_torch.ops.vote import probe_inputs, vote_batch
    from subread_tpu_torch.synth import (
        synthetic_genome, synthetic_long_indel_reads, synthetic_pairs,
        synthetic_reads, write_fastq,
    )
    from subread_tpu_torch.tools import align as align_cli

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
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)

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
          f"saved ({t_save:.1f}s); {len(reads)} reads ({t_reads:.1f}s); "
          f"{args.pairs} pairs ({t_pairs:.1f}s)")

    # ---- phase 2: kernel against plain on the card -------------------
    cfg = align_cli.config_from_args(
        align_cli.build_parser().parse_args(
            ["-t", "1", "-i", prefix, "-r", str(fq), "-o", "-"]
        )
    )
    genome_l, index_l = align_cli.load_index_any(prefix)
    al_cuda = Aligner(genome_l, index_l, cfg, device=dev)
    blk = al_cuda.dev_index.blocks[0]
    R = 8192
    codes, ambig, lens = al_cuda._upload_reads(
        reads.codes[:R], reads.ambig[:R], reads.lengths[:R]
    )
    rescue_hits = al_cuda.rescue_hits
    keys, valid, orient, own, _ = probe_inputs(
        codes, ambig, lens, al_cuda.vote_params, 100
    )
    own_rp = own[None, :].expand(R, -1).contiguous()
    shapes = [
        ("main", R, keys.shape[1], 16),
        ("wide-mixed", 4096, 8, rescue_hits),
        ("wide-full", 512, keys.shape[1], rescue_hits),
    ]
    timings = {}
    max_err = 0
    for name, r, p, H in shapes:
        a = (keys[:r, :p].contiguous(), valid[:r, :p].contiguous(),
             orient[:r, :p].contiguous(),
             own_rp[:r, :p].contiguous() if name != "main" else own)
        ix = (blk.bucket_start, blk.comb, blk.sub_base, blk.sub_lo,
              blk.bucket_bits, blk.sub_bits, blk.search_steps, H)
        kv_k, tr_k = probe.probe_hits(*a, *ix)
        kv_r, tr_r = probe.probe_hits_reference(*a, *ix)
        torch.cuda.synchronize()
        err = int((kv_k - kv_r).abs().max().item()) if kv_k.numel() else 0
        max_err = max(max_err, err)
        check(torch.equal(kv_k, kv_r) and torch.equal(tr_k, tr_r),
              f"probe_hits kernel differs from plain at {name} (max |err| {err})")
        ms_k = cuda_ms(lambda: probe.probe_hits(*a, *ix))
        ms_r = cuda_ms(lambda: probe.probe_hits_reference(*a, *ix))
        timings[name] = (ms_k, ms_r)
        hits = int((kv_k != 0xFFFFFFFF).sum().item())
        print(f"phase 2: {name} [{r} x {p}] H={H}: bit-equal (tolerance 0), {hits} hits, "
              f"{int(tr_k.sum().item())} truncated; kernel {ms_k:.4f} ms, "
              f"plain {ms_r:.4f} ms, plain/kernel {ms_r / ms_k:.2f}")
    del blk, codes, ambig, keys, valid, orient, own, own_rp
    torch.cuda.empty_cache()

    # ---- phase 3: the main path through the CLI ----------------------
    sam = work / "out.sam"
    argv = ["-t", "1", "-i", prefix, "-r", str(fq), "-o", str(sam),
            "--device", "cuda"]
    probe.probe_hits.launches = 0
    run = align_cli.run_align(align_cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    launches = {"single-end (phase 3)": probe.probe_hits.launches}
    recs = sam_records(sam)
    primary = [r.split("\t", 2) for r in recs]   # name, flag, rest
    primary = [f for f in primary if int(f[1]) & 0x900 == 0]
    names = [f[0] for f in primary]
    check(len(names) == len(reads) and len(set(names)) == len(reads),
          f"{len(names)} primary records for {len(reads)} reads")
    mapped = [f for f in primary if not int(f[1]) & 4]
    frac = len(mapped) / len(reads)
    check(frac >= 0.9, f"mapped fraction {frac:.4f} < 0.9")
    # simulated names carry the truth (contig_pos1_..., subread_tpu.utils.
    # simulate): a mapping within 1200 bp of it is correct
    correct = sum(
        1 for f in mapped
        if f[2].split("\t")[0] == f[0].split("_")[0]
        and abs(int(f[2].split("\t")[1]) - int(f[0].split("_")[1])) <= 1200
    ) / len(mapped)
    check(correct >= 0.98, f"only {correct:.4f} of mapped reads at their truth")
    check(launches["single-end (phase 3)"] > 0,
          "the single-end path never launched the probe_hits kernel")
    rps = len(reads) / run["time_align"]
    print(f"phase 3: {len(reads)} reads, mapped fraction {frac:.4f}, "
          f"{correct:.4f} of them within 1200 bp of the truth, "
          f"{launches['single-end (phase 3)']} kernel launches; "
          f"{rps:.1f} reads/s over align_file "
          f"({run['time_align']:.2f}s: device+collect+host indel "
          f"{run['time_voting']:.2f}s, read+emit {run['time_io']:.2f}s); "
          f"index load {run['time_load']:.2f}s, upload {run['time_upload']:.2f}s")

    # ---- phase 4: CUDA against CPU ------------------------------------
    n4 = min(8192, len(reads))
    fq4 = work / "reads8k.fq"
    head_fastq(fq, fq4, n4)

    def run4(d):
        al = al_cuda if d == "cuda" else Aligner(genome_l, index_l, cfg, device=d)
        al.align_file(str(fq4), str(work / f"p4_{d}.sam"))
        return work / f"p4_{d}.sam"

    cpu_cuda_agree("phase 4", run4, n4)

    # ---- phase 5: the paired-end path through the CLI ------------------
    sam5 = work / "pe.sam"
    argv = ["-t", "1", "-i", prefix, "-r", str(fq1), "-R", str(fq2),
            "-o", str(sam5), "--device", "cuda"]
    probe.probe_hits.launches = 0
    run = align_cli.run_align(align_cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    launches["paired-end (phase 5)"] = probe.probe_hits.launches
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
          f"({run['time_align']:.2f}s: device+collect+host indel "
          f"{run['time_voting']:.2f}s, read+emit {run['time_io']:.2f}s)")
    # the paired selection alone on one sub-batch of the main pass
    bs = cfg.batch_reads
    p1, p2 = pairs
    m1 = al_cuda._upload_reads(p1.codes[:bs], p1.ambig[:bs], p1.lengths[:bs])
    m2 = al_cuda._upload_reads(p2.codes[:bs], p2.ambig[:bs], p2.lengths[:bs])
    blk = al_cuda.dev_index.blocks[0]
    vp8 = al_cuda.vote_params._replace(top_k=max(al_cuda.vote_params.top_k, 8))
    scs = []
    for c, a, ln in (m1, m2):
        v = vote_batch(c, a, ln, blk.bucket_start, blk.comb, blk.bucket_bits,
                       vp8, static_len=100, sub_base=blk.sub_base,
                       sub_lo=blk.sub_lo, sub_bits=blk.sub_bits,
                       search_steps=blk.search_steps)
        scs.append(al_cuda._score_candidates(c, a, ln, v, cfg.min_votes_second, 100))
    etl = (cfg.min_fragment + cfg.max_fragment) // 2
    sel_ev, sel_wall = timed_ms(
        lambda: al_cuda._select_pe(m1[2], m2[2], *scs, etl))
    ul1 = uniform_length(p1.lengths[:bs])
    ul2 = uniform_length(p2.lengths[:bs])
    all_ev, all_wall = timed_ms(
        lambda: al_cuda._device_align_pe(*m1, *m2, ul1=ul1, ul2=ul2), n=10)
    print(f"phase 5: one {bs}-pair sub-batch, medians of the same timed calls "
          f"(CUDA events / host clock to a synchronise): _select_pe "
          f"[{bs} x {vp8.top_k} x {vp8.top_k}] {sel_ev:.4f} / {sel_wall:.4f} ms "
          f"(20 calls); whole _device_align_pe {all_ev:.4f} / "
          f"{all_wall:.4f} ms (10 calls); _select_pe's share "
          f"{sel_ev / all_ev:.4f} / {sel_wall / all_wall:.4f}")
    del m1, m2, scs, blk
    torch.cuda.empty_cache()

    # ---- phase 6: paired-end, CUDA against CPU -------------------------
    n6 = min(8192, n_pairs)
    f61, f62 = work / "r1_8k.fq", work / "r2_8k.fq"
    head_fastq(fq1, f61, n6)
    head_fastq(fq2, f62, n6)

    def run6(d):
        al = al_cuda if d == "cuda" else Aligner(genome_l, index_l, cfg, device=d)
        if d == "cuda":
            probe.probe_hits.launches = 0
        al.align_file_pe(str(f61), str(f62), str(work / f"p6_{d}.sam"))
        if d == "cuda":
            torch.cuda.synchronize()
            launches["paired-end 8k pairs (phase 6)"] = probe.probe_hits.launches
        return work / f"p6_{d}.sam"

    cpu_cuda_agree("phase 6", run6, n6)
    check(launches["paired-end 8k pairs (phase 6)"] > 0,
          "phase 6 never launched the probe_hits kernel")

    # ---- phase 7: the long-indel rescue (-I 60), CUDA against CPU -----
    li = synthetic_long_indel_reads(genome, n_sites=12, n_sim=300,
                                    seed=args.seed + 3)
    fq7 = work / "longindel.fq"
    write_fastq(str(fq7), li)
    cfg7 = align_cli.config_from_args(align_cli.build_parser().parse_args(
        ["-t", "1", "-i", prefix, "-r", str(fq7), "-o", "-", "-I", "60"]
    ))

    def run7(d):
        al = Aligner(genome_l, index_l, cfg7, device=d)
        if d == "cuda":
            probe.probe_hits.launches = 0
        al.align_file(str(fq7), str(work / f"p7_{d}.sam"))
        if d == "cuda":
            torch.cuda.synchronize()
            launches["long-indel -I 60 (phase 7)"] = probe.probe_hits.launches
        return work / f"p7_{d}.sam"

    cpu_cuda_agree("phase 7", run7, len(li))
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
    print(f"probe_hits launches per path: {json.dumps(launches)}")
    shutil.rmtree(work, ignore_errors=True)

    ms_k, ms_r = timings["main"]
    # the kernels line counts the two main paths' runs only (phases 3, 5)
    main_paths = {"single-end": launches["single-end (phase 3)"],
                  "paired-end": launches["paired-end (phase 5)"]}
    print(card)
    print(json.dumps({"kernels": [{
        "name": "probe_hits", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(main_paths.values()),
        "launches_by_path": main_paths,
        "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_r,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
