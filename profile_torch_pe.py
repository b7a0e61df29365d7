#!/usr/bin/env python3
"""Where a paired-end run of the PyTorch port (subread_tpu_torch) spends its
time, on one NVIDIA GPU.

    python3 profile_torch_pe.py [--genome-mb 100] [--pairs 65536] [--seed 7]
                                [--reps 5] [--device cuda] [--batch-reads N]

The genome, index and pairs are chip_smoke.py's (a synthetic genome from the
seed, its full index, simulated 100 bp pairs with fragments of 150-500
bases), kept in memory.  It prints, for the first sub-batch of
`batch_reads` pairs, the median time of each device stage (both mates'
upload and unpack, both votes, both scan-2 scorings, `_select_pe`, the
whole `_device_align_pe`), each call timed by CUDA events and by the host's
clock from a synchronised start to a synchronise after it; then for one
chunk of `--pairs` pairs, the host's time to submit and collect it and,
under torch.profiler, the card's busy time and kernel count; then the host
time of each step of `align_file_pe` over that chunk, its files under
build/profile_pe/.  `--device cpu` with a small genome, few pairs and a
small --batch-reads is a dry run, with host clocks only.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-mb", type=float, default=100.0)
    ap.add_argument("--pairs", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-reads", type=int, default=0,
                    help="sub-batch size (default: the CLI's)")
    args = ap.parse_args()

    import torch

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile_torch_pe: no GPU; use --device cpu for a dry run")
    sys.path.insert(0, str(ROOT))
    from subread_tpu.index.build import build_hash_index
    from subread_tpu_torch.align import indelevent
    from subread_tpu_torch.align.pipeline import Aligner, uniform_length
    from subread_tpu_torch.synth import (
        synthetic_genome, synthetic_pairs, write_fastq,
    )
    from subread_tpu_torch.timing import first_block_vote, host_seconds, stage_ms
    from subread_tpu_torch.tools import align as align_cli

    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t = time.time()
    genome = synthetic_genome(int(args.genome_mb * 1_000_000), seed=args.seed,
                              n_contigs=4)
    index = build_hash_index(genome, index_gap=1)
    b1, b2 = synthetic_pairs(genome, args.pairs, seed=args.seed + 2)
    cfg = align_cli.config_from_args(align_cli.build_parser().parse_args(
        ["-t", "1", "-i", "-", "-r", "-", "-o", "-"]))
    if args.batch_reads:
        cfg = dataclasses.replace(cfg, batch_reads=args.batch_reads)
    al = Aligner(genome, index, cfg, device=torch.device(args.device))
    print(f"set-up: genome {genome.total} bases, index {index.n_items} "
          f"entries, {args.pairs} pairs ({time.time() - t:.1f}s)")

    # ---- device stages on the first sub-batch -------------------------
    bs = al.cfg.batch_reads
    rows = [(b.codes[:bs], b.ambig[:bs], b.lengths[:bs]) for b in (b1, b2)]
    ul1, ul2 = (uniform_length(r[2]) for r in rows)
    m1, m2 = (al._upload_reads(*r) for r in rows)
    vp = al.vote_params._replace(top_k=max(al.vote_params.top_k, 8))

    def votes():
        return [first_block_vote(al, c, a, ln, vp, ul)
                for (c, a, ln), ul in ((m1, ul1), (m2, ul2))]

    v = votes()

    def scores():
        return [al._score_candidates(c, a, ln, vv, al.cfg.min_votes_second, ul)
                for (c, a, ln), vv, ul in ((m1, v[0], ul1), (m2, v[1], ul2))]

    sc = scores()
    etl = (al.cfg.min_fragment + al.cfg.max_fragment) // 2
    stages = [
        ("upload + unpack, both mates", lambda: [al._upload_reads(*r) for r in rows]),
        (f"vote, both mates (top_k {vp.top_k})", votes),
        ("scan-2 scoring, both mates", scores),
        ("_select_pe", lambda: al._select_pe(m1[2], m2[2], *sc, etl)),
        ("whole _device_align_pe",
         lambda: al._device_align_pe(*m1, *m2, ul1=ul1, ul2=ul2)),
    ]
    print(f"per {bs}-pair sub-batch, medians of {args.reps} "
          f"(CUDA events / host clock to a synchronise):")
    for name, fn in stages:
        ev, wall = stage_ms(fn, args.reps, cuda)
        print(f"  {name}: {ev:.4f} / {wall:.4f} ms")
    r1, r2 = al._device_align_pe(*m1, *m2, ul1=ul1, ul2=ul2, rescue=True,
                                 vp=al.vote_params)
    n_sat = int((r1["saturated"] | r2["saturated"]).sum().item())
    print(f"  pairs saturated in the main pass: {n_sat} of {bs}")
    del m1, m2, v, sc, r1, r2

    # ---- one chunk: submit + collect, and the card's busy time ---------
    al.collect_batch_pe(al.submit_batch_pe(b1, b2))      # warm-up
    sync()
    t = time.perf_counter()
    al.collect_batch_pe(al.submit_batch_pe(b1, b2))
    sync()
    t_chunk = time.perf_counter() - t
    print(f"one {args.pairs}-pair chunk: submit + collect {t_chunk:.4f} s of host time")
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            al.collect_batch_pe(al.submit_batch_pe(b1, b2))
            sync()
        dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e6
        print(f"  under torch.profiler: {len(dev_ev)} device events, "
              f"{busy:.4f} s of device time, busy {busy / t_chunk:.4f} of the "
              f"unprofiled {t_chunk:.4f} s")

    # ---- host steps of align_file_pe over the chunk ---------------------
    steps = [
        (al, "submit_batch_pe", "submit_batch_pe (to a synchronise)", True),
        (al, "collect_batch_pe", "collect_batch_pe (with the host rescue)"),
        (indelevent, "propose_and_apply", "propose_and_apply, both mates"),
        (indelevent, "rescue_clipped_with_events",
         "rescue_clipped_with_events, both mates"),
        (indelevent, "rescue_unmapped_mates", "rescue_unmapped_mates"),
        (al, "_emit_sam_pe", "_emit_sam_pe"),
    ]
    work = ROOT / "build" / "profile_pe"
    work.mkdir(parents=True, exist_ok=True)
    fq1, fq2 = str(work / "r1.fq"), str(work / "r2.fq")
    write_fastq(fq1, b1)
    write_fastq(fq2, b2)
    with host_seconds(steps, sync) as spent:
        t = time.perf_counter()
        al.align_file_pe(fq1, fq2, str(work / "out.sam"))
        t_file = time.perf_counter() - t
    shutil.rmtree(work, ignore_errors=True)
    print(f"align_file_pe over {args.pairs} pairs: {t_file:.4f} s "
          f"({2 * args.pairs / t_file:.1f} reads/s); host seconds per step:")
    for label, s in spent.items():
        print(f"  {label}: {s:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
