"""sublong (long-read mapping) on the PyTorch port.

    python -m subread_tpu_torch.tools.sublong -i <prefix> -r long.fq -o out.sam

Takes the options of subread_tpu/tools/sublong.py (`-X` RNA mode, `-B`,
`--min-windows`, `--SAMoutput`) plus `--device` (default `cuda`, which must
be present: there is no fall-back to the CPU).  The reads' 100 bp windows
are aligned on the port's `Aligner` in batches of 2048 and chained on the
host (`align.longread`).
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser():
    ap = argparse.ArgumentParser(prog="subread_tpu_torch-sublong")
    ap.add_argument("-i", "--index", required=True)
    ap.add_argument("-r", "--reads", required=True, help="long-read FASTQ")
    ap.add_argument("-o", "--output", required=True, help="SAM/BAM output")
    ap.add_argument("--min-windows", type=int, default=2,
                    help="minimum chained 100bp windows for a mapping")
    ap.add_argument("-T", "--threads", type=int, default=1)
    # reference longread-mapping.c getopt "Xr:i:o:B:T:v"
    ap.add_argument("-X", dest="rna_mode", action="store_true",
                    help="RNA-seq mode (junction-aware chaining scores)")
    ap.add_argument("-B", dest="multi_best", type=int, default=1,
                    help="report up to N best alignments per read (<=20)")
    ap.add_argument("--SAMoutput", action="store_true",
                    help="write SAM text instead of BAM")
    ap.add_argument("-v", "--version", action="version",
                    version="subread_tpu_torch-sublong")
    ap.add_argument("--device", default="cuda",
                    help="torch device to align on (default cuda)")
    return ap


def sublong_config(args):
    """The AlignConfig subread_tpu's sublong builds from the same options
    (subread_tpu/tools/sublong.py:38-48)."""
    from ..config import aligner_config

    cfg_kw = dict(batch_reads=2048, min_votes=2,
                  multi_best=min(max(1, args.multi_best), 20))
    if args.rna_mode:
        # -X (longread-mapping.c): RNA-seq chaining scores — junctions
        # between chained anchors become N ops; DP score set match 6 /
        # mismatch 0 / gap open -6 / gap extend -1
        cfg_kw.update(dp_match=6, dp_mismatch=0, dp_gap_open=-6,
                      dp_gap_ext=-1, detect_junctions=True)
    return aligner_config(**cfg_kw)


def run_sublong(args) -> dict:
    """Map as the options say; returns the mapped and total read counts and
    the wall seconds of the index load and of `sublong_file`."""
    from ..align.longread import sublong_file
    from ..align.pipeline import Aligner
    from ..device import resolve_device
    from .align import load_index_any

    t0 = time.time()
    device = resolve_device(args.device)
    genome, index = load_index_any(args.index)
    aligner = Aligner(genome, index, sublong_config(args), device=device)
    t1 = time.time()
    mapped, total = sublong_file(
        aligner, args.reads, args.output, min_windows=args.min_windows,
        sam_output=args.SAMoutput,
    )
    t2 = time.time()
    print(
        f"// sublong: mapped {mapped}/{total} long reads in "
        f"{t2 - t0:.1f}s on {device}",
        file=sys.stderr,
    )
    return dict(mapped=mapped, total=total, time_load=t1 - t0,
                time_map=t2 - t1)


def main(argv=None) -> int:
    run_sublong(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
