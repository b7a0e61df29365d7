"""subjunc (RNA-seq, junction-aware alignment) on the PyTorch port.

    python -m subread_tpu_torch.tools.subjunc -i <prefix> -r reads.fq -o out.sam
    python -m subread_tpu_torch.tools.subjunc -i <prefix> -r r1.fq -R r2.fq -o out.sam --allJunctions

Writes the SAM, `<out>.junction.bed`, `<out>.indel.vcf` and, with
--allJunctions, `<out>.breakpoints.vcf`.  Takes subread_tpu's subjunc
option set (`subread_tpu.tools.align.build_parser(subjunc=True)` plus the
options of subread_tpu/tools/subjunc.py) and `--device` (default `cuda`,
which must be present: there is no fall-back to the CPU).
"""

from __future__ import annotations

import sys

from subread_tpu.tools.align import build_parser as _jax_free_parser

from .align import run_align


def build_parser():
    ap = _jax_free_parser(prog="subread_tpu_torch-subjunc", subjunc=True)
    ap.add_argument("--allJunctions", action="store_true",
                    help="report non-canonical junctions and fusions")
    # subjunc-specific knobs (core-interface-subjunc.c parse_opts_subjunc)
    ap.add_argument("--exonicSubreadFrac", type=float, default=0.3,
                    help="min fraction of exonic subreads (default 0.3)")
    ap.add_argument("--minMappedFraction", type=int, default=0,
                    help="min mapped fraction of a reported read")
    ap.add_argument("--relaxMismatchedBases", action="store_true",
                    help="no mismatch limit; minMappedFraction=61")
    ap.add_argument("--junctionIns", type=int, default=0,
                    help="allow insertions at junctions (disables the "
                    "donor-site check, as upstream)")
    ap.add_argument("--disableBigMargin", action="store_true",
                    help="disable the big-margin junction filter")
    ap.add_argument("--extendIndelDetection", action="store_true",
                    help="extended indel search (compat)")
    ap.add_argument("--pairedSAM", action="store_true",
                    help="SAM/BAM read input is paired-end")
    ap.add_argument("--singleSAM", action="store_true",
                    help="SAM/BAM read input is single-end")
    ap.add_argument("--device", default="cuda",
                    help="torch device to align on (default cuda)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.relaxMismatchedBases:
        # reference: both mismatch caps -> 999, min_mapped_fraction 61
        args.max_mismatches = 999
        args.minMappedFraction = 61
    run_align(args, subjunc=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
