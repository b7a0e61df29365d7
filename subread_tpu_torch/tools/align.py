"""subread-align on the PyTorch port, single-end or paired-end.

    python -m subread_tpu_torch.tools.align -t 1 -i <prefix> -r reads.fq -o out.sam
    python -m subread_tpu_torch.tools.align -t 1 -i <prefix> -r r1.fq -R r2.fq -o out.sam

Takes subread_tpu's option set (`subread_tpu.tools.align.build_parser`,
which imports no JAX) plus `--device` (default `cuda`, which must be
present: there is no fall-back to the CPU).  --sv/--longDel/--SVdetection
switch on junction and breakpoint detection (`.junction.bed`,
`.breakpoints.vcf`), and -a/-A preload annotated junctions, as in
subread_tpu.  `run_align` also serves `tools.subjunc`.
"""

from __future__ import annotations

import sys
import time

from subread_tpu.tools.align import build_parser as _jax_free_parser
from subread_tpu.tools.align import load_index_any


def build_parser():
    ap = _jax_free_parser(prog="subread_tpu_torch-align")
    ap.add_argument("--device", default="cuda",
                    help="torch device to align on (default cuda)")
    return ap


def main(argv=None) -> int:
    run_align(build_parser().parse_args(argv))
    return 0


def config_from_args(args, subjunc: bool = False):
    """The AlignConfig subread_tpu's run_align builds from the same options
    (subread_tpu/tools/align.py:172-223): subjunc's defaults or
    subread-align's, --allJunctions and --minMappedFraction where the
    parser has them, and --sv/--longDel/--SVdetection switching on junction
    and breakpoint detection for subread-align."""
    from subread_tpu.config import aligner_config, subjunc_config

    overrides = dict(
        max_indel=args.max_indel,
        max_mismatches=args.max_mismatches,
        min_fragment=args.min_fragment,
        max_fragment=args.max_fragment,
        phred_offset=64 if args.phred == "6" else 33,
        show_soft_clipping=not args.hide_softclip,
        sam_output=args.SAMoutput,
        sort_by_coordinates=args.sort_coords,
        rg_id=args.rg_id,
        rg_extra=tuple(args.rg),
        multi_best=args.multi_best,
        all_junctions=getattr(args, "allJunctions", False),
        report_multi_mapping=(args.multiMapping or args.multi_best > 1)
        and not args.unique,
        ignore_unmapped=args.ignoreUnmapped,
        min_mapped_length=args.minMappedLength,
        min_mapped_fraction=getattr(args, "minMappedFraction", 0),
        mate_orientation=args.order,
        dp_mismatch=args.DPMismatch, dp_match=args.DPMatch,
        dp_gap_open=args.DPGapOpen, dp_gap_ext=args.DPGapExt,
    )
    if not subjunc and args.type == 1:
        overrides["is_rna_seq"] = False
    if args.subreads is not None:
        overrides["total_subreads"] = args.subreads
    if args.min_votes is not None:
        overrides["min_votes"] = args.min_votes
    if args.min_votes2 is not None:
        overrides["min_votes_second"] = args.min_votes2
    if args.maxVoteSimples is not None:
        overrides["top_k"] = max(1, args.maxVoteSimples)
    if args.maxRealignLocations is not None:
        overrides["multi_best"] = min(
            overrides.get("multi_best", 1), args.maxRealignLocations
        )
    if args.fast:
        overrides["top_k"] = 1
        overrides["multi_best"] = 1
    if (args.sv or args.longDel or args.SVdetection) and not subjunc:
        # --sv/--longDel set do_breakpoint_detection (core-indel.c:4405)
        overrides["detect_junctions"] = True
        overrides["all_junctions"] = True
    return (subjunc_config if subjunc else aligner_config)(**overrides)


def read_format(args) -> str | None:
    """The input format run_align reads: SAM, BAM, or None for FASTQ/FASTA."""
    return "SAM" if args.SAMinput else (
        "BAM" if (args.BAMinput or args.scRNA_BAMinput) else None
    )


def open_reader(args):
    """The read source run_align opens for single-end input."""
    from subread_tpu.io.fastq import make_trim_transform, open_read_source

    tf = make_trim_transform(args.trim5, args.trim3, args.color_convert)
    if args.scRNA_FQinput:
        from subread_tpu.io.scrna import ScRNAFastqReader

        return ScRNAFastqReader(args.reads, transform=tf)
    if args.BCLinput:
        from subread_tpu.io.scrna import BCLReadReader

        return BCLReadReader(args.reads, transform=tf)
    return open_read_source(args.reads, read_format(args), transform=tf)


def open_readers_pe(args):
    """The two mates' read sources, as subread_tpu's run_align opens them
    (subread_tpu/tools/align.py:260-267): one SAM/BAM given to both -r and
    -R is split by the first/second-in-pair flags."""
    from subread_tpu.io.fastq import make_trim_transform, open_read_source

    tf = make_trim_transform(args.trim5, args.trim3, args.color_convert)
    fmt = read_format(args)
    mates = (0, 1) if (fmt and args.reads2 == args.reads) else (None, None)
    return (
        open_read_source(args.reads, fmt, transform=tf, mate=mates[0]),
        open_read_source(args.reads2, fmt, transform=tf, mate=mates[1]),
    )


def load_annotated_junctions(args) -> dict:
    """-a/-A: the exon annotation's junctions, with its chromosome names
    mapped through the alias CSV (subread_tpu/tools/align.py:238-259)."""
    from subread_tpu.io.gtf import load_annotation

    from ..align.pipeline import known_junctions_from_annotation

    ann = load_annotation(
        args.exonAnnotation, fmt=args.exonFormat,
        feature_type=args.gtfFeature, attr_type=args.gtfAttr,
    )
    if args.exonAlias:
        amap = {}
        for line in open(args.exonAlias):
            line = line.strip()
            if line and "," in line:
                a, b = line.split(",", 1)
                amap[a] = b
        ann.feat_chro = [amap.get(c, c) for c in ann.feat_chro]
    return known_junctions_from_annotation(ann)


def run_align(args, subjunc: bool = False) -> dict:
    """Align as the options say (subjunc's defaults when `subjunc`);
    returns the AlignSummary's fields plus the wall time of each step
    (index load, upload to the device, align_file)."""
    from ..align.pipeline import Aligner
    from ..device import resolve_device

    t0 = time.time()
    device = resolve_device(args.device)
    cfg = config_from_args(args, subjunc)
    genome, index = load_index_any(args.index)
    t1 = time.time()
    aligner = Aligner(genome, index, cfg, device=device)
    if args.exonAnnotation:
        aligner.annot_junctions = load_annotated_junctions(args)
        print(
            f"// Loaded {len(aligner.annot_junctions)} annotated junctions "
            f"from {args.exonAnnotation}", file=sys.stderr,
        )
    t2 = time.time()
    if getattr(args, "pairedSAM", False) and read_format(args) and not args.reads2:
        args.reads2 = args.reads    # --pairedSAM: one SAM/BAM holds both mates
    if args.reads2:
        summary = aligner.align_file_pe(
            args.reads, args.reads2, args.output, readers=open_readers_pe(args)
        )
    else:
        summary = aligner.align_file(
            args.reads, args.output, reader=open_reader(args)
        )
    t3 = time.time()
    d = summary.as_dict()
    d.update(time_load=t1 - t0, time_upload=t2 - t1, time_align=t3 - t2)
    print(
        f"// Mapped: {d['mapped']}/{d['total']} "
        f"({100.0*d['mapped']/max(d['total'],1):.1f}%), "
        f"unique {d['unique']}, multi {d['multi']}, "
        f"indel-CIGARs {d['indels']}; {t3 - t0:.1f}s total on {device} "
        f"(index load {t1 - t0:.1f}s, upload {t2 - t1:.1f}s, align "
        f"{t3 - t2:.1f}s: device+host {d['time_voting']:.1f}s, "
        f"io {d['time_io']:.1f}s)",
        file=sys.stderr,
    )
    return d


if __name__ == "__main__":
    sys.exit(main())
