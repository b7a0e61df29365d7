"""subread-align on the PyTorch port, single-end or paired-end.

    python -m subread_tpu_torch.tools.align -t 1 -i <prefix> -r reads.fq -o out.sam
    python -m subread_tpu_torch.tools.align -t 1 -i <prefix> -r r1.fq -R r2.fq -o out.sam

Takes subread_tpu's option set (`option_parser`, a copy of
`subread_tpu.tools.align.build_parser`) plus `--device` (default `cuda`,
which must be present: there is no fall-back to the CPU).
--sv/--longDel/--SVdetection switch on junction and breakpoint detection
(`.junction.bed`, `.breakpoints.vcf`), and -a/-A preload annotated
junctions, as in subread_tpu.  `run_align` also serves `tools.subjunc`.
"""

from __future__ import annotations

import argparse
import sys
import time

from .. import timing

def option_parser(prog="subread_tpu_torch-align", subjunc=False):
    """The option table of subread_tpu/tools/align.py::build_parser, copied:
    the same options, defaults and destinations."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("-i", "--index", required=True, help="index prefix")
    ap.add_argument("-r", "--reads", required=True, help="FASTQ (R1)")
    ap.add_argument("-R", "--reads2", help="FASTQ (R2) for paired-end")
    ap.add_argument("-o", "--output", required=True, help="output SAM/BAM")
    if not subjunc:
        ap.add_argument("-t", "--type", type=int, default=0,
                        help="0=RNA-seq 1=DNA-seq")
    ap.add_argument("-n", "--subreads", type=int, default=None,
                    help="subreads per read (default 10 DNA / 14 subjunc)")
    ap.add_argument("-m", "--min-votes", type=int, default=None)
    ap.add_argument("-p", "--min-votes2", type=int, default=None)
    ap.add_argument("-I", "--max-indel", type=int, default=5)
    ap.add_argument("-M", "--max-mismatches", type=int, default=3)
    ap.add_argument("-T", "--threads", type=int, default=1,
                    help="compatibility (device parallelism is automatic)")
    ap.add_argument("-d", "--min-fragment", type=int, default=50)
    ap.add_argument("-D", "--max-fragment", type=int, default=600)
    ap.add_argument("-P", "--phred", choices=["3", "6"], default="3",
                    help="3 = phred+33, 6 = phred+64")
    ap.add_argument("-J", dest="hide_softclip", action="store_true",
                    help="do not show soft-clipping")
    ap.add_argument("-H", dest="hamming", action="store_true",
                    help="hamming-distance tie-break (compat)")
    ap.add_argument("-Q", dest="quality_break", action="store_true",
                    help="quality-score tie-break (compat)")
    ap.add_argument("--SAMoutput", action="store_true", help="write SAM text")
    ap.add_argument("--sortReadsByCoordinates", dest="sort_coords",
                    action="store_true",
                    help="coordinate-sort the BAM output and write a BAI")
    ap.add_argument("--gzFASTQinput", action="store_true",
                    help="compat flag; gz detected automatically")
    ap.add_argument("--rg-id", dest="rg_id")
    ap.add_argument("--rg", dest="rg", action="append", default=[])
    ap.add_argument("-B", "--multi", dest="multi_best", type=int, default=1,
                    help="report up to N best locations per read")
    ap.add_argument("-u", "--unique", action="store_true",
                    help="report uniquely mapped reads only")
    ap.add_argument("--multiMapping", action="store_true",
                    help="report multi-mapping reads (with -B)")
    ap.add_argument("-5", "--trim5", type=int, default=0,
                    help="trim N bases from the read 5' end")
    ap.add_argument("-3", "--trim3", type=int, default=0,
                    help="trim N bases from the read 3' end")
    ap.add_argument("-S", "--order", default="fr", choices=["fr", "ff", "rf"],
                    help="mate orientation")
    ap.add_argument("-b", "--color-convert", dest="color_convert",
                    action="store_true",
                    help="convert SOLiD color-space input to base space")
    ap.add_argument("--fast", action="store_true",
                    help="fast top-1 mapping (reference --fast)")
    ap.add_argument("--SAMinput", action="store_true",
                    help="input reads are a SAM file (re-alignment)")
    ap.add_argument("--BAMinput", action="store_true",
                    help="input reads are a BAM file (re-alignment)")
    ap.add_argument("--keepReadOrder", action="store_true",
                    help="keep input read order in BAM output (default here)")
    ap.add_argument("--ignoreUnmapped", action="store_true",
                    help="omit unmapped reads from the output")
    ap.add_argument("--minMappedLength", type=int, default=0)
    ap.add_argument("--maxVoteSimples", type=int, default=None,
                    help="candidate locations examined per read")
    ap.add_argument("--minVoteCutoff", type=int, default=None,
                    help="vote difference cutoff (compat)")
    ap.add_argument("--maxRealignLocations", type=int, default=None)
    ap.add_argument("--complexIndels", action="store_true",
                    help="detect adjacent short indels (always on here)")
    ap.add_argument("--sv", action="store_true",
                    help="detect structural variants (breakpoints output)")
    ap.add_argument("--longDel", action="store_true",
                    help="detect long deletions (breakpoints output)")
    ap.add_argument("--forcedPE", action="store_true")
    # --noTLENpreference disables the reference's TLEN-closeness tiebreak
    # (core.c:2816); our PE scoring never applies one, so accepting the
    # flag IS the implemented behavior.  --reportPairedMultiBest: PE
    # multi-best record sets (the SE analog is -B).
    ap.add_argument("--noTLENpreference", action="store_true",
                    help="no TLEN preference in pair scoring (default here)")
    ap.add_argument("--reportPairedMultiBest", action="store_true",
                    help="accepted for compatibility")
    ap.add_argument("--memoryMultiplex", type=float, default=1.0)
    ap.add_argument("-X", "--DPMismatch", type=int, default=0)
    ap.add_argument("-Y", "--DPMatch", type=int, default=2)
    ap.add_argument("-G", "--DPGapOpen", type=int, default=-1)
    ap.add_argument("-E", "--DPGapExt", type=int, default=0)
    ap.add_argument("-a", "--exonAnnotation", default=None,
                    help="exon annotation (known junctions preload)")
    ap.add_argument("-F", "--exonFormat", default="GTF",
                    choices=["GTF", "SAF"])
    ap.add_argument("-A", "--exonAlias", default=None,
                    help="chromosome alias CSV for -a")
    ap.add_argument("--gtfFeature", default="exon")
    ap.add_argument("--gtfAttr", default="gene_id")
    ap.add_argument("-v", "--version", action="version",
                    version=prog)
    # scRNA input modes (core-interface-aligner.c:502-513): read names
    # carry '|'-joined barcode/UMI/sample fields for downstream counting
    ap.add_argument("--scRNA_FQinput", action="store_true",
                    help="-r is scRNA FASTQ triplets (io/scrna.py format)")
    ap.add_argument("--scRNA_BAMinput", action="store_true",
                    help="-r is a BAM whose names carry barcode fields")
    ap.add_argument("--BCLinput", action="store_true",
                    help="-r is a raw Illumina run directory")
    ap.add_argument("--SVdetection", action="store_true",
                    help="structural-variant detection (same as --sv)")
    ap.add_argument("--accurateFusions", action="store_true",
                    help="stricter fusion filtering (compat)")
    # accepted-for-parity no-ops: the reference parses these but the
    # values are never consumed in v2.0.6 (-s downscale_mapping_quality
    # core.c:626 and --extraColumns SAM_extra_columns never reach the SAM
    # writer; --exonAnnotationScreenOut only redirects a progress table)
    ap.add_argument("-s", dest="downscale_mapq", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--extraColumns", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--exonAnnotationScreenOut", default=None,
                    help=argparse.SUPPRESS)
    return ap


def build_parser():
    ap = option_parser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to align on (default cuda)")
    return ap


def main(argv=None) -> int:
    run_align(build_parser().parse_args(argv))
    return 0


@timing.span("index.load")
def load_index_any(prefix: str):
    """Load a native (.genome.npz/.hash.npz) or reference-built
    ({prefix}.00.b.tab/.array/.reads) index."""
    import os

    from ..index.build import HashIndex
    from ..index.genome import Genome

    if os.path.exists(prefix + ".hash.npz"):
        return Genome.load(prefix), HashIndex.load(prefix)
    if os.path.exists(prefix + ".00.hash.npz"):
        from ..index.build import load_index_blocks

        return Genome.load(prefix), load_index_blocks(prefix)
    if os.path.exists(prefix + ".00.b.tab"):
        from ..index.interop import read_reference_index

        return read_reference_index(prefix)
    raise FileNotFoundError(
        f"no index at '{prefix}' (need .hash.npz or .00.b.tab)"
    )


def config_from_args(args, subjunc: bool = False):
    """The AlignConfig subread_tpu's run_align builds from the same options
    (subread_tpu/tools/align.py:172-223): subjunc's defaults or
    subread-align's, --allJunctions and --minMappedFraction where the
    parser has them, and --sv/--longDel/--SVdetection switching on junction
    and breakpoint detection for subread-align."""
    from ..config import aligner_config, subjunc_config

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
    from ..io.fastq import make_trim_transform, open_read_source

    tf = make_trim_transform(args.trim5, args.trim3, args.color_convert)
    if args.scRNA_FQinput:
        from ..io.scrna import ScRNAFastqReader

        return ScRNAFastqReader(args.reads, transform=tf)
    if args.BCLinput:
        from ..io.scrna import BCLReadReader

        return BCLReadReader(args.reads, transform=tf)
    return open_read_source(args.reads, read_format(args), transform=tf)


def open_readers_pe(args):
    """The two mates' read sources, as subread_tpu's run_align opens them
    (subread_tpu/tools/align.py:260-267): one SAM/BAM given to both -r and
    -R is split by the first/second-in-pair flags."""
    from ..io.fastq import make_trim_transform, open_read_source

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
    from ..align.pipeline import known_junctions_from_annotation
    from ..io.gtf import load_annotation

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
    returns the AlignSummary's fields, the wall time of each step (index
    load, upload to the device, align_file) and, under "spans", the host
    seconds of each span of the run."""
    from ..align.pipeline import Aligner
    from ..device import resolve_device

    before = timing.totals()
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
    d.update(time_load=t1 - t0, time_upload=t2 - t1, time_align=t3 - t2,
             spans={k: v - before.get(k, 0.0)
                    for k, v in timing.totals().items()
                    if v > before.get(k, 0.0)})
    print(
        f"// Mapped: {d['mapped']}/{d['total']} "
        f"({100.0*d['mapped']/max(d['total'],1):.1f}%), "
        f"unique {d['unique']}, multi {d['multi']}, "
        f"indel-CIGARs {d['indels']}; {t3 - t0:.1f}s total on {device}, "
        f"align {t3 - t2:.1f}s; host seconds in "
        + ", ".join(f"{k} {v:.1f}s" for k, v in d["spans"].items()),
        file=sys.stderr,
    )
    return d


if __name__ == "__main__":
    sys.exit(main())
