"""featureCounts on the PyTorch port (reference readSummary.c:8859, long
options :7302).

    python -m subread_tpu_torch.tools.featurecounts -a genes.gtf -o counts.txt in.sam
    python -m subread_tpu_torch.tools.featurecounts --deviceCounts -a genes.gtf -o counts.txt in.sam

Takes subread_tpu's featureCounts options (`build_parser`, a copy of
subread_tpu/tools/featurecounts.py's) plus `--device` (default `cuda`,
which must be present: there is no fall-back to the CPU).  The device is
resolved before anything is counted, so a run never goes on without the
device it named.  The host engine (`quant.featurecounts.FeatureCounter`,
native `fccount.cpp` or pure Python) counts every input, except with
`--deviceCounts`: then an input whose options fall inside
`DeviceCounter`'s subset is counted on the device, and the others go to
the host engine, as in subread_tpu.  The device path counts on the one
device `--device` names; with `--device cuda` and more than one visible
card it counts over every card (`DeviceCounter.count_sharded`), as the
JAX package counts over `jax.devices()`.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser():
    ap = argparse.ArgumentParser(prog="subread_tpu_torch-featureCounts")
    ap.add_argument("-v", "--version", action="version",
                    version="subread_tpu_torch-featureCounts")
    ap.add_argument("-a", "--annotation", required=True)
    ap.add_argument("-A", "--aliases", help="chromosome alias CSV (anno,sam)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-F", "--format", default="GTF", choices=["GTF", "SAF"])
    ap.add_argument("-t", "--feature-type", default="exon")
    ap.add_argument("-g", "--attr-type", default="gene_id")
    ap.add_argument("-p", dest="paired", action="store_true")
    ap.add_argument("--countReadPairs", dest="count_read_pairs", action="store_true")
    ap.add_argument("-B", dest="both_ends", action="store_true")
    ap.add_argument("-C", dest="no_chimeric", action="store_true")
    ap.add_argument("-P", dest="pe_dist", action="store_true")
    ap.add_argument("-d", dest="min_fragment", type=int, default=50)
    ap.add_argument("-D", dest="max_fragment", type=int, default=600)
    ap.add_argument("-M", dest="multi", action="store_true")
    ap.add_argument("--primary", action="store_true")
    ap.add_argument("-Q", dest="min_mapq", type=int, default=0)
    ap.add_argument("-s", dest="strand", default="0")
    ap.add_argument("-f", dest="feature_level", action="store_true")
    ap.add_argument("-O", dest="multi_overlap", action="store_true")
    ap.add_argument("--minOverlap", type=int, default=1)
    ap.add_argument("--fracOverlap", type=float, default=0.0)
    ap.add_argument("--largestOverlap", action="store_true")
    ap.add_argument("--read2pos", type=int, default=0)
    ap.add_argument("--readExtension5", type=int, default=0)
    ap.add_argument("--readExtension3", type=int, default=0)
    ap.add_argument("--ignoreDup", action="store_true")
    ap.add_argument("--fraction", action="store_true")
    ap.add_argument("--maxMOp", type=int, default=10)
    ap.add_argument("--splitOnly", action="store_true")
    ap.add_argument("--nonSplitOnly", action="store_true")
    ap.add_argument("--donotsort", action="store_true")
    ap.add_argument("-J", dest="junctions", action="store_true")
    ap.add_argument("-G", dest="genome", help="genome FASTA for -J strands")
    ap.add_argument("-T", dest="threads", type=int, default=1)
    ap.add_argument("--readShiftSize", type=int, default=0)
    ap.add_argument("--readShiftType", default="upstream",
                    choices=["upstream", "downstream", "left", "right"])
    ap.add_argument("--nonOverlap", type=int, default=-1)
    ap.add_argument("--nonOverlapFeature", type=int, default=-1)
    ap.add_argument("--fracOverlapFeature", type=float, default=0.0)
    ap.add_argument("--extraAttributes", default=None,
                    help="comma-separated extra GTF attributes to output")
    ap.add_argument("--byReadGroup", action="store_true")
    ap.add_argument("-L", dest="long_reads", action="store_true",
                    help="long-read counting (no CIGAR M-op cap, SE only)")
    ap.add_argument("-R", dest="detail_format", default=None,
                    choices=["CORE", "SAM", "BAM"],
                    help="per-read assignment detail output")
    ap.add_argument("--Rpath", default=None,
                    help="directory for -R detail files")
    ap.add_argument("--tmpDir", default=None)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--detectionCall", dest="detection_call",
                    action="store_true",
                    help="echo the SAF 6th column as a GCfraction column")
    # accepted-for-parity no-ops: -S/--order is deprecated upstream
    # (readSummary.c:8973-8986); --restrictedlyNoOverlap is parsed but
    # never read (readSummary.c:6506 is its only consumer, itself unread);
    # --debugCommand is internal debugging
    ap.add_argument("-S", "--order", dest="order", default=None,
                    help="(deprecated upstream; accepted and ignored)")
    ap.add_argument("--restrictedlyNoOverlap", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--debugCommand", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--deviceCounts", action="store_true",
                    help="count on --device: disjoint-span searchsorted "
                         "counter; covers the default gene-level "
                         "unique-counting option subset (SE and -p "
                         "fragments, -s 0/1/2); other options go to the "
                         "host counter")
    # scRNA sub-mode (readSummary.c:7332-7334): BC+UMI parsed from
    # '|'-joined read names; per-sample sparse matrices emitted
    ap.add_argument("--scSampleSheet", default=None,
                    help="scRNA sample sheet CSV; enables the scRNA sub-mode")
    ap.add_argument("--scInputMode", default="BAM", choices=["FASTQ", "BAM"],
                    help="scRNA input kind (BAM = barcodes in read names)")
    ap.add_argument("--scCellBarcodeFile", default=None,
                    help="cell barcode whitelist (one barcode per line)")
    ap.add_argument("input", nargs="+", help="SAM/BAM input file(s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for --deviceCounts (default cuda)")
    return ap


def _try_device_count(fc, ann, path, device) -> bool:
    """Count one input on `device` through quant.device_count.DeviceCounter
    when the options fall inside its covered subset; returns False for the
    host counter to count it."""
    o = fc.opts
    eligible = (
        not o.feature_level and not o.count_multi and not o.primary_only
        and o.min_mapq == 0 and not o.allow_multi_overlap
        and o.min_overlap == 1 and o.frac_overlap == 0
        and not o.largest_overlap and o.read2pos == 0
        and o.ext5 == 0 and o.ext3 == 0 and not o.ignore_dup
        and not o.fraction and not o.split_only and not o.non_split_only
        and not o.count_junctions and o.read_shift_size == 0
        and o.non_overlap < 0 and o.non_overlap_feature < 0
        and o.frac_overlap_feature == 0 and not o.by_read_group
        and not o.long_reads and o.strand in (0, 1, 2)
        and (not o.paired or (o.count_read_pairs
                              and not o.require_both_ends
                              and not o.check_pe_dist))
    )
    if not eligible:
        return False

    from ..quant.device_count import DeviceCounter, STATUS_NAMES

    dc = DeviceCounter(
        ann, strand=o.strand, max_sections=20 if o.paired else 10,
        device=device,
    )
    # native record parser covers SAM text, BAM and BGZF-BAM
    if o.paired:
        ss, se, gate, stbl = dc.fragments_from_file(path)
    else:
        ss, se, gate, stbl = dc.sections_from_file(path)
    mesh = device_mesh(device)
    if mesh is not None:
        counts, summary, overflow = dc.count_sharded(mesh, ss, se, gate, stbl)
        where = f"{mesh.size} devices"
    else:
        counts, summary, _, overflow = dc.count(ss, se, gate, stbl)
        where = dc.device
    if overflow:
        return False
    fc.counts += counts.astype(fc.counts.dtype)
    for name, v in zip(STATUS_NAMES, summary.tolist()):
        fc.summary[name] += int(v)
    print(f"// deviceCounts: {path} counted on {where}", file=sys.stderr)
    return True


def device_mesh(device):
    """The mesh of every visible card when `device` is "cuda" (no index)
    and more than one card is visible, else None: count on `device`."""
    import torch

    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        from ..parallel.mesh import make_mesh

        return make_mesh()
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..device import resolve_device
    from ..io.gtf import load_annotation
    from ..quant.featurecounts import FCOptions, FeatureCounter

    import os as _os

    device = resolve_device(args.device)
    for path in [args.annotation] + args.input:
        if not _os.path.exists(path):
            print(f"ERROR: file not found: {path}", file=sys.stderr)
            return 1
    extra_attrs = (
        [c for c in args.extraAttributes.replace(";", ",").split(",") if c]
        if args.extraAttributes else None
    )
    if args.order:
        print('The "-S" option has been depreciated.', file=sys.stderr)
    ann = load_annotation(
        args.annotation, fmt=args.format,
        feature_type=args.feature_type, attr_type=args.attr_type,
        extra_attrs=extra_attrs, gc_column=args.detection_call,
    )
    if ann.n_features == 0:
        print(
            f"ERROR: no features of type '{args.feature_type}' loaded from "
            f"{args.annotation} (is -F {args.format} correct?)",
            file=sys.stderr,
        )
        return 1
    # negative --minOverlap = allowed gap -> read extensions
    # (readSummary.c:8153-8156)
    min_overlap, ext5, ext3 = (
        args.minOverlap, args.readExtension5, args.readExtension3
    )
    if min_overlap < 1:
        ext5 += 1 - min_overlap
        ext3 += 1 - min_overlap
        min_overlap = 1
    strand_list = [int(s) for s in args.strand.split(",")]
    opts = FCOptions(
        paired=args.paired,
        count_read_pairs=args.count_read_pairs,
        require_both_ends=args.both_ends,
        no_chimeric=args.no_chimeric,
        check_pe_dist=args.pe_dist,
        min_fragment=args.min_fragment,
        max_fragment=args.max_fragment,
        count_multi=args.multi,
        primary_only=args.primary,
        min_mapq=args.min_mapq,
        strand=strand_list[0],
        feature_level=args.feature_level,
        allow_multi_overlap=args.multi_overlap,
        min_overlap=min_overlap,
        frac_overlap=args.fracOverlap,
        largest_overlap=args.largestOverlap,
        read2pos=args.read2pos,
        ext5=ext5,
        ext3=ext3,
        ignore_dup=args.ignoreDup,
        fraction=args.fraction,
        max_mop=args.maxMOp,
        split_only=args.splitOnly,
        non_split_only=args.nonSplitOnly,
        count_junctions=args.junctions,
        read_shift_size=args.readShiftSize,
        read_shift_type=args.readShiftType,
        non_overlap=args.nonOverlap,
        non_overlap_feature=args.nonOverlapFeature,
        frac_overlap_feature=args.fracOverlapFeature,
        by_read_group=args.byReadGroup,
        long_reads=args.long_reads,
        verbose=args.verbose,
    )
    if args.long_reads:
        opts.paired = False
    aliases = None
    if args.aliases:
        aliases = {}
        for line in open(args.aliases):
            line = line.strip()
            if line and "," in line:
                a, b = line.split(",", 1)
                aliases[a] = b
    fc = FeatureCounter(ann, opts, chro_aliases=aliases)
    sc = None
    if args.scSampleSheet:
        if not args.scCellBarcodeFile:
            print("ERROR: --scSampleSheet needs --scCellBarcodeFile",
                  file=sys.stderr)
            return 1
        from ..io.bcl import parse_sample_sheet
        from ..quant.fc_scrna import ScRNACounter

        _, entries = parse_sample_sheet(args.scSampleSheet)
        # BAM input mode: one sample per run (readSummary.c:3821-3822)
        sample_names = [entries[0].sample if entries else "Sample1"]
        barcodes = [
            l.strip().split("-")[0].split("\t")[0]
            for l in open(args.scCellBarcodeFile) if l.strip()
        ]
        sc = ScRNACounter(barcodes, sample_names)
        fc.sc = sc
    # count-column headers are the input paths exactly as typed
    # (readSummary.c writes argv paths verbatim)
    names = list(args.input)
    detail_dir = args.Rpath or os.path.dirname(args.output) or "."
    for fi, path in enumerate(args.input):
        # -s accepts a comma-separated per-input strand list
        fc.opts.strand = strand_list[min(fi, len(strand_list) - 1)]
        if args.deviceCounts and sc is None and not args.detail_format:
            if _try_device_count(fc, ann, path, device):
                continue
            print(f"// deviceCounts: falling back to the host counter for "
                  f"{path}", file=sys.stderr)
        if args.detail_format:
            fmt = "CORE" if args.detail_format == "CORE" else "SAM"
            if args.detail_format == "BAM":
                print("NOTE: -R BAM details are written as SAM text",
                      file=sys.stderr)
            ext = ".featureCounts" + ("" if fmt == "CORE" else ".sam")
            fc.open_details(
                os.path.join(detail_dir, os.path.basename(path) + ext), fmt
            )
        fc.count_file(path)
        fc.close_details()
        if sc is not None:
            # outputs are prefixed by the INPUT path (the reference uses
            # global_context->input_file_name)
            target_names = (
                ann.gene_names if not opts.feature_level
                else [ann.gene_names[int(g)] for g in ann.feat_gene]
            )
            sc.write_outputs(path, target_names)
    fc.write_counts(args.output, names)
    fc.write_summary(args.output + ".summary", names)
    if args.junctions:
        fc.write_jcounts(args.output + ".jcounts", names, genome=args.genome)
    print(
        f"// Assigned {int(fc.summary['Assigned'])} fragments", file=sys.stderr
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
