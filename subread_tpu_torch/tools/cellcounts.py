"""cellCounts on the PyTorch port (reference cell-counts.c:4853).

    python -m subread_tpu_torch.tools.cellcounts -i <prefix> -r r1.fq -R r2.fq -a genes.gtf -c whitelist.txt -o outdir
    python -m subread_tpu_torch.tools.cellcounts -i <prefix> --inputMode BCL --dataset <run> --sampleSheetFile sheet.csv -a genes.gtf -c whitelist.txt -o outdir

Takes subread_tpu's cellCounts options (a copy of
subread_tpu/tools/cellcounts.py) plus `--device` (default `cuda`, which
must be present: there is no fall-back to the CPU).  The cDNA reads are
aligned on the port's `Aligner` with subjunc's defaults, batch_reads 2048,
multi-mapping reports and 8 best candidates.

Input modes (`--inputMode`, cell-counts.c:401): FASTQ (R1 barcode+UMI /
R2 cDNA files) and BCL (raw Illumina run directory + `--sampleSheetFile`
demultiplex).  Long options mirror the reference table
(cell-counts.c:399-422); the short options are this tool's shorthand.
"""

from __future__ import annotations

import argparse
import os
import sys


def _count_batches(aligner, genome, fcview, counter, batch_pairs,
                   writer=None, gene_names=None, ann_weights=None):
    """Run alignment + gene assignment + cell/UMI accumulation over
    (R1, R2) ReadBatch pairs (cellCounts_run_mapping/_run_counting,
    cell-counts.c:3425/4837).  With `writer`, also emits the cDNA
    alignments with CellRanger-style CB/UB/GX tags (the reference's
    per-sample BAM output, cell-counts.c:4837+)."""
    import numpy as np

    from .. import dna
    from ..io import sam as samio

    from ..quant.cellcounts import assign_genes_batch

    for b1, b2 in batch_pairs:
        if b1 is None or b2 is None or len(b2) == 0:
            continue
        res = aligner.align_batch(b2)
        if ann_weights is not None:
            from ..quant.cellcounts import select_annotated_candidates
            select_annotated_candidates(res, b2.lengths, ann_weights)
        lin = res["pos"].astype(np.int64)
        cidx, coff = genome.linear_to_chro(lin)
        if writer is None and hasattr(counter, "add_batch"):
            # vectorised path (no per-sample BAM requested)
            mapped = np.asarray(res["mapped"], bool) & (coff >= 0) & (
                coff < genome.lengths[cidx]
            )
            counter.stats["mapped"] = (
                counter.stats.get("mapped", 0) + int(mapped.sum())
            )
            start = (coff + 1).astype(np.int64)
            end = start + b2.lengths.astype(np.int64) - 1
            gene = assign_genes_batch(
                fcview, genome.names, cidx, start, end, mapped
            )
            counter.add_batch(b1.codes, gene)
            continue
        for i in range(len(b1)):
            gene_idx = -1
            if res["mapped"][i]:
                chro = genome.names[int(cidx[i])]
                ci = fcview.by_chrom.get(chro)
                if ci is not None:
                    s = int(coff[i]) + 1
                    e = s + int(b2.lengths[i]) - 1
                    hits = {
                        int(fcview.feat_target[int(ci.feat_idx[j])])
                        for j in ci.query(s, e)
                    }
                    if len(hits) == 1:
                        gene_idx = hits.pop()
            L1 = int(b1.lengths[i])
            r1seq = dna.decode(b1.codes[i, :L1])
            counter.add(r1seq, gene_idx)
            if writer is not None:
                bl = counter.matcher.barcode_len
                cb = r1seq[:bl]
                ub = r1seq[bl : bl + counter.umi_len]
                L2 = int(b2.lengths[i])
                strand = int(res["strand"][i])
                seq_codes = b2.codes[i, :L2]
                qual = b2.quals[i, :L2].tobytes().decode()
                if strand == 1 and res["mapped"][i]:
                    seq = dna.decode(dna.revcomp(seq_codes))
                    qual = qual[::-1]
                else:
                    seq = dna.decode(seq_codes)
                tags = [f"CB:Z:{cb}-1", f"UB:Z:{ub}"]
                if gene_idx >= 0 and gene_names is not None:
                    tags.append(f"GX:Z:{gene_names[gene_idx]}")
                if not res["mapped"][i]:
                    writer.write(samio.SamRecord(
                        b2.names[i], samio.FLAG_UNMAPPED, "*", 0, 0, "*",
                        seq=seq, qual=qual, tags=tags,
                    ))
                else:
                    flag = samio.FLAG_REVERSE if strand else 0
                    writer.write(samio.SamRecord(
                        b2.names[i], flag, genome.names[int(cidx[i])],
                        int(coff[i]) + 1, int(res["mapq"][i]),
                        f"{L2}M", seq=seq, qual=qual, tags=tags,
                    ))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="subread_tpu_torch-cellCounts")
    ap.add_argument("-v", "--version", action="version",
                    version="subread_tpu_torch-cellCounts")
    ap.add_argument("-i", "--index", required=True, help="index prefix")
    ap.add_argument("--inputMode", default=None, choices=["FASTQ", "BCL"],
                    help="FASTQ (default) or raw BCL/CBCL run directory")
    ap.add_argument("--dataset", default=None,
                    help="BCL run directory (BCL mode)")
    ap.add_argument("--sampleSheetFile", default=None,
                    help="Illumina sample sheet for BCL demultiplexing")
    ap.add_argument("-r", "--reads", default=None,
                    help="R1 FASTQ (cell barcode + UMI)")
    ap.add_argument("-R", "--reads2", default=None, help="R2 FASTQ (cDNA)")
    ap.add_argument("-a", "--annotation", required=True, help="GTF/SAF")
    ap.add_argument("-F", "--anno-format", default="GTF", choices=["GTF", "SAF"])
    ap.add_argument("--isGTFannotation", action="store_true")
    ap.add_argument("-c", "--cell-barcodes", "--cellBarcodeFile",
                    dest="cell_barcodes", required=True,
                    help="cell barcode whitelist (one per line, may be .gz)")
    ap.add_argument("-o", "--output", required=True,
                    help="output directory (per-sample subdirs in BCL mode)")
    ap.add_argument("--umi-len", type=int, default=10)
    ap.add_argument("--umiCutoff", type=float, default=None,
                    help="fixed UMI cutoff for cell calling (default: "
                         "bootstrap knee point, cell-counts.c:4374)")
    ap.add_argument("--cellCalling", action="store_true",
                    help="apply knee-point cell calling in FASTQ mode "
                         "(always on in BCL mode)")
    # remaining reference long options (cell-counts.c:399-422)
    ap.add_argument("--annotationChroAlias", default=None,
                    help="chromosome alias CSV (annotation name, index name)")
    ap.add_argument("--annotationType", default="exon",
                    help="GTF feature type (default exon)")
    ap.add_argument("--geneIdColumn", default="gene_id",
                    help="GTF attribute holding the gene id")
    ap.add_argument("--subreadsPerRead", type=int, default=None,
                    help="subreads extracted per read")
    ap.add_argument("--minVotesPerRead", type=int, default=None,
                    help="min consensus votes to report a location")
    ap.add_argument("--maxMismatch", type=int, default=None)
    ap.add_argument("--minMappedLength", type=int, default=0)
    ap.add_argument("--maxDiffToTopVotes", type=int, default=None,
                    help="vote gap below the top vote still examined")
    ap.add_argument("--reportedAlignmentsPerRead", type=int, default=1,
                    help="alignments reported per read (top-1 counted)")
    ap.add_argument("--reportMultiMappingReads", action="store_true")
    ap.add_argument("--reportExcludedBarcodes", default=None,
                    help="write reads with unmatched barcodes to this file")
    ap.add_argument("-T", "--threads", type=int, default=1,
                    help="compatibility (device parallelism is automatic)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to align on (default cuda)")
    args = ap.parse_args(argv)

    from ..align.pipeline import Aligner
    from ..config import subjunc_config
    from ..device import resolve_device
    from ..io.bcl import parse_cell_barcodes
    from ..io.fastq import FastqReader
    from ..io.gtf import load_annotation
    from ..quant.cellcounts import (
        BatchBarcodeMatcher as BarcodeMatcher,
        BatchCellCounter as CellCounter,
    )
    from ..quant.featurecounts import FCOptions, FeatureCounter

    from .align import load_index_any

    device = resolve_device(args.device)
    mode = args.inputMode or ("BCL" if args.dataset else "FASTQ")
    genome, index = load_index_any(args.index)
    fmt = "GTF" if args.isGTFannotation else args.anno_format
    ann = load_annotation(
        args.annotation, fmt=fmt,
        feature_type=args.annotationType, attr_type=args.geneIdColumn,
    )
    whitelist = parse_cell_barcodes(args.cell_barcodes)
    aliases = None
    if args.annotationChroAlias:
        aliases = {}
        for line in open(args.annotationChroAlias):
            line = line.strip()
            if line and "," in line:
                a, b = line.split(",", 1)
                aliases[a] = b
    fcview = FeatureCounter(ann, FCOptions(), chro_aliases=aliases)
    from ..quant.cellcounts import AnnotationWeights
    ann_weights = AnnotationWeights(ann, genome, chro_aliases=aliases)
    # cellCounts reports a read's top location even on score ties (its
    # SampleTable counts them mapped; reportedAlignmentsPerRead=1 keeps
    # the first-best) — unlike subread-align's break-even drop
    # multi_best=8 exports the candidate table so the annotation-weighted
    # rescoring (cellCounts_calculate_pos_weight, cell-counts.c:1535) can
    # re-resolve repeat-copy ties to the annotated copy
    overrides = dict(batch_reads=2048, report_multi_mapping=True,
                     multi_best=8)
    if args.subreadsPerRead is not None:
        overrides["total_subreads"] = args.subreadsPerRead
    if args.minVotesPerRead is not None:
        overrides["min_votes"] = args.minVotesPerRead
    if args.maxMismatch is not None:
        overrides["max_mismatches"] = args.maxMismatch
    if args.minMappedLength:
        overrides["min_mapped_length"] = args.minMappedLength
    if args.reportMultiMappingReads:
        overrides["report_multi_mapping"] = True
    aligner = Aligner(genome, index, subjunc_config(**overrides),
                      device=device)

    if mode == "FASTQ":
        if not (args.reads and args.reads2):
            ap.error("FASTQ mode needs -r/--reads and -R/--reads2")
        matcher = BarcodeMatcher(whitelist)
        counter = CellCounter(matcher, ann.gene_names, umi_len=args.umi_len)
        r1 = FastqReader(args.reads)
        r2 = FastqReader(args.reads2)

        def pairs():
            while True:
                b1 = r1.next_batch(1 << 16)
                b2 = r2.next_batch(1 << 16, pad_to=aligner.cfg.pad_read_len)
                if b1 is None or b2 is None:
                    return
                yield b1, b2

        _count_batches(aligner, genome, fcview, counter, pairs(),
                       ann_weights=ann_weights)
        r1.close()
        r2.close()
        if args.sampleSheetFile:
            # reference artifact set: {output} is a PREFIX like the
            # reference binary's --output (cell-counts.c:4430-4500)
            from ..io.bcl import parse_sample_sheet
            from ..quant.cellcounts import write_reference_outputs

            _fmt, entries = parse_sample_sheet(args.sampleSheetFile)
            sname = entries[0].sample if entries else "Sample1"
            # per-gene annotation rows ({prefix}.Annot): name, chro, span,
            # strand, merged-exon union length
            import numpy as np

            glens = ann.gene_lengths()
            annot_rows = []
            for g, name in enumerate(ann.gene_names):
                sel = np.flatnonzero(ann.feat_gene == g)
                chro = ann.feat_chro[int(sel[0])]
                s = int(ann.feat_start[sel].min())
                e = int(ann.feat_end[sel].max())
                strand = "+-."[int(ann.feat_strand[int(sel[0])])]
                annot_rows.append((name, chro, s, e, strand, int(glens[g])))
            write_reference_outputs(
                counter, args.output, sname, annot_rows=annot_rows,
                umi_cutoff=args.umiCutoff,
            )
            print(
                f"// cellCounts[{sname}]: {counter.stats['reads']} reads, "
                f"{counter.stats['assigned']} assigned -> "
                f"{args.output}.scRNA.*",
                file=sys.stderr,
            )
            return 0
        counter.write_matrix(
            args.output, cell_calling=args.cellCalling,
            umi_cutoff=args.umiCutoff,
        )
        print(
            f"// cellCounts: {counter.stats['reads']} reads, "
            f"{counter.stats['barcode_matched']} barcode-matched, "
            f"{counter.stats['assigned']} assigned -> {args.output}",
            file=sys.stderr,
        )
        return 0

    # ---- BCL mode: sample-sheet demux, one matrix per sample ------------
    if not (args.dataset and args.sampleSheetFile):
        ap.error("BCL mode needs --dataset and --sampleSheetFile")
    from ..io.bcl import parse_sample_sheet
    from ..quant.cellcounts import batches_from_bcl, demux_bcl

    sheet_fmt, entries = parse_sample_sheet(args.sampleSheetFile)
    if sheet_fmt != "rawdir":
        ap.error("BCL mode needs a rawdir (Lane,...) sample sheet")
    from ..io import sam as samio

    demux = demux_bcl(args.dataset, entries)
    lane_cache: dict = {}
    sample_rows: list[str] = []
    for sample, (picks, r1_i, r2_i, rd) in demux.items():
        matcher = BarcodeMatcher(whitelist)
        counter = CellCounter(matcher, ann.gene_names, umi_len=args.umi_len)
        b1, b2 = batches_from_bcl(picks, r1_i, r2_i, rd, lane_cache)
        if b2 is not None and b2.codes.shape[1] < aligner.cfg.pad_read_len:
            import numpy as np

            pad = aligner.cfg.pad_read_len - b2.codes.shape[1]
            b2.codes = np.pad(b2.codes, ((0, 0), (0, pad)))
            b2.quals = np.pad(b2.quals, ((0, 0), (0, pad)))
            b2.ambig = np.pad(b2.ambig, ((0, 0), (0, pad)))
        out_dir = os.path.join(args.output, sample)
        os.makedirs(out_dir, exist_ok=True)
        bam = samio.make_writer(
            os.path.join(out_dir, f"{sample}.bam"),
            genome.names, [int(x) for x in genome.lengths],
            sam_output=False,
        )
        try:
            _count_batches(aligner, genome, fcview, counter, [(b1, b2)],
                           ann_weights=ann_weights,
                           writer=bam, gene_names=ann.gene_names)
        finally:
            bam.close()
        info = counter.write_matrix(
            out_dir, cell_calling=True, umi_cutoff=args.umiCutoff
        )
        sample_rows.append(
            f"{sample}\t{info['umi_cutoff']}\t{counter.stats['reads']}"
            f"\t{counter.stats['barcode_matched']}"
            f"\t{counter.stats['assigned']}\t{info['n_cells']}\n"
        )
        print(
            f"// cellCounts[{sample}]: {counter.stats['reads']} reads, "
            f"{counter.stats['barcode_matched']} barcode-matched, "
            f"{counter.stats['assigned']} assigned -> {out_dir}",
            file=sys.stderr,
        )
    # the reference's {prefix}.scRNA.SampleTable
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "scRNA.SampleTable"), "w") as f:
        f.write("SampleName\tUMICutoff\tTotalReads\tMappedReads"
                "\tAssignedReads\tCells\n")
        f.writelines(sample_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
