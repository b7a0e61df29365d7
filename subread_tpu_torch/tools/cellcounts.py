"""cellCounts on the PyTorch port (reference cell-counts.c:4853).

    python -m subread_tpu_torch.tools.cellcounts -i <prefix> -r r1.fq -R r2.fq -a genes.gtf -c whitelist.txt -o outdir [--bam sample.bam]
    python -m subread_tpu_torch.tools.cellcounts -i <prefix> --inputMode BCL --dataset <run> --sampleSheetFile sheet.csv -a genes.gtf -c whitelist.txt -o outdir

Takes subread_tpu's cellCounts options (a copy of
subread_tpu/tools/cellcounts.py) plus `--device` (default `cuda`, which
must be present: there is no fall-back to the CPU).  The cDNA reads are
aligned on the port's `Aligner` with subjunc's defaults, batch_reads 2048,
multi-mapping reports and 8 best candidates.

Input modes (`--inputMode`, cell-counts.c:401): FASTQ (R1 barcode+UMI /
R2 cDNA files; `cellcounts_file`, which `--bam` asks to write the sample's
BAM too) and BCL (raw Illumina run directory + `--sampleSheetFile`
demultiplex, a BAM and a matrix each sample).  Both run each batch of
read pairs through `count_batch`.  Long options mirror the reference table
(cell-counts.c:399-422); the short options are this tool's shorthand.  The
last line on stderr gives the counts, the host seconds of each span
(`cellcounts.read`, `.align`, `.assign`, `.barcode`, `.emit`,
`.finalise` and the aligner's own) and the barcode and UMI counters.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np

from .. import timing

# read pairs a FASTQ-mode batch holds: one align_batch call
PAIRS_PER_BATCH = 1 << 16


class FastqPairs:
    """The R1 and R2 FASTQ files as one reader of read pairs: next_batch
    gives (R1 batch, R2 batch), R2 padded to pad_to, or None at the end
    of either file."""

    def __init__(self, r1: str, r2: str):
        from ..io.fastq import FastqReader

        self.r1, self.r2 = FastqReader(r1), FastqReader(r2)

    def next_batch(self, max_pairs: int, pad_to: int | None = None):
        b1 = self.r1.next_batch(max_pairs)
        b2 = self.r2.next_batch(max_pairs, pad_to=pad_to)
        if b1 is None or b2 is None:
            return None
        return b1, b2

    def close(self):
        self.r1.close()
        self.r2.close()


def count_batch(aligner, annotation, counter, b1, b2, writer=None):
    """One batch of (R1, R2) read pairs through cellCounts' steps
    (cellCounts_run_mapping/_run_counting, cell-counts.c:3425/4837): R2
    aligned (`cellcounts.align`), its candidates rescored by the
    annotation and each mapped read given its gene, the one gene whose
    exons its `<length>M` record overlaps (`assign_genes_batch`,
    `cellcounts.assign`), R1's barcode matched and the (cell, gene, UMI)
    triples packed (`cellcounts.barcode`); with writer, the records of the
    batch (`write_cell_records`, `cellcounts.emit`)."""
    from ..quant import cellcounts as cc

    if b1 is None or b2 is None or len(b2) == 0:
        return
    genome = aligner.genome
    with timing.span("cellcounts.align"):
        res = aligner.align_batch(b2)
    with timing.span("cellcounts.assign"):
        cc.select_annotated_candidates(res, b2.lengths, annotation.weights)
        cidx, coff = genome.linear_to_chro(res["pos"].astype(np.int64))
        mapped = np.asarray(res["mapped"], bool)
        in_contig = mapped & (coff >= 0) & (coff < genome.lengths[cidx])
        counter.stats["mapped"] = (
            counter.stats.get("mapped", 0) + int(in_contig.sum())
        )
        start = (coff + 1).astype(np.int64)
        gene = cc.assign_genes_batch(
            annotation.fcview, genome.names, cidx, start,
            start + b2.lengths.astype(np.int64) - 1, in_contig,
        )
    with timing.span("cellcounts.barcode"):
        counter.add_batch(b1.codes, gene)
    if writer is not None:
        with timing.span("cellcounts.emit"):
            write_cell_records(writer, genome, b1, b2, res, cidx, coff, gene,
                               annotation.gene_names,
                               counter.matcher.barcode_len, counter.umi_len)


def cell_tags(b1, gene, gene_names, barcode_len: int, umi_len: int):
    """The string tags of a batch's records as format_bam_records takes
    them: CB, R1's first barcode_len bases and "-1"; UB, the umi_len bases
    after them; GX, the read's gene, left out where it has none."""
    from .. import dna

    n = len(b1)
    L1 = b1.lengths.astype(np.int32)
    text = dna.CODE2BASE[b1.codes[:, : barcode_len + umi_len] & 3]
    k = np.minimum(L1, barcode_len)
    cb = np.zeros((n, barcode_len + 2), np.uint8)
    cb[:, : min(barcode_len, text.shape[1])] = text[:, :barcode_len]
    rows = np.arange(n)
    cb[rows, k], cb[rows, k + 1] = ord("-"), ord("1")
    ub = text[:, barcode_len : barcode_len + umi_len]
    table, glen = _name_table(tuple(gene_names))
    has = gene >= 0
    g = np.where(has, gene, 0)
    return [("CB", cb, k + 2),
            ("UB", ub, np.clip(L1 - barcode_len, 0, umi_len)),
            ("GX", table[g], np.where(has, glen[g], -1))]


@functools.lru_cache(maxsize=4)
def _name_table(gene_names: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The gene names as rows of bytes, zero-padded, and their lengths."""
    names = [g.encode() for g in gene_names] or [b""]
    table = np.zeros((len(names), max(map(len, names))), np.uint8)
    for i, g in enumerate(names):
        table[i, : len(g)] = np.frombuffer(g, np.uint8)
    return table, np.asarray([len(g) for g in names], np.int32)


def write_cell_records(writer, genome, b1, b2, res, cidx, coff, gene,
                       gene_names, barcode_len: int, umi_len: int) -> None:
    """A batch's BAM records, one a read pair in input order: R2 unmapped,
    or `<length>M` at its position with SEQ and QUAL reverse-complemented on
    the reverse strand, the aligner's MAPQ, and the tags of cell_tags,
    encoded in one native call (`native.format_bam_records`); record by
    record through SamRecord where the library is missing or refuses a
    row.  The reference's per-sample BAM (cell-counts.c:4837+)."""
    import time

    from .. import native
    from ..io import sam as samio

    n = len(b2)
    mapped = np.asarray(res["mapped"], bool)[:n]
    strand = np.asarray(res["strand"], np.int32)[:n]
    flags = np.where(mapped, np.where(strand == 1, samio.FLAG_REVERSE, 0),
                     samio.FLAG_UNMAPPED).astype(np.int32)
    tags = cell_tags(b1, gene, gene_names, barcode_len, umi_len)
    lens = b2.lengths.astype(np.int32)
    mapq = np.where(mapped, np.asarray(res["mapq"], np.int32)[:n], 0)
    bam = writer.bam
    t0 = time.perf_counter_ns()
    ref_of = bam.ref_ids([*genome.names, "*"])
    z = np.zeros(n, np.int32)
    got = native.format_bam_records(
        b2.names, b2.codes, b2.quals, lens, flags,
        np.where(mapped, ref_of[cidx], ref_of[-1]), np.where(mapped, coff, -1),
        mapq, np.full(n, ref_of[-1]), np.full(n, -1), z, mapped,
        z, z, z, z, z, None, z, z, ztags=tags,
    )
    if got is not None:
        bam.add_records(*got, pack_ns=time.perf_counter_ns() - t0)
        return
    from .. import dna

    for i in range(n):
        L = int(lens[i])
        seq, qual = b2.codes[i, :L], b2.quals[i, :L].tobytes().decode()
        if flags[i] & samio.FLAG_REVERSE:
            seq, qual = dna.revcomp(seq), qual[::-1]
        rec_tags = [f"{t}:Z:{v[i, :ln[i]].tobytes().decode()}"
                    for t, v, ln in tags if ln[i] >= 0]
        if mapped[i]:
            rec = samio.SamRecord(b2.names[i], int(flags[i]),
                                  genome.names[int(cidx[i])], int(coff[i]) + 1,
                                  int(mapq[i]), f"{L}M", seq=dna.decode(seq),
                                  qual=qual, tags=rec_tags)
        else:
            rec = samio.SamRecord(b2.names[i], samio.FLAG_UNMAPPED, "*", 0, 0,
                                  "*", seq=dna.decode(seq), qual=qual,
                                  tags=rec_tags)
        writer.write(rec)


def cellcounts_file(aligner, matcher, annotation, r1: str, r2: str, out: str | None,
                    umi_len: int = 10, cell_calling: bool = False,
                    umi_cutoff: float | None = None, bam: str | None = None,
                    reader=None, batch_pairs: int = PAIRS_PER_BATCH):
    """cellCounts' FASTQ mode on one sample: the read pairs of the R1
    (barcode and UMI) and R2 (cDNA) files, or those reader hands over
    (`next_batch(max_pairs, pad_to)` giving (R1 batch, R2 batch) or None,
    and `close()`), counted batch_pairs at a time (`count_batch`).  With bam,
    also the sample's BAM there, one record a pair in input order with
    CB, UB and GX.  With out, the matrix there (`write_matrix`:
    matrix.mtx, barcodes.tsv, features.tsv; `cellcounts.finalise`).
    Returns the counter.  annotation: a quant.cellcounts.CellAnnotation on
    the aligner's genome; matcher: a BatchBarcodeMatcher."""
    from ..io import sam as samio
    from ..quant.cellcounts import BatchCellCounter

    counter = BatchCellCounter(matcher, annotation.gene_names, umi_len=umi_len)
    reader = reader if reader is not None else FastqPairs(r1, r2)
    g = aligner.genome
    writer = None if bam is None else samio.make_writer(
        bam, g.names, [int(x) for x in g.lengths], sam_output=False)
    chunk = 0
    try:
        while True:
            timing.set_chunk(chunk)
            with timing.span("cellcounts.read"):
                pairs = reader.next_batch(batch_pairs, pad_to=aligner.cfg.pad_read_len)
            if pairs is None:
                break
            count_batch(aligner, annotation, counter, *pairs, writer=writer)
            chunk += 1
    finally:
        reader.close()
        if writer is not None:
            with timing.span("cellcounts.emit"):
                writer.close()
        timing.set_chunk(-1)
    if out is not None:
        with timing.span("cellcounts.finalise"):
            counter.write_matrix(out, cell_calling=cell_calling,
                                 umi_cutoff=umi_cutoff)
    return counter


def closing_line(label: str, counter, before: dict) -> str:
    """The CLI's last line: the counts, the stages' host seconds (every
    span total since `before`) and the barcode and UMI counters."""
    st = counter.stats
    spans = {k: v - before.get(k, 0.0) for k, v in timing.totals().items()
             if v > before.get(k, 0.0)}
    return (f"// cellCounts{label}: {st['reads']} reads, "
            f"{st['barcode_matched']} barcode-matched, {st['assigned']} assigned; "
            f"barcodes exact {st['barcode_exact']}, rescued {st['barcode_rescued']}, "
            f"unmatched {st['reads'] - st['barcode_matched']}; UMIs "
            f"{st['umis']}, merged {st['umi_merged']}; host seconds in "
            + ", ".join(f"{k} {v:.1f}s" for k, v in spans.items()))


def build_parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--bam", default=None,
                    help="FASTQ mode: also write the sample's BAM here, a "
                         "record a read pair with CB, UB and GX tags, as BCL "
                         "mode writes each sample's")
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
    return ap


def aligner_config(args):
    """The aligner's configuration: subjunc's defaults, batch_reads 2048,
    multi-mapping reads reported and 8 best candidates exported, then the
    options.  cellCounts reports a read's top location even on score ties
    (its SampleTable counts them mapped; reportedAlignmentsPerRead=1 keeps
    the first-best), unlike subread-align's break-even drop; multi_best=8
    exports the candidate table, so the annotation-weighted rescoring
    (cellCounts_calculate_pos_weight, cell-counts.c:1535) can re-resolve
    repeat-copy ties to the annotated copy."""
    from ..config import subjunc_config

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
    return subjunc_config(**overrides)


def cell_annotation(args, genome):
    """The annotation the options name, as a CellAnnotation on genome."""
    from ..io.gtf import load_annotation
    from ..quant.cellcounts import CellAnnotation

    fmt = "GTF" if args.isGTFannotation else args.anno_format
    ann = load_annotation(
        args.annotation, fmt=fmt,
        feature_type=args.annotationType, attr_type=args.geneIdColumn,
    )
    aliases = None
    if args.annotationChroAlias:
        aliases = {}
        for line in open(args.annotationChroAlias):
            line = line.strip()
            if line and "," in line:
                a, b = line.split(",", 1)
                aliases[a] = b
    return CellAnnotation(ann, genome, chro_aliases=aliases)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    from ..align.pipeline import Aligner
    from ..device import resolve_device
    from ..io.bcl import parse_cell_barcodes
    from ..quant.cellcounts import BatchBarcodeMatcher, BatchCellCounter

    from .align import load_index_any

    before = timing.totals()
    device = resolve_device(args.device)
    mode = args.inputMode or ("BCL" if args.dataset else "FASTQ")
    genome, index = load_index_any(args.index)
    annotation = cell_annotation(args, genome)
    ann = annotation.ann
    whitelist = parse_cell_barcodes(args.cell_barcodes)
    aligner = Aligner(genome, index, aligner_config(args), device=device)

    if mode == "FASTQ":
        if not (args.reads and args.reads2):
            ap.error("FASTQ mode needs -r/--reads and -R/--reads2")
        matcher = BatchBarcodeMatcher(whitelist)
        sheet = args.sampleSheetFile
        counter = cellcounts_file(
            aligner, matcher, annotation, args.reads, args.reads2,
            None if sheet else args.output, umi_len=args.umi_len,
            cell_calling=args.cellCalling, umi_cutoff=args.umiCutoff,
            bam=args.bam)
        if sheet:
            # reference artifact set: {output} is a PREFIX like the
            # reference binary's --output (cell-counts.c:4430-4500)
            from ..io.bcl import parse_sample_sheet
            from ..quant.cellcounts import write_reference_outputs

            _fmt, entries = parse_sample_sheet(sheet)
            sname = entries[0].sample if entries else "Sample1"
            # per-gene annotation rows ({prefix}.Annot): name, chro, span,
            # strand, merged-exon union length
            glens = ann.gene_lengths()
            annot_rows = []
            for g, name in enumerate(ann.gene_names):
                sel = np.flatnonzero(ann.feat_gene == g)
                chro = ann.feat_chro[int(sel[0])]
                s = int(ann.feat_start[sel].min())
                e = int(ann.feat_end[sel].max())
                strand = "+-."[int(ann.feat_strand[int(sel[0])])]
                annot_rows.append((name, chro, s, e, strand, int(glens[g])))
            with timing.span("cellcounts.finalise"):
                write_reference_outputs(
                    counter, args.output, sname, annot_rows=annot_rows,
                    umi_cutoff=args.umiCutoff,
                )
            print(closing_line(f"[{sname}]", counter, before)
                  + f" -> {args.output}.scRNA.*", file=sys.stderr)
            return 0
        print(closing_line("", counter, before) + f" -> {args.output}",
              file=sys.stderr)
        return 0

    # ---- BCL mode: sample-sheet demux, one matrix per sample ------------
    if not (args.dataset and args.sampleSheetFile):
        ap.error("BCL mode needs --dataset and --sampleSheetFile")
    from ..io import sam as samio
    from ..io.bcl import parse_sample_sheet
    from ..quant.cellcounts import batches_from_bcl, demux_bcl

    sheet_fmt, entries = parse_sample_sheet(args.sampleSheetFile)
    if sheet_fmt != "rawdir":
        ap.error("BCL mode needs a rawdir (Lane,...) sample sheet")

    demux = demux_bcl(args.dataset, entries)
    lane_cache: dict = {}
    sample_rows: list[str] = []
    matcher = BatchBarcodeMatcher(whitelist)
    for sample, (picks, r1_i, r2_i, rd) in demux.items():
        # BCL mode's UMIs merge as CellCounter's do, ties by their text
        counter = BatchCellCounter(matcher, ann.gene_names,
                                   umi_len=args.umi_len, text_order=True)
        b1, b2 = batches_from_bcl(picks, r1_i, r2_i, rd, lane_cache)
        if b2 is not None and b2.codes.shape[1] < aligner.cfg.pad_read_len:
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
            count_batch(aligner, annotation, counter, b1, b2, writer=bam)
        finally:
            with timing.span("cellcounts.emit"):
                bam.close()
        with timing.span("cellcounts.finalise"):
            info = counter.write_matrix(
                out_dir, cell_calling=True, umi_cutoff=args.umiCutoff
            )
        sample_rows.append(
            f"{sample}\t{info['umi_cutoff']}\t{counter.stats['reads']}"
            f"\t{counter.stats['barcode_matched']}"
            f"\t{counter.stats['assigned']}\t{info['n_cells']}\n"
        )
        print(closing_line(f"[{sample}]", counter, before) + f" -> {out_dir}",
              file=sys.stderr)
    # the reference's {prefix}.scRNA.SampleTable
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "scRNA.SampleTable"), "w") as f:
        f.write("SampleName\tUMICutoff\tTotalReads\tMappedReads"
                "\tAssignedReads\tCells\n")
        f.writelines(sample_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
