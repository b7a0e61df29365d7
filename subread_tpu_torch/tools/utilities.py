"""Copy of `subread_tpu/tools/utilities.py`: the port imports nothing of the JAX package.

Utility tools (reference SURVEY.md §2 #28-39): small host-side programs.

Each has a main(argv); dispatched via ``python -m subread_tpu_torch.tools.utilities
<tool> ...`` or the per-tool wrappers.  Reference equivalents noted per
function.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _sam_records(path):
    """Iterate SAM/BAM records as SAM text fields."""
    with open(path, "rb") as f:
        is_bam = f.read(2) == b"\x1f\x8b"
    if is_bam:
        from ..io.bam import bam_to_sam_lines

        yield from bam_to_sam_lines(path)
    else:
        for line in open(path):
            if not line.startswith("@") and line.strip():
                yield line.rstrip("\n").split("\t")


def _sam_header(path):
    with open(path, "rb") as f:
        is_bam = f.read(2) == b"\x1f\x8b"
    if is_bam:
        from ..io.bam import BamReader

        r = BamReader(path)
        return [f"@SQ\tSN:{n}\tLN:{l}" for n, l in zip(r.ref_names, r.ref_lengths)]
    out = []
    for line in open(path):
        if line.startswith("@"):
            out.append(line.rstrip("\n"))
        else:
            break
    return out


# --- propmapped (propmapped.c) ---------------------------------------------

def propmapped(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="propmapped",
                                 description="fraction of mapped reads")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", help="append result to this file")
    ap.add_argument("-V", dest="verbose", action="store_true",
                    help="verbose per-chromosome output (compat)")
    ap.add_argument("-f", dest="fragments", action="store_true",
                    help="count fragments instead of reads")
    ap.add_argument("-p", dest="primary", action="store_true",
                    help="count primary alignments only")
    args = ap.parse_args(argv)
    total = mapped = 0
    seen = set()
    for f in _sam_records(args.input):
        flag = int(f[1])
        if args.primary and (flag & 0x100):
            continue
        if args.fragments and (flag & 0x1):
            key = f[0]
            if key in seen:
                continue
            seen.add(key)
        total += 1
        if not (flag & 0x4):
            mapped += 1
    prop = mapped / total if total else 0.0
    line = f"{args.input}\t{total}\t{mapped}\t{prop:.6f}"
    print("Sample\tNumReads\tNumMapped\tPropMapped")
    print(line)
    if args.output:
        with open(args.output, "a") as fo:
            fo.write(line + "\n")
    return 0


# --- qualityScores (qualityScores.c) ----------------------------------------

def qualityscores(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="qualityScores")
    ap.add_argument("-i", "--input", required=True, help="FASTQ input")
    ap.add_argument("-o", "--output")
    ap.add_argument("-n", "--nreads", type=int, default=10000)
    ap.add_argument("-P", dest="phred", choices=["3", "6"], default="3",
                    help="3 = phred+33, 6 = phred+64")
    ap.add_argument("--offset", type=int, default=None)
    args = ap.parse_args(argv)
    offset = args.offset if args.offset is not None else (
        64 if args.phred == "6" else 33
    )
    from ..io.fastq import FastqReader

    r = FastqReader(args.input)
    batch = r.next_batch(args.nreads)
    r.close()
    if batch is None:
        print("no reads", file=sys.stderr)
        return 1
    out = open(args.output, "w") if args.output else sys.stdout
    for i in range(len(batch)):
        L = int(batch.lengths[i])
        scores = (batch.quals[i, :L].astype(np.int32) - offset)
        out.write("\t".join(str(int(x)) for x in scores) + "\n")
    if args.output:
        out.close()
    return 0


# --- removeDup (removeDupReads.c) -------------------------------------------

def removedup(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="removeDup")
    ap.add_argument("-i", "--input", required=True, help="SAM/BAM input")
    ap.add_argument("-o", "--output", required=True, help="SAM output")
    ap.add_argument("-S", dest="sam_output", action="store_true",
                    help="SAM text output (default here)")
    ap.add_argument("-t", dest="temp_dir", default=None,
                    help="temp-file directory (accepted; not needed)")
    ap.add_argument("-T", dest="threads", type=int, default=1)
    ap.add_argument("-D", dest="debug", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("-r", "--threshold", type=int, default=2,
                    help="remove reads at positions with >= r duplicates")
    args = ap.parse_args(argv)
    counts: dict[tuple[str, int], int] = {}
    for f in _sam_records(args.input):
        if int(f[1]) & 0x4:
            continue
        key = (f[2], int(f[3]))
        counts[key] = counts.get(key, 0) + 1
    removed = kept = 0
    with open(args.output, "w") as out:
        for h in _sam_header(args.input):
            out.write(h + "\n")
        for f in _sam_records(args.input):
            flag = int(f[1])
            if not (flag & 0x4) and counts.get((f[2], int(f[3])), 0) >= args.threshold:
                removed += 1
                continue
            kept += 1
            out.write("\t".join(f) + "\n")
    print(f"// removeDup: kept {kept}, removed {removed}", file=sys.stderr)
    return 0


# --- flattenGTF (flattenAnnotations.c) --------------------------------------

def flattengtf(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flattenGTF")
    ap.add_argument("-a", "--annotation", required=True, help="GTF input")
    ap.add_argument("-o", "--output", required=True, help="SAF output")
    ap.add_argument("-t", "--feature-type", default="exon")
    ap.add_argument("-g", "--attr-type", default="gene_id")
    ap.add_argument("-C", dest="chop", action="store_true",
                    help="chop into non-overlapping bins instead of merging")
    args = ap.parse_args(argv)
    from ..io.gtf import load_annotation

    ann = load_annotation(args.annotation, fmt="GTF",
                          feature_type=args.feature_type,
                          attr_type=args.attr_type)
    with open(args.output, "w") as out:
        out.write("GeneID\tChr\tStart\tEnd\tStrand\n")
        for gidx, gname in enumerate(ann.gene_names):
            sel = np.flatnonzero(ann.feat_gene == gidx)
            by_chro: dict[str, list] = {}
            for i in sel:
                by_chro.setdefault(ann.feat_chro[i], []).append(
                    (int(ann.feat_start[i]), int(ann.feat_end[i]),
                     int(ann.feat_strand[i]))
                )
            for chro, ivs in by_chro.items():
                ivs.sort()
                merged = [list(ivs[0])]
                for s, e, st in ivs[1:]:
                    if s <= merged[-1][1] + 1:
                        merged[-1][1] = max(merged[-1][1], e)
                    else:
                        merged.append([s, e, st])
                for s, e, st in merged:
                    out.write(
                        f"{gname}\t{chro}\t{s}\t{e}\t{'+-.'[st]}\n"
                    )
    return 0


# --- repair (read-repair.c) --------------------------------------------------

def repair(argv=None) -> int:
    """Re-pair name-scattered mates so they are adjacent (featureCounts-
    ready); orphans get a dummy unmapped mate (read-repair.c usage :11-35)."""
    ap = argparse.ArgumentParser(prog="repair")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-d", dest="add_dummy", action="store_true",
                    help="add dummy mates for orphan reads (default on)")
    args = ap.parse_args(argv)
    pending: dict[str, list[str]] = {}
    n_pairs = n_orphans = 0
    with open(args.output, "w") as out:
        for h in _sam_header(args.input):
            out.write(h + "\n")
        for f in _sam_records(args.input):
            flag = int(f[1])
            if not (flag & 0x1):
                out.write("\t".join(f) + "\n")
                continue
            mate = pending.pop(f[0], None)
            if mate is None:
                pending[f[0]] = f
            else:
                out.write("\t".join(mate) + "\n")
                out.write("\t".join(f) + "\n")
                n_pairs += 1
        for f in pending.values():
            out.write("\t".join(f) + "\n")
            # dummy unmapped mate
            flag = int(f[1])
            mate_first = 0x40 if (flag & 0x80) else 0x80
            dummy = [
                f[0], str(0x1 | 0x4 | mate_first), f[2], f[3], "0", "*",
                "=", f[3], "0", "*", "*",
            ]
            out.write("\t".join(dummy) + "\n")
            n_orphans += 1
    print(f"// repair: {n_pairs} pairs, {n_orphans} orphans", file=sys.stderr)
    return 0


# --- coverageCount (coverage_calc.c) -----------------------------------------

def coveragecount(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="coverageCount")
    ap.add_argument("-i", "--input", required=True, help="SAM/BAM input")
    ap.add_argument("-o", "--output", required=True,
                    help="output prefix (one .int32.bin per chromosome)")
    args = ap.parse_args(argv)
    from ..io.sam import parse_cigar

    sizes: dict[str, int] = {}
    for h in _sam_header(args.input):
        if h.startswith("@SQ"):
            d = dict(kv.split(":", 1) for kv in h.split("\t")[1:])
            sizes[d["SN"]] = int(d["LN"])
    cov = {n: np.zeros(l + 1, dtype=np.int32) for n, l in sizes.items()}
    for f in _sam_records(args.input):
        if int(f[1]) & 0x4 or f[2] not in cov:
            continue
        p = int(f[3]) - 1
        for n, op in parse_cigar(f[5]):
            if op in "M=X":
                cov[f[2]][p : p + n] += 1
                p += n
            elif op in "DN":
                p += n
    for name, arr in cov.items():
        arr[: len(arr) - 1].tofile(f"{args.output}.{name}.int32.bin")
    print(f"// coverageCount: wrote {len(cov)} chromosome files", file=sys.stderr)
    return 0


# --- subread-fullscan (fullscan.c) -------------------------------------------

def fullscan(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="subread-fullscan",
                                 description="scan genome for high-similarity "
                                             "locations of a sequence")
    ap.add_argument("-g", "--genome", required=True, help="FASTA")
    ap.add_argument("-s", "--sequence", required=True)
    ap.add_argument("-m", "--min-identity", type=float, default=0.9)
    args = ap.parse_args(argv)
    from .. import dna
    from ..io.fasta import read_fasta

    q = dna.encode(args.sequence.upper())
    L = len(q)
    qr = dna.revcomp(q)
    for contig in read_fasta(args.genome):
        g = contig.codes
        if len(g) < L:
            continue
        # vectorised identity scan via stride tricks
        windows = np.lib.stride_tricks.sliding_window_view(g, L)
        for label, query in (("+", q), ("-", qr)):
            ident = (windows == query[None, :]).mean(axis=1)
            for pos in np.flatnonzero(ident >= args.min_identity):
                print(
                    f"{contig.name}\t{pos + 1}\t{label}\t{ident[pos] * 100:.1f}%"
                )
    return 0


# --- txUnique (tx-unique.c) ---------------------------------------------------

def txunique(argv=None) -> int:
    """Per-transcript count of exonic bases unique vs other transcripts of
    the same gene (tx-unique.c)."""
    ap = argparse.ArgumentParser(prog="txUnique")
    ap.add_argument("-a", "--annotation", required=True, help="GTF")
    ap.add_argument("-g", "--gene-attr", default="gene_id")
    ap.add_argument("-t", "--tx-attr", default="transcript_id")
    ap.add_argument("-f", "--feature-type", default="exon")
    args = ap.parse_args(argv)
    from ..io.gtf import parse_gtf_attr

    genes: dict[str, dict[str, list[tuple[int, int]]]] = {}
    for line in open(args.annotation):
        if line.startswith("#") or not line.strip():
            continue
        c = line.rstrip("\n").split("\t")
        if len(c) < 9 or c[2] != args.feature_type:
            continue
        gid = parse_gtf_attr(c[8], args.gene_attr)
        tid = parse_gtf_attr(c[8], args.tx_attr)
        if gid is None or tid is None:
            continue
        genes.setdefault(gid, {}).setdefault(tid, []).append(
            (int(c[3]), int(c[4]))
        )
    print("GeneID\tTranscriptID\tExonicBases\tUniqueBases")
    for gid, txs in genes.items():
        for tid, ivs in txs.items():
            own = set()
            for s, e in ivs:
                own.update(range(s, e + 1))
            others = set()
            for tid2, ivs2 in txs.items():
                if tid2 == tid:
                    continue
                for s, e in ivs2:
                    others.update(range(s, e + 1))
            print(f"{gid}\t{tid}\t{len(own)}\t{len(own - others)}")
    return 0


# --- sam2fq -------------------------------------------------------------------

def sam2fq(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sam2fq")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True, help="FASTQ out")
    args = ap.parse_args(argv)
    from .. import dna

    with open(args.output, "w") as out:
        for f in _sam_records(args.input):
            flag = int(f[1])
            if flag & 0x100 or flag & 0x800:
                continue
            seq, qual = f[9], f[10]
            if flag & 0x10:
                seq = dna.decode(dna.revcomp(dna.encode(seq)))
                qual = qual[::-1]
            out.write(f"@{f[0]}\n{seq}\n+\n{qual}\n")
    return 0


# --- genRandomReads (gen_rand_reads.c) ---------------------------------------

def genrandomreads(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genRandomReads")
    ap.add_argument("-g", "--genome", required=True, help="FASTA")
    ap.add_argument("-o", "--output", required=True, help="output prefix")
    ap.add_argument("-n", "--nreads", type=int, default=10000)
    ap.add_argument("-l", "--read-len", type=int, default=100)
    ap.add_argument("-e", "--error-rate", type=float, default=0.0)
    ap.add_argument("--indel-rate", type=float, default=0.0)
    ap.add_argument("-p", "--paired", action="store_true")
    ap.add_argument("-s", "--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from ..index.genome import genome_from_fasta
    from ..utils.simulate import simulate_reads, write_fastq

    g = genome_from_fasta(args.genome)
    rng = np.random.default_rng(args.seed)
    b1, b2 = simulate_reads(
        g, args.nreads, read_len=args.read_len, rng=rng,
        error_rate=args.error_rate, indel_rate=args.indel_rate,
        paired=args.paired,
    )
    if args.paired:
        write_fastq(args.output + "_R1.fastq", b1, suffix="/1")
        write_fastq(args.output + "_R2.fastq", b2, suffix="/2")
    else:
        write_fastq(args.output + ".fastq", b1)
    return 0


# --- detectionCall (detection-calls.c) ---------------------------------------

def detectioncall(argv=None) -> int:
    """GC-annotated detection-call inputs (detection-calls.c): per-exon
    rows carrying the gene-level GC fraction over the exon union, plus a
    `<output>-bins` file of 2000bp background bins over intergenic gaps
    (or intron gaps with -I), for the downstream detected/not-detected
    statistic.  Reference: DTCparse_GTF_and_Genome (:317-425),
    DTCanno_fill_gap (:196), DTCtotal_GC_bases (:165)."""
    ap = argparse.ArgumentParser(prog="detectionCall")
    ap.add_argument("-a", "--annotation", required=True, help="GTF/SAF")
    ap.add_argument("-G", "--genome", required=True, help="genome FASTA")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-F", "--anno-format", default="GTF", choices=["GTF", "SAF"])
    ap.add_argument("-g", "--gene-id", default="gene_id")
    ap.add_argument("-e", "--feature-type", default="exon")
    ap.add_argument("-I", "--intron-bins", action="store_true",
                    help="background bins from intron gaps, not intergenic")
    args = ap.parse_args(argv)
    import numpy as np

    from ..io.fasta import read_fasta
    from ..io.gtf import load_annotation

    BIN = 2000  # DTC_GAP_BIN_MIN_LENGTH

    contigs = {}
    for c in read_fasta(args.genome):
        # GC when code in {G=1, C=2} and not ambiguous; total = ACGT bases
        is_gc = ((c.codes == 1) | (c.codes == 2)) & ~c.ambig
        gc_cum = np.zeros(len(c.codes) + 1, np.int64)
        np.cumsum(is_gc, out=gc_cum[1:])
        tot_cum = np.zeros(len(c.codes) + 1, np.int64)
        np.cumsum(~c.ambig, out=tot_cum[1:])
        contigs[c.name] = (gc_cum, tot_cum, len(c.codes))

    def find_contig(chro):
        if chro in contigs:
            return contigs[chro]
        if len(chro) < 3 and "chr" + chro in contigs:
            return contigs["chr" + chro]
        if chro.lower().startswith("chr") and chro[3:] in contigs:
            return contigs[chro[3:]]
        return None

    def gc_total(chro, start, end):
        # 1-based inclusive, like DTCtotal_GC_bases
        ct = find_contig(chro)
        if ct is None or end > ct[2]:
            return 0, 0
        gc_cum, tot_cum, _ = ct
        return int(gc_cum[end] - gc_cum[start - 1]), int(
            tot_cum[end] - tot_cum[start - 1]
        )

    ann = load_annotation(args.annotation, fmt=args.anno_format)

    # per-gene exon-union GC over each chromosome (sweep in start order)
    gene_gc: dict[str, list[int]] = {}
    gene_span: dict[tuple[str, str], list[int]] = {}  # (chro, gene) -> span
    order = np.lexsort((ann.feat_start, np.asarray(ann.feat_chro)))
    for i in order:
        chro = ann.feat_chro[i]
        gname = ann.gene_names[int(ann.feat_gene[i])]
        s, e = int(ann.feat_start[i]), int(ann.feat_end[i])
        acc = gene_gc.setdefault(gname, [0, 0])
        span = gene_span.get((chro, gname))
        if span is None:
            gene_span[(chro, gname)] = [s, e]
            g, t = gc_total(chro, s, e)
            acc[0] += g
            acc[1] += t
        else:
            ns = max(s, span[1] + 1)
            if ns <= e:
                g, t = gc_total(chro, ns, e)
                acc[0] += g
                acc[1] += t
                span[1] = max(span[1], e)

    fill_no = 0

    def fill_gap(fbin, chro, start, stop):
        # DTCanno_fill_gap: >=2000bp bins, last bin absorbs the remainder
        nonlocal fill_no
        if stop < start:
            return
        cur = start
        while True:
            bin_end = cur + BIN
            if bin_end > stop + 1 - BIN:
                bin_end = stop + 1
            g, t = gc_total(chro, cur, bin_end - 1)
            fc = g / t if t else 0.0
            fbin.write(
                f"_fill_bin_{fill_no:07d}\t{chro}\t{cur}\t{bin_end - 1}"
                f"\t+\t{fc:.5f}\n"
            )
            fill_no += 1
            if bin_end >= stop:
                break
            cur += BIN

    with open(args.output, "w") as fg, open(args.output + "-bins", "w") as fb:
        header = "GeneID\tChr\tStart\tEnd\tStrand\tGCfraction\n"
        fg.write(header)
        fb.write(header)
        # background bins per chromosome
        by_chro: dict[str, list[tuple[int, int]]] = {}
        for (chro, gname), (s, e) in gene_span.items():
            by_chro.setdefault(chro, []).append((s, e))
        if args.intron_bins:
            # gaps between merged exon blocks inside gene spans
            exons_by_chro: dict[str, list[tuple[int, int]]] = {}
            for i in range(ann.n_features):
                exons_by_chro.setdefault(ann.feat_chro[i], []).append(
                    (int(ann.feat_start[i]), int(ann.feat_end[i]))
                )
            for chro, ivs in sorted(exons_by_chro.items()):
                ivs.sort()
                merged = []
                cs, ce = ivs[0]
                for s, e in ivs[1:]:
                    if s > ce:
                        merged.append((cs, ce))
                        cs, ce = s, e
                    else:
                        ce = max(ce, e)
                merged.append((cs, ce))
                spans = sorted(by_chro.get(chro, []))
                max_gene_end = 0
                last_end = 0
                for (s, e) in merged:
                    if last_end > 0 and s > last_end + 1:
                        fill_gap(fb, chro, last_end + 1, s - 1)
                    max_gene_end = max(
                        max_gene_end,
                        max((ge for gs, ge in spans if gs <= s), default=0),
                    )
                    last_end = e if max_gene_end > e else 0
        else:
            for chro, spans in sorted(by_chro.items()):
                ct = find_contig(chro)
                if ct is None:
                    continue
                spans.sort()
                top_s, top_e = spans[0]
                fill_gap(fb, chro, 1, top_s)
                for s, e in spans[1:]:
                    if top_e < s:
                        fill_gap(fb, chro, top_e + 1, s - 1)
                        top_s, top_e = s, e
                    else:
                        top_e = max(top_e, e)
                fill_gap(fb, chro, top_e + 1, ct[2] - 1)
        # per-exon rows with gene-level GC fraction (DTCwrite_annotations)
        strands = "+-."
        for i in range(ann.n_features):
            gname = ann.gene_names[int(ann.feat_gene[i])]
            g, t = gene_gc.get(gname, (0, 0))
            fc = g / t if t else 0.0
            st = "-" if strands[int(ann.feat_strand[i])] == "-" else "+"
            fg.write(
                f"{gname}\t{ann.feat_chro[i]}\t{int(ann.feat_start[i])}"
                f"\t{int(ann.feat_end[i])}\t{st}\t{fc:.5f}\n"
            )
    return 0


# --- mergeVCF (mergeVCF.c) ----------------------------------------------------

def mergevcf(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mergeVCF")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("inputs", nargs="+")
    args = ap.parse_args(argv)
    header_written = False
    rows = {}
    for path in args.inputs:
        for line in open(path):
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            key = (f[0], int(f[1]), f[3], f[4])
            if key not in rows:
                rows[key] = f
    with open(args.output, "w") as out:
        out.write("##fileformat=VCFv4.0\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for key in sorted(rows):
            out.write("\t".join(rows[key]) + "\n")
    print(f"// mergeVCF: {len(rows)} variants", file=sys.stderr)
    return 0


# --- samMappedBases -----------------------------------------------------------

def sammappedbases(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="samMappedBases")
    ap.add_argument("-i", "--input", required=True)
    args = ap.parse_args(argv)
    from ..io.sam import parse_cigar

    total = 0
    for f in _sam_records(args.input):
        if int(f[1]) & 0x4 or f[5] == "*":
            continue
        total += sum(n for n, op in parse_cigar(f[5]) if op in "M=X")
    print(f"MappedBases\t{total}")
    return 0


# --- filterJunctionTable ------------------------------------------------------

def filterjunctiontable(argv=None) -> int:
    """Filter a .junction.bed by minimum supporting reads."""
    ap = argparse.ArgumentParser(prog="filterJunctionTable")
    ap.add_argument("-i", "--input", required=True, help=".junction.bed")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-n", "--min-support", type=int, default=2)
    args = ap.parse_args(argv)
    kept = 0
    with open(args.output, "w") as out:
        for line in open(args.input):
            if line.startswith("#"):
                out.write(line)
                continue
            if int(line.split("\t")[4]) >= args.min_support:
                out.write(line)
                kept += 1
    print(f"// filterJunctionTable: kept {kept}", file=sys.stderr)
    return 0


TOOLS = {
    "propmapped": propmapped,
    "qualityScores": qualityscores,
    "removeDup": removedup,
    "flattenGTF": flattengtf,
    "repair": repair,
    "coverageCount": coveragecount,
    "fullscan": fullscan,
    "txUnique": txunique,
    "sam2fq": sam2fq,
    "genRandomReads": genrandomreads,
    "detectionCall": detectioncall,
    "mergeVCF": mergevcf,
    "samMappedBases": sammappedbases,
    "filterJunctionTable": filterjunctiontable,
}


def _globalreassembly(argv):
    from .globalreassembly import main as _m

    return _m(argv)


TOOLS["globalReassembly"] = _globalreassembly


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print(f"usage: utilities <tool> [args]; tools: {', '.join(TOOLS)}",
              file=sys.stderr)
        return 2
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
