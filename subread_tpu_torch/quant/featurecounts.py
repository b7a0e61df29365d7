"""Copy of `subread_tpu/quant/featurecounts.py`: the port imports nothing of the JAX package.

featureCounts: read-to-feature assignment and counting.

Reference: readSummary.c — annotation load (:975), sorted per-chromosome
feature blocks (:1509-1680), record gates (process_line_buffer
:2924-3211), overlap scoring/voting (vote_and_add_count :4611-5050),
summary categories (:7207).  This is the host-side engine; the hot
interval-assignment loop has a device (jnp.searchsorted-based) twin in
quant/device_count.py (--deviceCounts), fed by the native record parser
(native/fccount.cpp fc_read_sections_sam/_bam) and psum-merged across
chips/hosts.

Gate order (process_line_buffer): unmapped → read-type → singleton (-B) →
MAPQ (-Q) → chimera (-C) → fragment length (-P -d -D) → duplicate
(--ignoreDup) → multi-mapping (NH / -M / --primary) → secondary →
split/non-split → feature overlap → ambiguity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.gtf import Annotation
from ..io.sam import parse_cigar

SUMMARY_CATEGORIES = [
    "Assigned",
    "Unassigned_Unmapped",
    "Unassigned_Read_Type",
    "Unassigned_Singleton",
    "Unassigned_MappingQuality",
    "Unassigned_Chimera",
    "Unassigned_FragmentLength",
    "Unassigned_Duplicate",
    "Unassigned_MultiMapping",
    "Unassigned_Secondary",
    "Unassigned_NonSplit",
    "Unassigned_NoFeatures",
    "Unassigned_Overlapping_Length",
    "Unassigned_Ambiguity",
]


@dataclass
class FCOptions:
    paired: bool = False              # -p
    count_read_pairs: bool = False    # --countReadPairs
    require_both_ends: bool = False   # -B
    no_chimeric: bool = False         # -C
    check_pe_dist: bool = False       # -P
    min_fragment: int = 50            # -d
    max_fragment: int = 600           # -D
    count_multi: bool = False         # -M
    primary_only: bool = False        # --primary
    min_mapq: int = 0                 # -Q
    strand: int = 0                   # -s 0/1/2
    feature_level: bool = False       # -f
    allow_multi_overlap: bool = False # -O
    min_overlap: int = 1              # --minOverlap
    frac_overlap: float = 0.0         # --fracOverlap
    largest_overlap: bool = False     # --largestOverlap
    read2pos: int = 0                 # --read2pos 5|3 (0 = off)
    ext5: int = 0                     # --readExtension5
    ext3: int = 0                     # --readExtension3
    ignore_dup: bool = False          # --ignoreDup
    fraction: bool = False            # --fraction
    max_mop: int = 10                 # --maxMOp
    split_only: bool = False          # --splitOnly
    non_split_only: bool = False      # --nonSplitOnly
    count_junctions: bool = False     # -J
    # --readShiftSize / --readShiftType (readSummary.c:3226-3239)
    read_shift_size: int = 0
    read_shift_type: str = "upstream"  # upstream|downstream|left|right
    # --nonOverlap / --nonOverlapFeature / --fracOverlapFeature
    # (readSummary.c:4703-4760, 4908-4919); -1 = no limit
    non_overlap: int = -1
    non_overlap_feature: int = -1
    frac_overlap_feature: float = 0.0
    by_read_group: bool = False       # --byReadGroup
    long_reads: bool = False          # -L (no MOp cap, SE counting)
    verbose: bool = False             # --verbose


class _ChromIndex:
    """Sorted-by-start feature arrays for one chromosome with a prefix-max
    end for bounded backward scans (the reference's block min_start/max_end
    structure, readSummary.c:1592-1680, recast)."""

    def __init__(self, idx: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        order = np.argsort(starts, kind="stable")
        self.feat_idx = idx[order]
        self.starts = starts[order]
        self.ends = ends[order]
        self.prefix_max_end = np.maximum.accumulate(self.ends)

    def query(self, s: int, e: int) -> np.ndarray:
        """Feature indices overlapping [s, e] (1-based inclusive)."""
        hi = np.searchsorted(self.starts, e, side="right")
        out = []
        i = hi - 1
        while i >= 0 and self.prefix_max_end[i] >= s:
            if self.ends[i] >= s:
                out.append(i)
            i -= 1
        return np.asarray(out[::-1], dtype=np.int64)


@dataclass
class _Rec:
    flag: int
    chro: str
    pos: int
    mapq: int
    cigar: str
    tlen: int
    nh: int
    qname: str = ""
    rg: str | None = None
    raw: list[str] | None = None   # full SAM fields (kept for -R SAM/BAM)


def _parse_rec(fields: list[str], keep_raw: bool = False) -> _Rec:
    nh = 1
    rg = None
    for tag in fields[11:]:
        if tag.startswith("NH:i:"):
            nh = int(tag[5:])
        elif tag.startswith("RG:Z:"):
            rg = tag[5:]
    return _Rec(
        flag=int(fields[1]),
        chro=fields[2],
        pos=int(fields[3]),
        mapq=int(fields[4]),
        cigar=fields[5],
        tlen=int(fields[8]),
        nh=nh,
        qname=fields[0],
        rg=rg,
        raw=fields if keep_raw else None,
    )


def _sections(rec: _Rec, max_mop: int) -> list[tuple[int, int]]:
    """CIGAR → genomic [start, end] sections (1-based incl.), split at N.
    M/D/=/X consume reference within a section; N splits; at most max_mop
    M operations are honoured (--maxMOp, readSummary.c)."""
    if rec.cigar == "*":
        return []
    out = []
    p = rec.pos
    sec_start = None
    n_m = 0
    for n, op in parse_cigar(rec.cigar):
        if op in "M=X":
            n_m += 1
            if n_m > max_mop:
                break
            if sec_start is None:
                sec_start = p
            p += n
        elif op == "D":
            if sec_start is not None:
                p += n
            else:
                p += n
        elif op == "N":
            if sec_start is not None:
                out.append((sec_start, p - 1))
                sec_start = None
            p += n
        # I/S/H/P consume no reference
    if sec_start is not None:
        out.append((sec_start, p - 1))
    return out


class FeatureCounter:
    def __init__(self, annotation: Annotation, opts: FCOptions,
                 chro_aliases: dict[str, str] | None = None):
        # chro_aliases maps annotation chromosome name to SAM chromosome
        # name (-A alias CSV, readSummary.c alias table).
        self.ann = annotation
        self.opts = opts
        # targets: per-gene (meta-feature) or per-feature row (-f)
        if opts.feature_level:
            self.n_targets = annotation.n_features
            self.feat_target = np.arange(annotation.n_features, dtype=np.int64)
        else:
            self.n_targets = len(annotation.gene_names)
            self.feat_target = annotation.feat_gene.astype(np.int64)
        self.by_chrom: dict[str, _ChromIndex] = {}
        chro_arr = np.asarray(annotation.feat_chro)
        for chro in set(annotation.feat_chro):
            sel = np.flatnonzero(chro_arr == chro)
            ci = _ChromIndex(
                sel, annotation.feat_start[sel], annotation.feat_end[sel]
            )
            # register fuzzy aliases: with/without "chr" prefix, lower-case
            # (the reference's chromosome-name inference)
            aliases = {chro, chro.lower(),
                       chro[3:] if chro.lower().startswith("chr") else "chr" + chro}
            if chro_aliases and chro in chro_aliases:
                aliases.add(chro_aliases[chro])
            for alias in aliases:
                self.by_chrom.setdefault(alias, ci)
            self.by_chrom[chro] = ci
        self.counts = np.zeros(self.n_targets, dtype=np.float64)
        self.summary = {c: 0 for c in SUMMARY_CATEGORIES}
        self.jcounts: dict[tuple[str, int, int], float] = {}
        # --byReadGroup: per-RG (counts, summary) tables keyed by RG id
        self.rg_tables: dict[str, tuple[np.ndarray, dict]] = {}
        # -R detail output (write_read_details_FP, readSummary.c:2851)
        self._detail_fh = None
        self._detail_fmt = None
        # --scSampleSheet sub-mode: a quant.fc_scrna.ScRNACounter fed one
        # (read_name, gene, mapped) triple per fragment
        self.sc = None

    # --- per-RG tables / -R detail output -----------------------------------

    def _tables(self, recs) -> tuple[np.ndarray, dict]:
        """Count/summary tables for this fragment: the per-RG tables when
        --byReadGroup (readSummary.c get_RG_tables), else the globals."""
        if self.opts.by_read_group:
            rg = next((r.rg for r in recs if r.rg), None)
            if rg is not None:
                if rg not in self.rg_tables:
                    self.rg_tables[rg] = (
                        np.zeros(self.n_targets, dtype=np.float64),
                        {c: 0 for c in SUMMARY_CATEGORIES},
                    )
                return self.rg_tables[rg]
        return self.counts, self.summary

    def _target_name(self, t: int) -> str:
        if self.opts.feature_level:
            return self.ann.gene_names[int(self.ann.feat_gene[t])]
        return self.ann.gene_names[t]

    def open_details(self, path: str, fmt: str = "CORE") -> None:
        """-R CORE/SAM detail stream: one line per read giving the
        assignment status (reference write_read_details_FP)."""
        self._detail_fmt = fmt.upper()
        self._detail_fh = open(path, "w")

    def close_details(self) -> None:
        if self._detail_fh is not None:
            self._detail_fh.close()
            self._detail_fh = None

    def _detail(self, recs, status: str, count: int, features) -> None:
        if self._detail_fh is None:
            return
        if self._detail_fmt == "CORE":
            qname = recs[0].qname
            self._detail_fh.write(
                f"{qname}\t{status}\t{count}\t{features or 'NA'}\n"
            )
        else:  # SAM: original record + XS/XN/XT tags
            for r in recs:
                if r.raw is None:
                    continue
                tags = [f"XS:Z:{status}"]
                if count > 0:
                    tags += [f"XN:i:{count}", f"XT:Z:{features}"]
                self._detail_fh.write("\t".join(r.raw + tags) + "\n")

    # --- fragment-level processing ----------------------------------------

    def _read_interval_ops(self, rec: _Rec) -> list[tuple[int, int]]:
        o = self.opts
        secs = _sections(rec, 1 << 30 if o.long_reads else o.max_mop)
        if not secs:
            return []
        if o.read_shift_size > 0:
            # readSummary.c:3226-3239: upstream = toward the read's 5' end
            # (left for fwd-strand reads, right for reverse), downstream the
            # opposite; left/right are absolute chromosome directions.
            neg = bool(rec.flag & 0x10)
            t = o.read_shift_type
            if t == "left" or (t == "upstream" and not neg) or (
                t == "downstream" and neg
            ):
                d = -o.read_shift_size
            else:
                d = o.read_shift_size
            secs = [(max(1, s + d), max(1, e + d)) for s, e in secs]
        if o.read2pos == 5:
            p = secs[0][0] if not (rec.flag & 0x10) else secs[-1][1]
            secs = [(p, p)]
        elif o.read2pos == 3:
            p = secs[-1][1] if not (rec.flag & 0x10) else secs[0][0]
            secs = [(p, p)]
        if o.ext5:
            if rec.flag & 0x10:
                s, e = secs[-1]
                secs[-1] = (s, e + o.ext5)
            else:
                s, e = secs[0]
                secs[0] = (max(1, s - o.ext5), e)
        if o.ext3:
            if rec.flag & 0x10:
                s, e = secs[0]
                secs[0] = (max(1, s - o.ext3), e)
            else:
                s, e = secs[-1]
                secs[-1] = (s, e + o.ext3)
        return secs

    def _assign(self, recs: list[_Rec]) -> None:
        """Fragment gates + vote_and_add_count semantics
        (readSummary.c:2924-3211, 4611-5050):

        * without -O a target hit by both ends (vote 2) beats one hit by a
          single end (vote 1); remaining ties -> Ambiguity;
        * overlap lengths are merged unions per target (a read overlapping
          an exon twice, or both mates overlapping, never double-counts);
        * --largestOverlap scores overlap*2 + (both-ends ? 1 : 0) and keeps
          only the maximum (reference 15FEB2023 rule);
        * chimeric = NOT (same chromosome AND opposite strands)
          (readSummary.c:3066-3113); PE distance uses |TLEN|;
        * PE MAPQ gate uses max(mapq1, mapq2) (readSummary.c:3048).
        """
        o = self.opts
        counts, s = self._tables(recs)
        mapped = [r for r in recs if not (r.flag & 0x4) and r.cigar != "*"]
        if not mapped:
            s["Unassigned_Unmapped"] += 1
            self._detail(recs, "Unassigned_Unmapped", 0, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, False)
            return
        if o.require_both_ends and o.paired:
            paired_recs = [r for r in recs if r.flag & 0x1]
            if len(mapped) < 2 and paired_recs:
                s["Unassigned_Singleton"] += 1
                self._detail(recs, "Unassigned_Singleton", 0, None)
                if self.sc is not None:
                    self.sc.add_fragment(recs[0].qname, -1, True)
                return
        if o.min_mapq:
            q = max(r.mapq for r in mapped) if o.paired else mapped[0].mapq
            if q < o.min_mapq:
                s["Unassigned_MappingQuality"] += 1
                self._detail(recs, "Unassigned_MappingQuality", 0, None)
                if self.sc is not None:
                    self.sc.add_fragment(recs[0].qname, -1, True)
                return
        if o.paired and len(mapped) == 2 and (o.check_pe_dist or o.no_chimeric):
            r1, r2 = mapped[0], mapped[1]
            opposite = ((r1.flag & 0x10) != 0) != ((r2.flag & 0x10) != 0)
            if r1.chro == r2.chro and opposite:
                if o.check_pe_dist:
                    flen = abs(r1.tlen)
                    if not (o.min_fragment <= flen <= o.max_fragment):
                        s["Unassigned_FragmentLength"] += 1
                        self._detail(recs, "Unassigned_FragmentLength", -1, None)
                        if self.sc is not None:
                            self.sc.add_fragment(recs[0].qname, -1, True)
                        return
            else:
                if o.no_chimeric:
                    s["Unassigned_Chimera"] += 1
                    self._detail(recs, "Unassigned_Chimera", -1, None)
                    if self.sc is not None:
                        self.sc.add_fragment(recs[0].qname, -1, True)
                    return
        if o.ignore_dup and any(r.flag & 0x400 for r in recs):
            s["Unassigned_Duplicate"] += 1
            self._detail(recs, "Unassigned_Duplicate", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return
        nh = max(r.nh for r in mapped)
        is_multi = nh > 1
        if is_multi and not o.count_multi:
            s["Unassigned_MultiMapping"] += 1
            self._detail(recs, "Unassigned_MultiMapping", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return
        if o.primary_only and any(r.flag & 0x100 for r in mapped):
            s["Unassigned_MultiMapping"] += 1
            self._detail(recs, "Unassigned_MultiMapping", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return
        has_split = any("N" in r.cigar for r in mapped)
        if o.split_only and not has_split:
            s["Unassigned_NonSplit"] += 1
            self._detail(recs, "Unassigned_NonSplit", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return
        if o.non_split_only and has_split:
            s["Unassigned_NonSplit"] += 1
            self._detail(recs, "Unassigned_Split", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return

        # strandness: fragment strand = strand of the first-in-pair read
        frag_strand = None
        if o.strand:
            first = next((r for r in mapped if r.flag & 0x40), mapped[0])
            frag_strand = 1 if (first.flag & 0x10) else 0
            if o.strand == 2:
                frag_strand ^= 1

        # per-end overlap intervals per feature (exon), then per target
        feat_hits: list[dict[int, list[tuple[int, int]]]] = [{}, {}]
        span_ivs: list[tuple[str, int, int]] = []
        for ei, r in enumerate(mapped[:2]):
            for (ss, ee) in self._read_interval_ops(r):
                span_ivs.append((r.chro, ss, ee))
                ci = self.by_chrom.get(r.chro)
                if ci is None:
                    if o.verbose:
                        import sys
                        print(f"WARNING: unmatched chromosome/contig: "
                              f"{r.chro}", file=sys.stderr)
                    continue
                for j in ci.query(ss, ee):
                    fi = int(ci.feat_idx[j])
                    if frag_strand is not None:
                        fstr = int(self.ann.feat_strand[fi])
                        if fstr != 2 and fstr != frag_strand:
                            continue
                    ov_s = max(ss, int(ci.starts[j]))
                    ov_e = min(ee, int(ci.ends[j]))
                    if ov_s <= ov_e:
                        feat_hits[ei].setdefault(fi, []).append((ov_s, ov_e))

        if o.count_junctions:
            self._count_junctions(mapped, None)

        def union_len(ivs):
            ivs = sorted(ivs)
            total = 0
            cs, ce = ivs[0]
            for a, b in ivs[1:]:
                if a > ce + 1:
                    total += ce - cs + 1
                    cs, ce = a, b
                else:
                    ce = max(ce, b)
            return total + ce - cs + 1

        # feature-side overlap gates (--fracOverlapFeature / --nonOverlapFeature,
        # readSummary.c:4703-4760): union overlap with the feature across both
        # ends must reach max(ceil.001(frac*span), span - nonOverlapFeature).
        if o.frac_overlap_feature > 0 or o.non_overlap_feature >= 0:
            for fi in set(feat_hits[0]) | set(feat_hits[1]):
                span = int(self.ann.feat_end[fi] - self.ann.feat_start[fi] + 1)
                thr_missing = 0
                if o.non_overlap_feature >= 0 and span > o.non_overlap_feature:
                    thr_missing = span - o.non_overlap_feature
                frac_f = o.frac_overlap_feature * span
                thr_frac = int(frac_f)
                if frac_f - thr_frac >= 0.001:
                    thr_frac += 1
                need_f = max(thr_frac, thr_missing)
                ov = union_len(
                    feat_hits[0].get(fi, []) + feat_hits[1].get(fi, [])
                )
                if ov < need_f:
                    feat_hits[0].pop(fi, None)
                    feat_hits[1].pop(fi, None)

        end_hits: list[dict[int, list[tuple[int, int]]]] = [{}, {}]
        for ei in range(2):
            for fi, ivs in feat_hits[ei].items():
                t = int(self.feat_target[fi])
                end_hits[ei].setdefault(t, []).extend(ivs)

        targets = set(end_hits[0]) | set(end_hits[1])
        if not targets:
            s["Unassigned_NoFeatures"] += 1
            self._detail(recs, "Unassigned_NoFeatures", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return

        need_len = (o.min_overlap > 1 or o.frac_overlap > 0
                    or o.largest_overlap or o.non_overlap >= 0)

        numbers: dict[int, int] = {}
        for t in targets:
            n_ends = (t in end_hits[0]) + (t in end_hits[1])
            numbers[t] = 1 if o.allow_multi_overlap else n_ends

        if need_len:
            overlaps = {
                t: union_len(end_hits[0].get(t, []) + end_hits[1].get(t, []))
                for t in targets
            }
            # fragment length = merged union of both mates' sections
            # (calc_total_frag_len, readSummary.c:2142)
            read_span = 0
            for chro in {c for c, _, _ in span_ivs}:
                read_span += union_len(
                    [(a, b) for c, a, b in span_ivs if c == chro]
                )
            need = o.min_overlap
            if o.frac_overlap > 0:
                frac_need = int(o.frac_overlap * read_span)
                if o.frac_overlap * read_span - frac_need >= 0.001:
                    frac_need += 1
                need = max(need, frac_need)
            if o.non_overlap >= 0 and read_span > o.non_overlap:
                # --nonOverlap (readSummary.c:4908-4911): at most N read
                # bases may fall outside the assigned feature.
                need = max(need, read_span - o.non_overlap)
            if o.largest_overlap:
                for t in targets:
                    both = (t in end_hits[0]) and (t in end_hits[1])
                    numbers[t] = overlaps[t] * 2 + (1 if both else 0)
                longest = max(numbers.values())
            else:
                longest = 0
            for t in targets:
                if overlaps[t] < need or numbers[t] < longest:
                    numbers[t] = 0

        best = max(numbers.values())
        if best < 1:
            s["Unassigned_Overlapping_Length"] += 1
            self._detail(recs, "Unassigned_Overlapping_Length", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return
        winners = [t for t, v in numbers.items() if v == best]
        if len(winners) > 1 and not o.allow_multi_overlap:
            s["Unassigned_Ambiguity"] += 1
            self._detail(recs, "Unassigned_Ambiguity", -1, None)
            if self.sc is not None:
                self.sc.add_fragment(recs[0].qname, -1, True)
            return

        weight = 1.0
        if o.fraction:
            if o.count_multi and is_multi:
                weight /= nh
            if o.allow_multi_overlap and len(winners) > 1:
                weight /= len(winners)
        s["Assigned"] += 1
        for t in winners:
            counts[t] += weight
        if self.sc is not None:
            self.sc.add_fragment(
                recs[0].qname,
                int(winners[0]) if len(winners) == 1 else -1, True,
            )
        if self._detail_fh is not None:
            names = ",".join(self._target_name(t) for t in winners)
            self._detail(recs, "Assigned", len(winners), names)

    def _count_junctions(self, mapped, overlap):
        for r in mapped:
            p = r.pos
            last_exon_end = None
            for n, op in parse_cigar(r.cigar):
                if op in "MD=X":
                    p += n
                elif op == "N":
                    site1 = p - 1        # last base of left exon
                    site2 = p + n        # first base of right exon
                    key = (r.chro, site1, site2)
                    self.jcounts[key] = self.jcounts.get(key, 0) + 1
                    p += n
                    last_exon_end = p

    # --- record streaming ---------------------------------------------------

    def count_file(self, path: str) -> None:
        """Dispatch SAM text vs BAM by magic bytes."""
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic == b"\x1f\x8b":
            self.count_bam(path)
        else:
            self.count_sam(path)

    def _count_bam_native(self, path: str) -> bool:
        from .. import native
        from ..io.bam import BamReader

        o = self.opts
        nt = self._native_tables()
        names = nt[0]
        rd = BamReader(path)
        name_to_ci = {n: i for i, n in enumerate(names)}
        ref2chrom = np.asarray(
            [name_to_ci.get(n, -1) for n in rd.ref_names], np.int32
        )
        kw = dict(
            n_targets=self.n_targets,
            min_mapq=o.min_mapq, primary_only=o.primary_only,
            ignore_dup=o.ignore_dup, count_multi=o.count_multi,
            strandness=o.strand, max_mop=o.max_mop,
        )
        if o.paired:
            res = native.fc_count_bam_pe(
                rd._data, ref2chrom, *nt[1:], start=rd._off, **kw
            )
            if res is None:
                return False
            results = [res]
        else:
            # SE records are independent: record-aligned ranges count in
            # parallel threads (the ctypes call releases the GIL)
            import os as _os
            from concurrent.futures import ThreadPoolExecutor

            T = min(8, _os.cpu_count() or 1)
            spans = None
            if T > 1 and len(rd._data) - rd._off > (1 << 23):
                cuts = native.fc_bam_split_offsets(rd._data, rd._off, T)
                if cuts:
                    edges = [0] + cuts + [len(rd._data) - rd._off]
                    edges = sorted(set(edges))
                    spans = [
                        (rd._off + edges[i], edges[i + 1] - edges[i])
                        for i in range(len(edges) - 1)
                        if edges[i + 1] > edges[i]
                    ]
            if spans and len(spans) > 1:
                with ThreadPoolExecutor(len(spans)) as ex:
                    results = list(ex.map(
                        lambda sp: native.fc_count_bam_simple(
                            rd._data, ref2chrom, *nt[1:],
                            start=sp[0], length=sp[1], **kw
                        ),
                        spans,
                    ))
            else:
                results = [native.fc_count_bam_simple(
                    rd._data, ref2chrom, *nt[1:], start=rd._off, **kw
                )]
        if any(r is None for r in results):
            return False
        for counts, summ, _n in results:
            self.counts += counts
            for k, v in summ.items():
                self.summary[k] += v
        return True

    def count_bam(self, path: str) -> None:
        if self._native_eligible() and self._count_bam_native(path):
            return
        from ..io.bam import bam_to_sam_lines

        o = self.opts
        keep_raw = self._detail_fmt in ("SAM", "BAM")
        pending: dict[str, list[str]] = {}
        for fields in bam_to_sam_lines(path):
            flag = int(fields[1])
            if o.paired and (flag & 0x1):
                qname = fields[0]
                mate = pending.pop(qname, None)
                if mate is None:
                    pending[qname] = fields
                else:
                    self._assign([_parse_rec(mate, keep_raw),
                                  _parse_rec(fields, keep_raw)])
            else:
                self._assign([_parse_rec(fields, keep_raw)])
        for fields in pending.values():
            self._assign([_parse_rec(fields, keep_raw)])

    # --- native fast path --------------------------------------------------

    def _native_eligible(self) -> bool:
        """True when the active options are inside the subset the C++
        fast path implements exactly (single-end, default overlap rules;
        the PE fast path additionally needs --countReadPairs and no
        -B/-C/-P gates — see _native_pe_eligible)."""
        o = self.opts
        if o.paired:
            return self._native_pe_eligible()
        return not (
            o.allow_multi_overlap or o.fraction
            or o.largest_overlap or o.min_overlap > 1 or o.frac_overlap > 0
            or o.read2pos or o.ext5 or o.ext3 or o.split_only
            or o.non_split_only or o.count_junctions
            or o.read_shift_size or o.non_overlap >= 0
            or o.non_overlap_feature >= 0 or o.frac_overlap_feature > 0
            or o.by_read_group or o.long_reads
            or self._detail_fh is not None
            or self.sc is not None
        )

    def _native_pe_eligible(self) -> bool:
        o = self.opts
        return o.count_read_pairs and not (
            o.require_both_ends or o.no_chimeric or o.check_pe_dist
            or o.allow_multi_overlap or o.fraction
            or o.largest_overlap or o.min_overlap > 1 or o.frac_overlap > 0
            or o.read2pos or o.ext5 or o.ext3 or o.split_only
            or o.non_split_only or o.count_junctions
            or o.read_shift_size or o.non_overlap >= 0
            or o.non_overlap_feature >= 0 or o.frac_overlap_feature > 0
            or o.by_read_group or o.long_reads
            or self._detail_fh is not None
            or self.sc is not None
        )

    def _native_tables(self):
        if not hasattr(self, "_nt"):
            names, fs, fe, pm, tg, st = [], [], [], [], [], []
            offs = [0]
            for alias, ci in self.by_chrom.items():
                names.append(alias)
                fs.append(ci.starts)
                fe.append(ci.ends)
                pm.append(ci.prefix_max_end)
                tg.append(self.feat_target[ci.feat_idx])
                st.append(self.ann.feat_strand[ci.feat_idx])
                offs.append(offs[-1] + len(ci.starts))
            cat = lambda a: (
                np.concatenate(a) if a else np.zeros(0, np.int64)
            )
            self._nt = (
                names, cat(fs), cat(fe), cat(pm), cat(tg), cat(st),
                np.asarray(offs, np.int64),
            )
        return self._nt

    def _count_sam_native(self, path: str) -> bool:
        from .. import native

        import os
        from concurrent.futures import ThreadPoolExecutor

        o = self.opts
        nt = self._native_tables()
        with open(path, "rb") as f:
            data = f.read()

        if o.paired:
            # PE: qname mate-pairing crosses any line range, so no thread
            # fan-out; the single pass still runs at C speed
            res = native.fc_count_sam_pe(
                data, *nt, n_targets=self.n_targets,
                min_mapq=o.min_mapq, primary_only=o.primary_only,
                ignore_dup=o.ignore_dup, count_multi=o.count_multi,
                strandness=o.strand, max_mop=o.max_mop,
            )
            if res is None:
                return False
            counts, summ, _n = res
            self.counts += counts
            for k, v in summ.items():
                self.summary[k] += v
            return True

        def run(start, length):
            return native.fc_count_sam_simple(
                data, *nt, n_targets=self.n_targets,
                min_mapq=o.min_mapq, primary_only=o.primary_only,
                ignore_dup=o.ignore_dup, count_multi=o.count_multi,
                strandness=o.strand, max_mop=o.max_mop,
                start=start, length=length,
            )

        # line-aligned ranges counted in parallel (the ctypes call releases
        # the GIL; records are independent in the simple-options subset)
        T = min(8, os.cpu_count() or 1)
        if T > 1 and len(data) > (1 << 22):
            cuts = [0]
            step = len(data) // T
            for t in range(1, T):
                j = data.find(b"\n", t * step)
                cuts.append(len(data) if j < 0 else j + 1)
            cuts.append(len(data))
            cuts = sorted(set(cuts))
            spans = [
                (cuts[i], cuts[i + 1] - cuts[i])
                for i in range(len(cuts) - 1)
                if cuts[i + 1] > cuts[i]
            ]
            with ThreadPoolExecutor(len(spans)) as ex:
                results = list(ex.map(lambda s: run(*s), spans))
            if any(r is None for r in results):
                return False
            for counts, summ, _n in results:
                self.counts += counts
                for k, v in summ.items():
                    self.summary[k] += v
            return True
        res = run(0, len(data))
        if res is None:
            return False
        counts, summ, _n = res
        self.counts += counts
        for k, v in summ.items():
            self.summary[k] += v
        return True

    def count_sam(self, path: str,
                  orphan_budget: int | None = 2_000_000) -> None:
        """Stream a SAM text file; mates re-paired by name (the SAM_pairer
        analog, input-files.c:2562 — here a host hash of pending mates).

        orphan_budget bounds the in-RAM pending-mate table: when a
        name-scattered input accumulates more orphans, they SPILL to
        qname-hashed bucket files on disk and are paired per bucket after
        the streaming pass (the reference spills orphan blocks and merges
        them in rounds, input-files.c:5672).  Counting is order-free, so
        bucket-order pairing is exact; per-read detail output keeps the
        unbounded path (order matters there)."""
        if self._native_eligible() and self._count_sam_native(path):
            return
        o = self.opts
        keep_raw = self._detail_fmt in ("SAM", "BAM")
        if keep_raw:
            orphan_budget = None  # detail files need streaming order
        spill_dir = None
        spill_fps: list = []
        N_BUCKETS = 64

        def spill(items):
            nonlocal spill_dir, spill_fps
            if spill_dir is None:
                import tempfile

                from ..utils.cleanup import register

                spill_dir = tempfile.TemporaryDirectory(
                    prefix="fc_orphans_"
                )
                # orphan spill survives only while pairing runs; a signal
                # or crash removes it (reference deletes its temp BAM
                # blocks the same way, SIGINT_hook analog)
                register(spill_dir.name)
                spill_fps = [
                    open(f"{spill_dir.name}/b{b:02d}.sam", "a+")
                    for b in range(N_BUCKETS)
                ]
            for qname, fields in items:
                b = hash(qname) % N_BUCKETS
                spill_fps[b].write("\t".join(fields) + "\n")

        pending: dict[str, list[str]] = {}
        with open(path) as f:
            for line in f:
                if line.startswith("@") or not line.strip():
                    continue
                fields = line.rstrip("\n").split("\t")
                flag = int(fields[1])
                if o.paired and (flag & 0x1):
                    qname = fields[0]
                    mate = pending.pop(qname, None)
                    if mate is None:
                        pending[qname] = fields
                        if orphan_budget and len(pending) > orphan_budget:
                            spill(pending.items())
                            pending.clear()
                    else:
                        self._assign([_parse_rec(mate, keep_raw),
                                      _parse_rec(fields, keep_raw)])
                else:
                    self._assign([_parse_rec(fields, keep_raw)])
        if spill_dir is not None:
            # merge rounds: per-bucket pairing (each bucket holds all
            # spilled records of its qname-hash class, so pairs meet)
            spill(pending.items())
            pending.clear()
            for fp in spill_fps:
                fp.seek(0)
                bucket: dict[str, list[str]] = {}
                for line in fp:
                    fields = line.rstrip("\n").split("\t")
                    qname = fields[0]
                    mate = bucket.pop(qname, None)
                    if mate is None:
                        bucket[qname] = fields
                    else:
                        self._assign([_parse_rec(mate, keep_raw),
                                      _parse_rec(fields, keep_raw)])
                for fields in bucket.values():
                    self._assign([_parse_rec(fields, keep_raw)])
                fp.close()
            spill_dir.cleanup()
            from ..utils.cleanup import unregister

            unregister(spill_dir.name)
            return
        # leftover singletons (mate never seen)
        for fields in pending.values():
            self._assign([_parse_rec(fields, keep_raw)])

    # --- outputs ------------------------------------------------------------

    def _count_columns(
        self, input_names: list[str]
    ) -> tuple[list[str], list[np.ndarray]]:
        """Column headers + count vectors: one per input, or one per
        (input, read-group) when --byReadGroup (reference appends RG ids
        to the file name with ':')."""
        if self.opts.by_read_group and self.rg_tables:
            hdr, cols = [], []
            base = input_names[0] if input_names else "input"
            for rg in sorted(self.rg_tables):
                hdr.append(f"{base}:{rg}")
                cols.append(self.rg_tables[rg][0])
            return hdr, cols
        return list(input_names), [self.counts]

    def write_counts(self, path: str, input_names: list[str]) -> None:
        ann = self.ann
        hdr, cols = self._count_columns(input_names)
        extra_names = ann.extra_attr_names
        with open(path, "w") as f:
            f.write(
                "# Program:subread_tpu featureCounts; Output:gene-level\n"
            )
            extra_hdr = "".join("\t" + n for n in extra_names)
            # --detectionCall: GCfraction echoed as the 2nd column
            # (readSummary.c:6954,7129-7136)
            gc_hdr = "GCfraction\t" if ann.gene_gc is not None else ""
            f.write(
                f"Geneid\t{gc_hdr}Chr\tStart\tEnd\tStrand\tLength"
                + extra_hdr + "\t" + "\t".join(hdr) + "\n"
            )
            strands = "+-."

            def gc_col(gidx: int) -> str:
                if ann.gene_gc is None:
                    return ""
                return ann.gene_gc.get(ann.gene_names[gidx], "nan") + "\t"

            def extras(gidx: int) -> str:
                return "".join(
                    "\t" + ann.gene_extra[ai][gidx]
                    for ai in range(len(extra_names))
                )

            if self.opts.feature_level:
                for i in range(ann.n_features):
                    gidx = int(ann.feat_gene[i])
                    cnts = "\t".join(self._fmt(c[i]) for c in cols)
                    f.write(
                        f"{ann.gene_names[gidx]}\t{gc_col(gidx)}{ann.feat_chro[i]}"
                        f"\t{int(ann.feat_start[i])}\t{int(ann.feat_end[i])}"
                        f"\t{strands[int(ann.feat_strand[i])]}"
                        f"\t{int(ann.feat_end[i]-ann.feat_start[i]+1)}"
                        f"{extras(gidx)}\t{cnts}\n"
                    )
            else:
                lengths = ann.gene_lengths()
                # one global (gene, start) sort + searchsorted group bounds
                # instead of a per-gene flatnonzero scan (O(F log F) total,
                # was O(G*F): 1.3s of the 2M-record BAM wall on 20K genes)
                order_all = np.lexsort(
                    (np.arange(ann.n_features), ann.feat_start, ann.feat_gene)
                )
                fg_sorted = ann.feat_gene[order_all]
                bounds = np.searchsorted(
                    fg_sorted, np.arange(len(ann.gene_names) + 1)
                )
                fstart_s = ann.feat_start[order_all]
                fend_s = ann.feat_end[order_all]
                fstrand_s = ann.feat_strand[order_all]
                for gidx, gname in enumerate(ann.gene_names):
                    lo, hi = int(bounds[gidx]), int(bounds[gidx + 1])
                    order = order_all[lo:hi]
                    chrs = ";".join(ann.feat_chro[i] for i in order)
                    starts = ";".join(map(str, fstart_s[lo:hi].tolist()))
                    ends = ";".join(map(str, fend_s[lo:hi].tolist()))
                    strs = ";".join(strands[s] for s in fstrand_s[lo:hi].tolist())
                    cnts = "\t".join(self._fmt(c[gidx]) for c in cols)
                    f.write(
                        f"{gname}\t{gc_col(gidx)}{chrs}\t{starts}\t{ends}\t{strs}"
                        f"\t{int(lengths[gidx])}{extras(gidx)}\t{cnts}\n"
                    )

    @staticmethod
    def _fmt(v: float) -> str:
        if abs(v - round(v)) < 1e-9:
            return str(int(round(v)))
        return f"{v:.2f}"

    def write_summary(self, path: str, input_names: list[str]) -> None:
        hdr, _ = self._count_columns(input_names)
        tables = (
            [self.rg_tables[rg][1] for rg in sorted(self.rg_tables)]
            if self.opts.by_read_group and self.rg_tables
            else [self.summary]
        )
        with open(path, "w") as f:
            f.write("Status\t" + "\t".join(hdr) + "\n")
            for c in SUMMARY_CATEGORIES:
                # readSummary.c:7207: the split gate's category is labelled
                # by mode — Unassigned_Split under --nonSplitOnly.
                label = (
                    "Unassigned_Split" if c == "Unassigned_NonSplit" and
                    self.opts.non_split_only else c
                )
                vals = "\t".join(str(t[c]) for t in tables)
                f.write(f"{label}\t{vals}\n")

    def _junction_genes(self, chro: str, s1: int, s2: int) -> tuple[str, str]:
        """PrimaryGene/SecondaryGenes for a junction: genes whose features
        overlap either splice site; primary = max overlap-count then first
        appearance (readSummary.c jcounts output)."""
        ci = self.by_chrom.get(chro)
        if ci is None:
            return "NA", "NA"
        votes: dict[int, int] = {}
        for site in (s1, s2):
            for j in ci.query(site, site):
                g = int(self.ann.feat_gene[int(ci.feat_idx[j])])
                votes[g] = votes.get(g, 0) + 1
        if not votes:
            return "NA", "NA"
        primary = max(votes, key=lambda g: (votes[g], -g))
        secondary = sorted(g for g in votes if g != primary)
        return (
            self.ann.gene_names[primary],
            ";".join(self.ann.gene_names[g] for g in secondary) or "NA",
        )

    def write_jcounts(self, path: str, input_names: list[str],
                      genome=None) -> None:
        """-J output.  With a genome (fasta path or Genome), splice-site
        strand comes from the donor/acceptor motif (GT..AG fwd, CT..AC rev
        — the -G option's use in the reference)."""
        lookup = None
        if genome is not None:
            from ..index.genome import Genome, genome_from_fasta

            g = genome if isinstance(genome, Genome) else genome_from_fasta(genome)
            name_to_ci = {n: i for i, n in enumerate(g.names)}

            def lookup(chro, s1, s2):
                ci = name_to_ci.get(chro)
                if ci is None:
                    return "NA"
                import numpy as _np

                def base(p):
                    lin = g.chro_to_linear(ci, p - 1)
                    return "AGCT"[int(g.codes[lin])]

                donor = base(s1 + 1) + base(s1 + 2)
                accep = base(s2 - 2) + base(s2 - 1)
                if donor == "GT" and accep == "AG":
                    return "+"
                if donor == "CT" and accep == "AC":
                    return "-"
                return "NA"

        with open(path, "w") as f:
            f.write(
                "PrimaryGene\tSecondaryGenes\tSite1_chr\tSite1_location\t"
                "Site1_strand\tSite2_chr\tSite2_location\tSite2_strand\t"
                + "\t".join(input_names) + "\n"
            )
            for (chro, s1, s2), cnt in sorted(self.jcounts.items()):
                pg, sg = self._junction_genes(chro, s1, s2)
                strand = lookup(chro, s1, s2) if lookup else "NA"
                f.write(
                    f"{pg}\t{sg}\t{chro}\t{s1}\t{strand}"
                    f"\t{chro}\t{s2}\t{strand}\t{int(cnt)}\n"
                )


def read_summary(argv: list[str]) -> int:
    """The Rsubread-compatible 56-slot positional API
    (readSummary, readSummary.c:7977-8041) — the internal interface shared
    between the featureCounts CLI and the R package.  Slot meanings follow
    the reference's comment block verbatim; options outside the engine's
    current surface are accepted and ignored when harmless."""
    from ..io.gtf import load_annotation

    def num(i, default=0):
        try:
            return int(float(argv[i]))
        except (IndexError, ValueError):
            return default

    def txt(i, default=""):
        v = argv[i] if i < len(argv) else default
        return default if v in ("", "NULL", " ", None) else v

    ann_path = argv[1]
    in_files = argv[2].split(";")
    out_path = argv[3]
    opts = FCOptions(
        paired=bool(num(4)),
        count_read_pairs=bool(num(4)),
        min_fragment=num(5, 50),
        max_fragment=num(6, 600),
        allow_multi_overlap=bool(num(8)),
        feature_level=not bool(num(9, 1)),
        strand=num(12),
        require_both_ends=bool(num(14)),
        no_chimeric=bool(num(15)),
        check_pe_dist=bool(num(16)),
        min_mapq=num(19),
        count_multi=bool(num(20)),
        ext5=num(25),
        ext3=num(26),
        min_overlap=num(27, 1),
        split_only=num(28) == 1,
        non_split_only=num(28) == 2,
        read2pos={0: 0, 1: 5, 2: 3}[num(29)],
        ignore_dup=bool(num(31)),
        fraction=bool(num(33)),
        largest_overlap=bool(num(34)),
        count_junctions=bool(num(36)),
        max_mop=num(38, 10),
        frac_overlap=float(txt(40, "0") or 0),
        primary_only=bool(num(50)),
        by_read_group=bool(num(43)),
        long_reads=bool(num(44)),
        verbose=bool(num(45)),
        frac_overlap_feature=float(txt(46, "0") or 0),
        non_overlap=num(48, -1),
        non_overlap_feature=num(49, -1),
        read_shift_type=txt(54, "upstream"),
        read_shift_size=num(55, 0),
    )
    fmt = "GTF" if num(11, 1) else "SAF"
    feature_type = txt(17, "exon")
    attr_type = txt(18, "gene_id")
    alias_path = txt(21)
    aliases = None
    if alias_path:
        aliases = {}
        for line in open(alias_path):
            parts = line.strip().split(",")
            if len(parts) == 2:
                aliases[parts[1]] = parts[0]
    extra_cols = txt(52)
    extra_attrs = (
        [c for c in extra_cols.replace(";", ",").split(",") if c]
        if extra_cols else None
    )
    ann = load_annotation(
        ann_path, fmt=fmt, feature_type=feature_type, attr_type=attr_type,
        extra_attrs=extra_attrs,
    )
    fc = FeatureCounter(ann, opts, chro_aliases=aliases)
    if num(13):  # isReadSummaryReported -> -R CORE details
        import os as _os

        rpath = txt(51) or _os.path.dirname(out_path) or "."
        fc.open_details(
            _os.path.join(rpath, _os.path.basename(in_files[0])
                          + ".featureCounts"),
            "CORE",
        )
    for path in in_files:
        fc.count_file(path)
    fc.close_details()
    fc.write_counts(out_path, in_files)
    fc.write_summary(out_path + ".summary", in_files)
    if opts.count_junctions:
        fc.write_jcounts(out_path + ".jcounts", in_files, genome=txt(37) or None)
    return 0
