"""Copy of `subread_tpu/quant/snp.py`: the port imports nothing of the JAX package.

exactSNP: pileup + Fisher-exact SNP calling.

Reference: SNPCalling.c — pileup piles (put_hash_to_pile :550),
sliding-window Fisher test (fishers_test_on_block :484), acceptance rule
and VCF emission (process_snp_votes :840-960), defaults (main :1626-1652):
min phred 13, head/tail trim 3, Fisher window ±5, cutoff_multiplex 12,
cutoff upper bound 5e-3, normalisation target 50.

Numpy formulation: piles are dense [len, 4] arrays per chromosome
(np.add.at scatter), window sums are cumsum differences, and the Fisher
test (log-factorial hypergeometric tail, HelperFunctions.c
fast_fisher_test_one_side) runs only on candidate positions.
Base order here is A=0,C=1,G=2,T=3 (SNPCalling.c convention — note this
differs from the index layer's base2int).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..io.sam import parse_cigar

ACGT = "ACGT"
BASE_IDX = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(b"ACGT"):
    BASE_IDX[_b] = _i
    BASE_IDX[_b + 32] = _i

# reference-base mapping of fishers_test_on_block (SNPCalling.c:500):
# A->0, C->1, G->2, everything else (incl. IUPAC junk) -> 3 ('T');
# only a literal N is excluded from SNP calling (process_snp_votes :850).
REF_IDX = np.full(256, 3, dtype=np.int8)
for _i, _b in enumerate(b"ACG"):
    REF_IDX[_b] = _i
    REF_IDX[_b + 32] = _i


@dataclass
class SNPOptions:
    min_phred: int = 13            # -s min_phred_score
    phred_offset: int = 33
    trim_head_tail: int = 3        # -t bases_ignored_head_tail
    testlen: int = 5               # -w Fisher window half-width
    min_supporting: int = 1        # -r min total reads at position
    min_alternative: int = 1       # -n min reads for an alt allele
    supporting_rate: float = 0.0   # -f min POI mismatch fraction
    cutoff_multiplex: float = 12.0  # -Q
    cutoff_upper_bound: float = 5e-3  # -p
    normalisation_target: float = 50.0
    max_depth: int = 1_000_000     # -x max_supporting_read_number
    use_soft_clip: bool = False    # -S vote soft-clipped bases too


def log_fact(n: int, cache={}) -> float:
    return math.lgamma(n + 1)


def fisher_exact_one_sided(a: int, b: int, c: int, d: int) -> float:
    """One-sided Fisher exact test of the reference's orientation
    (fisher_exact_test, SNPCalling.c:152): returns 1.1 when the POI
    mismatch rate a/c is below the background rate b/d; otherwise the
    hypergeometric upper tail P(X >= a).  The guard mirrors the C float
    comparison exactly: x/0 is +inf (or NaN for 0/0), and any comparison
    with NaN is false."""
    ac = math.inf if (c == 0 and a > 0) else (math.nan if c == 0 else a / c)
    bd = math.inf if (d == 0 and b > 0) else (math.nan if d == 0 else b / d)
    if ac < bd:  # NaN comparisons are false, as in C
        return 1.1
    n = a + b + c + d
    row1 = a + b
    col1 = a + c
    # log P(X = x) for hypergeometric
    denom = log_fact(n)
    p_sum = 0.0
    x_max = min(row1, col1)
    for x in range(a, x_max + 1):
        lp = (
            log_fact(row1) + log_fact(n - row1) + log_fact(col1) + log_fact(n - col1)
            - denom - log_fact(x) - log_fact(row1 - x) - log_fact(col1 - x)
            - log_fact(n - row1 - col1 + x)
        )
        p_sum += math.exp(lp)
    return min(p_sum, 1.0)


@dataclass
class _Pile:
    votes: np.ndarray                  # int32 [len, 4]
    indels: dict = field(default_factory=dict)  # pos(0-based) -> {indel_desc: count}


class SNPCaller:
    def __init__(self, fasta_path: str, opts: SNPOptions | None = None):
        from ..io.fasta import read_fasta
        from .. import dna

        self.opts = opts or SNPOptions()
        # keep the raw FASTA characters: the reference maps junk letters to
        # 'T' but skips only literal N — so we must not normalise them away
        self.chroms: dict[str, str] = {}
        name, chunks = None, []
        import gzip
        f = open(fasta_path, "rb")
        if f.peek(2)[:2] == b"\x1f\x8b":
            f.close(); f = gzip.open(fasta_path, "rb")
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    self.chroms[name] = b"".join(chunks).decode().upper()
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            self.chroms[name] = b"".join(chunks).decode().upper()
        f.close()
        self.piles: dict[str, _Pile] = {
            name: _Pile(votes=np.zeros((len(seq), 4), dtype=np.int32))
            for name, seq in self.chroms.items()
        }
        self.known: dict[str, np.ndarray] = {}   # -a: bool [len] per chrom
        self.bgc: SNPCaller | None = None        # -N: control-sample piles

    def load_known_snps(self, vcf_path: str):
        """-a known-SNP VCF: known positions are excluded from the flanking
        background sums (break_VCF_file input-files.c:1776-1852 record
        rules; is_snp_bitmap gating in fishers_test_on_block)."""
        import gzip

        f = open(vcf_path, "rb")
        if f.peek(2)[:2] == b"\x1f\x8b":
            f.close(); f = gzip.open(vcf_path, "rb")
        for raw in f:
            line = raw.decode(errors="replace").rstrip("\n")
            if not line or line[0] == "#" or "INDEL" in line:
                continue
            fs = line.split("\t")
            if len(fs) < 6:  # the reference requires a field after ALT
                continue
            chro, pos_s, _, ref_s, alt_s = fs[:5]
            is_snp = any(len(a) == len(ref_s) for a in alt_s.split(",")) \
                if "," in alt_s else len(ref_s) == len(alt_s)
            if not is_snp or chro not in self.chroms:
                continue
            try:
                pos0 = int(pos_s) - 1
            except ValueError:
                continue
            bm = self.known.get(chro)
            if bm is None:
                bm = self.known[chro] = np.zeros(
                    len(self.chroms[chro]), dtype=bool
                )
            if 0 <= pos0 < len(bm):
                bm[pos0] = True

    def set_background(self, path: str):
        """-N control sample: a second pileup voted with min_phred-3
        (process_snp_votes SNPCalling.c:669-689); adds CTRL_*/VS_QV INFO."""
        from dataclasses import replace

        bgc = SNPCaller.__new__(SNPCaller)
        bgc.opts = replace(self.opts, min_phred=self.opts.min_phred - 3)
        bgc.chroms = self.chroms
        bgc.piles = {
            name: _Pile(votes=np.zeros((len(seq), 4), dtype=np.int32))
            for name, seq in self.chroms.items()
        }
        bgc.known = {}
        bgc.bgc = None
        bgc.add_sam(path)
        self.bgc = bgc

    # --- pileup ------------------------------------------------------------

    def _record_bases(self, chro: str, pos1: int, cigar: str, seq: str, qual: str):
        """Filtered (gpos, base_idx, qual) arrays of one alignment; also
        registers its CIGAR indel events."""
        pile = self.piles.get(chro)
        if pile is None or cigar == "*":
            return None
        o = self.opts
        gpos = pos1 - 1
        rpos = 0
        L = len(seq)
        qarr = np.frombuffer(qual.encode(), dtype=np.uint8) if qual != "*" else None
        sarr = np.frombuffer(seq.encode(), dtype=np.uint8)
        gs, bs, qs = [], [], []
        seen_m = False
        for n, op in parse_cigar(cigar):
            if op in "M=X" or (op == "S" and o.use_soft_clip):
                if op == "S":
                    # -S: leading soft-clip votes at [pos-n, pos); trailing
                    # at [cursor, cursor+n); cursor does not advance
                    # (break_SAM_file input-files.c:2030-2034)
                    g = np.arange(gpos - (0 if seen_m else n),
                                  gpos + (n if seen_m else 0))
                else:
                    g = np.arange(gpos, gpos + n)
                    seen_m = True
                r = np.arange(rpos, rpos + n)
                ok = (g >= 0) & (g < len(pile.votes))
                ok &= (r >= o.trim_head_tail) & (r < L - o.trim_head_tail)
                qv = (
                    qarr[np.clip(r, 0, L - 1)].astype(np.int32) - o.phred_offset
                    if qarr is not None and len(qarr) == L
                    else np.full(n, 40, np.int32)
                )
                ok &= qv >= o.min_phred
                bi = BASE_IDX[sarr[np.clip(r, 0, L - 1)]]
                ok &= bi >= 0
                gs.append(g[ok]); bs.append(bi[ok]); qs.append(qv[ok])
                rpos += n
                if op != "S":
                    gpos += n
            elif op == "I":
                key = (gpos - 1, -n, seq[rpos : rpos + n])
                pile.indels[key] = pile.indels.get(key, 0) + 1
                rpos += n
            elif op == "D":
                key = (gpos - 1, n, "")
                pile.indels[key] = pile.indels.get(key, 0) + 1
                gpos += n
            elif op == "N":
                gpos += n
            elif op == "S":
                rpos += n
            # H/P consume nothing
        if not gs:
            return None
        return np.concatenate(gs), np.concatenate(bs), np.concatenate(qs)

    def add_fragment(self, parts: list[tuple[str, int, str, str, str]]):
        """Add one fragment (1-2 alignments).  Positions covered by both
        mates vote once, with the higher-quality base (the reference's
        per-fragment merge table, put_hash_to_pile SNPCalling.c:550)."""
        per_chro: dict[str, list] = {}
        for (chro, pos1, cigar, seq, qual) in parts:
            r = self._record_bases(chro, pos1, cigar, seq, qual)
            if r is not None:
                per_chro.setdefault(chro, []).append(r)
        for chro, rs in per_chro.items():
            pile = self.piles[chro]
            if len(rs) == 1:
                g, b, q = rs[0]
            else:
                g = np.concatenate([x[0] for x in rs])
                b = np.concatenate([x[1] for x in rs])
                q = np.concatenate([x[2] for x in rs])
                # keep the best-quality base per genome position; on equal
                # quality the FIRST mate wins (strict '<' in the reference
                # merge, SNPCalling.c old_qual < qual[i])
                neg_idx = -np.arange(len(g))
                order = np.lexsort((neg_idx, q, g))
                g, b, q = g[order], b[order], q[order]
                keep = np.concatenate([g[1:] != g[:-1], [True]])
                g, b = g[keep], b[keep]
            if self.opts.max_depth < 1_000_000:
                # -x depth cap: later-arriving bases at a saturated position
                # are dropped (read_tmp_block SNPCalling.c:241)
                cap = self.opts.max_depth
                for gg, bb in zip(g, b):
                    if pile.votes[gg].sum() < cap:
                        pile.votes[gg, bb] += 1
            else:
                np.add.at(pile.votes, (g, b.astype(np.int64)), 1)

    def _add_bam_native(self, path: str) -> bool:
        """Whole-file native pileup (native/snppile.cpp) — same semantics
        as add_fragment over every record; ~20x the python record loop."""
        from .. import native
        from ..io.bam import BamReader

        if native.get_lib() is None:
            return False
        if self.opts.use_soft_clip or self.opts.max_depth < 1_000_000:
            return False  # rare flags take the python record path
        rd = BamReader(path)
        names = list(self.piles)
        name_to_ci = {n: i for i, n in enumerate(names)}
        ref2chrom = np.asarray(
            [name_to_ci.get(n, -1) for n in rd.ref_names], np.int32
        )
        lens = np.asarray([len(self.chroms[n]) for n in names], np.int64)
        offs = np.zeros(len(names), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        total = int(lens.sum())
        votes = np.zeros((total, 4), np.int32)
        o = self.opts
        res = native.snp_pileup_bam(
            rd._data, rd._off, ref2chrom, offs, lens, votes,
            trim=o.trim_head_tail, min_q=o.min_phred,
            qual_bias=33 - o.phred_offset,
        )
        if res is None:
            return False
        _n, indels = res
        for ci, name in enumerate(names):
            lo = int(offs[ci])
            self.piles[name].votes += votes[lo : lo + int(lens[ci])]
        for ci, pos0, ilen, seq, cnt in indels:
            pile = self.piles[names[ci]]
            key = (pos0, ilen, seq)
            pile.indels[key] = pile.indels.get(key, 0) + cnt
        return True

    def add_sam(self, path: str):
        from ..io.bam import bam_to_sam_lines

        with open(path, "rb") as f:
            is_bam = f.read(2) == b"\x1f\x8b"
        if is_bam:
            if self._add_bam_native(path):
                return
            it = bam_to_sam_lines(path)
        else:
            def sam_iter():
                for line in open(path):
                    if not line.startswith("@") and line.strip():
                        yield line.rstrip("\n").split("\t")
            it = sam_iter()
        pending: dict[str, tuple] = {}
        for f_ in it:
            flag = int(f_[1])
            if flag & 0x4:
                continue
            part = (f_[2], int(f_[3]), f_[5], f_[9], f_[10])
            if flag & 0x1:
                mate = pending.pop(f_[0], None)
                if mate is None:
                    pending[f_[0]] = part
                else:
                    self.add_fragment([mate, part])
            else:
                self.add_fragment([part])
        for part in pending.values():
            self.add_fragment([part])

    # --- calling -----------------------------------------------------------

    def call_chrom(self, chro: str):
        """Yield SNP rows (pos1, ref, alts, quals_str, Q, dp, mmsum, bg_total,
        bg_mm) for one chromosome."""
        o = self.opts
        seq = np.frombuffer(self.chroms[chro].encode(), dtype=np.uint8)
        votes = self.piles[chro].votes
        n = len(seq)
        ref_idx = REF_IDX[seq]  # junk letters count as T; N handled below
        total = votes.sum(axis=1)
        ref_ok = (seq != ord("N")) & (seq != ord("n"))
        match = votes[np.arange(n), np.clip(ref_idx, 0, 3)]
        mism = total - match

        # sliding-window sums over +-testlen (inclusive)
        w = o.testlen
        k = 2 * w + 1

        def winsum(x):
            cs = np.concatenate(([0], np.cumsum(x, dtype=np.int64)))
            lo = np.clip(np.arange(n) - w, 0, n)
            hi = np.clip(np.arange(n) + w + 1, 0, n)
            return cs[hi] - cs[lo]

        known = self.known.get(chro)
        if known is not None:
            # known SNPs are excluded from the flanking background sums
            # (fishers_test_on_block :531,:600); a known POI is NOT
            # subtracted back out (:553-556) since it was never added
            win_mm = winsum(np.where(known, 0, mism))
            win_mat = winsum(np.where(known, 0, match))
        else:
            win_mm = winsum(mism)
            win_mat = winsum(match)

        bgc_votes = self.bgc.piles[chro].votes if self.bgc is not None else None
        if bgc_votes is not None:
            bgc_total = bgc_votes.sum(axis=1)
            bgc_match = bgc_votes[np.arange(n), np.clip(ref_idx, 0, 3)]
            bgc_mism = bgc_total - bgc_match
            if known is not None:
                bgc_win_mm = winsum(np.where(known, 0, bgc_mism))
                bgc_win_mat = winsum(np.where(known, 0, bgc_match))
            else:
                bgc_win_mm = winsum(bgc_mism)
                bgc_win_mat = winsum(bgc_match)

        cand = np.flatnonzero(
            (mism > 0) & (total >= o.min_supporting) & ref_ok
        )
        mb = o.normalisation_target / o.cutoff_multiplex
        for i in cand:
            poi_mm = int(mism[i]); poi_mat = int(match[i])
            all_reads = int(total[i])
            poi_known = bool(known[i]) if known is not None else False
            if poi_known:
                flank_mm = int(win_mm[i])
                flank_mat = int(win_mat[i])
            else:
                flank_mm = int(win_mm[i]) - poi_mm
                flank_mat = int(win_mat[i]) - poi_mat
            # alt alleles with enough support
            alts, sups = [], []
            ri = int(ref_idx[i])
            for bidx in range(4):
                if bidx == ri:
                    continue
                v = int(votes[i, bidx])
                if v >= o.min_alternative:
                    alts.append(ACGT[bidx])
                    sups.append(v)
            if not alts or poi_mm / all_reads < o.supporting_rate:
                continue
            coverage = (int(win_mm[i]) + int(win_mat[i])) / k
            p_cutoff = min(o.cutoff_upper_bound, 10 ** (-(coverage / mb)))
            p_cutoff = max(1e-323, p_cutoff)
            p = fisher_exact_one_sided(poi_mm, flank_mm, poi_mat, flank_mat)
            if p < p_cutoff and flank_mat * 20 > (flank_mat + flank_mm) * 16:
                q = -math.log10(max(1e-40, p))
                ctrl = ""
                if bgc_votes is not None:
                    # control-sample INFO (process_snp_votes :902-916):
                    # the same window Fisher test on the control piles
                    # (1.1 when the control POI has no mismatch), plus a
                    # tumor-vs-normal test at the POI
                    c_mm = int(bgc_mism[i]); c_mat = int(bgc_match[i])
                    if poi_known:
                        cf_mm, cf_mat = int(bgc_win_mm[i]), int(bgc_win_mat[i])
                    else:
                        cf_mm = int(bgc_win_mm[i]) - c_mm
                        cf_mat = int(bgc_win_mat[i]) - c_mat
                    p_bgc = (
                        fisher_exact_one_sided(c_mm, cf_mm, c_mat, cf_mat)
                        if c_mm > 0 else 1.1
                    )
                    p_vs = fisher_exact_one_sided(poi_mm, c_mm, poi_mat, c_mat)
                    bgc_q = -math.log10(max(1e-40, p_bgc))
                    vs_q = -math.log10(max(1e-40, p_vs))
                    ctrl = (
                        f";CTRL_DP={int(bgc_total[i])};CTRL_MM={c_mm}"
                        f";CTRL_QV={bgc_q:.4f};VS_QV={max(0.0, vs_q):.4f}"
                    )
                # REF column shows the mapped base (junk letters print as T,
                # matching the reference's loaded-genome normalisation)
                yield (
                    int(i) + 1, ACGT[ri], ",".join(alts),
                    ",".join(str(s) for s in sups), q, all_reads, poi_mm,
                    flank_mat + flank_mm, flank_mm, ctrl,
                )

    def write_vcf(self, path: str, cmdline: str = "") -> dict:
        stats = {"snps": 0, "indels": 0}
        with open(path, "w") as f:
            f.write("##fileformat=VCFv4.0\n")
            f.write(f"##exactSNP_Commandline={cmdline}\n")
            f.write(
                "##comment=The QUAL values for the SNPs in this VCF file are "
                "calculated as min(40, - log_10 (p_value)), where p_value is "
                "from the Fisher's Exact Test. The QUAL values for the Indels "
                "in this VCF file are always 1.0.\n"
            )
            f.write('##INFO=<ID=DP,Number=1,Type=Integer,Description="Read Depth">\n')
            f.write('##INFO=<ID=BGMM,Number=1,Type=Integer,Description="Number of mismatched bases in the background (for SNP only)">\n')
            f.write('##INFO=<ID=BGTOTAL,Number=1,Type=Integer,Description="Total number of bases in the background (for SNP only)">\n')
            f.write('##INFO=<ID=MM,Number=1,Type=String,Description="Number of supporting reads for each alternative allele (for SNP only)">\n')
            f.write('##INFO=<ID=INDEL,Number=0,Type=Flag,Description="Indicates that the variant is an INDEL.">\n')
            f.write('##INFO=<ID=SR,Number=1,Type=Integer,Description="Number of supporting reads (for INDEL only)">\n')
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for chro in self.chroms:
                rows = []  # (pos1, order_within_pos, line)
                for (pos1, ref, alts, sups, q, dp, mmsum, bgt, bgmm, ctrl) in self.call_chrom(chro):
                    rows.append((pos1, 0,
                        f"{chro}\t{pos1}\t.\t{ref}\t{alts}\t{q:.4f}\t.\t"
                        f"DP={dp};MMsum={mmsum};MM={sups};BGTOTAL={bgt};BGMM={bgmm}{ctrl}\n"
                    ))
                    stats["snps"] += 1
                # indels: REF/ALT construction and INFO per the reference
                # emission (process_snp_votes: REF = anchor..anchor+dlen+1,
                # ALT = anchor [+ inserted] + following base; QUAL 1.0;
                # DP = pile depth at the anchor, SR = supporting reads);
                # only emitted when the anchor has >= min_supporting reads.
                seq = self.chroms[chro]
                votes = self.piles[chro].votes
                for (pos0, ilen, ins_seq), count in sorted(
                    self.piles[chro].indels.items()
                ):
                    if pos0 < 0 or pos0 >= len(seq):
                        continue
                    all_reads = int(votes[pos0].sum())
                    if all_reads < self.opts.min_supporting or all_reads == 0:
                        continue
                    if ilen > 0:  # deletion of ilen bases after pos0
                        ref_s = seq[pos0 : pos0 + ilen + 2]
                        alt_s = seq[pos0] + seq[pos0 + ilen + 1]
                    else:  # insertion
                        ref_s = seq[pos0 : pos0 + 2]
                        alt_s = seq[pos0] + ins_seq + seq[pos0 + 1]
                    rows.append((pos0 + 1, 1,
                        f"{chro}\t{pos0 + 1}\t.\t{ref_s}\t{alt_s}\t1.0\t.\t"
                        f"INDEL;DP={all_reads};SR={count}\n"
                    ))
                    stats["indels"] += 1
                rows.sort(key=lambda r: (r[0], r[1]))
                for _, _, line in rows:
                    f.write(line)
        return stats
