// Copy of subread_tpu/native/fccount.cpp: the port imports nothing of the JAX package.
// Native featureCounts fast path — single-end records, default overlap
// semantics.  Reference equivalents: parse_bin + process_line_buffer +
// vote_and_add_count (readSummary.c:2363, 2924, 4611) restricted to the
// option subset where assignment reduces to "distinct overlapped targets
// == 1" (no -O / fractional / largestOverlap / minOverlap>1 / PE gates).
// The Python engine handles every other configuration; the caller only
// invokes this when the active options are inside the subset, so golden
// outputs are identical by construction.
//
// Feature lookup mirrors _ChromIndex: per chromosome, features sorted by
// start with a running prefix max of ends; a record section scans
// backwards from upper_bound(start <= section_end) while
// prefix_max_end >= section_start (the reference's block max_end bound,
// readSummary.c:1592-1680).

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// summary slot order (must match python _FC_SUMMARY_SLOTS)
enum {
    S_ASSIGNED = 0, S_UNMAPPED, S_NOFEAT, S_AMBIG, S_MULTI, S_MAPQ, S_DUP,
    S_N_SLOTS
};

static inline bool str_eq(const char *a, long alen, const char *b, long blen) {
    return alen == blen && memcmp(a, b, alen) == 0;
}

}  // namespace

extern "C" long fc_count_sam_simple(
    const char *buf, long buflen,
    const char *chrom_blob, const int64_t *chrom_off, int32_t n_chroms,
    const int32_t *feat_start, const int32_t *feat_end,
    const int32_t *feat_pmax_end, const int64_t *feat_target,
    const int8_t *feat_strand,
    const int64_t *chrom_feat_off,  // [n_chroms+1]
    int64_t n_targets,
    int32_t min_mapq, int32_t primary_only, int32_t ignore_dup,
    int32_t count_multi,            // 0: NH>1 -> Unassigned_MultiMapping
    int32_t strandness,             // 0 none, 1 stranded, 2 reversed
    int32_t max_mop,                // --maxMOp M-operation cap
    double *counts, int64_t *summary)
{
    (void)n_targets;
    // chromosome lookup cache: SAM files cluster records by chromosome
    int last_chrom = -1;
    const char *last_name = nullptr;
    long last_name_len = -1;

    const char *p = buf;
    const char *end = buf + buflen;
    long n_rec = 0;

    const int MAX_HIT = 64;
    int64_t hits[MAX_HIT];

    while (p < end) {
        const char *line_end = (const char *)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (*p == '@' || line_end == p) { p = line_end + 1; continue; }

        // locate the first 6 fields (qname flag rname pos mapq cigar)
        const char *f[7];
        int nf = 0;
        f[nf++] = p;
        for (const char *q = p; q < line_end && nf < 7; q++)
            if (*q == '\t') f[nf++] = q + 1;
        if (nf < 6) return -1;  // malformed: let python handle the file
        n_rec++;

        // gate order follows the python engine (_assign): unmapped,
        // mapq, duplicate, NH multi-mapping, primary
        long flag = strtol(f[1], nullptr, 10);
        bool skip = false;
        if ((flag & 0x4) || *f[5] == '*') { summary[S_UNMAPPED]++; skip = true; }
        else if (min_mapq && strtol(f[4], nullptr, 10) < min_mapq) {
            summary[S_MAPQ]++; skip = true;
        }
        else if (ignore_dup && (flag & 0x400)) { summary[S_DUP]++; skip = true; }
        if (!skip && !count_multi) {
            // NH:i: tag scan over the remainder of the line
            const char *t = nf >= 7 ? f[6] : line_end;
            for (const char *q = t; q + 5 <= line_end; q++) {
                if (q[0]=='N' && q[1]=='H' && q[2]==':' && q[3]=='i' && q[4]==':') {
                    if (strtol(q + 5, nullptr, 10) > 1) {
                        summary[S_MULTI]++; skip = true;
                    }
                    break;
                }
            }
        }
        if (!skip && primary_only && (flag & 0x100)) {
            summary[S_MULTI]++; skip = true;
        }
        if (skip) { p = line_end + 1; continue; }

        // chromosome id
        const char *rn = f[2];
        long rn_len = (f[3] - 1) - rn;
        int ci = -1;
        if (last_name && str_eq(rn, rn_len, last_name, last_name_len)) {
            ci = last_chrom;
        } else {
            for (int c = 0; c < n_chroms; c++) {
                const char *nm = chrom_blob + chrom_off[c];
                long nl = chrom_off[c + 1] - chrom_off[c];
                if (str_eq(rn, rn_len, nm, nl)) { ci = c; break; }
            }
            last_chrom = ci; last_name = rn; last_name_len = rn_len;
        }
        if (ci < 0) { summary[S_NOFEAT]++; p = line_end + 1; continue; }

        int read_strand = (flag & 0x10) ? 1 : 0;
        int want_strand = -1;  // required feature strand (2 always matches)
        if (strandness == 1) want_strand = read_strand;
        else if (strandness == 2) want_strand = read_strand ^ 1;

        int n_hit = 0;
        bool overflow = false;
        auto scan_section = [&](long ss, long ee) {
            long lo = chrom_feat_off[ci], hi = chrom_feat_off[ci + 1];
            long a = lo, b = hi;  // upper_bound over feat_start <= ee
            while (a < b) {
                long m = (a + b) >> 1;
                if ((long)feat_start[m] <= ee) a = m + 1; else b = m;
            }
            for (long j = a - 1; j >= lo && (long)feat_pmax_end[j] >= ss; j--) {
                if ((long)feat_end[j] < ss) continue;
                if (want_strand >= 0 && feat_strand[j] != 2 &&
                    feat_strand[j] != want_strand) continue;
                int64_t t = feat_target[j];
                bool seen = false;
                for (int k = 0; k < n_hit; k++)
                    if (hits[k] == t) { seen = true; break; }
                if (!seen) {
                    if (n_hit == MAX_HIT) { overflow = true; return; }
                    hits[n_hit++] = t;
                }
            }
        };

        // CIGAR -> genomic sections (split at N; M/D/=/X consume ref)
        long gp = strtol(f[3], nullptr, 10);
        long sec_start = -1;
        bool bad_cigar = false;
        int n_mop = 0;
        const char *q = f[5];
        while (q < line_end && *q != '\t') {
            long n = 0;
            while (q < line_end && *q >= '0' && *q <= '9') n = n * 10 + (*q++ - '0');
            char op = *q++;
            if ((op == 'M' || op == '=' || op == 'X') && ++n_mop > max_mop)
                break;  // python _sections: stop honouring M ops past the cap
            switch (op) {
                case 'M': case '=': case 'X':
                    if (sec_start < 0) sec_start = gp;
                    gp += n; break;
                case 'D':
                    gp += n; break;
                case 'N':
                    if (sec_start >= 0) { scan_section(sec_start, gp - 1); sec_start = -1; }
                    gp += n; break;
                case 'I': case 'S': case 'H': case 'P':
                    break;
                default:
                    bad_cigar = true; break;
            }
            if (bad_cigar || overflow) break;
        }
        if (bad_cigar || overflow) return -1;
        if (sec_start >= 0) scan_section(sec_start, gp - 1);
        if (overflow) return -1;

        if (n_hit == 0) summary[S_NOFEAT]++;
        else if (n_hit > 1) summary[S_AMBIG]++;
        else { counts[hits[0]] += 1.0; summary[S_ASSIGNED]++; }
        p = line_end + 1;
    }
    return n_rec;
}

// BAM-record variant: walks uncompressed BAM records (the caller BGZF-
// inflates and strips the header).  ref2chrom maps BAM reference ids to
// the chromosome table used above; -1 = not annotated.
extern "C" long fc_count_bam_simple(
    const uint8_t *buf, long buflen,
    const int32_t *ref2chrom, int32_t n_refs,
    const int32_t *feat_start, const int32_t *feat_end,
    const int32_t *feat_pmax_end, const int64_t *feat_target,
    const int8_t *feat_strand,
    const int64_t *chrom_feat_off,
    int64_t n_targets,
    int32_t min_mapq, int32_t primary_only, int32_t ignore_dup,
    int32_t count_multi, int32_t strandness, int32_t max_mop,
    double *counts, int64_t *summary)
{
    (void)n_targets;
    const uint8_t *p = buf;
    const uint8_t *end = buf + buflen;
    long n_rec = 0;
    const int MAX_HIT = 64;
    int64_t hits[MAX_HIT];

    auto rd_i32 = [](const uint8_t *q) {
        int32_t v; memcpy(&v, q, 4); return v;
    };
    auto rd_u32 = [](const uint8_t *q) {
        uint32_t v; memcpy(&v, q, 4); return v;
    };
    auto rd_u16 = [](const uint8_t *q) {
        uint16_t v; memcpy(&v, q, 2); return v;
    };

    while (p + 4 <= end) {
        int32_t block = rd_i32(p);
        const uint8_t *rec = p + 4;
        p = rec + block;
        if (p > end || block < 32) break;
        n_rec++;

        int32_t ref_id = rd_i32(rec);
        int32_t pos0 = rd_i32(rec + 4);
        uint8_t l_qname = rec[8];
        uint8_t mapq = rec[9];
        uint16_t n_cigar = rd_u16(rec + 12);
        uint16_t flag = rd_u16(rec + 14);
        int32_t l_seq = rd_i32(rec + 16);
        const uint8_t *cig = rec + 32 + l_qname;
        const uint8_t *seqp = cig + 4 * n_cigar;
        const uint8_t *tagp = seqp + (l_seq + 1) / 2 + l_seq;

        bool skip = false;
        if ((flag & 0x4) || n_cigar == 0) { summary[S_UNMAPPED]++; skip = true; }
        else if (min_mapq && mapq < min_mapq) { summary[S_MAPQ]++; skip = true; }
        else if (ignore_dup && (flag & 0x400)) { summary[S_DUP]++; skip = true; }
        if (!skip && !count_multi) {
            // binary tag walk for NH
            const uint8_t *t = tagp;
            while (t + 3 <= rec + block) {
                char c1 = t[0], c2 = t[1], typ = t[2];
                long vlen = 0;
                long nh = -1;
                switch (typ) {
                    case 'A': case 'c': case 'C': vlen = 1; break;
                    case 's': case 'S': vlen = 2; break;
                    case 'i': case 'I': case 'f': vlen = 4; break;
                    case 'Z': case 'H': {
                        const uint8_t *z = t + 3;
                        while (z < rec + block && *z) z++;
                        vlen = z - (t + 3) + 1;
                        break;
                    }
                    case 'B': {
                        // subtype(1) + count(u32) + count*esz payload
                        if (t + 8 > rec + block) { vlen = -1; break; }
                        uint8_t st = t[3];
                        int esz = (st=='c'||st=='C')?1:((st=='s'||st=='S')?2:4);
                        vlen = 1 + 4 + esz * (long)rd_u32(t + 4);
                        break;
                    }
                    default: vlen = -1; break;
                }
                if (vlen < 0) break;
                if (c1 == 'N' && c2 == 'H') {
                    switch (typ) {
                        case 'c': nh = *(const int8_t *)(t + 3); break;
                        case 'C': nh = t[3]; break;
                        case 's': { int16_t v; memcpy(&v, t+3, 2); nh = v; break; }
                        case 'S': { uint16_t v; memcpy(&v, t+3, 2); nh = v; break; }
                        case 'i': case 'I': nh = rd_i32(t + 3); break;
                        default: break;
                    }
                    if (nh > 1) { summary[S_MULTI]++; skip = true; }
                    break;
                }
                t += 3 + vlen;
            }
        }
        if (!skip && primary_only && (flag & 0x100)) {
            summary[S_MULTI]++; skip = true;
        }
        if (skip) continue;

        int ci = (ref_id >= 0 && ref_id < n_refs) ? ref2chrom[ref_id] : -1;
        if (ci < 0) { summary[S_NOFEAT]++; continue; }

        int want_strand = -1;
        int read_strand = (flag & 0x10) ? 1 : 0;
        if (strandness == 1) want_strand = read_strand;
        else if (strandness == 2) want_strand = read_strand ^ 1;

        int n_hit = 0;
        bool overflow = false;
        auto scan_section = [&](long ss, long ee) {
            long lo = chrom_feat_off[ci], hi = chrom_feat_off[ci + 1];
            long a = lo, b = hi;
            while (a < b) {
                long m = (a + b) >> 1;
                if ((long)feat_start[m] <= ee) a = m + 1; else b = m;
            }
            for (long j = a - 1; j >= lo && (long)feat_pmax_end[j] >= ss; j--) {
                if ((long)feat_end[j] < ss) continue;
                if (want_strand >= 0 && feat_strand[j] != 2 &&
                    feat_strand[j] != want_strand) continue;
                int64_t t = feat_target[j];
                bool seen = false;
                for (int k = 0; k < n_hit; k++)
                    if (hits[k] == t) { seen = true; break; }
                if (!seen) {
                    if (n_hit == MAX_HIT) { overflow = true; return; }
                    hits[n_hit++] = t;
                }
            }
        };

        long gp = pos0 + 1;  // 1-based
        long sec_start = -1;
        int n_mop = 0;
        bool bad = false;
        for (int k = 0; k < n_cigar && !bad && !overflow; k++) {
            uint32_t cv = rd_u32(cig + 4 * k);
            long n = cv >> 4;
            int op = cv & 0xF;  // MIDNSHP=X
            if ((op == 0 || op == 7 || op == 8) && ++n_mop > max_mop) break;
            switch (op) {
                case 0: case 7: case 8:         // M,=,X
                    if (sec_start < 0) sec_start = gp;
                    gp += n; break;
                case 2: gp += n; break;          // D
                case 3:                           // N
                    if (sec_start >= 0) { scan_section(sec_start, gp - 1); sec_start = -1; }
                    gp += n; break;
                case 1: case 4: case 5: case 6: break;  // I,S,H,P
                default: bad = true; break;
            }
        }
        if (bad || overflow) return -1;
        if (sec_start >= 0) scan_section(sec_start, gp - 1);
        if (overflow) return -1;

        if (n_hit == 0) summary[S_NOFEAT]++;
        else if (n_hit > 1) summary[S_AMBIG]++;
        else { counts[hits[0]] += 1.0; summary[S_ASSIGNED]++; }
    }
    return n_rec;
}

// ---------------------------------------------------------------------------
// Paired-end fast path (default PE options: -p --countReadPairs without
// -B/-C/-P): mates re-paired by qname (the SAM_pairer analog), fragment
// gates use max(mapq), max(NH) and any-duplicate across mates, the
// fragment strand is the first-in-pair read's strand, and a target hit by
// both ends (vote 2) beats a single-end hit (readSummary.c
// process_line_buffer + vote_and_add_count, PE arm).
// ---------------------------------------------------------------------------

#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct FeatView {
    const char *chrom_blob; const int64_t *chrom_off; int32_t n_chroms;
    const int32_t *feat_start, *feat_end, *feat_pmax_end;
    const int64_t *feat_target;
    const int8_t *feat_strand;
    const int64_t *chrom_feat_off;
    int32_t strandness, max_mop;
};

constexpr int PE_MAX_HIT = 64;

struct FragHits {
    int64_t t[PE_MAX_HIT];
    uint8_t ends[PE_MAX_HIT];  // bitmask of ends hitting the target
    int n = 0;
    bool overflow = false;
    void add(int64_t tgt, int ei) {
        for (int k = 0; k < n; k++)
            if (t[k] == tgt) { ends[k] |= 1 << ei; return; }
        if (n == PE_MAX_HIT) { overflow = true; return; }
        t[n] = tgt; ends[n] = (uint8_t)(1 << ei); n++;
    }
};

// scan one genomic section of end `ei` against chromosome ci's features
static void pe_scan_section(const FeatView &fv, int ci, int want_strand,
                            long ss, long ee, int ei, FragHits &h) {
    long lo = fv.chrom_feat_off[ci], hi = fv.chrom_feat_off[ci + 1];
    long a = lo, b = hi;
    while (a < b) {
        long m = (a + b) >> 1;
        if ((long)fv.feat_start[m] <= ee) a = m + 1; else b = m;
    }
    for (long j = a - 1; j >= lo && (long)fv.feat_pmax_end[j] >= ss; j--) {
        if ((long)fv.feat_end[j] < ss) continue;
        if (want_strand >= 0 && fv.feat_strand[j] != 2 &&
            fv.feat_strand[j] != want_strand) continue;
        h.add(fv.feat_target[j], ei);
        if (h.overflow) return;
    }
}

// walk a SAM CIGAR over sections; returns false on unknown op
static bool pe_walk_sam_cigar(const FeatView &fv, int ci, int want_strand,
                              const char *cig, const char *line_end,
                              long gp, int ei, FragHits &h) {
    long sec_start = -1;
    int n_mop = 0;
    const char *q = cig;
    while (q < line_end && *q != '\t') {
        long n = 0;
        while (q < line_end && *q >= '0' && *q <= '9') n = n * 10 + (*q++ - '0');
        char op = *q++;
        if ((op == 'M' || op == '=' || op == 'X') && ++n_mop > fv.max_mop) break;
        switch (op) {
            case 'M': case '=': case 'X':
                if (sec_start < 0) sec_start = gp;
                gp += n; break;
            case 'D': gp += n; break;
            case 'N':
                if (sec_start >= 0) {
                    pe_scan_section(fv, ci, want_strand, sec_start, gp - 1, ei, h);
                    sec_start = -1;
                }
                gp += n; break;
            case 'I': case 'S': case 'H': case 'P': break;
            default: return false;
        }
        if (h.overflow) return true;
    }
    if (sec_start >= 0)
        pe_scan_section(fv, ci, want_strand, sec_start, gp - 1, ei, h);
    return true;
}

struct SamRec {
    long flag, pos, mapq, nh;
    int ci;           // chromosome id or -1
    const char *cigar;
    const char *line_end;
    bool mapped;
};

}  // namespace

extern "C" long fc_count_sam_pe(
    const char *buf, long buflen,
    const char *chrom_blob, const int64_t *chrom_off, int32_t n_chroms,
    const int32_t *feat_start, const int32_t *feat_end,
    const int32_t *feat_pmax_end, const int64_t *feat_target,
    const int8_t *feat_strand,
    const int64_t *chrom_feat_off,
    int64_t n_targets,
    int32_t min_mapq, int32_t primary_only, int32_t ignore_dup,
    int32_t count_multi, int32_t strandness, int32_t max_mop,
    double *counts, int64_t *summary)
{
    (void)n_targets;
    FeatView fv{chrom_blob, chrom_off, n_chroms, feat_start, feat_end,
                feat_pmax_end, feat_target, feat_strand, chrom_feat_off,
                strandness, max_mop};

    int last_chrom = -1;
    const char *last_name = nullptr;
    long last_name_len = -1;

    auto chrom_of = [&](const char *rn, long rn_len) {
        if (last_name && str_eq(rn, rn_len, last_name, last_name_len))
            return last_chrom;
        int ci = -1;
        for (int c = 0; c < n_chroms; c++) {
            const char *nm = chrom_blob + chrom_off[c];
            long nl = chrom_off[c + 1] - chrom_off[c];
            if (str_eq(rn, rn_len, nm, nl)) { ci = c; break; }
        }
        last_chrom = ci; last_name = rn; last_name_len = rn_len;
        return ci;
    };

    // parse one line into a SamRec; returns qname via out-params
    auto parse_line = [&](const char *p, const char *line_end, SamRec &r,
                          const char **qn, long *qn_len) -> bool {
        const char *f[7];
        int nf = 0;
        f[nf++] = p;
        for (const char *q = p; q < line_end && nf < 7; q++)
            if (*q == '\t') f[nf++] = q + 1;
        if (nf < 6) return false;
        *qn = f[0]; *qn_len = (f[1] - 1) - f[0];
        r.flag = strtol(f[1], nullptr, 10);
        r.pos = strtol(f[3], nullptr, 10);
        r.mapq = strtol(f[4], nullptr, 10);
        r.cigar = f[5];
        r.line_end = line_end;
        r.mapped = !(r.flag & 0x4) && *f[5] != '*';
        r.ci = r.mapped ? chrom_of(f[2], (f[3] - 1) - f[2]) : -1;
        r.nh = 1;
        if (!count_multi && nf >= 7) {
            for (const char *q = f[6]; q + 5 <= line_end; q++)
                if (q[0]=='N'&&q[1]=='H'&&q[2]==':'&&q[3]=='i'&&q[4]==':') {
                    r.nh = strtol(q + 5, nullptr, 10);
                    break;
                }
        }
        return true;
    };

    bool abort_run = false;
    auto assign_fragment = [&](const SamRec *a, const SamRec *b) {
        const SamRec *m[2]; int nm_ = 0;
        if (a && a->mapped) m[nm_++] = a;
        if (b && b->mapped) m[nm_++] = b;
        if (nm_ == 0) { summary[S_UNMAPPED]++; return; }
        long q = 0, nh = 0; bool dup = false, sec = false;
        for (int i = 0; i < nm_; i++) {
            if (m[i]->mapq > q) q = m[i]->mapq;
            if (m[i]->nh > nh) nh = m[i]->nh;
        }
        if (a && (a->flag & 0x400)) dup = true;
        if (b && (b->flag & 0x400)) dup = true;
        for (int i = 0; i < nm_; i++) if (m[i]->flag & 0x100) sec = true;
        if (min_mapq && q < min_mapq) { summary[S_MAPQ]++; return; }
        if (ignore_dup && dup) { summary[S_DUP]++; return; }
        if (!count_multi && nh > 1) { summary[S_MULTI]++; return; }
        if (primary_only && sec) { summary[S_MULTI]++; return; }

        // fragment strand = first-in-pair's strand among mapped mates
        int want_strand = -1;
        if (strandness) {
            const SamRec *first = m[0];
            for (int i = 0; i < nm_; i++)
                if (m[i]->flag & 0x40) { first = m[i]; break; }
            int fs = (first->flag & 0x10) ? 1 : 0;
            if (strandness == 2) fs ^= 1;
            want_strand = fs;
        }

        FragHits h;
        for (int i = 0; i < nm_ && i < 2; i++) {
            if (m[i]->ci < 0) continue;
            if (!pe_walk_sam_cigar(fv, m[i]->ci, want_strand, m[i]->cigar,
                                   m[i]->line_end, m[i]->pos, i, h))
                { abort_run = true; return; }  // unknown CIGAR op: python path
            if (h.overflow) { abort_run = true; return; }
        }
        if (h.n == 0) { summary[S_NOFEAT]++; return; }
        int best = 0;
        for (int k = 0; k < h.n; k++) {
            int v = (h.ends[k] & 1 ? 1 : 0) + (h.ends[k] & 2 ? 1 : 0);
            if (v > best) best = v;
        }
        int64_t win = -1; int n_win = 0;
        for (int k = 0; k < h.n; k++) {
            int v = (h.ends[k] & 1 ? 1 : 0) + (h.ends[k] & 2 ? 1 : 0);
            if (v == best) { win = h.t[k]; n_win++; }
        }
        if (n_win > 1) { summary[S_AMBIG]++; return; }
        counts[win] += 1.0;
        summary[S_ASSIGNED]++;
    };

    std::unordered_map<std::string, long> pending;  // qname -> line offset
    std::vector<std::pair<long, long>> pend_span;   // offset -> (start,end)
    pending.reserve(1 << 16);

    const char *p = buf;
    const char *end = buf + buflen;
    long n_rec = 0;
    while (p < end) {
        const char *line_end = (const char *)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (*p == '@' || line_end == p) { p = line_end + 1; continue; }
        SamRec r; const char *qn; long qn_len;
        if (!parse_line(p, line_end, r, &qn, &qn_len)) return -1;
        if (abort_run) return -1;
        n_rec++;
        if (!(r.flag & 0x1)) {
            assign_fragment(&r, nullptr);
        } else {
            std::string key(qn, qn_len);
            auto it = pending.find(key);
            if (it == pending.end()) {
                pending.emplace(std::move(key), p - buf);
            } else {
                long off = it->second;
                pending.erase(it);
                const char *mp = buf + off;
                const char *mle = (const char *)memchr(mp, '\n', end - mp);
                if (!mle) mle = end;
                SamRec mr; const char *mqn; long mqn_len;
                parse_line(mp, mle, mr, &mqn, &mqn_len);
                assign_fragment(&mr, &r);
            }
        }
        p = line_end + 1;
    }
    for (auto &kv : pending) {
        const char *mp = buf + kv.second;
        const char *mle = (const char *)memchr(mp, '\n', end - mp);
        if (!mle) mle = end;
        SamRec mr; const char *mqn; long mqn_len;
        parse_line(mp, mle, mr, &mqn, &mqn_len);
        assign_fragment(&mr, nullptr);
        if (abort_run) return -1;
    }
    if (abort_run) return -1;
    return n_rec;
}

extern "C" long fc_count_bam_pe(
    const uint8_t *buf, long buflen,
    const int32_t *ref2chrom, int32_t n_refs,
    const int32_t *feat_start, const int32_t *feat_end,
    const int32_t *feat_pmax_end, const int64_t *feat_target,
    const int8_t *feat_strand,
    const int64_t *chrom_feat_off,
    int64_t n_targets,
    int32_t min_mapq, int32_t primary_only, int32_t ignore_dup,
    int32_t count_multi, int32_t strandness, int32_t max_mop,
    double *counts, int64_t *summary)
{
    (void)n_targets;
    FeatView fv{nullptr, nullptr, 0, feat_start, feat_end, feat_pmax_end,
                feat_target, feat_strand, chrom_feat_off, strandness, max_mop};

    auto rd_i32 = [](const uint8_t *q) { int32_t v; memcpy(&v, q, 4); return v; };
    auto rd_u32 = [](const uint8_t *q) { uint32_t v; memcpy(&v, q, 4); return v; };
    auto rd_u16 = [](const uint8_t *q) { uint16_t v; memcpy(&v, q, 2); return v; };

    struct BRec {
        long flag, pos, mapq, nh;
        int ci;
        const uint8_t *cig;
        int n_cigar;
        bool mapped;
    };

    // NH from the binary tag stream; -1 on malformed tags
    auto bam_nh = [&](const uint8_t *tagp, const uint8_t *rec_end) -> long {
        const uint8_t *t = tagp;
        while (t + 3 <= rec_end) {
            char c1 = t[0], c2 = t[1], typ = t[2];
            long vlen = 0;
            switch (typ) {
                case 'A': case 'c': case 'C': vlen = 1; break;
                case 's': case 'S': vlen = 2; break;
                case 'i': case 'I': case 'f': vlen = 4; break;
                case 'Z': case 'H': {
                    const uint8_t *z = t + 3;
                    while (z < rec_end && *z) z++;
                    vlen = z - (t + 3) + 1;
                    break;
                }
                case 'B': {
                    if (t + 8 > rec_end) return -2;
                    uint8_t st = t[3];
                    int esz = (st=='c'||st=='C')?1:((st=='s'||st=='S')?2:4);
                    vlen = 1 + 4 + esz * (long)rd_u32(t + 4);
                    break;
                }
                default: return -2;
            }
            if (c1 == 'N' && c2 == 'H') {
                switch (typ) {
                    case 'c': return *(const int8_t *)(t + 3);
                    case 'C': return t[3];
                    case 's': { int16_t v; memcpy(&v, t+3, 2); return v; }
                    case 'S': { uint16_t v; memcpy(&v, t+3, 2); return v; }
                    case 'i': case 'I': return rd_i32(t + 3);
                    default: return 1;
                }
            }
            t += 3 + vlen;
        }
        return 1;
    };

    auto parse_rec = [&](const uint8_t *rec, long block, BRec &r) {
        int32_t ref_id = rd_i32(rec);
        r.pos = rd_i32(rec + 4) + 1;
        uint8_t l_qname = rec[8];
        r.mapq = rec[9];
        r.n_cigar = rd_u16(rec + 12);
        r.flag = rd_u16(rec + 14);
        int32_t l_seq = rd_i32(rec + 16);
        r.cig = rec + 32 + l_qname;
        r.mapped = !(r.flag & 0x4) && r.n_cigar > 0;
        r.ci = (r.mapped && ref_id >= 0 && ref_id < n_refs)
            ? ref2chrom[ref_id] : -1;
        r.nh = 1;
        if (!count_multi) {
            const uint8_t *tagp = r.cig + 4 * r.n_cigar + (l_seq + 1) / 2 + l_seq;
            long nh = bam_nh(tagp, rec + block);
            if (nh == -2) return false;
            r.nh = nh;
        }
        return true;
    };

    bool abort_run = false;
    auto walk = [&](const BRec &r, int want_strand, int ei, FragHits &h) {
        long gp = r.pos, sec_start = -1;
        int n_mop = 0;
        for (int k = 0; k < r.n_cigar; k++) {
            uint32_t cv = rd_u32(r.cig + 4 * k);
            long n = cv >> 4;
            int op = cv & 0xF;
            if ((op == 0 || op == 7 || op == 8) && ++n_mop > fv.max_mop) break;
            switch (op) {
                case 0: case 7: case 8:
                    if (sec_start < 0) sec_start = gp;
                    gp += n; break;
                case 2: gp += n; break;
                case 3:
                    if (sec_start >= 0) {
                        pe_scan_section(fv, r.ci, want_strand, sec_start, gp - 1, ei, h);
                        sec_start = -1;
                    }
                    gp += n; break;
                case 1: case 4: case 5: case 6: break;
                default: abort_run = true; return;
            }
            if (h.overflow) { abort_run = true; return; }
        }
        if (sec_start >= 0)
            pe_scan_section(fv, r.ci, want_strand, sec_start, gp - 1, ei, h);
        if (h.overflow) abort_run = true;
    };

    auto assign_fragment = [&](const BRec *a, const BRec *b) {
        const BRec *m[2]; int nm_ = 0;
        if (a && a->mapped) m[nm_++] = a;
        if (b && b->mapped) m[nm_++] = b;
        if (nm_ == 0) { summary[S_UNMAPPED]++; return; }
        long q = 0, nh = 0; bool dup = false, sec = false;
        for (int i = 0; i < nm_; i++) {
            if (m[i]->mapq > q) q = m[i]->mapq;
            if (m[i]->nh > nh) nh = m[i]->nh;
        }
        if (a && (a->flag & 0x400)) dup = true;
        if (b && (b->flag & 0x400)) dup = true;
        for (int i = 0; i < nm_; i++) if (m[i]->flag & 0x100) sec = true;
        if (min_mapq && q < min_mapq) { summary[S_MAPQ]++; return; }
        if (ignore_dup && dup) { summary[S_DUP]++; return; }
        if (!count_multi && nh > 1) { summary[S_MULTI]++; return; }
        if (primary_only && sec) { summary[S_MULTI]++; return; }
        int want_strand = -1;
        if (strandness) {
            const BRec *first = m[0];
            for (int i = 0; i < nm_; i++)
                if (m[i]->flag & 0x40) { first = m[i]; break; }
            int fs = (first->flag & 0x10) ? 1 : 0;
            if (strandness == 2) fs ^= 1;
            want_strand = fs;
        }
        FragHits h;
        for (int i = 0; i < nm_ && i < 2; i++) {
            if (m[i]->ci < 0) continue;
            walk(*m[i], want_strand, i, h);
            if (abort_run) return;
        }
        if (h.n == 0) { summary[S_NOFEAT]++; return; }
        int best = 0;
        for (int k = 0; k < h.n; k++) {
            int v = (h.ends[k] & 1 ? 1 : 0) + (h.ends[k] & 2 ? 1 : 0);
            if (v > best) best = v;
        }
        int64_t win = -1; int n_win = 0;
        for (int k = 0; k < h.n; k++) {
            int v = (h.ends[k] & 1 ? 1 : 0) + (h.ends[k] & 2 ? 1 : 0);
            if (v == best) { win = h.t[k]; n_win++; }
        }
        if (n_win > 1) { summary[S_AMBIG]++; return; }
        counts[win] += 1.0;
        summary[S_ASSIGNED]++;
    };

    std::unordered_map<std::string, long> pending;
    pending.reserve(1 << 16);
    const uint8_t *p = buf;
    const uint8_t *end = buf + buflen;
    long n_rec = 0;
    while (p + 4 <= end) {
        int32_t block = rd_i32(p);
        const uint8_t *rec = p + 4;
        p = rec + block;
        if (p > end || block < 32) break;
        n_rec++;
        BRec r;
        if (!parse_rec(rec, block, r)) return -1;
        uint16_t flag = rd_u16(rec + 14);
        if (!(flag & 0x1)) {
            assign_fragment(&r, nullptr);
        } else {
            uint8_t l_qname = rec[8];
            std::string key((const char *)rec + 32,
                            l_qname > 0 ? l_qname - 1 : 0);
            auto it = pending.find(key);
            if (it == pending.end()) {
                pending.emplace(std::move(key), (rec - buf) - 4);
            } else {
                long off = it->second;
                pending.erase(it);
                const uint8_t *mp = buf + off;
                int32_t mblock = rd_i32(mp);
                BRec mr;
                if (!parse_rec(mp + 4, mblock, mr)) return -1;
                assign_fragment(&mr, &r);
            }
        }
        if (abort_run) return -1;
    }
    for (auto &kv : pending) {
        const uint8_t *mp = buf + kv.second;
        int32_t mblock = rd_i32(mp);
        BRec mr;
        if (!parse_rec(mp + 4, mblock, mr)) return -1;
        assign_fragment(&mr, nullptr);
        if (abort_run) return -1;
    }
    if (abort_run) return -1;
    return n_rec;
}

// Record-boundary split offsets for threading BAM counting: walks the
// record stream once (just block-size skips) and emits the first record
// offset at-or-after each target byte position.  Returns the number of
// cuts written (n_parts - 1) or -1 on malformed input.
extern "C" long fc_bam_split_offsets(
    const uint8_t *buf, long buflen, int32_t n_parts, int64_t *cuts)
{
    long written = 0;
    const uint8_t *p = buf;
    const uint8_t *end = buf + buflen;
    int32_t next_part = 1;
    while (p + 4 <= end && next_part < n_parts) {
        long target = (buflen * next_part) / n_parts;
        if (p - buf >= target) {
            cuts[written++] = p - buf;
            next_part++;
            continue;
        }
        int32_t block;
        memcpy(&block, p, 4);
        if (block < 32) return -1;
        p += 4 + block;
        if (p > end) return -1;
    }
    return written;
}

// ---------------------------------------------------------------------------
// Device-count section extraction: turn a SAM/BAM stream into per-record
// arrays (chrom index, CIGAR ref-sections, flag, NH, qname hash) that the
// host maps into the DeviceCounter's window coordinates and the TPU kernel
// consumes.  Replaces the per-line Python parser (the end-to-end
// bottleneck of --deviceCounts).  Sections follow the engine's
// M/D/N/maxMOp semantics (readSummary.c process_line_buffer analog).

static inline uint64_t qname_hash64(const char *s, long n) {
    uint64_t h = 1469598103934665603ull;        // FNV-1a
    for (long i = 0; i < n; i++) {
        h ^= (uint8_t)s[i];
        h *= 1099511628211ull;
    }
    return h;
}

extern "C" long fc_read_sections_sam(
    const char *buf, long buflen,
    const char *chrom_blob, const int64_t *chrom_off, int32_t n_chroms,
    int32_t S, int32_t max_mop,
    int32_t *chrom_idx, int32_t *nsec,
    int32_t *sec_s, int32_t *sec_e,
    int32_t *flag_out, int32_t *nh_out, int64_t *qhash,
    long max_rows)
{
    int last_chrom = -1;
    const char *last_name = nullptr;
    long last_name_len = -1;
    const char *p = buf;
    const char *end = buf + buflen;
    long row = 0;

    while (p < end) {
        const char *line_end = (const char *)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (*p == '@' || line_end == p) { p = line_end + 1; continue; }
        if (row >= max_rows) return -2;   // caller grows and retries

        const char *f[12];
        int nf = 0;
        f[nf++] = p;
        for (const char *q = p; q < line_end && nf < 12; q++)
            if (*q == '\t') f[nf++] = q + 1;
        if (nf < 6) return -1;

        long flag = strtol(f[1], nullptr, 10);
        qhash[row] = (int64_t)qname_hash64(f[0], (f[1] - 1) - f[0]);
        flag_out[row] = (int32_t)flag;
        nsec[row] = 0;
        chrom_idx[row] = -1;
        nh_out[row] = 1;

        bool mapped = !(flag & 0x4) && *f[5] != '*';
        if (mapped) {
            // chromosome id (cached: SAM clusters by chromosome)
            const char *rn = f[2];
            long rn_len = (f[3] - 1) - rn;
            int ci = -1;
            if (last_name && str_eq(rn, rn_len, last_name, last_name_len)) {
                ci = last_chrom;
            } else {
                for (int c = 0; c < n_chroms; c++) {
                    const char *nm = chrom_blob + chrom_off[c];
                    long nl = chrom_off[c + 1] - chrom_off[c];
                    if (str_eq(rn, rn_len, nm, nl)) { ci = c; break; }
                }
                last_chrom = ci; last_name = rn; last_name_len = rn_len;
            }
            chrom_idx[row] = ci;

            // NH tag
            if (nf >= 12) {
                const char *t = f[11];
                while (t < line_end) {
                    const char *te = (const char *)memchr(t, '\t', line_end - t);
                    if (!te) te = line_end;
                    if (te - t > 5 && t[0]=='N' && t[1]=='H' && t[2]==':'
                        && t[3]=='i' && t[4]==':')
                        { nh_out[row] = (int32_t)strtol(t + 5, nullptr, 10); break; }
                    t = te + 1;
                }
            }

            // CIGAR ref sections (split at N, D merges, max_mop M cap)
            long pos = strtol(f[3], nullptr, 10);
            long cur = pos, sec_start = -1, n_m = 0, k = 0;
            const char *c = f[5];
            long ln = 0;
            while (c < line_end && *c != '\t') {
                char ch = *c++;
                if (ch >= '0' && ch <= '9') { ln = ln * 10 + (ch - '0'); continue; }
                if (ch == 'M' || ch == '=' || ch == 'X') {
                    if (++n_m > max_mop) { ln = 0; break; }
                    if (sec_start < 0) sec_start = cur;
                    cur += ln;
                } else if (ch == 'D') {
                    cur += ln;
                } else if (ch == 'N') {
                    if (sec_start >= 0 && k < S) {
                        sec_s[row * S + k] = (int32_t)sec_start;
                        sec_e[row * S + k] = (int32_t)(cur - 1);
                        k++;
                    }
                    sec_start = -1;
                    cur += ln;
                }
                ln = 0;
            }
            if (sec_start >= 0 && k < S) {
                sec_s[row * S + k] = (int32_t)sec_start;
                sec_e[row * S + k] = (int32_t)(cur - 1);
                k++;
            }
            nsec[row] = (int32_t)k;
        }
        row++;
        p = line_end + 1;
    }
    return row;
}

extern "C" long fc_read_sections_bam(
    const uint8_t *buf, long buflen,
    const int32_t *ref2chrom, int32_t n_refs,
    int32_t S, int32_t max_mop,
    int32_t *chrom_idx, int32_t *nsec,
    int32_t *sec_s, int32_t *sec_e,
    int32_t *flag_out, int32_t *nh_out, int64_t *qhash,
    long max_rows)
{
    const uint8_t *p = buf;
    const uint8_t *end = buf + buflen;
    long row = 0;
    auto rd_i32 = [](const uint8_t *q) { int32_t v; memcpy(&v, q, 4); return v; };
    auto rd_u32 = [](const uint8_t *q) { uint32_t v; memcpy(&v, q, 4); return v; };
    auto rd_u16 = [](const uint8_t *q) { uint16_t v; memcpy(&v, q, 2); return v; };

    while (p + 4 <= end) {
        int32_t block = rd_i32(p);
        const uint8_t *rec = p + 4;
        p = rec + block;
        if (p > end || block < 32) break;
        if (row >= max_rows) return -2;

        int32_t ref_id = rd_i32(rec);
        int32_t pos0 = rd_i32(rec + 4);
        uint8_t l_qname = rec[8];
        uint16_t n_cigar = rd_u16(rec + 12);
        uint16_t flag = rd_u16(rec + 14);
        int32_t l_seq = rd_i32(rec + 16);
        const uint8_t *cig = rec + 32 + l_qname;
        const uint8_t *seqp = cig + 4 * n_cigar;
        const uint8_t *tagp = seqp + (l_seq + 1) / 2 + l_seq;

        qhash[row] = (int64_t)qname_hash64((const char *)rec + 32,
                                           l_qname > 0 ? l_qname - 1 : 0);
        flag_out[row] = flag;
        nsec[row] = 0;
        nh_out[row] = 1;
        chrom_idx[row] = (ref_id >= 0 && ref_id < n_refs)
                             ? ref2chrom[ref_id] : -1;

        bool mapped = !(flag & 0x4) && n_cigar > 0 && chrom_idx[row] >= 0;
        if (mapped) {
            // NH tag (binary walk, same as fc_count_bam_simple)
            const uint8_t *t = tagp;
            while (t + 3 <= rec + block) {
                char c1 = t[0], c2 = t[1], typ = t[2];
                long vlen = 0, nh = -1;
                switch (typ) {
                    case 'A': case 'c': nh = (typ=='c') ? (int8_t)t[3] : -1; vlen = 1; break;
                    case 'C': nh = t[3]; vlen = 1; break;
                    case 's': { int16_t v; memcpy(&v, t+3, 2); nh = v; vlen = 2; break; }
                    case 'S': { uint16_t v; memcpy(&v, t+3, 2); nh = v; vlen = 2; break; }
                    case 'i': { int32_t v; memcpy(&v, t+3, 4); nh = v; vlen = 4; break; }
                    case 'I': { uint32_t v; memcpy(&v, t+3, 4); nh = (long)v; vlen = 4; break; }
                    case 'f': vlen = 4; break;
                    case 'Z': case 'H': {
                        const uint8_t *z = t + 3;
                        while (z < rec + block && *z) z++;
                        vlen = z - (t + 3) + 1;
                        break;
                    }
                    case 'B': {
                        if (t + 8 > rec + block) { vlen = -1; break; }
                        uint8_t st = t[3];
                        uint32_t cnt = rd_u32(t + 4);
                        long esz = (st=='c'||st=='C') ? 1 : (st=='s'||st=='S') ? 2 : 4;
                        vlen = 5 + (long)cnt * esz;
                        break;
                    }
                    default: vlen = -1;
                }
                if (vlen < 0) break;
                if (c1 == 'N' && c2 == 'H' && nh >= 0) { nh_out[row] = (int32_t)nh; break; }
                t += 3 + vlen;
            }

            long cur = pos0 + 1, sec_start = -1, n_m = 0, k = 0;
            for (int i = 0; i < n_cigar; i++) {
                uint32_t cv = rd_u32(cig + 4 * i);
                long ln = cv >> 4;
                int op = cv & 0xf;       // MIDNSHP=X
                if (op == 0 || op == 7 || op == 8) {
                    if (++n_m > max_mop) break;
                    if (sec_start < 0) sec_start = cur;
                    cur += ln;
                } else if (op == 2) {
                    cur += ln;
                } else if (op == 3) {
                    if (sec_start >= 0 && k < S) {
                        sec_s[row * S + k] = (int32_t)sec_start;
                        sec_e[row * S + k] = (int32_t)(cur - 1);
                        k++;
                    }
                    sec_start = -1;
                    cur += ln;
                }
            }
            if (sec_start >= 0 && k < S) {
                sec_s[row * S + k] = (int32_t)sec_start;
                sec_e[row * S + k] = (int32_t)(cur - 1);
                k++;
            }
            nsec[row] = (int32_t)k;
        }
        row++;
    }
    return row;
}
