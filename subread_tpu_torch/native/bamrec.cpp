// BAM record encoder: one chunk of aligned reads, from the result columns
// of the align pipeline, to binary BAM records (SAM specification, section
// 4.2) in input order.  Each record is the bytes io/bam.py's
// BamWriter.add_sam_fields packs from the same record's SAM fields: bin 0,
// the CIGAR as u32 operations, SEQ as 4-bit codes (reverse-complemented on
// a mapped reverse-strand record), QUAL as phred bytes (reversed there),
// and integer tags as type 'i' in the order HI, NH, NM.
//
// Build: part of the native library (native/__init__.py).

#include <cstdint>
#include <cstring>

// BAM's 4-bit codes (=ACMGRSVTWYHKDBN) of the 2-bit read codes A, G, C, T
static const uint8_t NIB[4] = {1, 4, 2, 8};
// BAM CIGAR operation codes (MIDNSHP=X)
enum { OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4 };

static inline uint8_t *put_i32(uint8_t *p, int32_t v) {
    memcpy(p, &v, 4);   // little-endian hosts (x86-64, aarch64)
    return p + 4;
}

static inline uint8_t *put_u16(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)v;
    p[1] = (uint8_t)(v >> 8);
    return p + 2;
}

static inline uint8_t *put_tag(uint8_t *p, char a, char b, int32_t v) {
    p[0] = (uint8_t)a;
    p[1] = (uint8_t)b;
    p[2] = 'i';
    return put_i32(p + 3, v);
}

// one CIGAR operation; false where the Python packer would raise (a
// negative length, or one that does not fit the u32's 28 bits)
static inline bool put_op(uint8_t *&p, int32_t n, uint32_t op) {
    if (n < 0 || n >= (1 << 28)) return false;
    uint32_t v = ((uint32_t)n << 4) | op;
    memcpy(p, &v, 4);
    p += 4;
    return true;
}

// The CIGAR the emitters build from (split, indel, junc_gap, clips):
// clS spM jgN (L-cl-sp-cr)M crS for a junction, clS (sp-cl)M dD
// (L-sp-cr)M crS for a deletion, clS (sp-cl)M iI (L-sp-i-cr)M crS for an
// insertion, else clS (L-cl-cr)M crS.  Returns the number of operations,
// or -1 where the Python packer would raise.
static inline int put_cigar(uint8_t *p, int32_t L, int32_t ind, int32_t sp,
                            int32_t jg, int32_t cl, int32_t cr) {
    uint8_t *q = p;
    if (cl < 0 || cr < 0) return -1;
    bool ok = true;
    if (cl > 0) ok &= put_op(q, cl, OP_S);
    if (jg > 0) {
        ok &= put_op(q, sp, OP_M);
        ok &= put_op(q, jg, OP_N);
        ok &= put_op(q, L - cl - sp - cr, OP_M);
    } else if (ind > 0) {
        ok &= put_op(q, sp - cl, OP_M);
        ok &= put_op(q, ind, OP_D);
        ok &= put_op(q, L - sp - cr, OP_M);
    } else if (ind < 0) {
        ok &= put_op(q, sp - cl, OP_M);
        ok &= put_op(q, -ind, OP_I);
        ok &= put_op(q, L - sp + ind - cr, OP_M);
    } else {
        ok &= put_op(q, L - cl - cr, OP_M);
    }
    if (cr > 0) ok &= put_op(q, cr, OP_S);
    return ok ? (int)((q - p) / 4) : -1;
}

// Encodes rows [0, n) into out and sets rec_end[i] to the end of row i's
// record (a skipped row's is the end of the record before it).  Returns
// the bytes written; -1 if out is too small; -2 if a row holds what the
// Python packer refuses (a name of 255 bytes or more, MAPQ or FLAG out of
// range, a negative or oversized CIGAR length, a quality byte outside
// 33-127), so the caller packs the chunk in Python, which raises there.
extern "C" long format_bam_records(
    int32_t n,
    const char *names,                                 // n NUL-ended names
    const uint8_t *codes, const uint8_t *quals,        // [n, Lmax]
    const int32_t *lens, int32_t Lmax,
    const int32_t *flags, const int32_t *ref_id, const int32_t *pos,
    const int32_t *mapq, const int32_t *next_ref, const int32_t *next_pos,
    const int32_t *tlen, const uint8_t *mapped,
    const int32_t *indel, const int32_t *split, const int32_t *junc_gap,
    const int32_t *clip_l, const int32_t *clip_r, const int32_t *nm,
    // HI and NH tags where nh[i] > 0; NM on every mapped record
    const int32_t *hi, const int32_t *nh,
    const uint8_t *skip,                               // may be null
    // rows whose CIGAR is given: ov_row ascending, row ov_row[k]'s
    // operations ov_ops[ov_off[k], ov_off[k+1])
    int32_t n_ov, const int32_t *ov_row, const int64_t *ov_off,
    const uint32_t *ov_ops,
    uint8_t *out, int64_t outcap, int64_t *rec_end)
{
    uint8_t *p = out;
    const uint8_t *end = out + outcap;
    int32_t k = 0;          // next override
    for (int32_t i = 0; i < n; i++) {
        size_t l_name = strlen(names) + 1;
        const char *name = names;
        names += l_name;
        bool given = k < n_ov && ov_row[k] == i;
        int64_t g0 = given ? ov_off[k] : 0, g1 = given ? ov_off[k + 1] : 0;
        k += given;
        if (skip && skip[i]) {
            rec_end[i] = p - out;
            continue;
        }
        int32_t L = lens[i];
        bool is_mapped = mapped[i] != 0;
        int32_t flag = flags[i];
        int32_t mq = mapq[i];
        if (l_name > 255 || mq < 0 || mq > 255 || flag < 0 || flag > 0xFFFF)
            return -2;
        int64_t need = 4 + 32 + (int64_t)l_name + 4 * (5 + (g1 - g0))
            + (L + 1) / 2 + L + 21;
        if (p + need > end) return -1;

        uint8_t *rec = p;
        p += 4 + 32;
        memcpy(p, name, l_name);
        p += l_name;
        int n_cigar = 0;
        if (is_mapped) {
            if (given) {
                memcpy(p, ov_ops + g0, 4 * (g1 - g0));
                n_cigar = (int)(g1 - g0);
            } else {
                n_cigar = put_cigar(p, L, indel[i], split[i], junc_gap[i],
                                    clip_l[i], clip_r[i]);
                if (n_cigar < 0) return -2;
            }
            p += 4 * n_cigar;
        }
        if (n_cigar > 0xFFFF) return -2;

        // SEQ and QUAL, reverse-complemented on a mapped reverse record
        const uint8_t *cd = codes + (int64_t)i * Lmax;
        const uint8_t *qu = quals + (int64_t)i * Lmax;
        uint8_t *sq = p, *ql = p + (L + 1) / 2;
        uint8_t bad = 0;
        if (is_mapped && (flag & 0x10)) {
            for (int32_t j = 0; j < L; j++) {
                uint8_t c = NIB[3 - (cd[L - 1 - j] & 3)];
                if (j & 1) sq[j >> 1] |= c; else sq[j >> 1] = (uint8_t)(c << 4);
                uint8_t q = qu[L - 1 - j];
                bad |= (uint8_t)(q - 33) > 94;
                ql[j] = (uint8_t)(q - 33);
            }
        } else {
            for (int32_t j = 0; j < L; j++) {
                uint8_t c = NIB[cd[j] & 3];
                if (j & 1) sq[j >> 1] |= c; else sq[j >> 1] = (uint8_t)(c << 4);
                uint8_t q = qu[j];
                bad |= (uint8_t)(q - 33) > 94;
                ql[j] = (uint8_t)(q - 33);
            }
        }
        if (bad) return -2;
        if (L == 1 && qu[0] == '*') ql[0] = 0xFF;   // SAM's "no quality"
        p = ql + L;

        if (nh[i] > 0) {
            p = put_tag(p, 'H', 'I', hi[i]);
            p = put_tag(p, 'N', 'H', nh[i]);
        }
        if (is_mapped) p = put_tag(p, 'N', 'M', nm[i]);

        // block_size and the fixed part
        uint8_t *f = put_i32(rec, (int32_t)(p - rec - 4));
        f = put_i32(f, ref_id[i]);
        f = put_i32(f, pos[i]);
        *f++ = (uint8_t)l_name;
        *f++ = (uint8_t)mq;
        f = put_u16(f, 0);                              // bin
        f = put_u16(f, (uint32_t)n_cigar);
        f = put_u16(f, (uint32_t)flag);
        f = put_i32(f, L);
        f = put_i32(f, next_ref[i]);
        f = put_i32(f, next_pos[i]);
        put_i32(f, tlen[i]);
        rec_end[i] = p - out;
    }
    return p - out;
}
