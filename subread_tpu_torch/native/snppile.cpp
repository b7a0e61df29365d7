// Native exactSNP pileup over uncompressed BAM records.
//
// Reference: the per-read voting of SNPCalling.c (put_hash_to_pile :550):
// per fragment, positions covered by both mates vote once with the
// higher-quality base (ties -> first mate); head/tail-trimmed and
// low-quality bases are dropped; CIGAR I/D events are tallied per
// (chrom, pos, len, inserted-seq).  This mirrors quant/snp.py
// SNPCaller.add_fragment exactly — the Python path remains as the
// fallback and as the SAM-text path.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Trip {
  int64_t g;
  int8_t b;
  int16_t q;
  int32_t idx;  // emission order (tie-break: first mate wins)
};

struct MateRec {
  long rec_off;  // offset of the record body (after block_size)
  int32_t block;
};

// 4-bit BAM base code -> ACGT index or -1
static const int8_t kBase4[16] = {-1, 0, 1, -1, 2, -1, -1, -1,
                                  3,  -1, -1, -1, -1, -1, -1, -1};

struct IndelKey {
  int32_t chrom;
  int64_t pos;
  int32_t len;  // >0 deletion, <0 insertion
  std::string seq;
  bool operator==(const IndelKey& o) const {
    return chrom == o.chrom && pos == o.pos && len == o.len && seq == o.seq;
  }
};

struct IndelKeyHash {
  size_t operator()(const IndelKey& k) const {
    size_t h = std::hash<int64_t>()(k.pos) * 1000003u ^
               std::hash<int32_t>()(k.chrom) ^
               (std::hash<int32_t>()(k.len) << 8) ^ std::hash<std::string>()(k.seq);
    return h;
  }
};

struct Ctx {
  const uint8_t* recs;
  int32_t* votes;           // flat, chrom c position g base b at
                            // (chrom_off[c] + g) * 4 + b
  const int64_t* chrom_off;  // per-chrom start position in votes (positions)
  const int64_t* chrom_len;
  const int32_t* ref2chrom;
  int n_refs;
  int trim;
  int min_q;      // compare against (qual + 33 - phred_offset)
  int qual_bias;  // 33 - phred_offset
  std::unordered_map<IndelKey, int64_t, IndelKeyHash> indels;
  std::vector<Trip> trips;  // scratch for the current fragment
  int32_t trip_idx;
};

static inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
static inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Walk one record: append filtered (gpos, base, qual) triples for the
// fragment merge and tally indel events.  Returns the record's chrom id
// (or -1 when unusable).
static int32_t collect_record(Ctx& ctx, long off, int32_t block) {
  const uint8_t* r = ctx.recs + off;
  const int32_t ref_id = rd_i32(r);
  const int64_t pos0 = rd_i32(r + 4);
  const uint8_t l_read_name = r[8];
  const uint16_t n_cigar = rd_u16(r + 12);
  const int32_t l_seq = rd_i32(r + 16);
  if (ref_id < 0 || ref_id >= ctx.n_refs) return -1;
  const int32_t chrom = ctx.ref2chrom[ref_id];
  if (chrom < 0) return -1;
  const uint8_t* cig = r + 32 + l_read_name;
  const uint8_t* seq = cig + 4l * n_cigar;
  const uint8_t* qual = seq + (l_seq + 1) / 2;
  const bool has_qual = l_seq > 0 && qual[0] != 0xFF;
  const int64_t clen = ctx.chrom_len[chrom];

  int64_t g = pos0;
  int64_t rp = 0;
  for (uint16_t ci = 0; ci < n_cigar; ++ci) {
    const uint32_t cv = (uint32_t)rd_i32(cig + 4l * ci);
    const int64_t n = cv >> 4;
    const uint32_t op = cv & 0xF;  // MIDNSHP=X
    switch (op) {
      case 0: case 7: case 8: {  // M, =, X
        for (int64_t i = 0; i < n; ++i) {
          const int64_t gg = g + i, rr = rp + i;
          if (gg < 0 || gg >= clen) continue;
          if (rr < ctx.trim || rr >= l_seq - ctx.trim) continue;
          const int q = has_qual ? (int)qual[rr] + ctx.qual_bias : 40;
          if (q < ctx.min_q) continue;
          const uint8_t nib = seq[rr >> 1];
          const int8_t b = kBase4[(rr & 1) ? (nib & 0xF) : (nib >> 4)];
          if (b < 0) continue;
          ctx.trips.push_back(Trip{ctx.chrom_off[chrom] + gg, b, (int16_t)q,
                                   ctx.trip_idx++});
        }
        g += n;
        rp += n;
        break;
      }
      case 1: {  // I
        std::string ins((size_t)n, 'N');
        for (int64_t i = 0; i < n; ++i) {
          const uint8_t nib = seq[(rp + i) >> 1];
          const int8_t b = kBase4[((rp + i) & 1) ? (nib & 0xF) : (nib >> 4)];
          ins[(size_t)i] = b < 0 ? 'N' : "ACGT"[b];
        }
        ctx.indels[IndelKey{chrom, g - 1, (int32_t)-n, std::move(ins)}] += 1;
        rp += n;
        break;
      }
      case 2:  // D
        ctx.indels[IndelKey{chrom, g - 1, (int32_t)n, std::string()}] += 1;
        g += n;
        break;
      case 3:  // N
        g += n;
        break;
      case 4:  // S
        rp += n;
        break;
      default:  // H, P consume nothing
        break;
    }
  }
  return chrom;
}

static void vote_fragment(Ctx& ctx) {
  auto& t = ctx.trips;
  if (t.empty()) return;
  if (t.size() > 1) {
    // per genome position keep the highest quality; tie -> earliest index
    std::sort(t.begin(), t.end(), [](const Trip& a, const Trip& b) {
      if (a.g != b.g) return a.g < b.g;
      if (a.q != b.q) return a.q > b.q;
      return a.idx < b.idx;
    });
    size_t w = 0;
    for (size_t i = 0; i < t.size(); ++i)
      if (i == 0 || t[i].g != t[w - 1].g) t[w++] = t[i];
    t.resize(w);
  }
  for (const Trip& x : t) ctx.votes[x.g * 4 + x.b]++;
  t.clear();
  ctx.trip_idx = 0;
}

}  // namespace

extern "C" {

// Returns number of records processed, or -1 on malformed input.
// After voting, indel events are serialized into the out_* buffers
// (capacities in *_cap); returns -2 when a capacity is insufficient —
// caller retries with bigger buffers.  n_indels_out receives the count,
// blob_len_out the used seq-blob bytes.
long snp_pileup_bam(
    const uint8_t* recs, long len,
    const int32_t* ref2chrom, int32_t n_refs,
    const int64_t* chrom_off, const int64_t* chrom_len, int32_t n_chroms,
    int32_t trim, int32_t min_q, int32_t qual_bias,
    int32_t* votes,
    int32_t* out_chrom, int64_t* out_pos, int32_t* out_len,
    int64_t* out_count, int64_t* out_seq_off, long indel_cap,
    uint8_t* out_blob, long blob_cap,
    long* n_indels_out, long* blob_len_out) {
  (void)n_chroms;
  Ctx ctx;
  ctx.recs = recs;
  ctx.votes = votes;
  ctx.chrom_off = chrom_off;
  ctx.chrom_len = chrom_len;
  ctx.ref2chrom = ref2chrom;
  ctx.n_refs = n_refs;
  ctx.trim = trim;
  ctx.min_q = min_q;
  ctx.qual_bias = qual_bias;
  ctx.trip_idx = 0;

  std::unordered_map<std::string, MateRec> pending;
  long off = 0, n_rec = 0;
  while (off + 4 <= len) {
    const int32_t block = rd_i32(recs + off);
    if (block < 32 || off + 4 + block > len) return -1;
    const long body = off + 4;
    const uint8_t* r = recs + body;
    const uint16_t flag = rd_u16(r + 14);
    const uint8_t l_read_name = r[8];
    off = body + block;
    ++n_rec;
    if (flag & 0x4) continue;
    if (flag & 0x1) {
      std::string name((const char*)r + 32, l_read_name > 0 ? l_read_name - 1 : 0);
      auto it = pending.find(name);
      if (it == pending.end()) {
        pending.emplace(std::move(name), MateRec{body, block});
        continue;
      }
      const MateRec mate = it->second;
      pending.erase(it);
      // Merge only same-chrom triples (quant/snp.py groups per chrom).
      const int32_t c1 = collect_record(ctx, mate.rec_off, mate.block);
      // If mates land on different chroms, flush mate1's votes first so
      // the dedup never crosses chromosomes.  chrom_off makes positions
      // globally unique, so same-chrom is the common (no-op) case.
      (void)c1;
      collect_record(ctx, body, block);
      vote_fragment(ctx);
    } else {
      collect_record(ctx, body, block);
      vote_fragment(ctx);
    }
  }
  for (const auto& kv : pending) {
    collect_record(ctx, kv.second.rec_off, kv.second.block);
    vote_fragment(ctx);
  }

  // serialize indel events
  if ((long)ctx.indels.size() > indel_cap) return -2;
  long bi = 0, blob = 0;
  for (const auto& kv : ctx.indels) {
    if (blob + (long)kv.first.seq.size() > blob_cap) return -2;
    out_chrom[bi] = kv.first.chrom;
    out_pos[bi] = kv.first.pos;
    out_len[bi] = kv.first.len;
    out_count[bi] = kv.second;
    out_seq_off[bi] = blob;
    std::memcpy(out_blob + blob, kv.first.seq.data(), kv.first.seq.size());
    blob += (long)kv.first.seq.size();
    ++bi;
  }
  *n_indels_out = bi;
  *blob_len_out = blob;
  return n_rec;
}

}  // extern "C"
