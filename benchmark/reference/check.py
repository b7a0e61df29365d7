"""The plain reference that decides `correct`: what a cell's window wrote,
and the index the program built, held against the genome and the reads the
benchmark made.

It reads the program's outputs only to judge them (the BAM, the junction
table, the index arrays and its `.reads` file) and works everything out
again from the benchmark's own genome and reads.  Conventions it takes from
Subread's documentation, not from the program:

* a genome's N bases are read as A (subread-buildindex converts every
  non-ACGT base to A);
* SEQ is the read's bases as its FASTQ holds them, an N included
  (reverse-complemented on the reverse strand), as Subread writes them;
* NM is the record's edit distance to the genome: its mismatched bases
  over M/=/X operations plus its inserted and deleted bases (SAM; Subread's
  NM tag), a read's N counting where it faces a base;
* -M caps the mismatched bases of each stretch of a reported alignment
  between its introns (N operations): Subread's explain_read judges each
  junction section on its own, so a read across two junctions may carry
  more than -M in all; soft-clipped bases and a read's N do not count;
* a gapped index holds the 16-mer at every index_gap-th offset of each
  contig, keyed by 2 bits a base (A 0, G 1, C 2, T 3, first base highest),
  stored under min(key, reverse-complement key) with the orientation beside
  it, and leaves out a forward 16-mer that occurs more than the repeat
  threshold of times at those offsets;
* TLEN follows Subread's calc_tlen (subread_tlen), not the SAM
  specification;
* contig c lies at linear offset starts[c], with starts[0] = 1210 and
  starts[c + 1] = ends[c] + 1210, where ends[c] = starts[c] + length + 1210
  - 16 is the value of the index's `.reads` file.

Every count here is exact: each is 0 in a correct run, except easy_missed,
a share with a limit of its own (PERF.md).
"""

from __future__ import annotations

import numpy as np

from ..frozen.synth import Genome, Pool, revcomp
from .bam import OPS, Records

PADDING = 1210
KMER = 16
_CODE = np.zeros(256, np.uint8)              # A 0, G 1, C 2, T 3 (N as A)
for _ch, _v in zip(b"AGCT", range(4)):
    _CODE[_ch] = _v


def window_records(rec: Records, pool: Pool, n_fed: int) -> tuple[int, np.ndarray]:
    """The primary records of the n_fed reads the window fed (read k is the
    pool's read k mod len(pool)), each mate in input order: (the records
    missing, extra, misnamed or with the wrong mate flag, and the record
    index of each read's mates [n, mates], -1 where missing)."""
    m = pool.mates
    prim = np.flatnonzero((rec.flag & 0x900) == 0)
    want = n_fed * m
    errors = abs(len(prim) - want)
    n = min(len(prim), want) // m
    ids = np.full((n_fed, m), -1, np.int64)
    ids[:n] = prim[: n * m].reshape(n, m)
    names = rec.names()
    expect = [s.encode() for s in pool.names]
    N = len(pool)
    for k in range(n):
        e = expect[k % N]
        for j in range(m):
            i = int(ids[k, j])
            bad = names[i] != e
            if m == 2:
                f = int(rec.flag[i])
                bad = bad or not f & 1 or not f & (0x40 if j == 0 else 0x80)
            errors += bool(bad)
    return errors, ids


def _contig_index(rec: Records, genome: Genome) -> np.ndarray:
    """The benchmark genome's contig index of each BAM reference."""
    where = {n: c for c, n in enumerate(genome.names)}
    return np.asarray([where.get(n, -1) for n in rec.ref_names], np.int64)


def alignment(rec: Records, i: int, seq: np.ndarray, genome: Genome,
              cmap: np.ndarray):
    """Record i's alignment of the read seq (ASCII, in the record's
    orientation) recomputed from the genome: (the most mismatched bases of
    one stretch between N operations, over its M/=/X operations where the
    read calls a base; all mismatched bases, where it calls one; the
    record's edit distance, its mismatches with a read's N counted plus its
    inserted and deleted bases; whether its CIGAR consumes the whole read
    and stays inside its contig)."""
    cig = rec.cigar(i)
    c = int(cmap[int(rec.ref_id[i])]) if rec.ref_id[i] >= 0 else -1
    if c < 0:
        return 0, 0, 0, False
    read_len = sum(n for n, op in cig if OPS[op] in "MIS=X")
    ref_len = sum(n for n, op in cig if OPS[op] in "MDN=X")
    p = int(rec.pos[i])
    ok = read_len == len(seq) and p >= 0 and p + ref_len <= int(genome.lengths[c])
    if not ok:
        return 0, 0, 0, False
    g = genome.bases[int(genome.offsets[c]):]
    q, r, mism, edits, worst, section = 0, p, 0, 0, 0, 0
    for n, op in cig:
        o = OPS[op]
        if o in "M=X":
            a = seq[q: q + n]
            diff = a != g[r: r + n]
            m = int((diff & (a != ord("N"))).sum())
            mism += m
            edits += int(diff.sum())
            section += m
            q += n
            r += n
        elif o in "IS":
            q += n
            edits += n if o == "I" else 0
        elif o in "DN":
            r += n
            edits += n if o == "D" else 0
            if o == "N":
                worst, section = max(worst, section), 0
    return max(worst, section), mism, edits, True


def truth_mismatches(pool: Pool, genome: Genome, r: int, m: int) -> int | None:
    """Mismatched bases of mate m of read r at its planted origin, or None
    where that origin is not one ungapped stretch or the read holds an N."""
    if (pool.indel[m][r] or pool.introns[m][r] or pool.second[m][r] >= 0
            or pool.reverse[m][r] < 0):
        return None
    s = pool.seqs[m][r]
    if pool.reverse[m][r]:
        s = revcomp(s)
    if (s == ord("N")).any():
        return None
    o = int(genome.offsets[pool.contig[m][r]]) + int(pool.start[m][r])
    return int((s != genome.bases[o: o + len(s)]).sum())


def record_checks(rec: Records, ids: np.ndarray, pool: Pool, genome: Genome,
                  sample: np.ndarray, max_mismatches: int) -> dict:
    """For each sampled window read (rows of ids), each mate's record:
    bad_records (SEQ other than the read's, a CIGAR that does not consume
    the read or leaves its contig), nm_errors (an NM tag missing or other
    than the record's edit distance), over_mismatch_limit (a stretch between introns with more mismatched
    bases than -M) and, among the reads whose planted origin is
    one ungapped stretch with at most one mismatch and no N (easy),
    easy_missed: the share whose record is unmapped or aligns with more
    mismatches than the origin has.  examples lists the first three records
    of each kind of failure.  Also mate_errors for pairs: mate
    fields that disagree with the mate's record (RNEXT, PNEXT, the mate
    flags, TLEN equal and opposite, and within the CIGARs' indel, intron
    and clip bases of the pair's span)."""
    cmap = _contig_index(rec, genome)
    N = len(pool)
    out = dict(bad_records=0, nm_errors=0, over_mismatch_limit=0, easy=0,
               easy_missed=0, mate_errors=0)
    examples = out["examples"] = []

    def show(what, i, *extra):
        if sum(e[0] == what for e in examples) < 3:
            examples.append((what, rec.name(i).decode(), int(rec.flag[i]),
                             rec.ref_names[int(rec.ref_id[i])] if rec.ref_id[i] >= 0 else "*",
                             int(rec.pos[i]) + 1,
                             "".join(f"{n}{OPS[op]}" for n, op in rec.cigar(i)),
                             *extra))
    for k in sample.tolist():
        r = k % N
        for m in range(pool.mates):
            i = int(ids[k, m])
            if i < 0:
                continue
            want = pool.seqs[m][r]
            f = int(rec.flag[i])
            if f & 0x10:
                want = revcomp(want)
            seq = rec.seq(i)
            if len(seq) != len(want) or not (seq == want).all():
                out["bad_records"] += 1
                show("bad_records", i, "seq")
                continue
            tm = truth_mismatches(pool, genome, r, m)
            easy = tm is not None and tm <= 1
            out["easy"] += easy
            if f & 4:
                out["easy_missed"] += easy
                continue
            worst, mism, edits, ok = alignment(rec, i, want, genome, cmap)
            if not ok:
                out["bad_records"] += 1
                show("bad_records", i, "cigar")
                continue
            nm = rec.int_tag(i, b"NM")
            if nm != edits:
                out["nm_errors"] += 1
                show("nm_errors", i, f"NM {nm}", f"edit distance {edits}")
            if worst > max_mismatches:
                out["over_mismatch_limit"] += 1
                show("over_mismatch_limit", i, f"NM {nm}", f"mismatches {mism}")
            out["easy_missed"] += easy and mism > tm
        if pool.mates == 2 and ids[k, 0] >= 0 and ids[k, 1] >= 0:
            why = _mate_error(rec, int(ids[k, 0]), int(ids[k, 1]))
            if why:
                out["mate_errors"] += 1
                for i in ids[k]:
                    show("mate_errors", int(i), why, int(rec.tlen[i]),
                         int(rec.next_ref_id[i]), int(rec.next_pos[i]) + 1)
    out["easy_missed"] = out["easy_missed"] / max(out["easy"], 1)
    return out


def subread_tlen(rec: Records, m1: int, m2: int) -> tuple[int, int]:
    """The TLEN of a pair's mate 1 and mate 2 records, both mapped on one
    contig, by Subread's rule (calc_tlen, core.c:1718), not the SAM
    specification's: the record with the smaller POS walks its CIGAR, S and
    M moving both the genome and the read cursor, I the read, D and N the
    genome; at each I, D or N and at the end, once the section's genome end
    reaches the other record's POS, TLEN = read cursor + that POS - the
    section's end + the other read's length (if it never does: that POS -
    the last section's end + both lengths); equal POS gives the longer
    read's length.  The smaller POS is positive; at equal POS mate 1 is
    negative when it is reversed."""
    p1, p2 = int(rec.pos[m1]) + 1, int(rec.pos[m2]) + 1
    l1, l2 = int(rec.l_seq[m1]), int(rec.l_seq[m2])
    if p1 == p2:
        t = max(l1, l2)
        return (-t, t) if rec.flag[m1] & 0x10 else (t, -t)
    small, ps, pb, lsm, lbig = ((m1, p1, p2, l1, l2) if p1 < p2
                                else (m2, p2, p1, l2, l1))
    chro, read, end = ps, 0, 0
    cig = rec.cigar(small)
    t = None
    for j, (n, op) in enumerate(cig):
        o = OPS[op]
        if o in "MS=X":
            chro += n
            read += n
            end = chro
        if o in "NDI" or j == len(cig) - 1:
            if o in "ND":
                chro += n
            if end >= pb:
                t = read + pb - end + lbig
                break
        if o == "I":
            read += n
    if t is None:
        t = pb - end + lbig + lsm
    return (t, -t) if p1 < p2 else (-t, t)


def _mate_error(rec: Records, a: int, b: int) -> str:
    """Why the mate fields of the pair's mate 1 and mate 2 records a, b
    disagree with each other ('' if they agree)."""
    fa, fb = int(rec.flag[a]), int(rec.flag[b])
    if bool(fa & 8) != bool(fb & 4) or bool(fb & 8) != bool(fa & 4):
        return "mate-unmapped flag"
    if fa & 4 or fb & 4:
        return ""
    for x, y, fx, fy in ((a, b, fa, fb), (b, a, fb, fa)):
        if rec.next_ref_id[x] != rec.ref_id[y] or rec.next_pos[x] != rec.pos[y]:
            return "RNEXT/PNEXT"
        if bool(fx & 0x20) != bool(fy & 0x10):
            return "mate-reverse flag"
    if rec.ref_id[a] != rec.ref_id[b]:
        return "TLEN across contigs" if rec.tlen[a] or rec.tlen[b] else ""
    want = subread_tlen(rec, a, b)
    if (int(rec.tlen[a]), int(rec.tlen[b])) != want:
        return f"TLEN, not {want}"
    return ""


def junction_table_errors(rec: Records, bed_path: str) -> int:
    """Junctions whose support in the junction table differs from the
    count of primary mapped records whose CIGAR crosses them with an N at
    those edges (either side missing counts too)."""
    count: dict = {}
    spliced = np.flatnonzero(((rec.flag & 0x904) == 0) & (rec.n_cigar > 1))
    for i in spliced.tolist():
        r = int(rec.pos[i])
        name = rec.ref_names[int(rec.ref_id[i])]
        for n, op in rec.cigar(i):
            o = OPS[op]
            if o == "N":
                key = (name, r - 1, r + n)
                count[key] = count.get(key, 0) + 1
            if o in "MDN=X":
                r += n
    table = read_junction_table(bed_path)
    keys = set(count) | set(table)
    return sum(count.get(k, 0) != table.get(k, 0) for k in keys)


def read_junction_table(path: str) -> dict:
    """The junction table's rows as {(contig, left_edge0, right_edge0):
    support}, summed over strands: the last exon base before the intron and
    the first after it, 0-based, from its block columns (Subread's
    `.junction.bed`: chrom, start, end, name, support, strand, thickStart,
    thickEnd, colour, blocks, block sizes, block starts)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            x = line.rstrip("\n").split("\t")
            start = int(x[1])
            key = (x[0], start + int(x[10].split(",")[0]) - 1,
                   start + int(x[11].split(",")[1]))
            out[key] = out.get(key, 0) + int(x[4])
    return out


def junction_strands(path: str) -> set:
    """The junction table's rows as (contig, left_edge0, right_edge0,
    donor strand 0 or 1)."""
    out = set()
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            x = line.rstrip("\n").split("\t")
            start = int(x[1])
            out.add((x[0], start + int(x[10].split(",")[0]) - 1,
                     start + int(x[11].split(",")[1]), int(x[5] == "-")))
    return out


# --- the index -------------------------------------------------------------

def _keys(bases: np.ndarray) -> np.ndarray:
    """The key of the 16-mer at every offset of bases (len - 15 of them)."""
    m = len(bases) - KMER + 1
    if m <= 0:
        return np.zeros(0, np.uint32)
    c = _CODE[bases]
    b = (c[0: m + 12] << 6) | (c[1: m + 13] << 4) | (c[2: m + 14] << 2) | c[3: m + 15]
    out = b[0:m].astype(np.uint32) << 24
    out |= b[4: m + 4].astype(np.uint32) << 16
    out |= b[8: m + 8].astype(np.uint32) << 8
    out |= b[12: m + 12]
    return out


def _revcomp_keys(k: np.ndarray) -> np.ndarray:
    out = np.zeros_like(k)
    x = (~k).astype(np.uint32)
    for j in range(KMER):
        out |= ((x >> np.uint32(2 * j)) & np.uint32(3)) << np.uint32(2 * (KMER - 1 - j))
    return out


def index_layout(genome: Genome) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the contigs in the index's linear coordinates."""
    starts, ends, pos = [], [], PADDING
    for n in genome.lengths.tolist():
        starts.append(pos)
        ends.append(pos + n + PADDING - KMER)
        pos = ends[-1] + PADDING
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def stepped_keys(genome: Genome, index_gap: int) -> np.ndarray:
    """The forward 16-mer key at every index_gap-th offset of each contig,
    sorted: what the repeat threshold counts."""
    keys = [_keys(genome.contig(c))[::index_gap] for c in range(len(genome.names))]
    return np.sort(np.concatenate(keys))


def _key_at(genome: Genome, c: np.ndarray, off: np.ndarray) -> np.ndarray:
    """The forward 16-mer key at offset off of contig c (arrays)."""
    at = (genome.offsets[c] + off)[:, None] + np.arange(KMER)
    codes = _CODE[genome.bases[at]].astype(np.uint32)
    out = np.zeros(len(c), np.uint32)
    for j in range(KMER):
        out |= codes[:, j] << np.uint32(2 * (KMER - 1 - j))
    return out


def index_errors(genome: Genome, keys: np.ndarray, positions: np.ndarray,
                 orient: np.ndarray, reads_file: str, index_gap: int,
                 threshold: int, sorted_keys: np.ndarray, n_sample: int,
                 seed: int) -> int:
    """Errors of the program's index against the genome: each line of its
    `.reads` file that is not the contig's end and name; among n_sample
    entries drawn from the seed, each that is not the 16-mer the genome
    holds at its position (key, orientation, an offset on the index's
    step) or whose forward 16-mer is over the threshold; among n_sample
    indexed offsets drawn from the seed whose forward 16-mer is within the
    threshold, each the index does not hold.  sorted_keys is
    stepped_keys(genome, index_gap)."""
    starts, ends = index_layout(genome)
    want = [f"{e}\t{n}" for e, n in zip(ends.tolist(), genome.names)]
    with open(reads_file) as f:
        have = [x.rstrip("\n") for x in f if x.strip()]
    errors = sum(a != b for a, b in zip(have, want)) + abs(len(have) - len(want))
    count = lambda k: (np.searchsorted(sorted_keys, k, side="right")
                       - np.searchsorted(sorted_keys, k, side="left"))
    rng = np.random.default_rng(seed)
    # entries of the index: each a 16-mer of the genome at its position
    j = rng.integers(0, len(keys), size=min(n_sample, len(keys)))
    pos = positions[j].astype(np.int64)
    c = np.clip(np.searchsorted(ends, pos, side="right"), 0, len(ends) - 1)
    off = pos - starts[c]
    on_step = (off >= 0) & (off <= genome.lengths[c] - KMER) & (off % index_gap == 0)
    fwd = _key_at(genome, c[on_step], off[on_step])
    canon = np.minimum(fwd, _revcomp_keys(fwd))
    ok = ((keys[j][on_step].astype(np.uint32) == canon)
          & (orient[j][on_step].astype(bool) == (fwd != canon))
          & (count(fwd) <= threshold))
    errors += int((~on_step).sum()) + int((~ok).sum())
    # indexed offsets of the genome: each informative one in the index
    steps = (genome.lengths - KMER) // index_gap + 1
    cum = np.concatenate(([0], np.cumsum(steps)))
    q = rng.integers(0, cum[-1], size=n_sample)
    cq = np.searchsorted(cum, q, side="right") - 1
    offq = (q - cum[cq]) * index_gap
    kf = _key_at(genome, cq, offq)
    informative = count(kf) <= threshold
    kc = np.minimum(kf, _revcomp_keys(kf))
    lo = np.searchsorted(keys, kc, side="left")
    hi = np.searchsorted(keys, kc, side="right")
    lin = starts[cq] + offq
    for a, b, p, o in zip(lo[informative].tolist(), hi[informative].tolist(),
                          lin[informative].tolist(), (kf != kc)[informative].tolist()):
        there = (positions[a:b].astype(np.int64) == p) & (orient[a:b].astype(bool) == o)
        errors += not there.any()
    return errors
