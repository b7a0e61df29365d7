"""A plain reference of cellCounts' counting rules.

It imports numpy and nothing else, so the benchmark's check runs a
byte-equal copy of it as it is (`benchmark/frozen/cellcounts.py`), and every
value in it is an integer.  Bases are ASCII (`A`, `C`, `G`, `T`); a base's
2-bit value is A 0, G 1, C 2, T 3, and a barcode's or UMI's value reads its
first base highest.  From the R1 reads, the fields of the BAM's records,
the annotation's exons and the whitelist, it works out by cellCounts' rules
as `quant/cellcounts.py` and `tools/cellcounts.py` state them:

  * a read's barcode is R1's first barcode_len bases; its whitelist entry is
    the one equal to it, else the one entry within hamming distance 1 of it
    where there is exactly one, else none (`match_barcodes`);
  * a mapped record's gene is the one gene whose exons overlap the bases
    [POS, POS + length - 1] of its contig, the record being `<length>M`,
    and none where no gene's or two genes' exons do, or where POS lies
    outside the contig (`record_genes`);
  * a record's tags are CB, R1's barcode bases and "-1"; UB, the umi_len
    bases after them; GX, its gene's name, where it has one (`tags`);
  * a read counts where its barcode matched and its record has a gene; per
    (cell, gene), its distinct UMIs are taken in order of reads
    (descending), then of value (ascending), and each merges into the first
    one kept within hamming distance 1 of it, else is kept; the entry is
    the number kept (`umi_counts`);
  * with cell calling, the cells are those the bootstrapped knee calls and
    those the ambient rescue adds (`call_cells`); the matrix lists them in
    whitelist order (`matrix_files`: matrix.mtx, barcodes.tsv,
    features.tsv);
  * a mapped read's reported locus is rescored over its candidate table
    (`rescore`): candidates within 2 votes of its best score
    matched * 1,000,000 // (1 + mismatches) times the annotation's weight
    of their span (10,000,000 over an exon, 13 within 100 bases of one, 10
    elsewhere); the first best moves the read where it lies more than 64
    bases away.

Where it differs from Subread's `cell-counts.c`, as the port's docstrings
cite it: Subread writes a record's CB as the matched whitelist barcode and
tags only reads whose barcode matched (the port writes R1's own bases, "-1",
on every record); Subread merges UMIs in a sort of its own
(cell-counts.c:3523-3620) whose order among UMIs of equal reads this file
takes as their 2-bit value, the port's FASTQ mode's order (its BCL mode
takes their text, A < C < G < T); Subread assigns a read by the bases its
CIGAR covers, junctions left out, where the port's record is `<length>M`
over the whole span; Subread's knee uses floating point where this file
rounds the same halves in integers.
"""

from __future__ import annotations

import numpy as np

CODE = np.zeros(256, np.int64)
for _i, _b in enumerate(b"AGCT"):
    CODE[_b] = _i
BASES = np.frombuffer(b"AGCT", np.uint8)

BOOTSTRAP_HIGH_INDEX = 30
BOOTSTRAP_TIMES = 100
IDX_PRIME = 11218439
MIN_UMIS_FOR_RESCUE = 500
MAX_RESCUED = 20000
MAX_RESCUE_RANK = 45000

EXONIC, NEAR, BASE = 10_000_000, 13, 10


def values(text: np.ndarray) -> np.ndarray:
    """The 2-bit values of ASCII rows [n, L] (L <= 31), first base highest."""
    v = np.zeros(len(text), np.int64)
    for j in range(text.shape[1]):
        v = (v << 2) | CODE[text[:, j]]
    return v


def hamming(a: np.ndarray, b: np.ndarray, length: int) -> np.ndarray:
    """Bases that differ between values a and b of length bases."""
    x = np.bitwise_xor(a, b)
    d = np.zeros(np.shape(x), np.int64)
    for j in range(length):
        d += ((x >> (2 * j)) & 3) != 0
    return d


def _bases_apart(a: int, b: int) -> int:
    """hamming() of two values as Python integers."""
    x = a ^ b
    return bin((x | (x >> 1)) & 0x5555555555555555).count("1")


def match_barcodes(barcodes: np.ndarray, whitelist: np.ndarray) -> np.ndarray:
    """Each barcode's whitelist index, or -1: equal, else the unique entry
    within hamming 1.  barcodes [n, L] and whitelist [W, L] ASCII, the
    whitelist's entries distinct.  The candidates of a barcode with no
    equal entry are the entries that share its first L // 2 bases or its
    last L - L // 2: one at hamming 1 shares one half."""
    L = whitelist.shape[1]
    wv, q = values(whitelist), values(barcodes)
    order = np.argsort(wv, kind="stable")
    srt = wv[order]
    i = np.minimum(np.searchsorted(srt, q), len(srt) - 1)
    out = np.where(srt[i] == q, order[i], -1)
    miss = np.flatnonzero(out < 0)
    found = np.zeros(len(miss), np.int64)
    which = np.full(len(miss), -1, np.int64)
    tail = 2 * (L - L // 2)
    for part in (lambda v: v >> tail, lambda v: v & ((1 << tail) - 1)):
        pw = part(wv)
        po = np.argsort(pw, kind="stable")
        ps = pw[po]
        pq = part(q[miss])
        lo = np.searchsorted(ps, pq, "left")
        n = np.searchsorted(ps, pq, "right") - lo
        row = np.repeat(np.arange(len(miss)), n)
        cand = po[np.repeat(lo, n) + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)]
        one = hamming(q[miss][row], wv[cand], L) == 1
        found += np.bincount(row[one], minlength=len(miss))
        which[row[one]] = cand[one]
    out[miss[found == 1]] = which[found == 1]
    return out


def record_genes(contig_lengths, exons, ref_id, pos, flag, length) -> np.ndarray:
    """Each record's gene, or -1.  exons: (contig, start0, end0, gene)
    rows, end exclusive; records: contig index (-1 unmapped), 0-based POS,
    FLAG and read length."""
    ref_id, pos = np.asarray(ref_id, np.int64), np.asarray(pos, np.int64)
    flag, length = np.asarray(flag, np.int64), np.asarray(length, np.int64)
    gene = np.full(len(ref_id), -1, np.int64)
    ex = np.asarray(exons, np.int64).reshape(-1, 4)
    for c, clen in enumerate(contig_lengths):
        rows = np.flatnonzero((ref_id == c) & ((flag & 4) == 0)
                              & (pos >= 0) & (pos < clen))
        if not len(rows):
            continue
        # per base: how many genes' exons cover it, and the sum of those
        # genes' (gene + 1), which names the gene where the count is one
        mine = ex[ex[:, 0] == c]
        mine = mine[np.lexsort((mine[:, 1], mine[:, 3]))]
        merged = []
        for _, s, e, g in mine.tolist():
            if merged and merged[-1][2] == g and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e, g])
        m = np.asarray(merged, np.int64).reshape(-1, 3)
        n_cov = np.zeros(clen + 1, np.int32)
        id_sum = np.zeros(clen + 1, np.int32)
        np.add.at(n_cov, m[:, 0], 1)
        np.add.at(n_cov, m[:, 1], -1)
        np.add.at(id_sum, m[:, 0], m[:, 2] + 1)
        np.add.at(id_sum, m[:, 1], -(m[:, 2] + 1))
        n_cov, id_sum = np.cumsum(n_cov), np.cumsum(id_sum)
        n_cov[clen] = id_sum[clen] = 0
        for k in range(0, len(rows), 65536):
            r = rows[k: k + 65536]
            span = int(length[r].max())
            at = pos[r][:, None] + np.arange(span)[None, :]
            inside = (at < pos[r][:, None] + length[r][:, None]) & (at < clen)
            at = np.where(inside, at, clen)
            cnt, ids = n_cov[at], id_sum[at]
            hi = np.where(cnt == 1, ids, 0).max(axis=1)
            lo = np.where(cnt == 1, ids, np.iinfo(np.int32).max).min(axis=1)
            one = (cnt.max(axis=1) == 1) & (hi == lo)
            gene[r[one]] = hi[one] - 1
    return gene


def tags(r1: np.ndarray, r1_len, genes, gene_names, barcode_len: int = 16,
         umi_len: int = 12) -> list[tuple[str, str, str | None]]:
    """Each record's (CB, UB, GX or None): r1 ASCII [n, >= barcode_len]."""
    out = []
    for i in range(len(r1)):
        text = r1[i, : int(r1_len[i])].tobytes().decode()
        g = int(genes[i])
        out.append((text[:barcode_len] + "-1",
                    text[barcode_len: barcode_len + umi_len],
                    gene_names[g] if g >= 0 else None))
    return out


def umi_counts(cells, genes, umis, umi_len: int) -> np.ndarray:
    """[E, 3] (gene, cell, UMIs kept) entries in order of cell, then gene,
    from each read's whitelist index (-1 unmatched), gene (-1 none) and
    UMI value."""
    cells, genes, umis = (np.asarray(a, np.int64) for a in (cells, genes, umis))
    ok = (cells >= 0) & (genes >= 0)
    trip = np.stack([cells[ok], genes[ok], umis[ok]], axis=1)
    if not len(trip):
        return np.zeros((0, 3), np.int64)
    uniq, reads = np.unique(trip, axis=0, return_counts=True)
    new = np.ones(len(uniq), bool)
    new[1:] = (uniq[1:, 0] != uniq[:-1, 0]) | (uniq[1:, 1] != uniq[:-1, 1])
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], len(uniq))
    entries = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        group = sorted(zip((-reads[s:e]).tolist(), uniq[s:e, 2].tolist()))
        kept = []
        for _, u in group:
            if not any(_bases_apart(u, k) <= 1 for k in kept):
                kept.append(u)
        entries.append((int(uniq[s, 1]), int(uniq[s, 0]), len(kept)))
    return np.asarray(entries, np.int64)


def call_cells(cells, totals, umi_cutoff: int | None = None):
    """(called, rescued) whitelist indices, each in order of UMIs
    (descending), then index: the bootstrapped knee, 100 resamples in
    which sample t of all takes rank (n // 2 + t * 11218439) mod n, each
    calling the values at least its 30th highest / 10 (halves up); the
    mean count, halves up, of the top ranks are called (umi_cutoff: those
    with at least that many UMIs instead).  Then the next ranks, while
    their UMIs reach both 500 and a hundredth of the called cells' median
    (halves up) and their rank is under 45,000, are rescued, 20,000 at
    most."""
    cells, totals = np.asarray(cells, np.int64), np.asarray(totals, np.int64)
    order = np.lexsort((cells, -totals))
    n = len(order)
    if n == 0:
        return [], []
    desc = totals[order]
    if umi_cutoff is not None:
        n_called = int((desc >= umi_cutoff).sum())
    else:
        t = np.arange(BOOTSTRAP_TIMES * n, dtype=np.int64)
        pick = (n // 2 + t * IDX_PRIME) % n
        samples = np.sort(desc[pick].reshape(BOOTSTRAP_TIMES, n), axis=1)
        top = samples[:, max(n - BOOTSTRAP_HIGH_INDEX, 0)]
        thr = (top + 5) // 10
        total = int((samples >= thr[:, None]).sum())
        n_called = min(n, (total + BOOTSTRAP_TIMES // 2) // BOOTSTRAP_TIMES)
    called = order[:n_called]
    rescued = []
    if n_called:
        median = int(desc[(n_called - 1) // 2])
        cut = max((median + 50) // 100, MIN_UMIS_FOR_RESCUE)
        for rank in range(n_called, min(n, MAX_RESCUE_RANK)):
            if desc[rank] < cut:
                break
            if len(rescued) < MAX_RESCUED:
                rescued.append(int(order[rank]))
    return cells[called].tolist(), cells[rescued].tolist() if rescued else []


def matrix_files(entries: np.ndarray, gene_names, whitelist: np.ndarray,
                 cell_calling: bool, umi_cutoff: int | None = None) -> dict:
    """The text of matrix.mtx, barcodes.tsv and features.tsv from umi_counts'
    entries; whitelist ASCII [W, barcode_len]."""
    cells = np.unique(entries[:, 1]) if len(entries) else np.zeros(0, np.int64)
    if cell_calling and len(cells):
        totals = np.zeros(len(cells), np.int64)
        np.add.at(totals, np.searchsorted(cells, entries[:, 1]), entries[:, 2])
        called, rescued = call_cells(cells, totals, umi_cutoff)
        cells = np.sort(np.asarray(called + rescued, np.int64))
        entries = entries[np.isin(entries[:, 1], cells)]
    col = np.searchsorted(cells, entries[:, 1])
    lines = [f"{g + 1} {c + 1} {n}\n"
             for (g, _, n), c in zip(entries.tolist(), col.tolist())]
    return {
        "matrix.mtx": "%%MatrixMarket matrix coordinate integer general\n"
                      f"{len(gene_names)} {len(cells)} {len(entries)}\n" + "".join(lines),
        "barcodes.tsv": "".join(whitelist[c].tobytes().decode() + "\n"
                                for c in cells.tolist()),
        "features.tsv": "".join(f"{g}\t{g}\tGene Expression\n" for g in gene_names),
    }


def expected_outputs(r1: np.ndarray, whitelist: np.ndarray, contig_lengths, exons,
                     gene_names, ref_id, pos, flag, length, umi_len: int = 12,
                     cell_calling: bool = False, umi_cutoff: int | None = None):
    """The matrix files (a dict of their text) and each record's tags, from
    the R1 reads (ASCII [n, barcode_len + umi_len] or wider, every row of
    full length), the whitelist (ASCII [W, barcode_len]) and the records'
    fields, one a read in input order."""
    bl = whitelist.shape[1]
    cells = match_barcodes(r1[:, :bl], whitelist)
    genes = record_genes(contig_lengths, exons, ref_id, pos, flag, length)
    entries = umi_counts(cells, genes, values(r1[:, bl: bl + umi_len]), umi_len)
    files = matrix_files(entries, gene_names, whitelist, cell_calling, umi_cutoff)
    return files, tags(r1, np.full(len(r1), r1.shape[1]), genes, gene_names, bl, umi_len)


def _weight(lo: int, hi: int, exons_lin, pad: int = 100) -> int:
    near = False
    for s, e in exons_lin:
        if s <= hi and e >= lo:
            return EXONIC
        if s - pad <= hi and e + pad >= lo:
            near = True
    return NEAR if near else BASE


def rescore(alt_pos, alt_strand, alt_mism, alt_votes, alt_clip, lengths,
            pos, strand, mapped, multi, exons_lin, vote_diff: int = 2):
    """(pos, strand, multi) after the annotation's rescoring, read by read
    over the candidate tables (alt_pos [R, K] linear, 0xFFFFFFFF empty).
    exons_lin: each exon's (first, last) linear base, 1-based as the GTF's
    rows sit on the contigs' linear starts."""
    pos, strand, multi = (np.array(a) for a in (pos, strand, multi))
    empty = 0xFFFFFFFF
    for r in range(len(alt_pos)):
        cands = [k for k in range(alt_pos.shape[1]) if int(alt_pos[r, k]) != empty]
        if not cands or not mapped[r]:
            continue
        top = max(int(alt_votes[r, k]) for k in cands)
        L = int(lengths[r])
        scores = {}
        for k in cands:
            if int(alt_votes[r, k]) < top - vote_diff:
                continue
            m = int(alt_mism[r, k])
            matched = max(L - int(alt_clip[r, k]) - m, 0)
            a = int(alt_pos[r, k])
            scores[k] = matched * 1_000_000 // (1 + m) * _weight(a + 1, a + L, exons_lin)
        best = max(scores.values())
        k = min(k for k, s in scores.items() if s == best)
        if abs(int(alt_pos[r, k]) - int(pos[r])) > 64:
            pos[r], strand[r] = alt_pos[r, k], alt_strand[r, k]
            if sum(s == best for s in scores.values()) == 1:
                multi[r] = False
    return pos, strand, multi
