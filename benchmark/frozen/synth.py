"""Frozen, vectorised copies of the port's traffic generators.

Copied from `subread_tpu_torch/synth.py` (`synthetic_genome`,
`synthetic_reads`, `synthetic_pairs`, `synthetic_spliced_pairs` and the
helpers they call: `_transcripts`, `_motif_sites`, `_chimera`, `_mutate`,
`_with_n`) and `subread_tpu_torch/utils/simulate.py` (`simulate_reads`), at
commit 7c152797eaed1811dec0341cbdfcc3f26f815f9f.  The port may change its own
generators; these stay as they are, so a cell's traffic never moves under a
later change.

Departures from the originals, each for the benchmark's sake:

* The genome takes its contigs' names and lengths (the deployment's) instead
  of cutting one sequence into equal parts.
* Reads are drawn in a few large numpy calls, not read by read, so making a
  pool of half a million reads costs seconds of set-up, not minutes.
* A read's contig is drawn in proportion to the contig's length (the
  original drew contigs uniformly, which suits equal contigs only: it would
  put a seventh of the reads on a 13.8 kb chrM).
* Genomic reads and pairs come from either strand with equal odds (the
  original's single-end reads were all forward and its mate 1 always
  forward).
* The truth is returned as arrays (contig, interval, strand, indel and the
  introns crossed), not only written into the read names.

Bases are carried as ASCII bytes (`A`, `C`, `G`, `T`, `N`); a genome's N runs
are `N` in its FASTA, which an index builder reads as `A`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b
MAX_INTRON = 500_000  # subjunc's longest intron (the port's ops.junction.MAX_INTRON)


@dataclass
class Genome:
    """Contigs as one ASCII array: contig c is seq[offsets[c]:offsets[c] +
    lengths[c]]; N bases are `N`."""
    names: list[str]
    lengths: np.ndarray   # int64 [K]
    offsets: np.ndarray   # int64 [K]
    seq: np.ndarray       # uint8 [sum(lengths)] ASCII

    def contig(self, c: int) -> np.ndarray:
        o = int(self.offsets[c])
        return self.seq[o: o + int(self.lengths[c])]

    @property
    def bases(self) -> np.ndarray:
        """seq with N read as A, as an index builder and the original
        generators (which drew reads from the 2-bit codes) read it."""
        if getattr(self, "_bases", None) is None:
            self._bases = np.where(self.seq == ord("N"), np.uint8(ord("A")), self.seq)
        return self._bases


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII bases along the last axis."""
    return _COMP[seq[..., ::-1]]


def synthetic_genome(contigs: list[tuple[str, int]], seed: int,
                     segdup_frac: float = 0.02, segdup_len: int = 10_000,
                     tandem_frac: float = 0.01,
                     n_runs_per_contig: int = 3) -> Genome:
    """A random genome with the given (name, length) contigs.

    `segdup_frac` of the bases are copies (half reverse-complemented) of
    other `segdup_len`-base segments; `tandem_frac` of them are tandem
    arrays of a 5-50 base unit repeated 20-60 times; each contig gets
    `n_runs_per_contig` runs of 20-300 N (fewer bases where the contig is
    shorter)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([n for _, n in contigs], np.int64)
    n_bases = int(lengths.sum())
    codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
    seg = max(min(segdup_len, n_bases // 20), 100)
    for _ in range(int(n_bases * segdup_frac) // seg):
        src = int(rng.integers(0, n_bases - seg))
        dst = int(rng.integers(0, n_bases - seg))
        piece = codes[src: src + seg].copy()
        if rng.random() < 0.5:
            piece = (3 - piece[::-1]).astype(np.uint8)
        codes[dst: dst + seg] = piece
    placed = 0
    while placed < n_bases * tandem_frac:
        unit = rng.integers(0, 4, size=int(rng.integers(5, 51)), dtype=np.uint8)
        arr = np.tile(unit, int(rng.integers(20, 61)))
        if len(arr) >= n_bases // 4:
            continue
        dst = int(rng.integers(0, n_bases - len(arr)))
        codes[dst: dst + len(arr)] = arr
        placed += len(arr)
    seq = ACGT[codes]
    del codes
    offsets = np.concatenate(([0], np.cumsum(lengths)[:-1])).astype(np.int64)
    for c in range(len(lengths)):
        lo, hi = int(offsets[c]), int(offsets[c] + lengths[c])
        for _ in range(n_runs_per_contig):
            ln = min(int(rng.integers(20, 301)), max((hi - lo) // 100, 1))
            s = int(rng.integers(lo, max(hi - ln, lo + 1)))
            seq[s: s + ln] = ord("N")
    return Genome([n for n, _ in contigs], lengths, offsets, seq)


def write_fasta(path: str, genome: Genome, width: int = 60) -> None:
    """FASTA of the genome's contigs, in lines of `width` bases."""
    with open(path, "wb") as f:
        for c, name in enumerate(genome.names):
            s = genome.contig(c)
            f.write(f">{name}\n".encode())
            n = len(s) // width * width
            lines = np.concatenate(
                [s[:n].reshape(-1, width),
                 np.full((n // width, 1), ord("\n"), np.uint8)], axis=1)
            f.write(lines.tobytes())
            if n < len(s):
                f.write(s[n:].tobytes() + b"\n")


@dataclass
class Pool:
    """Reads made from a seed, with their truth.  Mate m (0, or 0 and 1 for
    pairs) of read i has bases seqs[m][i] (ASCII, as the FASTQ holds them)
    and lies on contig[m][i] over [start[m][i], end[m][i]) (0-based), on the
    reverse strand where reverse[m][i] (-1: a chimera with no one strand);
    second[m][i] >= 0 marks a chimera whose other half lies on contig
    second[m][i] over [start2[m][i], end2[m][i]).  indel[m][i] is the length
    of the planted indel the mate crosses (0: none), introns[m][i] the
    number of introns it crosses.  junctions lists, for each read, the
    (contig, left_edge0, right_edge0, donor_strand, strong) of each intron
    its mates cross, strong where both flanks are at least 17 bases."""
    names: list[str]
    seqs: list[np.ndarray]
    qual: bytes
    contig: list[np.ndarray]
    start: list[np.ndarray]
    end: list[np.ndarray]
    reverse: list[np.ndarray]
    indel: list[np.ndarray]
    introns: list[np.ndarray]
    second: list[np.ndarray]
    start2: list[np.ndarray]
    end2: list[np.ndarray]
    junctions: list[list] | None = field(default=None)

    def __len__(self) -> int:
        return len(self.names)

    @property
    def mates(self) -> int:
        return len(self.seqs)


def _add_errors(seq: np.ndarray, rng, error_rate: float) -> None:
    """Substitute each base with odds error_rate by one of the other three
    (in place), as `_mutate` and simulate_reads' error step do."""
    hit = rng.random(seq.shape) < error_rate
    code = np.searchsorted(ACGT, seq[hit])
    seq[hit] = ACGT[(code + rng.integers(1, 4, size=len(code))) % 4]


def _add_n(seq: np.ndarray, rng, n_read_frac: float) -> None:
    """Turn 1-3 bases of n_read_frac of the reads into N (in place), as
    `_with_n` and `_to_fastq_seq` do."""
    rows = np.flatnonzero(rng.random(len(seq)) < n_read_frac)
    k = rng.integers(1, 4, size=len(rows))
    cols = rng.integers(0, seq.shape[1], size=(len(rows), 3))
    use = np.arange(3)[None, :] < k[:, None]
    seq[np.repeat(rows, 3).reshape(-1, 3)[use], cols[use]] = ord("N")


def _span(g: np.ndarray, planted: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Leftmost and one-past-rightmost genome offsets of each row of g,
    leaving out inserted bases (planted)."""
    big = np.iinfo(np.int64).max
    return (np.where(planted, big, g).min(axis=1),
            np.where(planted, -1, g).max(axis=1) + 1)


def genomic_reads(genome: Genome, n: int, seed: int, read_len: int = 100,
                  error_rate: float = 0.01, indel_rate: float = 0.05,
                  max_indel: int = 5, n_read_frac: float = 0.02,
                  paired: bool = False,
                  fragment_range: tuple[int, int] = (150, 500),
                  qual_char: str = "h") -> Pool:
    """simulate_reads with synthetic_reads' or synthetic_pairs' N bases.

    Each read (fragment, for pairs) starts at a uniform position of a
    contig drawn by length; indel_rate of them carry a deletion or an
    insertion (equal odds) of 1..max_indel bases 20-79 bases into the
    fragment; every base is substituted with odds error_rate; n_read_frac
    of the mates get 1-3 N.  A single read is reverse-complemented with odds
    one half; a pair's mate 2 is the reverse strand at the fragment's far
    end, and with odds one half the fragment comes from the reverse strand
    (the mates' strands swap).  Names: `r{i}_{contig}_{pos1}` for single
    reads, `p{i}_{contig}_{pos1}_{pos1}` for pairs (each mate's leftmost
    base)."""
    rng = np.random.default_rng(seed)
    L = read_len
    K = len(genome.names)
    c = rng.choice(K, size=n, p=genome.lengths / genome.lengths.sum())
    flen = (rng.integers(fragment_range[0], fragment_range[1] + 1, size=n)
            if paired else np.full(n, L))
    flen = np.maximum(flen, L)
    clen = genome.lengths[c]
    flen = np.where(clen < flen + 2 * max_indel + 2, np.minimum(flen, clen - 1), flen)
    room = np.maximum(clen - flen - max_indel - 1, 1)
    pos = (rng.random(n) * room).astype(np.int64)
    has = rng.random(n) < indel_rate
    ilen = np.where(has, rng.integers(1, max_indel + 1, size=n), 0)
    cut = rng.integers(20, L - 20, size=n)
    is_del = rng.random(n) < 0.5
    cols = np.arange(L)

    def mate(first):
        j = first[:, None] + cols[None, :]                 # fragment offsets
        after = j >= cut[:, None]
        dele = (is_del & has)[:, None]
        ins = (~is_del & has)[:, None]
        g = np.where(dele & after, j + ilen[:, None], j)
        planted = ins & after & (j < (cut + ilen)[:, None])
        g = np.where(ins & after & ~planted, j - ilen[:, None], g)
        base = (genome.offsets[c] + pos)[:, None]
        s = genome.bases[base + np.where(planted, 0, g)]
        s[planted] = ACGT[rng.integers(0, 4, size=int(planted.sum()))]
        crosses = has & (cut > first) & (cut < first + L)
        lo, hi = _span(g, planted)
        return s, pos + lo, pos + hi, np.where(crosses, ilen, 0)

    s1, a1, b1, d1 = mate(np.zeros(n, np.int64))
    _add_errors(s1, rng, error_rate)
    zeros = np.zeros(n, np.int32)
    none = np.full(n, -1, np.int32)
    if not paired:
        rev = rng.random(n) < 0.5
        s1[rev] = revcomp(s1[rev])
        _add_n(s1, rng, n_read_frac)
        names = [f"r{i}_{genome.names[k]}_{p + 1}"
                 for i, (k, p) in enumerate(zip(c.tolist(), a1.tolist()))]
        return Pool(names, [s1], (qual_char * L).encode(), [c], [a1], [b1],
                    [rev.astype(np.int8)], [d1], [zeros], [none], [zeros],
                    [zeros])
    s2, a2, b2, d2 = mate(flen - L)
    _add_errors(s2, rng, error_rate)
    s2 = revcomp(s2)
    flip = rng.random(n) < 0.5
    m1 = np.where(flip[:, None], s2, s1)
    m2 = np.where(flip[:, None], s1, s2)
    _add_n(m1, rng, n_read_frac)
    _add_n(m2, rng, n_read_frac)
    sel = lambda x, y: np.where(flip, y, x)
    names = [f"p{i}_{genome.names[k]}_{p + 1}_{q + 1}" for i, (k, p, q) in
             enumerate(zip(c.tolist(), sel(a1, a2).tolist(), sel(a2, a1).tolist()))]
    return Pool(names, [m1, m2], (qual_char * L).encode(), [c, c],
                [sel(a1, a2), sel(a2, a1)], [sel(b1, b2), sel(b2, b1)],
                [flip.astype(np.int8), (~flip).astype(np.int8)],
                [sel(d1, d2), sel(d2, d1)], [zeros, zeros], [none, none],
                [zeros, zeros], [zeros, zeros])


# donor and acceptor dinucleotides: 0 = GT..AG, 1 = CT..AC
_MOTIFS = {0: (b"GT", b"AG"), 1: (b"CT", b"AC")}


def _motif_sites(cc: np.ndarray, pair: bytes) -> np.ndarray:
    """Sorted offsets i with cc[i], cc[i+1] == pair."""
    return np.flatnonzero((cc[:-1] == pair[0]) & (cc[1:] == pair[1]))


def _has_n(genome: Genome, c: int, a: int, b: int) -> bool:
    return bool((genome.contig(c)[a:b] == ord("N")).any())


def _transcripts(genome: Genome, n: int, rng, max_intron: int = 20_000,
                 min_len: int = 300):
    """n transcripts of 2-4 exons of 40-300 bases (half of the middle exons
    40-70), each intron 60 to `max_intron` bases and placed only where the
    genome already carries the motif: GT after the left exon and AG before
    the right one, or CT and AC.  Returns [(contig, donor_strand,
    [(start0, end0), ...])]."""
    sites = {}
    lens = np.asarray(genome.lengths, np.int64)
    out = []
    while len(out) < n:
        c = int(rng.choice(len(lens), p=lens / lens.sum()))
        ds = int(rng.integers(0, 2))
        if (c, ds) not in sites:
            cc = genome.contig(c)
            sites[(c, ds)] = tuple(_motif_sites(cc, m) for m in _MOTIFS[ds])
        donors, acceptors = sites[(c, ds)]
        n_ex = int(rng.integers(2, 5))
        pos = int(rng.integers(100, max(int(lens[c]) - 2000, 101)))
        exons, ok = [], True
        for e in range(n_ex):
            middle = 0 < e < n_ex - 1
            elen = int(rng.integers(40, 71) if middle and rng.random() < 0.5
                       else rng.integers(40, 301))
            if e == n_ex - 1:
                exons.append((pos, pos + elen))
                break
            i = int(np.searchsorted(donors, pos + elen))
            if i >= len(donors):
                ok = False
                break
            le = int(donors[i]) - 1
            j = int(np.searchsorted(
                acceptors, le + 1 + int(rng.integers(60, max_intron + 1)) - 2))
            if j >= len(acceptors):
                ok = False
                break
            re_ = int(acceptors[j]) + 2
            if re_ - le - 1 > max_intron or le + 1 - pos > 300:
                ok = False
                break
            exons.append((pos, le + 1))
            pos = re_
        if not ok or exons[-1][1] > int(lens[c]) - 100:
            continue
        if sum(b - a for a, b in exons) < min_len:
            continue
        if any(_has_n(genome, c, a, b) for a, b in exons):
            continue
        out.append((c, ds, exons))
    return out


def _chimera(genome: Genome, rng, half: int):
    """Two `half`-base pieces joined: on two contigs, more than MAX_INTRON
    apart on one contig (where a contig is that long), or with the second
    piece inverted a few kb downstream.  Returns the bases and the two
    pieces as (contig, start0, end0)."""
    lens = np.asarray(genome.lengths, np.int64)
    while True:
        kind = str(rng.choice(["contig", "far", "inv"]))
        ca = int(rng.integers(0, len(lens)))
        if lens[ca] < 2000 + 2 * half + 10_000:
            continue
        a = int(rng.integers(1000, int(lens[ca]) - 1000 - half))
        if kind == "contig" and len(lens) > 1:
            cb = int((ca + rng.integers(1, len(lens))) % len(lens))
            if lens[cb] < 2000 + 2 * half:
                continue
            b = int(rng.integers(1000, int(lens[cb]) - 1000 - half))
        elif kind == "far" and lens[ca] > MAX_INTRON + 4 * half + 2000:
            cb = ca
            b = int(rng.integers(1000, int(lens[ca]) - 1000 - half))
            if abs(b - a) <= MAX_INTRON + 2 * half:
                continue
        elif kind == "inv":
            cb, b = ca, a + half + int(rng.integers(1000, 10_000))
            if b + half > lens[ca] - 1000:
                continue
        else:
            continue
        if _has_n(genome, ca, a, a + half) or _has_n(genome, cb, b, b + half):
            continue
        pa = genome.contig(ca)[a: a + half].copy()
        pb = genome.contig(cb)[b: b + half].copy()
        if kind == "inv":
            pb = revcomp(pb)
        return np.concatenate([pa, pb]), (ca, a, a + half), (cb, b, b + half)


def spliced_pairs(genome: Genome, n: int, seed: int, read_len: int = 100,
                  n_transcripts: int | None = None, error_rate: float = 0.01,
                  n_read_frac: float = 0.02, chimera_frac: float = 0.02,
                  fragment_range: tuple[int, int] = (150, 400),
                  qual_char: str = "I") -> Pool:
    """synthetic_spliced_pairs: pairs from transcripts of
    `_transcripts`, fragments of 150-400 bases of a transcript (at most its
    length), mate 1 from one end and mate 2 the reverse complement of the
    other, the fragment from either strand; chimera_frac of the pairs have a
    chimeric mate 1 (two half-length pieces) whose mate 2 lies 200-400
    bases beyond the start of its first piece, on the reverse strand.
    Names: `sjp{i}_{contig}_{pos1}_{pos1}` or `chimp{i}_{contig}_{pos1}`."""
    rng = np.random.default_rng(seed)
    L = read_len
    txs = _transcripts(genome, n_transcripts or max(n // 25, 4), rng)
    ex_pos = [np.concatenate([np.arange(a, b) for a, b in tx[2]]) for tx in txs]
    tx_len = np.asarray([len(p) for p in ex_pos], np.int64)
    tx_off = np.concatenate(([0], np.cumsum(tx_len)[:-1]))
    tx_map = np.concatenate(ex_pos)                       # contig offsets
    tx_c = np.asarray([tx[0] for tx in txs], np.int64)
    tx_ds = np.asarray([tx[1] for tx in txs], np.int64)

    chim = rng.random(n) < chimera_frac
    t_i = rng.integers(0, len(txs), size=n)
    T = tx_len[t_i]
    F = np.minimum(rng.integers(fragment_range[0], fragment_range[1] + 1, size=n), T)
    t = (rng.random(n) * (T - F + 1)).astype(np.int64)
    cols = np.arange(L)
    gA = tx_map[(tx_off[t_i] + t)[:, None] + cols]
    gB = tx_map[(tx_off[t_i] + t + F - L)[:, None] + cols]
    base = genome.offsets[tx_c[t_i]][:, None]
    a = genome.bases[base + gA]
    b = genome.bases[base + gB]
    fwd = rng.random(n) < 0.5
    rb = revcomp(b)
    m1 = np.where(fwd[:, None], a, rb)
    m2 = np.where(fwd[:, None], rb, a)
    g1 = np.where(fwd[:, None], gA, gB)
    g2 = np.where(fwd[:, None], gB, gA)
    c = tx_c[t_i]
    contig = [c.copy(), c.copy()]
    start = [g1[:, 0].copy(), g2[:, 0].copy()]
    end = [g1[:, -1] + 1, g2[:, -1] + 1]
    reverse = [(~fwd).astype(np.int8), fwd.astype(np.int8)]
    introns = [(np.diff(g, axis=1) > 1).sum(axis=1).astype(np.int32)
               for g in (g1, g2)]
    second = [np.full(n, -1, np.int32), np.full(n, -1, np.int32)]
    start2 = [np.zeros(n, np.int64), np.zeros(n, np.int64)]
    end2 = [np.zeros(n, np.int64), np.zeros(n, np.int64)]
    for i in np.flatnonzero(chim).tolist():
        seq, (ca, pa, ea), (cb, pb, eb) = _chimera(genome, rng, L // 2)
        off = pa + int(rng.integers(200, 401))
        if off + L > int(genome.lengths[ca]):
            off = int(genome.lengths[ca]) - L
        m1[i] = seq
        o = int(genome.offsets[ca]) + off
        m2[i] = revcomp(genome.bases[o: o + L])
        contig[0][i], start[0][i], end[0][i] = ca, pa, ea
        second[0][i], start2[0][i], end2[0][i] = cb, pb, eb
        reverse[0][i] = -1
        contig[1][i], start[1][i], end[1][i] = ca, off, off + L
        reverse[1][i] = 1
        introns[0][i] = introns[1][i] = 0
    _add_errors(m1, rng, error_rate)
    _add_errors(m2, rng, error_rate)
    _add_n(m1, rng, n_read_frac)
    _add_n(m2, rng, n_read_frac)

    junctions: list[list] = [[] for _ in range(n)]
    for g in (g1, g2):
        rows, k = np.nonzero(np.diff(g, axis=1) > 1)
        keep = ~chim[rows]
        rows, k = rows[keep], k[keep]
        strong = np.minimum(k + 1, L - k - 1) >= 17
        for r, kk, s in zip(rows.tolist(), k.tolist(), strong.tolist()):
            junctions[r].append((int(c[r]), int(g[r, kk]), int(g[r, kk + 1]),
                                 int(tx_ds[t_i[r]]), bool(s)))
    names = [
        f"chimp{i}_{genome.names[int(contig[0][i])]}_{int(start[0][i]) + 1}"
        if chim[i] else
        f"sjp{i}_{genome.names[int(c[i])]}_{int(start[0][i]) + 1}_{int(start[1][i]) + 1}"
        for i in range(n)
    ]
    zeros = np.zeros(n, np.int32)
    return Pool(names, [m1, m2], (qual_char * L).encode(), contig, start,
                end, reverse, [zeros, zeros], introns, second, start2, end2,
                junctions)


def write_fastq(path: str, names: list[str], seqs: np.ndarray, qual: bytes) -> None:
    """FASTQ of reads with bases seqs (ASCII rows) and quality string qual."""
    rows = seqs.view(f"S{seqs.shape[1]}").ravel()
    tail = b"\n+\n" + qual + b"\n"
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s\n%s%s" % (nm.encode(), s, tail)
                         for nm, s in zip(names, rows)))
