"""10x Chromium Single Cell 3' v3 read pairs, with the annotation and the
barcode whitelist they are read against.

Three pieces, each from a seed of its own:

* `whitelist(n, seed)`: n distinct random 16-base barcodes (10x's
  `3M-february-2018` list is not in the repository; it holds 6,794,880);
* `annotation(genome, n_genes, seed, ...)`: genes laid along the contigs in
  proportion to their lengths, one after another, each with 1-3
  transcripts of 2-12 exons whose introns sit at the genome's own splice
  motifs (GT..AG on '+', CT..AC on '-' as the forward strand reads them);
  written as a GTF by `write_gtf`;
* `generate(genome, n, seed, ...)`: the read pairs.  Molecules are drawn
  first, each a (cell, UMI, origin) read 1 + Poisson(dup_mean) times; a
  cell is one of `cells` whitelist barcodes with a log-normal depth, or,
  for `ambient_frac` of the molecules, one of `ambient_barcodes` others; an
  origin is, with odds `exonic`, `r2_len` bases within the last
  `three_prime` bases of one of a gene's transcripts (genes drawn Zipf-like
  by the annotation's fixed ranks, the transcript's sense strand, spliced
  where it crosses an exon edge), with odds `intronic` a stretch inside one
  of a gene's introns, on its sense strand, and otherwise an intergenic
  stretch on either strand.  Each read of a molecule gets its own errors:
  `barcode_one_error` of the R1s one substitution in the barcode,
  `barcode_more_errors` two or three; `umi_error` one in the UMI; R2's
  bases each substituted with odds `sub_rate`.  Every base is called (no
  N).

`generate` returns a `CellPool`: R1 (ASCII [n, barcode_len + umi_len]),
R2 as a `frozen.synth.Pool` with one mate (its truth: contig, genomic span,
strand, introns crossed), and each pair's whitelist index, gene (-1
outside genes' exons), UMI (ASCII) and origin kind (0 exonic, 1 intronic,
2 intergenic).  Read names are `cc<i>`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.frozen.synth import ACGT, Genome, Pool, revcomp

_MOTIFS = {0: (b"GT", b"AG"), 1: (b"CT", b"AC")}
EXONIC, INTRONIC, INTERGENIC = 0, 1, 2


def whitelist(n: int, seed: int, barcode_len: int = 16) -> np.ndarray:
    """n distinct barcodes, ASCII [n, barcode_len], in the order drawn."""
    rng = np.random.default_rng(seed)
    draw = rng.integers(0, 4, (n + n // 100 + 1000, barcode_len), dtype=np.uint8)
    keys = np.zeros(len(draw), np.int64)
    for j in range(barcode_len):
        keys = (keys << 2) | draw[:, j]
    first = np.sort(np.unique(keys, return_index=True)[1])
    if len(first) < n:
        raise ValueError("too few distinct barcodes drawn")
    return ACGT[draw[first[:n]]]


@dataclass
class Annotation:
    """genes[k] = (name, contig, strand 0 '+' / 1 '-', [transcripts: sorted
    [(start0, end0), ...]]); chain[k]: the gene's exons, sorted, which
    every transcript's exons are taken from (its introns are theirs);
    rank[k]: the gene's place in the tissue's expression, 0 the highest,
    drawn with the annotation so every sample of the tissue shares it."""
    genes: list
    chains: list
    rank: np.ndarray

    def exons(self) -> np.ndarray:
        """(contig, start0, end0, gene) of every transcript's exons, distinct."""
        rows = {(c, s, e, k) for k, (_, c, _, txs) in enumerate(self.genes)
                for tx in txs for s, e in tx}
        return np.asarray(sorted(rows), np.int64).reshape(-1, 4)


def _sites(bases: np.ndarray, pair: bytes) -> np.ndarray:
    return np.flatnonzero((bases[:-1] == pair[0]) & (bases[1:] == pair[1]))


def _chain(rng, sites, p, exons, exon_len, exon_median, intron, intron_median):
    """One gene's exons from offset p, its introns at the motif sites
    (donors, acceptors) of its strand."""
    donors, acceptors = sites
    chain, pos = [], p
    n_ex = int(rng.integers(exons[0], exons[1] + 1))
    for e in range(n_ex):
        elen = int(np.clip(rng.lognormal(np.log(exon_median), 1.0), *exon_len))
        i = int(np.searchsorted(donors, pos + elen))
        if e == n_ex - 1 or i >= len(donors):
            chain.append((pos, pos + elen))
            break
        d = int(donors[i])
        want = int(np.clip(rng.lognormal(np.log(intron_median), 1.0), *intron))
        j = int(np.searchsorted(acceptors, d + want - 2))
        if j >= len(acceptors) or int(acceptors[j]) + 2 - d > intron[1]:
            chain.append((pos, pos + elen))
            break
        chain.append((pos, d))
        pos = int(acceptors[j]) + 2
    if len(chain) < 2:
        # a second exon past the first's nearest motif pair
        i = int(np.searchsorted(donors, chain[0][1]))
        j = int(np.searchsorted(acceptors, donors[i] + intron[0] - 2))
        chain = [(chain[0][0], int(donors[i])),
                 (int(acceptors[j]) + 2, int(acceptors[j]) + 2 + exon_len[0])]
    return chain


def annotation(genome: Genome, n_genes: int, seed: int,
               transcripts=(1, 3), exons=(2, 12), exon_len=(50, 500),
               exon_median: int = 150, intron=(50, 5000),
               intron_median: int = 100) -> Annotation:
    """n_genes genes, as the module's docstring says.  Exon and intron
    lengths are log-normal (sigma 1.0) about their medians, clipped to
    their ranges; an intron ends at the first acceptor motif past its drawn
    length, and a gene stops at an intron longer than intron[1].  Genes
    are spaced evenly on average, leaving 1,000 bases at each contig end."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(genome.lengths, np.int64)
    est = 2.0 * (np.mean(exons) * exon_median + (np.mean(exons) - 1) * intron_median * 2)
    room = np.maximum(lens - 2000, 0)
    cap = (room // est).astype(np.int64)
    want = n_genes * room / room.sum()
    k = np.minimum(np.floor(want).astype(np.int64), cap)
    for c in np.argsort(-(want - k)):
        if k.sum() >= n_genes:
            break
        if k[c] < cap[c]:
            k[c] += 1
    while k.sum() < n_genes:
        k[int(np.argmax(cap - k))] += 1
    genes, chains = [], []
    for c, kc in enumerate(k.tolist()):
        if not kc:
            continue
        sites = {ds: tuple(_sites(genome.contig(c), m) for m in _MOTIFS[ds])
                 for ds in (0, 1)}
        gap = max((room[c] - kc * est) / (kc + 1), 100.0)
        p = 1000
        for placed in range(kc):
            # leave each gene still to come the room of est bases
            p = max(min(p + int(rng.uniform(0.1, 1.9) * gap),
                        int(lens[c] - 1000 - (kc - placed) * est)), p + 100)
            for _attempt in range(50):
                ds = int(rng.integers(0, 2))
                chain = _chain(rng, sites[ds], p, exons, exon_len, exon_median,
                               intron, intron_median)
                if chain[-1][1] <= lens[c] - 1000:
                    break
            else:
                raise ValueError(f"genes overran contig {genome.names[c]}")
            txs = []
            for t in range(int(rng.integers(transcripts[0], transcripts[1] + 1))):
                keep = rng.random(len(chain)) < 0.7
                keep[0] = keep[-1] = True
                if t == 0:
                    keep[:] = True
                txs.append([ex for ex, kp in zip(chain, keep) if kp])
            genes.append((f"WBGene{len(genes) + 1:08d}", c, ds, txs))
            chains.append(chain)
            p = chain[-1][1]
    return Annotation(genes, chains, rng.permutation(len(genes)))


def write_gtf(path: str, genome: Genome, ann: Annotation) -> None:
    """One exon row per transcript exon, gene_id and transcript_id set."""
    with open(path, "w") as f:
        for name, c, ds, txs in ann.genes:
            for t, tx in enumerate(txs):
                for s, e in tx:
                    f.write(f"{genome.names[c]}\tbench\texon\t{s + 1}\t{e}\t.\t"
                            f"{'+-'[ds]}\t.\tgene_id \"{name}\"; transcript_id "
                            f"\"{name}.{t + 1}\";\n")


@dataclass
class CellPool:
    r1: np.ndarray        # ASCII [n, barcode_len + umi_len]
    r2: Pool              # one mate: R2 and its truth
    cell: np.ndarray      # whitelist index of each pair's molecule
    gene: np.ndarray      # its gene where exonic, else -1
    kind: np.ndarray      # EXONIC, INTRONIC or INTERGENIC

    def __len__(self) -> int:
        return len(self.cell)


def _substitute(seq: np.ndarray, rows: np.ndarray, cols: np.ndarray, rng) -> None:
    """Change seq[rows, cols] to another base each (in place)."""
    code = np.searchsorted(ACGT, seq[rows, cols])
    seq[rows, cols] = ACGT[(code + rng.integers(1, 4, len(rows))) % 4]


def generate(genome: Genome, n: int, seed: int, *, ann: Annotation, wl: np.ndarray,
             barcode_len: int = 16, umi_len: int = 12, r2_len: int = 90,
             cells: int = 10_000, depth_sigma: float = 0.5, ambient_frac: float = 0.08,
             ambient_barcodes: int = 50_000, dup_mean: float = 1.5, exonic: float = 0.75,
             intronic: float = 0.2, three_prime: int = 600, zipf: float = 1.0,
             barcode_one_error: float = 0.02, barcode_more_errors: float = 0.01,
             umi_error: float = 0.01, sub_rate: float = 0.003,
             qual_char: str = "F") -> CellPool:
    rng = np.random.default_rng(seed)
    L = r2_len
    # molecules, and the read pairs of each
    m = int(n / (1 + dup_mean) * 1.2) + 16
    reads_of = 1 + rng.poisson(dup_mean, m)
    m = int(np.searchsorted(np.cumsum(reads_of), n)) + 1
    reads_of = reads_of[:m]
    reads_of[-1] -= int(reads_of.sum()) - n
    mol = np.repeat(np.arange(m), reads_of)
    # cells and ambient barcodes; depth log-normal
    pick = rng.choice(len(wl), cells + ambient_barcodes, replace=False)
    depth = rng.lognormal(0.0, depth_sigma, cells)
    amb = rng.random(m) < ambient_frac
    cell = np.where(amb, pick[cells + rng.integers(0, ambient_barcodes, m)],
                    pick[rng.choice(cells, m, p=depth / depth.sum())])
    umi = ACGT[rng.integers(0, 4, (m, umi_len))]
    # origins
    G = len(ann.genes)
    expr = 1.0 / (1.0 + ann.rank) ** zipf
    u = rng.random(m)
    kind = np.where(u < exonic, EXONIC, np.where(u < exonic + intronic, INTRONIC, INTERGENIC))
    contig = np.zeros(m, np.int64)
    rev = np.zeros(m, np.int8)
    gpos = np.zeros((m, L), np.int32)        # contig offsets of each R2 base
    gene = np.full(m, -1, np.int64)
    tx_c, tx_s, tx_gene, tx_ex = [], [], [], []
    for k, (_, c, ds, txs) in enumerate(ann.genes):
        for tx in txs:
            tx_c.append(c)
            tx_s.append(ds)
            tx_gene.append(k)
            tx_ex.append(tx)
    tx_gene = np.asarray(tx_gene)
    first_tx = np.searchsorted(tx_gene, np.arange(G))
    n_tx = np.bincount(tx_gene, minlength=G)
    ex = np.flatnonzero(kind == EXONIC)
    g = rng.choice(G, len(ex), p=expr / expr.sum())
    t = first_tx[g] + (rng.random(len(ex)) * n_tx[g]).astype(np.int64)
    window = {}
    for i, tt in zip(ex.tolist(), t.tolist()):
        w = window.get(tt)
        if w is None:
            # the transcript's last three_prime bases: its 3' end lies at
            # its highest offset on '+', its lowest on '-'
            pos = np.concatenate([np.arange(s, e, dtype=np.int32) for s, e in tx_ex[tt]])
            w = window[tt] = pos[:three_prime] if tx_s[tt] else pos[-three_prime:]
        o = int(rng.integers(0, len(w) - L + 1))
        gpos[i] = w[o: o + L]
        contig[i], rev[i] = tx_c[tt], tx_s[tt]
    gene[ex] = tx_gene[t]
    # introns of r2_len bases or more, drawn by their gene's expression
    intr = [(k, s, e) for k, ch in enumerate(ann.chains)
            for (_, s), (e, _) in zip(ch[:-1], ch[1:]) if e - s >= L]
    ik = np.asarray([x[0] for x in intr])
    iw = expr[ik] / np.bincount(ik, minlength=G)[ik]
    it = np.flatnonzero(kind == INTRONIC)
    j = rng.choice(len(intr), len(it), p=iw / iw.sum())
    for i, jj in zip(it.tolist(), j.tolist()):
        k, s, e = intr[jj]
        o = s + int(rng.integers(0, e - s - L + 1))
        gpos[i] = np.arange(o, o + L)
        contig[i], rev[i] = ann.genes[k][1], ann.genes[k][2]
    # intergenic stretches, 200 bases clear of every gene, by their length
    spans = {}
    for k, (_, c, _, _) in enumerate(ann.genes):
        spans.setdefault(c, []).append((ann.chains[k][0][0], ann.chains[k][-1][1]))
    free = []
    for c in range(len(genome.names)):
        edges = [(0, 1000)] + sorted(spans.get(c, [])) + [(int(genome.lengths[c]) - 1000,) * 2]
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b - a >= L + 400:
                free.append((c, a + 200, b - 200))
    fl = np.asarray([b - a - L for _, a, b in free], np.float64)
    ig = np.flatnonzero(kind == INTERGENIC)
    j = rng.choice(len(free), len(ig), p=fl / fl.sum())
    for i, jj in zip(ig.tolist(), j.tolist()):
        c, a, b = free[jj]
        o = a + int(rng.integers(0, b - a - L + 1))
        gpos[i] = np.arange(o, o + L)
        contig[i], rev[i] = c, int(rng.integers(0, 2))
    # the reads of each molecule, each with its own errors
    r2m = genome.bases[genome.offsets[contig][:, None] + gpos]
    r2m[rev == 1] = revcomp(r2m[rev == 1])
    r2 = r2m[mol]
    hit = np.nonzero(rng.random(r2.shape) < sub_rate)
    _substitute(r2, hit[0], hit[1], rng)
    r1 = np.concatenate([wl[cell], umi], axis=1)[mol]
    u = rng.random(n)
    nerr = np.where(u < barcode_one_error, 1,
                    np.where(u < barcode_one_error + barcode_more_errors,
                             rng.integers(2, 4, n), 0))
    cols = np.argsort(rng.random((n, barcode_len)), axis=1)[:, :3]
    use = np.arange(3)[None, :] < nerr[:, None]
    rows = np.repeat(np.arange(n)[:, None], 3, axis=1)
    _substitute(r1, rows[use], cols[use], rng)
    ue = np.flatnonzero(rng.random(n) < umi_error)
    _substitute(r1, ue, barcode_len + rng.integers(0, umi_len, len(ue)), rng)
    # the truth of R2
    start = gpos[:, 0].astype(np.int64)[mol]
    end = gpos[:, -1].astype(np.int64)[mol] + 1
    introns = (np.diff(gpos, axis=1) > 1).sum(axis=1).astype(np.int32)[mol]
    zeros = np.zeros(n, np.int32)
    names = [f"cc{i}" for i in range(n)]
    pool = Pool(names, [r2], (qual_char * L).encode(), [contig[mol]], [start], [end],
                [rev[mol]], [zeros], [introns], [np.full(n, -1, np.int32)],
                [zeros], [zeros])
    return CellPool(r1, pool, cell[mol], gene[mol], kind[mol])
