"""Synthetic genomes and reads, made from a seed, for the port's tests and
chip_smoke.py.

The genome carries what the aligner's repeat handling needs to be
exercised: several contigs, segmental duplications (forward and reverse
copies, so repeat reads tie), tandem arrays of 20-60 copies (their 16-mer
runs exceed the 16-wide probe window, so `HashIndex.max_run >= 16` and the
saturation-rescue tiers exist) and runs of N.  Reads come from
`utils.simulate.simulate_reads` (a copy of the JAX package's) with errors and indels, single
or paired; a share of them get N bases, written as `N` in the FASTQ.
`synthetic_long_indel_reads` makes reads across planted 20-40 base
deletions and 20 base insertions; `synthetic_spliced_reads` and
`synthetic_spliced_pairs` make RNA-seq reads across introns at the
genome's own splice-site motifs, with chimeras, and return the planted
junctions and fusions.  `synthetic_long_reads` makes sublong's 2-20 kb
reads, some across a planted deletion; `synthetic_genes` and
`write_genes_gtf` an annotation of multi-exon, multi-transcript genes at
GENCODE's density; `synthetic_cell_reads` 10x-like barcode/UMI and cDNA
read pairs from those genes; `synthetic_snp_sample` a diploid sample's
reads over a region with planted homozygous and heterozygous SNPs, for
exactSNP.
"""

from __future__ import annotations

import numpy as np

from . import dna
from .index.genome import Genome, build_genome
from .io.fasta import Contig
from .io.fastq import ReadBatch, batch_from_records
from .ops.junction import MAX_INTRON
from .utils.simulate import simulate_reads


def synthetic_genome(
    n_bases: int,
    seed: int = 0,
    n_contigs: int = 3,
    segdup_frac: float = 0.02,
    segdup_len: int = 10_000,
    tandem_frac: float = 0.01,
    n_runs_per_contig: int = 3,
) -> Genome:
    """A random genome of about `n_bases` bases over `n_contigs` contigs.

    `segdup_frac` of the bases are copies (half reverse-complemented) of
    other `segdup_len`-base segments; `tandem_frac` of them are tandem
    arrays of a 5-50 base unit repeated 20-60 times; each contig gets
    `n_runs_per_contig` runs of 20-300 N (stored as 'A' with the ambiguity
    bit set, as a FASTA's N is)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
    seg = max(min(segdup_len, n_bases // 20), 100)
    for _ in range(int(n_bases * segdup_frac) // seg):
        src = int(rng.integers(0, n_bases - seg))
        dst = int(rng.integers(0, n_bases - seg))
        piece = codes[src : src + seg].copy()
        if rng.random() < 0.5:
            piece = dna.revcomp(piece)
        codes[dst : dst + seg] = piece
    placed = 0
    while placed < n_bases * tandem_frac:
        unit = rng.integers(0, 4, size=int(rng.integers(5, 51)), dtype=np.uint8)
        arr = np.tile(unit, int(rng.integers(20, 61)))
        if len(arr) >= n_bases // 4:
            continue
        dst = int(rng.integers(0, n_bases - len(arr)))
        codes[dst : dst + len(arr)] = arr
        placed += len(arr)
    ambig = np.zeros(n_bases, bool)
    cuts = np.linspace(0, n_bases, n_contigs + 1).astype(np.int64)
    contigs = []
    for c in range(n_contigs):
        lo, hi = int(cuts[c]), int(cuts[c + 1])
        for _ in range(n_runs_per_contig):
            ln = int(rng.integers(20, 301))
            s = int(rng.integers(lo, max(hi - ln, lo + 1)))
            codes[s : s + ln] = 0
            ambig[s : s + ln] = True
        contigs.append(
            Contig(name=f"chr{c + 1}", codes=codes[lo:hi].copy(),
                   ambig=ambig[lo:hi].copy())
        )
    return build_genome(contigs)


def synthetic_reads(
    genome: Genome,
    n_reads: int,
    seed: int = 1,
    read_len: int = 100,
    error_rate: float = 0.01,
    indel_rate: float = 0.05,
    n_read_frac: float = 0.02,
) -> ReadBatch:
    """`simulate_reads` output, with 1-3 bases of `n_read_frac` of the reads
    turned into N.  The batch is exactly what FastqReader parses from the
    file `write_fastq` makes of it."""
    rng = np.random.default_rng(seed)
    batch, _ = simulate_reads(
        genome, n_reads, read_len=read_len, rng=rng, error_rate=error_rate,
        indel_rate=indel_rate, max_indel=5,
    )
    return _with_n(batch, rng, n_read_frac, read_len)


def synthetic_pairs(
    genome: Genome,
    n_pairs: int,
    seed: int = 1,
    read_len: int = 100,
    error_rate: float = 0.01,
    indel_rate: float = 0.05,
    n_read_frac: float = 0.02,
) -> tuple[ReadBatch, ReadBatch]:
    """Paired `simulate_reads` output (fragments of 150-500 bases, mate 2
    the reverse strand at the fragment's far end, an indel 20-80 bases
    into the fragment), with N bases as in `synthetic_reads` in either
    mate.  Both batches are exactly what FastqReader parses from the
    files `write_fastq` makes of them with no suffix."""
    rng = np.random.default_rng(seed)
    b1, b2 = simulate_reads(
        genome, n_pairs, read_len=read_len, rng=rng, error_rate=error_rate,
        indel_rate=indel_rate, max_indel=5, paired=True,
        fragment_range=(150, 500),
    )
    return (_with_n(b1, rng, n_read_frac, read_len),
            _with_n(b2, rng, n_read_frac, read_len))


def synthetic_long_indel_reads(
    genome: Genome,
    n_sites: int = 6,
    n_sim: int = 300,
    seed: int = 77,
    read_len: int = 100,
) -> ReadBatch:
    """Reads for the long-indel rescue (-I > 16): at each of `n_sites`
    random places, reads across a deletion of 20, 30 and 40 bases (the
    breakpoint at read offsets 25-75) and across a random 20-base
    insertion (offsets 25-65); then `n_sim` simulated reads, a third of
    them with an indel of 1-30 bases.  Exact bases, no N."""
    rng = np.random.default_rng(seed)
    g, L = genome.codes, read_len
    names, seqs = [], []
    for _ in range(n_sites):
        c = int(rng.integers(0, len(genome.names)))
        at = int(rng.integers(1000, int(genome.lengths[c]) - 2000))
        for D in (20, 30, 40):
            for x in range(25, L - 24, 10):
                lin = genome.chro_to_linear(c, at - x)
                r = np.concatenate([g[lin: lin + x], g[lin + x + D: lin + D + L]])
                names.append(f"del{D}_{genome.names[c]}_{at}_{x}")
                seqs.append(dna.decode(r).encode())
        for x in range(25, L - 34, 10):
            lin = genome.chro_to_linear(c, at + 500 - x)
            ins = rng.integers(0, 4, 20).astype(np.uint8)
            r = np.concatenate([g[lin: lin + x], ins, g[lin + x: lin + L - 20]])
            names.append(f"ins20_{genome.names[c]}_{at + 500}_{x}")
            seqs.append(dna.decode(r).encode())
    sim, _ = simulate_reads(genome, n_sim, read_len=L, rng=rng,
                            error_rate=0.01, indel_rate=0.33, max_indel=30)
    names += list(sim.names)
    seqs += [dna.decode(c).encode() for c in sim.codes]
    return batch_from_records(names, seqs, [b"I" * L] * len(names), pad_to=L)


# splice-site motifs per donor strand (the .junction.bed strand column):
# 0 = GT..AG, 1 = CT..AC; base codes A=0, G=1, C=2, T=3
_MOTIFS = {0: ((1, 3), (0, 1)), 1: ((2, 3), (0, 2))}


def _has_n(genome: Genome, lo: int, hi: int) -> bool:
    """Whether linear [lo, hi) holds an N: Genome.get_ambig's answer,
    unpacking only the bitmap bytes that cover the range."""
    bits = np.unpackbits(genome.ambig[lo // 8: (hi + 7) // 8], bitorder="little")
    return bool(bits[lo % 8: lo % 8 + hi - lo].any())


def _motif_sites(cc: np.ndarray, pair) -> np.ndarray:
    """Sorted offsets i with cc[i], cc[i+1] == pair."""
    return np.flatnonzero((cc[:-1] == pair[0]) & (cc[1:] == pair[1]))


def _transcripts(genome: Genome, n: int, rng, max_intron: int = 20_000,
                 min_len: int = 300):
    """n transcripts of 2-4 exons of 40-300 bases (half of the middle
    exons 40-70, so reads cross two introns), each intron 60 to
    `max_intron` bases and placed only where the genome already carries
    the motif: GT after the left exon and AG before the right one, or CT
    and AC.  Returns [(contig, donor_strand, [(start0, end0), ...])]."""
    sites = {}
    lens = np.asarray(genome.lengths, np.int64)
    out = []
    while len(out) < n:
        c = int(rng.choice(len(lens), p=lens / lens.sum()))
        ds = int(rng.integers(0, 2))
        if (c, ds) not in sites:
            lo = genome.chro_to_linear(c, 0)
            cc = genome.codes[lo: lo + int(lens[c])]
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
            # left edge le: the last exon base, the donor motif at le+1
            i = int(np.searchsorted(donors, pos + elen))
            if i >= len(donors):
                ok = False
                break
            le = int(donors[i]) - 1
            # right edge re: the first base of the next exon, the acceptor
            # motif at re-2
            j = int(np.searchsorted(acceptors, le + 1 + int(rng.integers(60, max_intron + 1)) - 2))
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
        lin = [genome.chro_to_linear(c, a) for a, _ in exons]
        if any(_has_n(genome, s, s + b - a) for s, (a, b) in zip(lin, exons)):
            continue
        out.append((c, ds, exons))
    return out


def _spliced_read(genome: Genome, tx, t: int, L: int):
    """Bases of transcript `tx` at transcript offsets [t, t+L), their
    0-based contig start, CIGAR, and the junction keys crossed with both
    flank lengths: [(key, left_bases, right_bases)]."""
    c, ds, exons = tx
    lo = genome.chro_to_linear(c, 0)
    segs, cig, keys = [], [], []
    off = 0
    for a, b in exons:
        s, e = max(t, off), min(t + L, off + b - a)
        if s < e:
            g0 = a + (s - off)
            if segs:
                pa, pl = segs[-1]
                cig.append(f"{g0 - (pa + pl)}N")
                keys.append(((genome.names[c], pa + pl - 1, g0, ds),
                             sum(x[1] for x in segs), t + L - s))
            segs.append((g0, e - s))
            cig.append(f"{e - s}M")
        off += b - a
    seq = np.concatenate([genome.codes[lo + g: lo + g + n] for g, n in segs])
    return seq, segs[0][0], "".join(cig), keys


def _mutate(seq: np.ndarray, rng, error_rate: float) -> np.ndarray:
    seq = seq.copy()
    sub = np.flatnonzero(rng.random(len(seq)) < error_rate)
    seq[sub] = (seq[sub] + rng.integers(1, 4, len(sub))) % 4
    return seq


def _to_fastq_seq(seq: np.ndarray, rng, n_read_frac: float) -> bytes:
    s = bytearray(dna.decode(seq).encode())
    if rng.random() < n_read_frac:
        for j in rng.integers(0, len(s), size=int(rng.integers(1, 4))):
            s[int(j)] = ord("N")
    return bytes(s)


def _chimera(genome: Genome, rng, half: int):
    """Two `half`-base pieces joined: on two contigs, more than MAX_INTRON
    apart on one contig (where a contig is that long), or with the second
    piece inverted a few kb downstream.  Returns the bases, a kind name and
    the planted breakends ((contig, pos1), (contig, pos1)), 1-based."""
    lens = np.asarray(genome.lengths, np.int64)
    while True:
        kind = str(rng.choice(["contig", "far", "inv"]))
        ca = int(rng.integers(0, len(lens)))
        a = int(rng.integers(1000, int(lens[ca]) - 1000 - half))
        if kind == "contig" and len(lens) > 1:
            cb = int((ca + rng.integers(1, len(lens))) % len(lens))
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
        la, lb = genome.chro_to_linear(ca, a), genome.chro_to_linear(cb, b)
        if _has_n(genome, la, la + half) or _has_n(genome, lb, lb + half):
            continue
        pa = genome.codes[la: la + half]
        pb = genome.codes[lb: lb + half]
        if kind == "inv":
            pb = dna.revcomp(pb)
            ends = ((ca, a + half), (cb, b + half))      # b + half - 1, 1-based
        else:
            ends = ((ca, a + half), (cb, b + 1))
        named = tuple((genome.names[x], p) for x, p in ends)
        return np.concatenate([pa, pb]), kind, named


def synthetic_spliced_reads(
    genome: Genome,
    n_reads: int,
    seed: int = 1,
    read_len: int = 100,
    n_transcripts: int | None = None,
    error_rate: float = 0.01,
    n_read_frac: float = 0.02,
    short_flank_frac: float = 0.1,
    chain_frac: float = 0.1,
    chimera_frac: float = 0.02,
):
    """RNA-seq reads from transcripts of 2-4 exons whose introns sit at the
    genome's own GT..AG or CT..AC sites (nothing is planted: the genome and
    its index stay as they are).  Reads come from both strands with 1%
    substitutions and N bases in `n_read_frac` of them; `short_flank_frac`
    of them end 8-16 bases past a junction (too short to vote: the
    event-table rescue places them), `chain_frac` cross a short middle exon
    and two introns, and `chimera_frac` are chimeras of two 50-base halves
    (fusions).

    Each name records the truth: `sj{i}_{contig}_{pos1}_{strand}_{cigar}`
    (the 1-based leftmost base and the CIGAR in genome orientation) or
    `chim{i}_{kind}_{contig}_{pos1}_{contig}_{pos1}` (the two breakends).
    Returns (batch, truth): truth["junctions"] maps each crossed junction
    key (contig, left_edge0, right_edge0, donor_strand) to [reads, reads
    with both flanks >= 17]; truth["fusions"] lists the planted breakend
    pairs."""
    rng = np.random.default_rng(seed)
    L = read_len
    txs = _transcripts(genome, n_transcripts or max(n_reads // 50, 4), rng)
    names, seqs, junctions, fusions = [], [], {}, []
    for i in range(n_reads):
        if rng.random() < chimera_frac:
            seq, kind, ends = _chimera(genome, rng, L // 2)
            if rng.random() < 0.5:
                seq = dna.revcomp(seq)
            fusions.append(ends)
            (ca, pa), (cb, pb) = ends
            names.append(f"chim{i}_{kind}_{ca}_{pa}_{cb}_{pb}")
            seqs.append(_to_fastq_seq(_mutate(seq, rng, error_rate), rng,
                                      n_read_frac))
            continue
        tx = txs[int(rng.integers(0, len(txs)))]
        ex_len = [b - a for a, b in tx[2]]
        bnds = np.cumsum(ex_len)[:-1]                  # transcript offsets
        T = int(sum(ex_len))
        u = rng.random()
        t = int(rng.integers(0, T - L + 1))
        if u < short_flank_frac:
            f = int(rng.integers(8, 17))
            bnd = int(bnds[int(rng.integers(0, len(bnds)))])
            t = bnd - f if rng.random() < 0.5 else bnd + f - L
        elif u < short_flank_frac + chain_frac and len(ex_len) > 2:
            k = int(rng.integers(1, len(ex_len) - 1))
            if ex_len[k] <= L - 20:
                t = int(bnds[k - 1]) - int(rng.integers(10, L - ex_len[k] - 9))
        t = min(max(t, 0), T - L)
        seq, start0, cig, keys = _spliced_read(genome, tx, t, L)
        for key, left, right in keys:
            n = junctions.setdefault(key, [0, 0])
            n[0] += 1
            n[1] += int(min(left, right) >= 17)
        strand = int(rng.random() < 0.5)
        if strand:
            seq = dna.revcomp(seq)
        names.append(f"sj{i}_{genome.names[tx[0]]}_{start0 + 1}_{strand}_{cig}")
        seqs.append(_to_fastq_seq(_mutate(seq, rng, error_rate), rng, n_read_frac))
    batch = batch_from_records(names, seqs, [b"I" * L] * len(names), pad_to=L)
    return batch, dict(junctions=junctions, fusions=fusions)


def synthetic_spliced_pairs(
    genome: Genome,
    n_pairs: int,
    seed: int = 1,
    read_len: int = 100,
    n_transcripts: int | None = None,
    error_rate: float = 0.01,
    n_read_frac: float = 0.02,
    chimera_frac: float = 0.02,
):
    """Paired RNA-seq reads from the transcripts of
    `synthetic_spliced_reads`: fragments of 150-400 bases of a transcript
    (at most its length), mate 1 from one end and mate 2 the reverse
    complement of the other, on either strand.  `chimera_frac` of the pairs
    have a chimeric mate 1 (two 50-base halves, as there) whose mate 2
    lies 200-400 bases beyond its first half.  Names:
    `sjp{i}_{contig}_{pos1}_{cigar}_{pos1}_{cigar}` (mate 1, mate 2) or
    `chimp{i}_...` as for single reads.  Returns (mate 1 batch, mate 2
    batch, truth) with truth as there."""
    rng = np.random.default_rng(seed)
    L = read_len
    txs = _transcripts(genome, n_transcripts or max(n_pairs // 25, 4), rng)
    names, s1, s2, junctions, fusions = [], [], [], {}, []
    for i in range(n_pairs):
        if rng.random() < chimera_frac:
            seq, kind, ends = _chimera(genome, rng, L // 2)
            (ca, pa), (cb, pb) = ends
            c = genome.names.index(ca)
            lin = genome.chro_to_linear(c, pa - L // 2 + int(rng.integers(200, 401)))
            m2 = dna.revcomp(genome.codes[lin: lin + L])
            fusions.append(ends)
            names.append(f"chimp{i}_{kind}_{ca}_{pa}_{cb}_{pb}")
            s1.append(_to_fastq_seq(_mutate(seq, rng, error_rate), rng, n_read_frac))
            s2.append(_to_fastq_seq(_mutate(m2, rng, error_rate), rng, n_read_frac))
            continue
        tx = txs[int(rng.integers(0, len(txs)))]
        T = int(sum(b - a for a, b in tx[2]))
        F = min(int(rng.integers(150, 401)), T)
        t = int(rng.integers(0, T - F + 1))
        mates = []
        for tt in (t, t + F - L):
            seq, start0, cig, keys = _spliced_read(genome, tx, tt, L)
            for key, left, right in keys:
                n = junctions.setdefault(key, [0, 0])
                n[0] += 1
                n[1] += int(min(left, right) >= 17)
            mates.append((seq, start0, cig))
        (a, pa, ca_), (b, pb, cb_) = mates
        if rng.random() < 0.5:        # fragment from the forward strand
            r1, r2, first = a, dna.revcomp(b), (pa, ca_, pb, cb_)
        else:
            r1, r2, first = b, dna.revcomp(a), (pb, cb_, pa, ca_)
            r1, r2 = dna.revcomp(r1), dna.revcomp(r2)
        names.append(f"sjp{i}_{genome.names[tx[0]]}_{first[0] + 1}_{first[1]}"
                     f"_{first[2] + 1}_{first[3]}")
        s1.append(_to_fastq_seq(_mutate(r1, rng, error_rate), rng, n_read_frac))
        s2.append(_to_fastq_seq(_mutate(r2, rng, error_rate), rng, n_read_frac))
    quals = [b"I" * L] * len(names)
    return (batch_from_records(names, s1, quals, pad_to=L),
            batch_from_records(names, s2, quals, pad_to=L),
            dict(junctions=junctions, fusions=fusions))


def _with_n(batch: ReadBatch, rng, n_read_frac: float, read_len: int) -> ReadBatch:
    """The batch with 1-3 bases of `n_read_frac` of its reads turned to N."""
    seqs = []
    for i in range(len(batch)):
        s = bytearray(dna.decode(batch.codes[i, : batch.lengths[i]]).encode())
        if rng.random() < n_read_frac:
            for j in rng.integers(0, len(s), size=int(rng.integers(1, 4))):
                s[int(j)] = ord("N")
        seqs.append(bytes(s))
    quals = [bytes(batch.quals[i, : batch.lengths[i]]) for i in range(len(batch))]
    return batch_from_records(batch.names, seqs, quals, pad_to=read_len)


def write_fastq(path: str, batch: ReadBatch, suffix: str = "") -> None:
    """FASTQ of a batch, with N where the ambiguity mask is set and
    `suffix` (e.g. "/1", "/2") after every read name."""
    with open(path, "w") as f:
        for i, name in enumerate(batch.names):
            L = int(batch.lengths[i])
            seq = dna.CODE2BASE[batch.codes[i, :L] & 3].copy()
            seq[batch.ambig[i, :L]] = ord("N")
            q = batch.quals[i, :L].tobytes().decode()
            f.write(f"@{name}{suffix}\n{seq.tobytes().decode()}\n+\n{q}\n")


def write_genome_fasta(path: str, genome: Genome, width: int = 60) -> None:
    """FASTA of a genome's contigs, N where the ambiguity bit is set, in
    lines of `width` bases."""
    amb = genome.get_ambig(0, int(genome.total))
    with open(path, "wb") as f:
        for c, name in enumerate(genome.names):
            lo = int(genome.starts[c])
            hi = lo + int(genome.lengths[c])
            seq = dna.CODE2BASE[genome.codes[lo:hi] & 3].copy()
            seq[amb[lo:hi]] = ord("N")
            f.write(f">{name}\n".encode())
            n = len(seq) // width * width
            lines = np.concatenate(
                [seq[:n].reshape(-1, width),
                 np.full((n // width, 1), ord("\n"), np.uint8)], axis=1)
            f.write(lines.tobytes())
            if n < len(seq):
                f.write(seq[n:].tobytes() + b"\n")


def _long_read_errors(seq: np.ndarray, rng, error_rate: float) -> np.ndarray:
    """`seq` with `error_rate` of its bases hit: 60% substitutions, 20%
    one-base deletions, 20% one-base insertions after the base."""
    u = rng.random(len(seq))
    sub = u < 0.6 * error_rate
    dele = (u >= 0.6 * error_rate) & (u < 0.8 * error_rate)
    ins = (u >= 0.8 * error_rate) & (u < error_rate)
    seq = seq.copy()
    seq[sub] = (seq[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    # each base is written 0 (deleted), 1 or 2 times; the second copy of
    # an inserting base is replaced by a random one
    reps = 1 - dele.astype(np.int64) + ins
    out = np.repeat(seq, reps)
    ends = np.cumsum(reps)
    at = ends[ins] - 1
    out[at] = rng.integers(0, 4, len(at))
    return out


def synthetic_long_reads(
    genome: Genome,
    n_reads: int,
    seed: int = 1,
    min_len: int = 2000,
    max_len: int = 20_000,
    error_rate: float = 0.02,
    del_frac: float = 0.2,
    del_len: int = 300,
) -> ReadBatch:
    """Long reads of `min_len`-`max_len` genome bases (uniform), from both
    strands, with `error_rate` substitutions and one-base indels
    (`_long_read_errors`); `del_frac` of them skip `del_len` genome bases
    a quarter to three quarters of the way along.  Names record the truth:
    `lr<i>_<contig>_<pos1>_<strand>_<del>`, pos1 the 1-based contig position
    of the first genome base covered, strand 1 for a reverse-complemented
    read, del the 1-based position of the first deleted base or 0.  No
    read covers an N.  Qualities are all 'I'."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(genome.lengths, np.int64)
    names, seqs = [], []
    while len(seqs) < n_reads:
        L = int(rng.integers(min_len, max_len + 1))
        c = int(rng.choice(len(lens), p=lens / lens.sum()))
        gap = del_len if rng.random() < del_frac else 0
        span = L + gap
        if lens[c] < span + 2000:
            continue
        pos = int(rng.integers(1000, int(lens[c]) - span - 1000))
        lin = genome.chro_to_linear(c, pos)
        if _has_n(genome, lin, lin + span):
            continue
        seg = genome.codes[lin: lin + span]
        at = 0
        if gap:
            at = int(rng.integers(L // 4, 3 * L // 4))
            seg = np.concatenate([seg[:at], seg[at + gap:]])
        seg = _long_read_errors(seg, rng, error_rate)
        strand = int(rng.integers(0, 2))
        if strand:
            seg = dna.revcomp(seg)
        names.append(f"lr{len(seqs)}_{genome.names[c]}_{pos + 1}_{strand}_"
                     f"{pos + at + 1 if gap else 0}")
        seqs.append(dna.decode(seg).encode())
    return batch_from_records(names, seqs, [b"I" * len(s) for s in seqs])


def synthetic_genes(
    genome: Genome,
    n_genes: int,
    seed: int = 1,
    exons: tuple[int, int] = (8, 16),
    transcripts: tuple[int, int] = (2, 4),
    antisense_frac: float = 0.1,
):
    """`n_genes` genes with the shape of a GENCODE annotation: each a chain
    of `exons` (low, high) exons of 80-400 bases across introns of 100-5000
    bases placed where the genome carries the splice motifs of the gene's
    strand (GT..AG on '+', CT..AC on '-'), and `transcripts` (low, high)
    transcripts, each the first and last exon plus about 70% of the
    others, so a gene has about 25 exon rows; genes start at random, and
    `antisense_frac` of them inside an earlier gene, on the other strand.
    Returns [(gene_id, contig, strand '+'/'-', [[(start0, end0), ...] per
    transcript])]."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(genome.lengths, np.int64)
    sites = {}
    genes = []
    while len(genes) < n_genes:
        if genes and rng.random() < antisense_frac:
            _, c0, s0, tx0 = genes[int(rng.integers(0, len(genes)))]
            c, ds = genome.names.index(c0), int(s0 == "+")
            pos = int(rng.integers(tx0[0][0][0], tx0[0][-1][1]))
        else:
            c = int(rng.choice(len(lens), p=lens / lens.sum()))
            ds = int(rng.integers(0, 2))
            pos = int(rng.integers(1000, int(lens[c]) - 1000))
        if (c, ds) not in sites:
            lo = genome.chro_to_linear(c, 0)
            cc = genome.codes[lo: lo + int(lens[c])]
            sites[(c, ds)] = tuple(_motif_sites(cc, m) for m in _MOTIFS[ds])
        donors, acceptors = sites[(c, ds)]
        chain = []
        for e in range(int(rng.integers(exons[0], exons[1] + 1))):
            elen = int(rng.integers(80, 401))
            i = int(np.searchsorted(donors, pos + elen))
            j = (int(np.searchsorted(acceptors, int(donors[i]) + int(rng.integers(100, 5001))))
                 if i < len(donors) else len(acceptors))
            if j >= len(acceptors) or donors[i] - pos > 400:
                chain.append((pos, pos + elen))
                break
            chain.append((pos, int(donors[i])))
            pos = int(acceptors[j]) + 2
        lin = genome.chro_to_linear(c, chain[0][0])
        if (len(chain) < 2 or chain[-1][1] > int(lens[c]) - 1000
                or _has_n(genome, lin, lin + chain[-1][1] - chain[0][0])):
            continue
        txs = []
        for _ in range(int(rng.integers(transcripts[0], transcripts[1] + 1))):
            keep = rng.random(len(chain)) < 0.7
            keep[0] = keep[-1] = True
            txs.append([ex for ex, k in zip(chain, keep) if k])
        genes.append((f"G{len(genes):05d}", genome.names[c], "+-"[ds], txs))
    return genes


def write_genes_gtf(path: str, genes) -> int:
    """A GTF of `synthetic_genes`' genes: one exon row per exon of each
    transcript, 1-based inclusive; returns the number of rows."""
    n = 0
    with open(path, "w") as f:
        for gid, contig, strand, txs in genes:
            for t, tx in enumerate(txs):
                for a, b in tx:
                    f.write(f'{contig}\tsynth\texon\t{a + 1}\t{b}\t.\t{strand}\t.\t'
                            f'gene_id "{gid}"; transcript_id "{gid}.{t}";\n')
                    n += 1
    return n


def synthetic_cell_reads(
    genome: Genome,
    genes,
    n_pairs: int,
    seed: int = 1,
    n_cells: int = 1000,
    n_whitelist: int = 5000,
    bc_len: int = 16,
    umi_len: int = 12,
    read_len: int = 100,
    error_rate: float = 0.01,
    ambient_frac: float = 0.05,
):
    """Single-cell read pairs (10x-like): R1 = a `bc_len`-base cell barcode
    and a `umi_len`-base UMI; R2 = `read_len` bases of a transcript of one
    of `genes` (`synthetic_genes`), spliced where it crosses exon edges,
    on either strand.  `n_cells` barcodes of an `n_whitelist` whitelist
    are cells (read counts lognormal); `ambient_frac` of the pairs carry
    one of the other whitelist barcodes.  Each molecule (cell, gene, UMI)
    is read 1-3 times; `error_rate` substitutions in both reads.  Names
    record the truth: `sc<i>_<cell>_<gene>`, cell the whitelist index.
    Returns (whitelist, R1 batch, R2 batch, indices of the cells)."""
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, 4, size=(n_whitelist, bc_len)).astype(np.uint8)
    whitelist = [dna.decode(b) for b in wl]
    cells = rng.choice(n_whitelist, size=n_cells, replace=False)
    ambient = np.setdiff1d(np.arange(n_whitelist), cells)
    weight = rng.lognormal(0.0, 0.5, n_cells)
    gw = rng.lognormal(0.0, 1.0, len(genes))
    tx_seqs = []
    for _, contig, strand, txs in genes:
        c = genome.names.index(contig)
        lo = genome.chro_to_linear(c, 0)
        tx_seqs.append([np.concatenate([genome.codes[lo + a: lo + b] for a, b in tx])
                        for tx in txs])
    names, r1s, r2s = [], [], []
    while len(names) < n_pairs:
        cell = int(ambient[rng.integers(0, len(ambient))] if rng.random() < ambient_frac
                   else cells[rng.choice(n_cells, p=weight / weight.sum())])
        g = int(rng.choice(len(genes), p=gw / gw.sum()))
        tx = tx_seqs[g][int(rng.integers(0, len(tx_seqs[g])))]
        if len(tx) < read_len:
            continue
        t = int(rng.integers(0, len(tx) - read_len + 1))
        umi = rng.integers(0, 4, umi_len).astype(np.uint8)
        strand = int(rng.integers(0, 2))
        for _ in range(min(int(rng.integers(1, 4)), n_pairs - len(names))):
            r2 = tx[t: t + read_len]
            r2 = _mutate(dna.revcomp(r2) if strand else r2, rng, error_rate)
            r1 = _mutate(np.concatenate([wl[cell], umi]), rng, error_rate)
            names.append(f"sc{len(names)}_{cell}_{genes[g][0]}")
            r1s.append(dna.decode(r1).encode())
            r2s.append(dna.decode(r2).encode())
    q1 = [b"I" * (bc_len + umi_len)] * n_pairs
    q2 = [b"I" * read_len] * n_pairs
    return (whitelist, batch_from_records(names, r1s, q1),
            batch_from_records(names, r2s, q2), np.sort(cells))


def synthetic_snp_sample(
    genome: Genome,
    seed: int = 1,
    region_len: int = 2_000_000,
    region_start: int = 10_000,
    snps_per_kb: float = 1.0,
    het_frac: float = 0.5,
    coverage: float = 30.0,
    read_len: int = 100,
    error_rate: float = 0.01,
    min_gap: int = 20,
) -> tuple[ReadBatch, list[tuple[str, int, str, str, bool]]]:
    """A diploid sample for exactSNP: `snps_per_kb` SNPs per kb (at least
    `min_gap` bases apart, never at an N) planted in the first contig's
    [region_start, region_start + region_len) (cut to the contig), `het_frac`
    of them heterozygous, the rest homozygous; `coverage`-fold
    `read_len`-base reads from uniform starts in the region, each from one
    of the two haplotypes (the heterozygous alleles are on the second),
    half reverse-complemented, with `error_rate` substitutions.  Names
    record the truth, `snp<i>_<contig>_<pos1>_<strand>_<haplotype>`; bases
    over a genome N are N; qualities are all 'I'.  Returns the reads and
    the planted SNPs as (contig, 1-based position, ref, alt, heterozygous),
    sorted by position."""
    rng = np.random.default_rng(seed)
    c0 = int(genome.starts[0])
    lo = min(region_start, max(int(genome.lengths[0]) - read_len - 1, 0))
    hi = min(lo + region_len, int(genome.lengths[0]))
    region = genome.codes[c0 + lo: c0 + hi]
    amb = genome.get_ambig(c0 + lo, c0 + hi)
    n_snps = int((hi - lo) * snps_per_kb / 1000)
    cand = np.flatnonzero(~amb)
    picked = np.sort(rng.choice(cand, size=min(2 * n_snps, len(cand)), replace=False))
    keep, last = [], -min_gap
    for p in picked:
        if p - last >= min_gap:
            keep.append(int(p))
            last = p
    at = np.sort(rng.permutation(np.asarray(keep, np.int64))[:n_snps])
    ref = region[at]
    alt = ((ref.astype(np.int64) + rng.integers(1, 4, len(at))) % 4).astype(np.uint8)
    het = rng.random(len(at)) < het_frac
    hap0 = region.copy()
    hap0[at[~het]] = alt[~het]
    hap1 = region.copy()
    hap1[at] = alt
    n_reads = int(coverage * (hi - lo) / read_len)
    starts = rng.integers(0, hi - lo - read_len + 1, n_reads)
    hap = rng.integers(0, 2, n_reads)
    cols = starts[:, None] + np.arange(read_len)
    codes = np.where(hap[:, None] == 1, hap1[cols], hap0[cols])
    ambig = amb[cols]
    err = rng.random(codes.shape) < error_rate
    codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()))) % 4
    strand = rng.integers(0, 2, n_reads)
    rev = strand == 1
    codes[rev] = 3 - codes[rev, ::-1]
    ambig[rev] = ambig[rev, ::-1]
    codes[ambig] = 0
    name = genome.names[0]
    names = [f"snp{i}_{name}_{lo + int(s) + 1}_{int(t)}_{int(h)}"
             for i, (s, t, h) in enumerate(zip(starts, strand, hap))]
    batch = ReadBatch(
        names=names, codes=codes.astype(np.uint8),
        lengths=np.full(n_reads, read_len, np.int32),
        quals=np.full((n_reads, read_len), ord("I"), np.uint8), ambig=ambig,
    )
    bases = dna.CODE2BASE
    snps = [(name, lo + int(p) + 1, chr(bases[r]), chr(bases[a]), bool(h))
            for p, r, a, h in zip(at, ref, alt, het)]
    return batch, snps


def snp_call_metrics(vcf_path: str, snps) -> dict:
    """Recall of `synthetic_snp_sample`'s homozygous and heterozygous SNPs
    among a VCF's SNV records (the planted position with the planted
    alternative base among ALT) and the precision of those records."""
    called = {}
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            c, pos, _, ref, alt = line.split("\t", 5)[:5]
            if len(ref) == 1 and all(len(a) == 1 for a in alt.split(",")):
                called[(c, int(pos))] = set(alt.split(","))
    hit = [(c, p) in called and a in called[(c, p)] for c, p, _, a, _ in snps]
    het = np.asarray([h for *_, h in snps], bool)
    hit = np.asarray(hit, bool)
    return dict(
        called=len(called),
        hom_recall=float(hit[~het].mean()) if (~het).any() else 0.0,
        het_recall=float(hit[het].mean()) if het.any() else 0.0,
        precision=float(hit.sum() / len(called)) if called else 0.0,
    )

