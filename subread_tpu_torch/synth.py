"""Synthetic genomes and reads, made from a seed, for the port's tests and
chip_smoke.py.

The genome carries what the aligner's repeat handling needs to be
exercised: several contigs, segmental duplications (forward and reverse
copies, so repeat reads tie), tandem arrays of 20-60 copies (their 16-mer
runs exceed the 16-wide probe window, so `HashIndex.max_run >= 16` and the
saturation-rescue tiers exist) and runs of N.  Reads come from
`subread_tpu.utils.simulate.simulate_reads` with errors and indels, single
or paired; a share of them get N bases, written as `N` in the FASTQ.
`synthetic_long_indel_reads` makes reads across planted 20-40 base
deletions and 20 base insertions.
"""

from __future__ import annotations

import numpy as np

from subread_tpu import dna
from subread_tpu.index.genome import Genome, build_genome
from subread_tpu.io.fasta import Contig
from subread_tpu.io.fastq import ReadBatch, batch_from_records
from subread_tpu.utils.simulate import simulate_reads


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
