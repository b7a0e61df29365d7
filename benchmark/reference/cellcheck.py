"""The check of a cellCounts window: its BAM's records and its matrix files
against what the benchmark made (the reads and their truth, the genome,
the annotation and the whitelist), worked out again by the plain reference
(`frozen/cellcounts.py`, a byte-equal copy of the port's
`reference/cellcounts.py`, numpy only).

Conventions beyond those of `check.py`: cellCounts writes one record a read
pair, named by R2 and holding R2, `<length>M` where mapped; CB is R1's
barcode bases and "-1", UB its UMI bases, GX the one gene whose exons the
record overlaps (10x's tags; the port writes them on every record).
"""

from __future__ import annotations

import numpy as np

from ..frozen import cellcounts as ref
from ..frozen.synth import Genome, revcomp
from .bam import OPS, Records
from .check import _contig_index, truth_mismatches


def z_tags(rec: Records, i: int) -> dict[str, str]:
    """Record i's string (Z) tags."""
    raw = rec.raw
    o = (int(rec.off[i]) + 36 + int(rec.l_name[i]) + 4 * int(rec.n_cigar[i])
         + (int(rec.l_seq[i]) + 1) // 2 + int(rec.l_seq[i]))
    end = int(rec.off[i]) + 4 + int.from_bytes(raw[int(rec.off[i]): int(rec.off[i]) + 4],
                                                "little", signed=True)
    sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4, b"A": 1}
    out = {}
    while o + 3 <= end:
        t, typ = raw[o: o + 2], raw[o + 2: o + 3]
        o += 3
        if typ in (b"Z", b"H"):
            z = raw.index(b"\0", o)
            if typ == b"Z":
                out[t.decode()] = raw[o: z].decode()
            o = z + 1
        elif typ in sizes:
            o += sizes[typ]
        elif typ == b"B":
            cnt = int.from_bytes(raw[o + 1: o + 5], "little")
            o += 5 + cnt * sizes[raw[o: o + 1]]
        else:
            break
    return out


def record_fields(rec: Records, ids: np.ndarray, genome: Genome):
    """(contig, POS, FLAG, read length) of each read's record, contig -1
    where unmapped or missing."""
    cmap = np.append(_contig_index(rec, genome), -1)
    i = np.where(ids >= 0, ids, 0)
    have = ids >= 0
    rid = np.where(rec.ref_id[i] >= 0, rec.ref_id[i], -1)
    contig = np.where(have & ((rec.flag[i] & 4) == 0), cmap[rid], -1)
    return contig, rec.pos[i], np.where(have, rec.flag[i], 4), rec.l_seq[i]


def cell_checks(rec: Records, ids: np.ndarray, pool, genome: Genome, sample: np.ndarray,
                out_dir: str, wl: np.ndarray, exons: np.ndarray, gene_names: list[str],
                umi_len: int, cell_calling: bool) -> dict:
    """For the window's reads (ids: each read's record, -1 where missing;
    pool: the benchmark's CellPool, read k being its read k mod len(pool)):
    over the sampled reads, bad_records (SEQ, the CIGAR `<length>M` inside
    its contig), nm_errors (an NM tag other than the record's mismatches),
    tag_errors (CB, UB, GX other than the reference's), missed (of the
    exonic reads whose origin is one ungapped stretch with at most one
    mismatch: unmapped, or off the origin's span or strand); over every
    read, matrix_errors: lines of matrix.mtx, barcodes.tsv and features.tsv
    that the reference's lack or that lack the reference's."""
    r2 = pool.r2
    N = len(pool)
    ids = ids[:, 0]
    k_of = np.arange(len(ids)) % N
    contig, pos, flag, length = record_fields(rec, ids, genome)
    genes = ref.record_genes([int(x) for x in genome.lengths], exons, contig, pos, flag, length)
    out = dict(bad_records=0, nm_errors=0, tag_errors=0, easy=0, missed=0)
    examples = out["examples"] = []

    def show(what, i, *extra):
        if sum(e[0] == what for e in examples) < 3:
            examples.append((what, rec.name(i).decode(), int(rec.flag[i]), int(rec.pos[i]) + 1,
                             "".join(f"{n}{OPS[op]}" for n, op in rec.cigar(i)), *extra))

    for k in sample.tolist():
        i, r = int(ids[k]), int(k_of[k])
        if i < 0:
            continue
        f = int(rec.flag[i])
        want = revcomp(r2.seqs[0][r]) if f & 0x10 else r2.seqs[0][r]
        seq = rec.seq(i)
        mapped = not f & 4
        if len(seq) != len(want) or not (seq == want).all():
            out["bad_records"] += 1
            show("bad_records", i, "seq")
            continue
        c = int(contig[k])
        if mapped and (rec.cigar(i) != [(len(seq), 0)] or c < 0 or rec.pos[i] < 0
                       or rec.pos[i] + len(seq) > genome.lengths[c]):
            out["bad_records"] += 1
            show("bad_records", i, "cigar")
            continue
        nm = rec.int_tag(i, b"NM")
        if nm is not None:
            o = int(genome.offsets[c]) + int(rec.pos[i]) if mapped else 0
            if not mapped or nm != int((want != genome.bases[o: o + len(want)]).sum()):
                out["nm_errors"] += 1
                show("nm_errors", i, f"NM {nm}")
        text = pool.r1[r].tobytes().decode()
        bl = wl.shape[1]
        expect = {"CB": text[:bl] + "-1", "UB": text[bl: bl + umi_len]}
        if genes[k] >= 0:
            expect["GX"] = gene_names[int(genes[k])]
        got = {t: v for t, v in z_tags(rec, i).items() if t in ("CB", "UB", "GX")}
        if got != expect:
            out["tag_errors"] += 1
            show("tag_errors", i, str(got), str(expect))
        tm = truth_mismatches(r2, genome, r, 0)
        if pool.kind[r] != 0 or tm is None or tm > 1:
            continue
        out["easy"] += 1
        on = (mapped and c == r2.contig[0][r] and rec.pos[i] < r2.end[0][r]
              and rec.pos[i] + len(seq) > r2.start[0][r]
              and bool(f & 0x10) == bool(r2.reverse[0][r]))
        if not on:
            out["missed"] += 1
            show("missed", i, f"origin {r2.contig[0][r]}:{r2.start[0][r] + 1}")
    out["missed"] = out["missed"] / max(out["easy"], 1)

    # the matrix, from every read of the window
    r1 = pool.r1[k_of]
    bl = wl.shape[1]
    cells = ref.match_barcodes(r1[:, :bl], wl)
    entries = ref.umi_counts(cells, genes, ref.values(r1[:, bl: bl + umi_len]), umi_len)
    files = ref.matrix_files(entries, gene_names, wl, cell_calling)
    out["matrix_errors"] = 0
    for name, text in files.items():
        with open(f"{out_dir}/{name}") as f:
            got = f.read().splitlines()
        want = text.splitlines()
        diff = _line_difference(got, want)
        out["matrix_errors"] += diff
        if diff and sum(e[0] == "matrix_errors" for e in examples) < 3:
            examples.append(("matrix_errors", name, diff, len(got), len(want)))
    out["cells"] = len(files["barcodes.tsv"].splitlines())
    out["entries"] = len(entries)
    return out


def _line_difference(a: list[str], b: list[str]) -> int:
    """Lines of a not in b plus lines of b not in a, as multisets, and the
    lines out of place where both hold the same."""
    from collections import Counter

    ca, cb = Counter(a), Counter(b)
    n = sum((ca - cb).values()) + sum((cb - ca).values())
    if n == 0 and a != b:
        n = sum(x != y for x, y in zip(a, b))
    return n
