"""Copy of `subread_tpu/tools/subindel.py`: the port imports nothing of the JAX package.

subindel — long-indel detection from aligned SAM/BAM.

Reference: SUBindel.c (406 LoC) — wraps the core engine's third iteration
(long-indel local reassembly, finalise_long_insertions core-indel.c:4389):
indels longer than the aligner's -I limit leave reads soft-clipped at the
breakpoint; the clipped tails are locally re-anchored against the genome
to reconstruct the event.  Here: CIGAR-borne events are collected
directly; soft-clip clusters are consensus-assembled and their tails
re-matched downstream (deletions) or against themselves (insertions).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="subread_tpu-subindel")
    ap.add_argument("-v", "--version", action="version",
                    version="subread_tpu-subindel")
    ap.add_argument("-i", "--input", required=True, help="SAM/BAM input")
    ap.add_argument("-g", "--genome", required=True,
                    help="reference FASTA or index prefix (the reference "
                         "binary takes the subread index prefix)")
    ap.add_argument("-o", "--output", required=True, help="VCF output")
    ap.add_argument("-I", "--max-indel", type=int, default=200)
    ap.add_argument("-n", "--min-support", type=int, default=1)
    ap.add_argument("-d", "--fragment-distance", type=int, default=300,
                    help="expected fragment distance (compat)")
    ap.add_argument("--paired-end", action="store_true",
                    help="input reads are paired-end (compat)")
    args = ap.parse_args(argv)

    import os

    from ..io.sam import parse_cigar
    from ..tools.utilities import _sam_records

    # chromosome sequences for REF/ALT columns: -g may be a FASTA path or
    # (reference-binary convention) an index prefix
    chroms: dict[str, str] = {}
    if not os.path.isfile(args.genome) and (
        os.path.exists(args.genome + ".00.b.tab")
        or os.path.exists(args.genome + ".hash.npz")
        or os.path.exists(args.genome + ".genome.npz")
    ):
        from .align import load_index_any

        genome, _idx = load_index_any(args.genome)
        import numpy as np

        for ci, nm in enumerate(genome.names):
            s0 = int(genome.starts[ci])
            ln = int(genome.lengths[ci])
            chroms[nm] = "".join(
                "AGCT"[c] for c in np.asarray(genome.codes[s0 : s0 + ln])
            )
    else:
        name, chunks = None, []
        for line in open(args.genome):
            line = line.strip()
            if line.startswith(">"):
                if name:
                    chroms[name] = "".join(chunks).upper()
                name = line[1:].split()[0]
                chunks = []
            elif line:
                chunks.append(line)
        if name:
            chroms[name] = "".join(chunks).upper()

    events: dict[tuple[str, int, int, str], int] = {}

    def norm2(chro, pos0, ilen, ins):
        """Left-align long (>16bp) indel events so rotation-ambiguous
        placements from different reads share one key (VCF
        normalization); short events keep the aligner's DP placement."""
        seq = chroms.get(chro)
        if seq is None:
            return pos0, ins
        if ilen > 0:
            while pos0 >= 0 and pos0 + ilen < len(seq) \
                    and seq[pos0] == seq[pos0 + ilen]:
                pos0 -= 1
        elif ins:
            while pos0 >= 0 and seq[pos0] == ins[-1]:
                ins = seq[pos0] + ins[:-1]
                pos0 -= 1
        return pos0, ins
    # soft-clip clusters: (chro, clip_pos0) -> list of clipped tail/head seqs
    right_clips: dict[tuple[str, int], list[str]] = {}
    left_clips: dict[tuple[str, int], list[str]] = {}
    for f in _sam_records(args.input):
        if int(f[1]) & 0x4 or f[5] == "*":
            continue
        gpos = int(f[3]) - 1
        rpos = 0
        ops = parse_cigar(f[5])
        # soft-clip collection for the reassembly pass
        if ops and ops[0][1] == "S" and ops[0][0] >= 12:
            left_clips.setdefault((f[2], int(f[3]) - 1), []).append(
                f[9][: ops[0][0]]
            )
        if ops and ops[-1][1] == "S" and ops[-1][0] >= 12:
            span = sum(n for n, op in ops if op in "MDN=X")
            right_clips.setdefault((f[2], int(f[3]) - 1 + span), []).append(
                f[9][len(f[9]) - ops[-1][0] :]
            )
        for n, op in ops:
            if op in "M=X":
                gpos += n
                rpos += n
            elif op == "D":
                if n <= args.max_indel:
                    p0, _ins = (
                        norm2(f[2], gpos - 1, n, "") if n > 16
                        else (gpos - 1, "")
                    )
                    key = (f[2], p0, n, "")
                    events[key] = events.get(key, 0) + 1
                gpos += n
            elif op == "I":
                if n <= args.max_indel:
                    ins = f[9][rpos : rpos + n]
                    p0, ins = (
                        norm2(f[2], gpos - 1, -n, ins) if n > 16
                        else (gpos - 1, ins)
                    )
                    key = (f[2], p0, -n, ins)
                    events[key] = events.get(key, 0) + 1
                rpos += n
            elif op == "N":
                gpos += n
            elif op == "S":
                rpos += n

    # ---- soft-clip local reassembly (long indels) -----------------------
    def consensus(seqs: list[str], from_end: bool = False) -> str:
        m = max(len(x) for x in seqs)
        out = []
        for i in range(m):
            col = {}
            for x in seqs:
                ch = (x[len(x) - 1 - i] if from_end else x[i]) if i < len(x) else None
                if ch:
                    col[ch] = col.get(ch, 0) + 1
            if not col:
                break
            out.append(max(col, key=col.get))
        txt = "".join(out)
        return txt[::-1] if from_end else txt

    def matches(a: str, b: str, max_mm_frac: float = 0.1) -> bool:
        n = min(len(a), len(b))
        if n < 10:
            return False
        mm = sum(1 for i in range(n) if a[i] != b[i])
        return mm <= max_mm_frac * n

    def norm(chro, pos0, ilen, ins):
        """Left-align a reassembled long-indel event (VCF normalization) so
        head-side and tail-side rescues of one insertion share a key; the
        CIGAR-derived short events stay at the aligner's DP placement like
        the reference's."""
        seq = chroms[chro]
        if ilen > 0:
            while pos0 >= 0 and pos0 + ilen < len(seq) \
                    and seq[pos0] == seq[pos0 + ilen]:
                pos0 -= 1
        elif ins:
            while pos0 >= 0 and seq[pos0] == ins[-1]:
                ins = seq[pos0] + ins[:-1]
                pos0 -= 1
        return pos0, ins

    for (chro, bp), tails in right_clips.items():
        if len(tails) < max(args.min_support, 2) or chro not in chroms:
            continue
        seq = chroms[chro]
        T = consensus(tails)
        if len(T) < 12:
            continue
        found = False
        # deletion: the tail re-anchors downstream at bp + d
        for d in range(10, args.max_indel + 1):
            q = bp + d
            if q + len(T) > len(seq):
                break
            if matches(T, seq[q : q + len(T)]):
                p0, _ = norm(chro, bp - 1, d, "")
                key = (chro, p0, d, "")
                events[key] = events.get(key, 0) + len(tails)
                found = True
                break
        if not found:
            # insertion: T starts with inserted bases then rejoins at bp
            for k in range(5, min(len(T) - 10, args.max_indel) + 1):
                if matches(T[k:], seq[bp : bp + len(T) - k]):
                    p0, ins = norm(chro, bp - 1, -k, T[:k])
                    key = (chro, p0, -k, ins)
                    events[key] = events.get(key, 0) + len(tails)
                    break

    n_out = 0
    with open(args.output, "w") as out:
        out.write("##fileformat=VCFv4.0\n")
        out.write('##INFO=<ID=INDEL,Number=0,Type=Flag,Description="Indicates that the variant is an INDEL.">\n')
        out.write('##INFO=<ID=SR,Number=1,Type=Integer,Description="Number of supporting reads">\n')
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for (chro, pos0, ilen, ins), sup in sorted(events.items()):
            if sup < args.min_support or chro not in chroms:
                continue
            seq = chroms[chro]
            if pos0 < 0 or pos0 >= len(seq):
                continue
            if ilen > 0:
                ref_s = seq[pos0 : pos0 + ilen + 1]
                alt_s = seq[pos0]
            else:
                ref_s = seq[pos0]
                alt_s = seq[pos0] + ins
            out.write(
                f"{chro}\t{pos0 + 1}\t.\t{ref_s}\t{alt_s}\t.\t.\t"
                f"INDEL;SR={sup}\n"
            )
            n_out += 1
    print(f"// subindel: {n_out} indel events", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
