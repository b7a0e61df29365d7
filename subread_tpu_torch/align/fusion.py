"""Fusion / structural-breakpoint detection (subjunc --allJunctions).

Reference: core-junction.c — fusion events are vote-cluster pairs that
cannot be explained as an exon-exon junction (different strand, excessive
distance, or wrong coverage order), recorded as CHRO_EVENT_TYPE_FUSION
and written as paired VCF BND records by `write_fusion_final_results`
(core-junction.c:4142-4220).  Breakend sides carry
small/large_side_increasing_coordinate flags: a side's flag is 1 when its
aligned block lies at coordinates >= the breakend (the right block of a
junction), 0 when the block lies below it.

Here the device exports the per-read top-K vote clusters (pos, strand,
votes, coverage span); the host picks, for reads whose best cluster is
mapped, the strongest junction-incompatible minor cluster and derives the
two breakend coordinates from the read-coordinate split implied by the
clusters' coverage spans.

This module is a copy of subread_tpu/align/fusion.py: importing anything
under subread_tpu.align loads JAX, which the machine with the card does
not have.  Only the imports changed, to subread_tpu.dna and the port's
ops.junction.
"""

from __future__ import annotations

import numpy as np

from ..ops.junction import MAX_INTRON

SENTINEL = np.uint32(0xFFFFFFFF)


def detect_fusion_pairs(
    res: dict[str, np.ndarray],
    lens: np.ndarray,
    max_indel: int,
    min_minor_votes: int = 2,
    batch=None,
    genome=None,
) -> list[tuple[int, int, int, int, int]]:
    """Per-read fusion breakend pairs from exported vote clusters.

    Needs res keys vk_pos/vk_strand/vk_votes/vk_cov_s/vk_cov_e [R, K] and
    best_k [R].  Returns a list of
    (small_pos, large_pos, small_increasing, large_increasing, read_idx).
    """
    pos = res["vk_pos"].astype(np.int64)
    strand = res["vk_strand"]
    votes = res["vk_votes"]
    cov_s = res["vk_cov_s"].astype(np.int64)
    cov_e = res["vk_cov_e"].astype(np.int64)
    best = res["best_k"].astype(np.int64)
    R, K = pos.shape
    L = lens.astype(np.int64)

    rows = np.arange(R)
    b_pos = pos[rows, best]
    b_strand = strand[rows, best]
    # fusion reads are typically NOT whole-read mappable (each half fails
    # the mismatch gate), so the gate is vote evidence on the major
    # cluster, not the final mapped flag
    b_votes = votes[rows, best]
    anchored = (b_pos != np.int64(SENTINEL)) & (
        b_votes >= max(min_minor_votes, 3)
    )

    # coverage spans in FORWARD-read coordinates (strand-1 clusters voted
    # on the reverse-complemented read: fwd span = [L-cov_e, L-cov_s])
    def fwd_span(cs, ce, st):
        fs = np.where(st == 1, L[:, None] - ce, cs)
        fe = np.where(st == 1, L[:, None] - cs, ce)
        return fs, fe

    f_cs, f_ce = fwd_span(cov_s, cov_e, strand)
    bf_cs = f_cs[rows, best][:, None]
    bf_ce = f_ce[rows, best][:, None]

    valid = (pos != np.int64(SENTINEL)) & (votes >= min_minor_votes)
    valid[rows, best] = False
    diff = np.abs(pos - b_pos[:, None])
    # junction-compatible pairs are handled by the junction module;
    # a fusion minor is cross-strand, or too far, and must cover a read
    # span disjoint-ish from the major's
    incompatible = (strand != b_strand[:, None]) | (diff > MAX_INTRON)
    no_overlap = (f_cs >= bf_ce - 8) | (f_ce <= bf_cs + 8)
    cand = valid & incompatible & no_overlap & anchored[:, None]
    # fusion-mode big-margin gate (test_small_minor_votes,
    # core-junction.c:837-885): a minor farther than the max intron is
    # rejected when ANY other cluster with votes within 1 of the minor's
    # covers (in forward-read coordinates) nearly the same span (both
    # edges within 7) — a repeat twin makes the breakend placement
    # ambiguous and the reference drops the pair.
    far = diff > MAX_INTRON
    K_ = votes.shape[1]
    not_self = ~np.eye(K_, dtype=bool)[None, :, :]
    twin = (
        (votes[:, None, :] >= votes[:, :, None])   # within-1-vote rule:
        #  `if(minor_votes - other_votes >= 1) continue` keeps only
        #  others with votes >= the minor's
        & (np.abs(f_cs[:, None, :] - f_cs[:, :, None]) < 7)
        & (np.abs(f_ce[:, None, :] - f_ce[:, :, None]) < 7)
        & (pos[:, None, :] != np.int64(SENTINEL))
        & not_self
    ).any(axis=2)
    cand &= ~(far & twin)
    # NOTE: no multi-mapping gate here — a true chimera's two halves tie
    # as equally-scored distinct locations, so ambiguity is EXPECTED of
    # fusion reads; false pairs are filtered by the sequence validation
    # and the explained-read gate below instead
    if "mapped" in res:
        # a read already explained end-to-end (mapped with only small
        # clips and no junction split) needs no fusion: its minor cluster
        # is repeat noise.  Fusion evidence = a large unexplained fragment.
        zeros = np.zeros(R, np.int32)
        cl = np.asarray(res.get("clip_l", zeros))
        cr = np.asarray(res.get("clip_r", zeros))
        junc = np.asarray(res.get("junc", np.zeros(R, bool)), bool)
        explained = (
            np.asarray(res["mapped"], bool) & ~junc & (cl + cr < 16)
        )
        cand &= ~explained[:, None]

    span = f_ce - f_cs
    scores = np.where(cand, votes * 1000 + span, -1)  # votes, then coverage
    mk = scores.argmax(axis=1)
    has = scores[rows, mk] >= min_minor_votes * 1000

    out = []
    for i in np.flatnonzero(has):
        k = mk[i]
        Li = int(L[i])
        m_tail = f_cs[i, k] >= bf_ce[i, 0] - 8  # minor covers the read tail
        if m_tail:
            split = int((bf_ce[i, 0] + f_cs[i, k]) // 2)
        else:
            split = int((f_ce[i, k] + bf_cs[i, 0]) // 2)
        split = max(1, min(Li - 1, split))

        def edges(p, st, frag_is_prefix):
            # breakend genome coordinate + increasing flag for the cluster
            # aligned to fwd-read fragment [0,split) or [split,L)
            if frag_is_prefix:
                if st == 0:
                    return p + split - 1, 0   # block below edge
                return p + Li - split, 1      # rc: block above edge
            if st == 0:
                return p + split, 1
            return p + Li - 1 - split, 0

        if batch is not None and genome is not None:
            # sequence-validate the MINOR's voted coverage span (the
            # reference confirms fusion halves by realignment before
            # emitting breakpoints; vote clusters alone are too weak).
            # cov_s/cov_e are in the cluster's own oriented coordinates,
            # so no span conversion is needed.
            o = np.asarray(batch.codes[i, :Li])
            st_m = int(strand[i, k])
            o_m = (3 - o[::-1]) if st_m == 1 else o
            rs, re_ = int(cov_s[i, k]), int(cov_e[i, k])
            rs = max(0, rs)
            re_ = min(Li, re_)
            flen = re_ - rs
            if flen < 16:
                continue
            p_m = int(pos[i, k])
            gs = p_m + rs
            seg = np.asarray(genome.codes[gs : gs + flen])
            if len(seg) != flen:
                continue
            mm = int(np.sum(seg != o_m[rs:re_]))
            if mm > max(2, flen // 10):
                continue
        # major covers the prefix when the minor is the tail
        e1, f1 = edges(int(b_pos[i]), int(b_strand[i]), bool(m_tail))
        e2, f2 = edges(int(pos[i, k]), int(strand[i, k]), not bool(m_tail))
        if e1 <= e2:
            out.append((e1, e2, f1, f2, int(i)))
        else:
            out.append((e2, e1, f2, f1, int(i)))
    return out


def accumulate_breakpoints(
    table: dict, pairs, tolerance: int = 8
) -> None:
    """Merge per-read breakend pairs into a support-counted event table
    (the reference's event dedup, remove_neighbour core-indel.c:447,
    merges events within a small window)."""
    for small, large, fs, fl, _ridx in pairs:
        hit = None
        for (s0, l0, f0, f1) in table:
            if (
                f0 == fs and f1 == fl
                and abs(s0 - small) <= tolerance
                and abs(l0 - large) <= tolerance
            ):
                hit = (s0, l0, f0, f1)
                break
        if hit is None:
            table[(small, large, fs, fl)] = 1
        else:
            table[hit] += 1


def write_breakpoints_vcf(path: str, genome, table: dict, min_support: int = 1) -> None:
    """Paired BND records (write_fusion_final_results,
    core-junction.c:4147-4216)."""
    from subread_tpu import dna

    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        f.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n')
        f.write('##INFO=<ID=MATEID,Number=1,Type=String,Description="Paired breakend id">\n')
        f.write('##INFO=<ID=SR,Number=1,Type=Integer,Description="Supporting read number">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        n = 0
        for (small, large, f_small, f_large), support in sorted(table.items()):
            if support < min_support:
                continue
            cs, ps = genome.linear_to_chro(np.asarray([small]))
            cl, pl = genome.linear_to_chro(np.asarray([large]))
            if ps[0] < 0 or pl[0] < 0:
                continue
            n += 1
            name_s, pos_s = genome.names[int(cs[0])], int(ps[0]) + 1
            name_l, pos_l = genome.names[int(cl[0])], int(pl[0]) + 1
            ref_s = dna.decode(genome.codes[small : small + 1])
            ref_l = dna.decode(genome.codes[large : large + 1])

            bkt = "[" if f_large else "]"
            if f_small:
                alt = f"{bkt}{name_l}:{pos_l}{bkt}{ref_s}"
            else:
                alt = f"{ref_s}{bkt}{name_l}:{pos_l}{bkt}"
            f.write(
                f"{name_s}\t{pos_s}\tbnd_{2*n-1}\t{ref_s}\t{alt}\t.\tPASS\t"
                f"SVTYPE=BND;MATEID=bnd_{2*n};SR={support}\n"
            )
            bkt = "[" if f_small else "]"
            if f_large:
                alt = f"{bkt}{name_s}:{pos_s}{bkt}{ref_l}"
            else:
                alt = f"{ref_l}{bkt}{name_s}:{pos_s}{bkt}"
            f.write(
                f"{name_l}\t{pos_l}\tbnd_{2*n}\t{ref_l}\t{alt}\t.\tPASS\t"
                f"SVTYPE=BND;MATEID=bnd_{2*n-1};SR={support}\n"
            )
