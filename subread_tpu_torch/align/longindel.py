"""Long-indel rescue: the aligner's third iteration.

(A copy of subread_tpu/align/longindel.py with only its imports changed:
importing anything under subread_tpu.align loads JAX through that
package's __init__, and the machine with the card has no JAX.  The code is
numpy, so it runs unchanged.)

Reference: indels longer than the banded-DP reach (16bp) cannot be placed
by realignment; the reference runs a reassembly iteration that re-anchors
the soft-clipped breakpoint tails against nearby genome
(do_iteration_three / finalise_long_insertions, core.c:3643-3648,
core-indel.c:4389; enabled when -I > 16, init_global_context
core-indel.c:4399+).

Here: after scan-2, a read straddling a long indel comes out anchored on
one side with a large soft-clip at the breakpoint (the clip gate keeps the
anchored half mapped).  For each such read the clipped tail/head is
re-anchored host-side with a vectorized mismatch scan over candidate
deletion lengths d ∈ (short_limit, max_indel] (tail matches genome
displaced by d) or insertion lengths k (tail minus its first k bases
matches in place).  Successful rescues rewrite the CIGAR
(…M dD …M / …M kI …M), fix the position for head-side rescues, and add
the event to the .indel.vcf table.  Flagged reads are rare, so this is
host wall-clock noise next to the device scans.
"""

from __future__ import annotations

import numpy as np

from subread_tpu import dna
from subread_tpu.index.genome import Genome


def left_normalize_codes(gcodes: np.ndarray, pos0: int, ilen: int,
                         ins: np.ndarray | None):
    """Left-align an indel event over 2-bit genome codes: rotate the event
    left while the reference base before it equals its last base (the
    standard VCF normalization).  Re-anchored long indels otherwise land
    at rotation-ambiguous breakpoints — head-side and tail-side rescues of
    the SAME insertion produce shifted keys that would double-report.
    pos0 = small_side (0-based last reference base before the event);
    ilen > 0 deletion, < 0 insertion with `ins` codes.  Returns
    (pos0, ins)."""
    if ilen > 0:
        while pos0 >= 0 and gcodes[pos0] == gcodes[pos0 + ilen]:
            pos0 -= 1
    elif ins is not None and len(ins):
        ins = np.asarray(ins, np.uint8).copy()
        while pos0 >= 0 and gcodes[pos0] == ins[-1]:
            ins = np.concatenate([[gcodes[pos0]], ins[:-1]])
            pos0 -= 1
    return pos0, ins


def _best_match(windows: np.ndarray, tail: np.ndarray, max_mm: int) -> int:
    """Index of the window row best matching tail (fewest mismatches,
    ties to the smallest index) if within max_mm, else -1.
    windows [D, T], tail [T]."""
    if windows.size == 0:
        return -1
    mm = (windows != tail[None, :]).sum(axis=1)
    j = int(mm.argmin())
    return j if mm[j] <= max_mm else -1


def rescue_long_indels(
    genome: Genome,
    batch,
    res: dict,
    max_indel: int,
    short_limit: int = 16,
    min_clip: int = 12,
    max_mm_frac: float = 0.12,
    piles: dict | None = None,
) -> tuple[dict, dict, int]:
    """Re-anchor large soft-clips as long indels.

    Returns (overrides {i: (cigar, mism, nm)}, events
    {(cidx, pos0, ilen): (support, ins_seq)}, n_rescued).  Mutates
    res["pos"] for head-side rescues (the alignment start moves upstream).

    `piles` (optional dict, carried across chunks) collects the clipped
    fragments of reads whose single-read rescue FAILED — insertions
    longer than the clip itself — keyed by the linear breakpoint:
    piles[b] = {"pre": [tail-clip codes...], "suf": [head-clip codes...]}.
    assemble_insertion_piles() later reconstructs the full inserted
    sequence across reads (finalise_long_insertions analog,
    core-indel.c:4389: the reference re-votes a 350bp window over all
    local reads; a prefix/suffix overlap assembly of the same clip piles
    reaches the same insertions up to clip_l+clip_r-overlap bases).
    """
    if "clip_l" not in res or max_indel <= short_limit:
        return {}, {}, 0
    clip_l = np.asarray(res["clip_l"], np.int64)
    clip_r = np.asarray(res["clip_r"], np.int64)
    mapped = np.asarray(res["mapped"], bool)
    indel0 = np.asarray(res["indel"], np.int64)
    cand = mapped & (indel0 == 0) & (
        (clip_l >= min_clip) | (clip_r >= min_clip)
    )
    idxs = np.flatnonzero(cand)
    if len(idxs) == 0:
        return {}, {}, 0

    gcodes = genome.codes
    G = len(gcodes)
    pos = np.asarray(res["pos"], np.int64)
    strand = np.asarray(res["strand"], np.int64)
    mism = np.asarray(res["mism"], np.int64)
    overrides: dict[int, tuple[str, int, int]] = {}
    events: dict[tuple[int, int, int], tuple[int, str]] = {}
    new_pos = pos.copy()
    d_lo = short_limit + 1

    def add_event(lin_pos0: int, ilen: int, ins: str):
        ins_codes = dna.encode(ins) if ins else None
        lin_pos0, ins_codes = left_normalize_codes(
            gcodes, int(lin_pos0), ilen, ins_codes
        )
        ins = dna.decode(ins_codes) if ins_codes is not None else ""
        cidx, coff = genome.linear_to_chro(np.array([lin_pos0], np.int64))
        key = (int(cidx[0]), int(coff[0]), ilen)
        sup, prev = events.get(key, (0, ins))
        events[key] = (sup + 1, prev)

    for i in idxs:
        L = int(batch.lengths[i])
        oc = batch.codes[i, :L]
        if strand[i] == 1:
            oc = dna.revcomp(oc)
        cl, cr = int(clip_l[i]), int(clip_r[i])
        m = L - cl - cr  # matched span of the anchored half
        p = int(pos[i])  # linear genome pos of the first matched base

        if cr >= min_clip:
            tail = oc[L - cr :]
            q0 = p + m  # breakpoint: genome pos right after the match
            max_mm = int(max_mm_frac * cr)
            # deletion of d: tail re-anchors at q0 + d
            lo, hi = q0 + d_lo, min(q0 + max_indel + cr, G)
            if hi - lo >= cr:
                win = np.lib.stride_tricks.sliding_window_view(
                    gcodes[lo:hi], cr
                )
                j = _best_match(win, tail, max_mm)
            else:
                j = -1
            if j >= 0:
                d = d_lo + j
                mm = mism[i] + int((win[j] != tail).sum())
                cig = (f"{cl}S" if cl else "") + f"{m}M{d}D{cr}M"
                overrides[i] = (cig, int(mm), int(mm + d))
                add_event(q0 - 1, d, "")
                continue
            # insertion of k: tail[k:] re-anchors at q0; take the k with
            # the lowest mismatch fraction (first-acceptable can stop a
            # few bases short of the true insertion length)
            best_k, best_mm, best_frac = -1, 0, 1.0
            for k in range(d_lo, min(cr - 10, max_indel) + 1):
                t2 = tail[k:]
                if q0 + len(t2) > G:
                    break
                mmk = int((gcodes[q0 : q0 + len(t2)] != t2).sum())
                frac = mmk / len(t2)
                if frac <= max_mm_frac and frac < best_frac:
                    best_k, best_mm, best_frac = k, mmk, frac
            if best_k >= 0:
                k, mm = best_k, mism[i] + best_mm
                cig = (f"{cl}S" if cl else "") + f"{m}M{k}I{cr - k}M"
                overrides[i] = (cig, int(mm), int(mm + k))
                add_event(q0 - 1, -k, dna.decode(tail[:k]))
                continue
            if piles is not None and cr >= min_clip + 8:
                piles.setdefault(int(q0), {"pre": [], "suf": []})[
                    "pre"
                ].append(np.asarray(tail, np.uint8))

        if cl >= min_clip:
            head = oc[:cl]
            max_mm = int(max_mm_frac * cl)
            # deletion of d: head anchors at p - d - cl
            ds = np.arange(d_lo, max_indel + 1)
            starts = p - ds - cl
            ds = ds[starts >= 0]
            if len(ds):
                lo = int(p - ds[-1] - cl)
                hi = int(p - ds[0])  # head windows end before p - d
                win_all = np.lib.stride_tricks.sliding_window_view(
                    gcodes[lo:hi], cl
                )
                # window for deletion d starts at (p - d - cl) - lo
                sel = (p - ds - cl) - lo
                win = win_all[sel]
                j = _best_match(win, head, max_mm)
            else:
                j = -1
            if j >= 0:
                d = int(ds[j])
                mm = mism[i] + int((win[j] != head).sum())
                cig = f"{cl}M{d}D{m}M" + (f"{cr}S" if cr else "")
                overrides[i] = (cig, int(mm), int(mm + d))
                new_pos[i] = p - d - cl
                add_event(p - d - 1, d, "")
                continue
            # insertion of k: head[:cl-k] anchors at p - (cl - k); best k
            # by mismatch fraction (see tail-side note)
            best = None
            for k in range(d_lo, min(cl - 10, max_indel) + 1):
                h2 = head[: cl - k]
                q = p - len(h2)
                if q < 0:
                    continue
                mmk = int((gcodes[q : q + len(h2)] != h2).sum())
                frac = mmk / len(h2)
                if frac <= max_mm_frac and (best is None or frac < best[0]):
                    best = (frac, k, mmk, q)
            if best is not None:
                _, k, mmk, q = best
                mm = mism[i] + mmk
                cig = f"{cl - k}M{k}I{m}M" + (f"{cr}S" if cr else "")
                overrides[i] = (cig, int(mm), int(mm + k))
                new_pos[i] = q
                add_event(p - 1, -k, dna.decode(head[cl - k : cl]))
            elif piles is not None and cl >= min_clip + 8:
                piles.setdefault(int(p), {"pre": [], "suf": []})[
                    "suf"
                ].append(np.asarray(head, np.uint8))

    if overrides:
        res["pos"] = new_pos.astype(res["pos"].dtype)
    return overrides, events, len(overrides)


def assemble_insertion_piles(
    genome: Genome,
    piles: dict,
    max_indel: int,
    short_limit: int = 16,
    min_overlap: int = 12,
    tol: int = 4,
) -> dict:
    """Cross-read long-insertion reassembly (finalise_long_insertions
    analog, core-indel.c:4389 + core-indel.h:93-122).

    Reads whose clip could not be re-anchored single-read pile up at the
    breakpoint b: tail-clips carry [insertion + right-genome] fragments
    starting AT b, head-clips carry [left-genome + insertion] fragments
    ending AT b.  For each candidate insertion length K the fragments
    decompose deterministically — a prefix fragment P of length > K must
    continue as genome[b:] after its first K bases, a suffix fragment S
    of length > K must begin as genome[:b] before its last K bases — so
    scanning K over (short_limit, max_indel] and validating both sides
    against the genome recovers the full inserted sequence even when no
    single read spans it.  Both sides must agree on the inserted bases
    (<=1 mismatch).  Returns events {(cidx, pos0, -K): (support,
    ins_seq)} left-normalized like the single-read rescues."""
    events: dict = {}
    if not piles:
        return events
    gcodes = genome.codes
    G = len(gcodes)
    keys = sorted(piles)
    used = set()
    for b in keys:
        if b in used:
            continue
        pre, suf, members = [], [], []
        for b2 in keys:
            if abs(b2 - b) <= tol:
                members.append(b2)
                pre += [(b2, f) for f in piles[b2]["pre"]]
                suf += [(b2, f) for f in piles[b2]["suf"]]
        if not pre or not suf:
            continue
        for m in members:
            used.add(m)
        bp, P = max(pre, key=lambda t: len(t[1]))
        bs, S = max(suf, key=lambda t: len(t[1]))
        best = None
        for K in range(short_limit + 1, max_indel + 1):
            # prefix side: P starts at bp; P[K:] must continue as genome
            pt = len(P) - K
            p_ok = ins_p = None
            if pt >= 4 and bp + pt <= G:
                mm = int((P[K:] != gcodes[bp : bp + pt]).sum())
                if mm <= max(1, pt // 10):
                    p_ok, ins_p = True, P[:K]
            # suffix side: S ends at bs; S[:-K] must match genome before bs
            st = len(S) - K
            s_ok = ins_s = None
            if st >= 4 and bs - st >= 0:
                mm = int((S[:st] != gcodes[bs - st : bs]).sum())
                if mm <= max(1, st // 10):
                    s_ok, ins_s = True, S[st:]
            if p_ok and s_ok:
                agree = int((ins_p != ins_s).sum())
                if agree <= 1:
                    best = (K, ins_p)
                    break
            elif p_ok or s_ok:
                # one-sided genome validation: require the OTHER fragment
                # to agree over >=min_overlap bases of the insertion
                ins = ins_p if p_ok else ins_s
                other = S if p_ok else P
                if p_ok:
                    o = min(len(other), K)      # S tail vs ins tail
                    mm = int((other[-o:] != ins[K - o : K]).sum())
                else:
                    o = min(len(other), K)      # P head vs ins head
                    mm = int((other[:o] != ins[:o]).sum())
                if o >= min_overlap and mm <= 1:
                    best = (K, ins)
                    break
        if best is None:
            continue
        K, ins_codes = best
        pos0, ins_codes2 = left_normalize_codes(
            gcodes, int(bp) - 1, -K, np.asarray(ins_codes, np.uint8)
        )
        ins = dna.decode(np.asarray(ins_codes2, np.uint8))
        cidx, coff = genome.linear_to_chro(np.array([pos0], np.int64))
        key = (int(cidx[0]), int(coff[0]), -K)
        sup = len(pre) + len(suf)
        s0, p0 = events.get(key, (0, ins))
        events[key] = (s0 + sup, p0)
    return events
