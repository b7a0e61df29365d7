"""Reference-exact indel event discovery + event-driven CIGAR placement.

(A copy of subread_tpu/align/indelevent.py with only its imports changed:
the port imports nothing of the JAX package.  The code is numpy and the
port's copy of the native host library, so it runs unchanged.)

The reference places every indel via a SHARED event table, not per read:
scan 1 proposes events from a banded dynamic-programming alignment of the
window between the vote cluster's sections (find_new_indels
core-indel.c:1831-1990, core_dynamic_align :4573-4787), events are
deduplicated globally, and scan 2 re-explains each read against the table
so all reads crossing one indel share the same boundary.  Per-read
minimum-mismatch splits (our device scan) tie frequently inside
homopolymers and diverge from the reference; this module reproduces the
reference's placement:

  1. reconstruct the indel_recorder sections from the device's per-probe
     cluster kv table (probe_kv),
  2. run the exact reference DP (match +2, mismatch 0, gap open -1,
     extend 0, band +-max_indel, the reference's tie rules and backtrack)
     over the window [find_subread_end(last)-9, find_subread_end(next)-7+10],
  3. collect events (small_side = last chromosome base before the indel),
     deduplicate with support counts,
  4. rewrite each read's CIGAR from its best-supported matching event and
     recompute mismatches/clips with the reference rules.
"""

from __future__ import annotations

import numpy as np

from .. import timing

SENTINEL = np.uint32(0xFFFFFFFF)

# movement codes (core-indel.c:4575)
MV_MATCH, MV_DEL, MV_INS, MV_MISM = 0, 1, 2, 3
# mask codes (symbolic)
_M_MATCH, _M_DEL, _M_INS, _M_MISM = 0, 1, 2, 3


def find_subread_end(read_len: int, total_subreads: int, subread0: int) -> int:
    """input-files.c:1371 (subread0 is the reference's 0-based `subread`)."""
    if read_len <= 160:  # EXON_LONG_READ_LENGTH
        step = ((read_len << 16) - (19 << 16)) // (total_subreads - 1)
        return ((step * subread0) >> 16) + 15
    step = 6 << 16
    if ((read_len - 18) << 16) // step > 62:
        step = ((read_len - 18) << 16) // 62
    return ((step * subread0) >> 16) + 15


def core_dynamic_align(read: np.ndarray, genome: np.ndarray,
                       expected_offset: int, max_indel: int = 16):
    """Exact core_dynamic_align (core-indel.c:4573): returns the movement
    list (0 match, 1 del, 2 ins, 3 mismatch) or None.

    read: window codes [m]; genome: codes [m + expected_offset] starting
    at the window's chromosome position.
    """
    m = len(read)
    if m < 3 or abs(expected_offset) > max_indel:
        return None
    if expected_offset < 0 and m < (3 - expected_offset):
        return None
    rows = m + expected_offset
    if rows <= 0 or rows > len(genome):
        return None
    NEG = -9999
    table = np.full((rows, m), NEG, np.int32)
    mask = np.zeros((rows, m), np.int8)
    for i in range(rows):
        gch = genome[i]
        lo = max(0, i - max_indel)
        hi = min(m - 1, i + max_indel)
        for j in range(lo, hi + 1):
            from_upper = table[i - 1][j] + (
                0 if (i > 0 and mask[i - 1][j] == _M_DEL) else -1
            ) if i > 0 else NEG
            from_left = table[i][j - 1] + (
                0 if (j > 0 and mask[i][j - 1] == _M_INS) else -1
            ) if j > 0 else NEG
            sc = 2 if gch == read[j] else 0
            if i > 0 and j > 0:
                from_ul = table[i - 1][j - 1] + sc
            elif i == 0 and j == 0:
                from_ul = sc
            else:
                from_ul = NEG
            if from_ul == from_upper and from_ul > from_left:
                mask[i][j] = _M_DEL
                table[i][j] = from_upper
            elif from_ul == from_left and from_ul > from_upper:
                mask[i][j] = _M_INS
                table[i][j] = from_left
            elif from_ul > from_left and from_ul > from_upper:
                mask[i][j] = _M_MATCH if gch == read[j] else _M_MISM
                table[i][j] = from_ul
            elif from_ul == from_left and from_ul == from_upper:
                mask[i][j] = _M_MATCH if gch == read[j] else _M_MISM
                table[i][j] = from_ul
            elif from_left > from_upper:
                mask[i][j] = _M_INS
                table[i][j] = from_left
            else:
                mask[i][j] = _M_DEL
                table[i][j] = from_upper
    # backtrack (core-indel.c:4707-4735)
    pi, j = rows - 1, m - 1
    moves = []
    delta = 0
    while True:
        mk = mask[pi][j]
        if mk == _M_INS:
            j -= 1
            delta -= 1
            moves.append(MV_INS)
        elif mk == _M_DEL:
            pi -= 1
            delta += 1
            moves.append(MV_DEL)
        else:
            moves.append(MV_MATCH if mk == _M_MATCH else MV_MISM)
            pi -= 1
            j -= 1
        if pi == -1 and j == -1:
            break
        if j < 0 or pi < 0:
            return None
    if delta != expected_offset:
        return None
    moves.reverse()
    return moves


def dp_align_jobs(jobs, max_indel: int = 16):
    """Run core_dynamic_align over a batch of windows.

    jobs: [(read_window uint8[m], genome_window uint8[g], expected_offset)].
    Uses the native batched DP (native/dpalign.cpp — the same cell
    recurrence compiled; ~100x the pure-python scalar loop on indel-dense
    chunks) and falls back to the per-window python when no toolchain.
    Returns one move-list (or None) per job."""
    if not jobs:
        return []
    try:
        import ctypes

        from ..native import get_lib

        lib = get_lib()
    except Exception:
        lib = None
    if lib is None or not hasattr(lib, "dp_align_batch"):
        return [
            core_dynamic_align(r, g, off, max_indel) for (r, g, off) in jobs
        ]
    W = len(jobs)
    Mmax = max(max((len(r) for r, _, _ in jobs), default=1), 1)
    Rmax = max(max((len(g) for _, g, _ in jobs), default=1), 1)
    reads = np.zeros((W, Mmax), np.uint8)
    genomes = np.zeros((W, Rmax), np.uint8)
    mlens = np.zeros(W, np.int32)
    glens = np.zeros(W, np.int32)
    offs = np.zeros(W, np.int32)
    for k, (r, g, off) in enumerate(jobs):
        reads[k, : len(r)] = r
        genomes[k, : len(g)] = g
        mlens[k] = len(r)
        glens[k] = len(g)
        offs[k] = off
    moves = np.zeros((W, Mmax + Rmax), np.int8)
    nmoves = np.zeros(W, np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.dp_align_batch(
        p(reads), p(mlens), p(genomes), p(glens), p(offs),
        ctypes.c_int32(W), ctypes.c_int32(Mmax), ctypes.c_int32(Rmax),
        ctypes.c_int32(max_indel), p(moves), p(nmoves),
    )
    return [
        None if nmoves[k] < 0 else moves[k, : nmoves[k]].tolist()
        for k in range(W)
    ]


def dp_events_jobs(jobs, metas, max_indel: int = 16, max_events: int = 8):
    """jobs as dp_align_jobs; metas: [(chromo_start, read_start)] per job.
    Returns one event list (or None) per job: [(small_side, len, rcur)].
    Native end-to-end (DP + movement walk in C, native/dpalign.cpp) with a
    python fallback."""
    if not jobs:
        return []
    try:
        import ctypes

        from ..native import get_lib

        lib = get_lib()
    except Exception:
        lib = None
    if lib is None or not hasattr(lib, "dp_events_batch"):
        out = []
        for (r, g, off), (gstart, lcb) in zip(jobs, metas):
            mv = core_dynamic_align(r, g, off, max_indel)
            out.append(
                None if mv is None else _events_from_moves(mv, gstart, lcb)
            )
        return out
    W = len(jobs)
    Mmax = max(max((len(r) for r, _, _ in jobs), default=1), 1)
    Rmax = max(max((len(g) for _, g, _ in jobs), default=1), 1)
    reads = np.zeros((W, Mmax), np.uint8)
    genomes = np.zeros((W, Rmax), np.uint8)
    mlens = np.zeros(W, np.int32)
    glens = np.zeros(W, np.int32)
    offs = np.zeros(W, np.int32)
    for k, (r, g, off) in enumerate(jobs):
        reads[k, : len(r)] = r
        genomes[k, : len(g)] = g
        mlens[k] = len(r)
        glens[k] = len(g)
        offs[k] = off
    stride = Mmax + Rmax
    moves = np.zeros((W, stride), np.int8)
    nmoves = np.zeros(W, np.int32)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.dp_align_batch(
        p(reads), p(mlens), p(genomes), p(glens), p(offs),
        ctypes.c_int32(W), ctypes.c_int32(Mmax), ctypes.c_int32(Rmax),
        ctypes.c_int32(max_indel), p(moves), p(nmoves),
    )
    chro = np.asarray([m[0] for m in metas], np.int64)
    rstart = np.asarray([m[1] for m in metas], np.int32)
    ev_small = np.zeros((W, max_events), np.int64)
    ev_len = np.zeros((W, max_events), np.int32)
    ev_rcur = np.zeros((W, max_events), np.int32)
    n_ev = np.zeros(W, np.int32)
    lib.dp_events_batch(
        p(moves), p(nmoves), p(chro), p(rstart),
        ctypes.c_int32(W), ctypes.c_int32(stride),
        ctypes.c_int32(max_events),
        p(ev_small), p(ev_len), p(ev_rcur), p(n_ev),
    )
    out = []
    for k in range(W):
        if n_ev[k] < 0:
            out.append(None)
        else:
            out.append([
                (int(ev_small[k, t]), int(ev_len[k, t]), int(ev_rcur[k, t]))
                for t in range(int(n_ev[k]))
            ])
    return out


def _events_from_moves(moves, chromo_start: int, read_start: int):
    """Walk a movement buffer → [(small_side, indel_len, read_cursor_at)]
    exactly as find_new_indels (core-indel.c:1936-2086); returns None when
    the window has >2 mismatches."""
    total_mm = sum(1 for mv in moves if mv == MV_MISM)
    if total_mm > 2:
        return None
    events = []
    cursor_chro = chromo_start
    cursor_read = read_start
    last_mv = 0
    in_indel = False
    cur_len = 0
    left_boundary = 0
    for mv in moves:
        if last_mv != mv:
            if mv in (MV_DEL, MV_INS) and not in_indel:
                left_boundary = cursor_chro
                in_indel = True
                cur_len = 0
            elif in_indel and mv in (MV_MATCH, MV_MISM):
                events.append((left_boundary - 1, cur_len,
                               cursor_read + min(0, cur_len)))
                in_indel = False
            if mv in (MV_MATCH, MV_MISM):
                in_indel = False
        if in_indel and mv == MV_DEL:
            cur_len += 1
        if in_indel and mv == MV_INS:
            cur_len -= 1
        if mv in (MV_DEL, MV_MISM, MV_MATCH):
            cursor_chro += 1
        if mv in (MV_INS, MV_MISM, MV_MATCH):
            cursor_read += 1
        last_mv = mv
    return events


def _sections_from_probe_kv(pkv_row: np.ndarray, pos: int, gap: int = 1):
    """Reconstruct indel_recorder sections [(first_subread0, last_subread0,
    cum_offset)] from per-probe cluster kv (delta vs the anchor).

    With a gapped index the scan probes each nominal subread at `gap`
    phases but the reference's recorder stores the NOMINAL subread number
    (gehash_go_X receives subread_no, core.c:3179), which find_subread_end
    maps to a read offset — so probe indices collapse to probe//gap."""
    sections = []
    cur = None
    for p, kv in enumerate(pkv_row):
        if kv == 0xFFFFFFFF:
            continue
        sn = p // gap
        d = int(kv) - int(pos)
        if cur is not None and d == cur[2]:
            cur[1] = sn
        else:
            if cur is not None:
                sections.append(tuple(cur))
            cur = [sn, sn, d]
    if cur is not None:
        sections.append(tuple(cur))
    return sections


def _oriented_codes(batch, i, strand):
    L = int(batch.lengths[i])
    c = batch.codes[i, :L].astype(np.int64)
    if strand:
        c = (3 - c)[::-1]
    return c


def ref_stats_host(mm_head, mm_tail, L, splits, indels, cs, ce,
                   show_clip=True):
    """Host single-read version of ops.extend.ref_clip_stats for an
    arbitrary multi-indel section list: splits/indels are parallel lists
    (section boundaries in read coords and per-boundary indel lengths).
    mm_head/mm_tail unused here — kept in the device variant; this
    recomputes from explicit per-base mismatch vector `mm_head` which the
    caller builds for the final alignment (M-section bases only) —
    mm_tail ignored."""
    mm = mm_head
    W, ME = 5, 1
    first_len = splits[0] if splits else L
    last_start = (splits[-1] + max(0, -indels[-1])) if splits else 0
    # head scan
    c0 = cs
    test1 = first_len
    s0 = 0 if c0 < 0 else (test1 - 1 if c0 >= test1 else c0 + 1)
    head = 0
    if show_clip and s0 >= 0:
        matched_last = -1
        win = []
        mmw = 0
        tripped = False
        for j in range(s0, -1, -1):
            is_mm = bool(mm[j])
            win.append(is_mm)
            mmw += is_mm
            if len(win) > W:
                mmw -= win.pop(0)
            if not is_mm:
                matched_last = j
            if mmw > ME:
                head = matched_last if matched_last >= 0 else s0 - 1
                tripped = True
                break
        else:
            head = matched_last if matched_last >= 0 else test1
        if head >= test1:
            head = 0
        head = max(0, head)
    # tail scan
    test2 = L - last_start
    c1 = ce - last_start
    s0t_rel = 0 if c1 < 0 else (test2 - 1 if c1 >= test2 else c1 - 1)
    s0t = last_start + s0t_rel
    tail = 0
    if show_clip and test2 > 0:
        matched_last = -1
        win = []
        mmw = 0
        for j in range(s0t, L):
            is_mm = bool(mm[j])
            win.append(is_mm)
            mmw += is_mm
            if len(win) > W:
                mmw -= win.pop(0)
            if not is_mm:
                matched_last = j
            if mmw > ME:
                tail = (L - 1 - matched_last) if matched_last >= 0 \
                    else test2 - s0t_rel
                break
        else:
            tail = (L - 1 - matched_last) if matched_last >= 0 else test2
        if tail >= test2:
            tail = 0
        tail = max(0, tail)
    if show_clip and not splits and head + tail >= L - 1:
        head = tail = 0
    ins_total = sum(max(0, -d) for d in indels)
    keep = np.zeros(L, bool)
    keep[head:L - tail] = True
    mism = int(np.sum(mm & keep))
    match = (L - head - tail) - mism - ins_total
    return head, tail, mism, match


def ref_stats_batch_np(mm, read_len, split, indel, cs, ce, show_clip=True):
    """Vectorised (numpy, [N, L]) single-indel version of ref_stats_host —
    the batched form of ops.extend.ref_clip_stats for the event-placement
    pass (find_soft_clipping window=5 max_err=1 + final_CIGAR_quality,
    core-junction.c:2820/:2899).  `mm` is the final-alignment per-base
    mismatch map the caller builds over the M sections."""
    N, L = mm.shape
    j = np.arange(L)[None, :]
    rl = read_len[:, None].astype(np.int64)
    ins = np.maximum(-indel, 0)[:, None]
    single = (indel == 0)[:, None]
    splitc = np.where(single, rl, split[:, None])
    sec2_start = np.where(single, 0, splitc + ins)
    in_sec1 = j < splitc
    in_sec2 = (j >= sec2_start) & (j < rl)
    m_sec = in_sec1 | in_sec2
    mmx = mm & m_sec
    mt = (~mm) & m_sec

    test1 = splitc
    c0 = cs[:, None]
    s0h = np.where(c0 < 0, 0, np.where(c0 >= test1, test1 - 1, c0 + 1))
    mmh = (mmx & (j <= s0h)).astype(np.int32)
    win_h = mmh.copy()
    for d in range(1, 5):
        win_h[:, :-d] += mmh[:, d:]
    trip_h = (win_h > 1) & (j <= s0h)
    tripped_h = trip_h.any(1, keepdims=True)
    jt_h = np.max(np.where(trip_h, j, -1), axis=1, keepdims=True)
    lo_h = np.where(tripped_h, jt_h, 0)
    m_h = mt & (j >= lo_h) & (j <= s0h)
    has_m_h = m_h.any(1, keepdims=True)
    lm_h = np.min(np.where(m_h, j, 1 << 20), axis=1, keepdims=True)
    head = np.where(has_m_h, lm_h, np.where(tripped_h, s0h - 1, test1))
    head = np.where(head >= test1, 0, head)
    head = np.maximum(head, 0)

    test2 = rl - sec2_start
    c1 = ce[:, None] - sec2_start
    s0t_rel = np.where(c1 < 0, 0, np.where(c1 >= test2, test2 - 1, c1 - 1))
    s0t = sec2_start + s0t_rel
    mmt = (mmx & (j >= s0t)).astype(np.int32)
    win_t = mmt.copy()
    for d in range(1, 5):
        win_t[:, d:] += mmt[:, :-d]
    trip_t = (win_t > 1) & (j >= s0t) & (j < rl)
    tripped_t = trip_t.any(1, keepdims=True)
    jt_t = np.min(np.where(trip_t, j, 1 << 20), axis=1, keepdims=True)
    hi_t = np.where(tripped_t, jt_t, rl - 1)
    m_t = mt & (j <= hi_t) & (j >= s0t)
    has_m_t = m_t.any(1, keepdims=True)
    lm_t = np.max(np.where(m_t, j, -1), axis=1, keepdims=True)
    tail = np.where(
        has_m_t, rl - 1 - lm_t, np.where(tripped_t, test2 - s0t_rel, test2)
    )
    tail = np.where(tail >= test2, 0, tail)
    tail = np.maximum(tail, 0)

    if not show_clip:
        head = np.zeros_like(head)
        tail = np.zeros_like(tail)
    else:
        both_gone = single & (head + tail >= rl - 1)
        head = np.where(both_gone, 0, head)
        tail = np.where(both_gone, 0, tail)

    keep = (j >= head) & (j < rl - tail)
    mism = (mmx & keep).sum(1).astype(np.int64)
    ins_f = np.maximum(-indel, 0)
    non_clipped = read_len - head[:, 0] - tail[:, 0]
    match = non_clipped - mism - ins_f
    return head[:, 0], tail[:, 0], mism, match


@timing.span("indel")
def propose_and_apply(genome, batch, res, cfg, anchor_mism_limit=3,
                      index_gap: int = 1):
    """Event-table indel placement for one batch.

    Updates res arrays IN PLACE (pos/split/clip_l/clip_r/mism/mapq/mapped):
    every event CIGAR has the single-indel shape
    [hS] (split-h)M dD/I mM [tS] the emitters already format from those
    arrays, so no string overrides are needed and the native fast paths
    stay active.  Returns (events {(small_side, len): (support, ins_seq)},
    done_rows list) — done_rows' indel events are recorded here; emitters
    must not double-count them.
    """
    if "probe_kv" not in res:
        return {}, []
    pos_arr = np.asarray(res["pos"], np.uint32)
    indel_arr = np.asarray(res["indel"], np.int32)
    strand_arr = np.asarray(res["strand"], np.int32)
    cl_arr = np.asarray(res["clip_l"], np.int32) if "clip_l" in res else None
    cr_arr = np.asarray(res["clip_r"], np.int32) if "clip_r" in res else None
    split_arr = np.asarray(res["split"], np.int32)
    mism_arr = np.asarray(res["mism"], np.int32)
    mapped_arr = np.asarray(res["mapped"], bool)
    pkv = np.asarray(res["probe_kv"], np.uint32)
    gcodes = genome.codes
    glen = len(gcodes)
    total_subreads = cfg.total_subreads
    max_indel = min(cfg.max_indel, 16)

    # candidates: mapped indel reads, plus indel-cluster reads the device
    # split left over the mismatch limit (a better event boundary can
    # rescue them, as the reference's scan-2 explain does)
    votes_arr = np.asarray(res["votes"], np.int32)
    multi_arr = np.asarray(res["multi"], bool)
    rescueable = (
        ~mapped_arr & (votes_arr >= cfg.min_votes) & ~multi_arr
        & (pos_arr != SENTINEL)
    )
    cand_mask = (mapped_arr | rescueable) & (indel_arr != 0)
    if "multi_indel" in res:
        # >=3-section reads go to refine_multi_indels (banded multi-indel
        # CIGAR reconstruction) instead
        cand_mask = cand_mask & ~np.asarray(res["multi_indel"], bool)
    cand = np.flatnonzero(cand_mask)
    if len(cand) == 0:
        return {}, []

    # ---- pass 1: propose events via the reference DP ---------------------
    # window construction first, one batched DP call for the whole chunk
    # (native/dpalign.cpp), then the event walk per window
    proposals = {}   # i -> [(small_side_abs, len, ins_seq)]
    events = {}      # (small_side_abs, len) -> [support, ins_seq]
    jobs = []        # (read_window, genome_window, indels)
    jmeta = []       # (read idx, gstart, lcb, read arrays)
    read_cache = {}
    for i in cand:
        L = int(batch.lengths[i])
        cl = int(cl_arr[i]) if cl_arr is not None else 0
        vpos = int(pos_arr[i]) - cl          # unclipped voting position
        read = _oriented_codes(batch, i, int(strand_arr[i]))
        read_cache[i] = read
        secs = _sections_from_probe_kv(pkv[i], vpos, gap=index_gap)
        if len(secs) < 2:
            continue
        last_correct_subread = secs[0][1]
        last_indel = 0
        for (first_p, last_p, off) in secs[1:]:
            indels = off - last_indel
            if indels != 0 and abs(indels) <= max_indel:
                lcb = find_subread_end(L, total_subreads,
                                       last_correct_subread) - 9
                fcb = find_subread_end(L, total_subreads, first_p) - 16 + 9
                lcb = min(max(lcb, 0), L - 1)
                fcb = max(min(fcb, L - 1), 0)
                fcb = max(fcb, lcb)
                fcb = min(fcb + 10, L)
                gstart = vpos + lcb + last_indel
                gwin = gcodes[gstart:gstart + (fcb - lcb) + max(0, indels) + 1]
                jobs.append((read[lcb:fcb], gwin, indels))
                jmeta.append((i, gstart, lcb))
            last_correct_subread = last_p
            last_indel = off
    ev_batch = dp_events_jobs(
        jobs, [(gstart, lcb) for (_i, gstart, lcb) in jmeta], max_indel
    )
    for (i, gstart, lcb), evs in zip(jmeta, ev_batch):
        if not evs:
            continue
        read = read_cache[i]
        for (ss, elen, rcur) in evs:
            ins_seq = "".join(
                "AGCT"[b] for b in read[rcur:rcur - elen]
            ) if elen < 0 else ""
            proposals.setdefault(i, []).append((ss, elen, ins_seq))
            key = (ss, elen)
            e = events.get(key)
            if e is None:
                events[key] = [1, ins_seq]
            else:
                e[0] += 1

    if not events:
        return {}, []

    # ---- pass 2: apply the best-supported matching event per read --------
    done_rows = []
    out_events = {}
    by_len = {}
    for (ss, elen), (sup, iseq) in events.items():
        by_len.setdefault(elen, []).append((ss, sup, iseq))
    mapq_arr = np.asarray(res["mapq"], np.int32)
    n_anch = np.asarray(res.get("n_anchors", np.ones(len(pos_arr))), np.int32)
    cs_res = np.asarray(res["cov_start"], np.int32) if "cov_start" in res \
        else None
    # event choice per read, then one batched stats pass.  Events are
    # position-sorted per indel length so each read's in-span candidates
    # come from two searchsorted cuts instead of a full scan (the pass
    # previously cost ~read_count * event_count python comparisons).
    ce_res = np.asarray(res["cov_end"], np.int32) if "cov_end" in res else None
    multi_res0 = np.asarray(res["multi"], bool)

    # ---- pass 1.5: multi-event chains from the read's OWN window walk ----
    # One DP window's movement buffer can hold SEVERAL adjacent events
    # (e.g. 3I then 1I three bases apart -> 24M3I3M1I69M), which the
    # reference's explain walk chains into one CIGAR
    # (search_events_to_back/front, core-junction.c:588/:125,
    # MAX_EVENTS_IN_READ=8).  A read whose own proposals hold >= 2 events
    # summing to its net indel gets the chained override directly.
    chained = set()
    overrides = res.get("cigar_override") or {}
    for i in cand:
        props = proposals.get(i)
        if not props or len(props) < 2:
            continue
        ind = int(indel_arr[i])
        if sum(e for (_s, e, _q) in props) != ind:
            continue
        L = int(batch.lengths[i])
        cl0 = int(cl_arr[i]) if cl_arr is not None else 0
        vpos = int(pos_arr[i]) - cl0
        read = read_cache[i]
        evs = sorted(props)
        rc, gc = 0, vpos
        cig = []
        mism = 0
        ok = True
        for (ss, elen, _q) in evs:
            seg = ss - gc + 1
            if seg <= 0 or rc + seg > L:
                ok = False
                break
            mism += int(np.sum(read[rc:rc + seg] != gcodes[gc:gc + seg]))
            cig.append(f"{seg}M")
            rc += seg
            gc += seg
            if elen > 0:
                cig.append(f"{elen}D")
                gc += elen
            else:
                if rc - elen > L:
                    ok = False
                    break
                cig.append(f"{-elen}I")
                rc += -elen
        tailn = L - rc
        if not ok or tailn <= 0 or gc + tailn > glen:
            continue
        mism += int(np.sum(read[rc:L] != gcodes[gc:gc + tailn]))
        cig.append(f"{tailn}M")
        if mism > anchor_mism_limit:
            continue
        nm = mism + sum(abs(e) for (_s, e, _q) in evs)
        overrides[int(i)] = ("".join(cig), mism, nm)
        chained.add(int(i))
        done_rows.append(int(i))
        pos_arr[i] = np.uint32(vpos)
        mism_arr[i] = mism
        if cl_arr is not None:
            cl_arr[i] = 0
        if cr_arr is not None:
            cr_arr[i] = 0
        mapq_arr[i] = 0 if bool(multi_res0[i]) else (
            cfg.mapq_unique // max(1, int(n_anch[i]) + mism)
        )
        mapped_arr[i] = True
        for (ss, elen, iseq) in evs:
            sup0, iseq0 = out_events.get((ss, elen), (0, iseq))
            out_events[(ss, elen)] = (sup0 + 1, iseq0)
    by_len_sorted = {}
    for elen, lst in by_len.items():
        lst.sort(key=lambda t: t[0])
        by_len_sorted[elen] = (
            np.asarray([t[0] for t in lst], np.int64),
            np.asarray([t[1] for t in lst], np.int64),
            [t[2] for t in lst],
        )
    sel = []   # (i, vpos, split, ind, ss, iseq)
    for i in cand:
        if i in chained:
            continue
        L = int(batch.lengths[i])
        cl0 = int(cl_arr[i]) if cl_arr is not None else 0
        vpos = int(pos_arr[i]) - cl0
        ind = int(indel_arr[i])
        ent = by_len_sorted.get(ind)
        if ent is None:
            continue
        ss_arr, sup_arr, iseq_list = ent
        lo = int(np.searchsorted(ss_arr, vpos, "left"))
        hi = int(np.searchsorted(ss_arr, vpos + L + max(0, ind) - 1, "left"))
        if hi <= lo:
            continue
        sup_s = sup_arr[lo:hi]
        max_sup = int(sup_s.max())
        # max support; tie → the read's own proposal, then smaller position
        own = {ss for (ss, elen, _s) in proposals.get(i, ()) if elen == ind}
        pick = -1
        for k in range(lo, hi):
            if int(sup_arr[k]) != max_sup:
                continue
            if int(ss_arr[k]) in own:
                pick = k
                break
            if pick < 0:
                pick = k
        ss = int(ss_arr[pick])
        iseq = iseq_list[pick]
        split = ss - vpos + 1
        if split < 1 or split + max(0, -ind) > L - 1:
            continue
        sel.append((int(i), vpos, split, ind, ss, iseq))

    if sel:
        # batched final-alignment mismatch maps + reference clip stats
        N = len(sel)
        Lmax = int(batch.lengths[[s[0] for s in sel]].max())
        mm_b = np.zeros((N, Lmax), bool)
        lens_b = np.zeros(N, np.int64)
        split_b = np.zeros(N, np.int64)
        ind_b = np.zeros(N, np.int64)
        cs_b = np.zeros(N, np.int64)
        ce_b = np.zeros(N, np.int64)
        for k, (i, vpos, split, ind, ss, iseq) in enumerate(sel):
            L = int(batch.lengths[i])
            read = read_cache.get(i)
            if read is None:
                read = _oriented_codes(batch, i, int(strand_arr[i]))
            g_head = gcodes[vpos:vpos + split]
            mm_b[k, :split] = read[:split] != g_head
            tail_start = split + max(0, -ind)
            g_tail_pos = vpos + split + max(0, ind)
            ntail = L - tail_start
            g_tail = gcodes[g_tail_pos:g_tail_pos + ntail]
            mm_b[k, tail_start:L] = read[tail_start:] != g_tail[:ntail]
            lens_b[k] = L
            split_b[k] = split
            ind_b[k] = ind
            cs_b[k] = int(cs_res[i]) if cs_res is not None else 0
            ce_b[k] = int(ce_res[i]) if ce_res is not None else L
        head_b, tail_b, mism_b, match_b = ref_stats_batch_np(
            mm_b, lens_b, split_b, ind_b, cs_b, ce_b,
            show_clip=cfg.show_soft_clipping,
        )
        multi_res = np.asarray(res["multi"], bool)
        for k, (i, vpos, split, ind, ss, iseq) in enumerate(sel):
            mism = int(mism_b[k])
            if mism > anchor_mism_limit or match_b[k] < 1:
                continue
            head = int(head_b[k])
            tail = int(tail_b[k])
            # in-place: the event CIGAR [hS](split-h)M dD/I mM[tS] is what
            # the emitters format from (pos, split, indel, clips)
            done_rows.append(i)
            pos_arr[i] = np.uint32(vpos + head)
            split_arr[i] = split
            mism_arr[i] = mism
            if cl_arr is not None:
                cl_arr[i] = head
            if cr_arr is not None:
                cr_arr[i] = tail
            mapq_arr[i] = 0 if bool(multi_res[i]) else (
                cfg.mapq_unique // max(1, int(n_anch[i]) + mism)
            )
            ck = (ss, ind)
            sup0, iseq0 = out_events.get(ck, (0, iseq))
            out_events[ck] = (sup0 + 1, iseq0)
            mapped_arr[i] = True
    if done_rows:
        res["pos"] = pos_arr
        res["split"] = split_arr
        res["mism"] = mism_arr
        res["mapq"] = mapq_arr
        res["mapped"] = mapped_arr
        if cl_arr is not None:
            res["clip_l"] = cl_arr
        if cr_arr is not None:
            res["clip_r"] = cr_arr
    if chained:
        res["cigar_override"] = overrides
    return out_events, done_rows




def rescue_clipped_with_events(genome, batch, res, events,
                               max_mismatches: int = 3):
    """Re-explain soft-clipped records across KNOWN indel events.

    The reference's scan-2 event sharing (explain_read over the indel
    event table, core-indel.c): a read whose clip boundary sits just
    past an event discovered by ANOTHER read (typically its own mate)
    gets the event-crossing CIGAR instead of the clip — e.g. the mate of
    a 61M1D39M read comes out 5M1D95M, not 4S96M.  `events` maps
    (small_side_lin, ilen) -> (support, ins_seq); only single-event
    explanations with the [aM dD/kI bM] shape are attempted, matching
    the res-array record format.  Updates res in place; returns the
    number of rescued records.
    """
    if "clip_l" not in res or not events:
        return 0
    gcodes = genome.codes
    G = len(gcodes)
    cl_arr = np.asarray(res["clip_l"], np.int32)
    cr_arr = np.asarray(res["clip_r"], np.int32)
    mapped = np.asarray(res["mapped"], bool)
    indel_arr = np.asarray(res["indel"], np.int32)
    junc = np.asarray(res.get("junc", np.zeros(len(cl_arr), bool)), bool)
    pos_arr = np.asarray(res["pos"], np.uint32)
    strand_arr = np.asarray(res["strand"], np.int32)
    mism_arr = np.asarray(res["mism"], np.int32)
    cand = mapped & (indel_arr == 0) & ~junc & (
        ((cl_arr >= 1) & (cl_arr <= 16)) | ((cr_arr >= 1) & (cr_arr <= 16))
    )
    rows = np.flatnonzero(cand)
    if not len(rows):
        return 0
    # sorted deletion/insertion event arrays for window lookups
    ev = sorted(events)
    ev_pos = np.asarray([e[0] for e in ev], np.int64)
    n_res = 0
    R = len(batch.lengths)
    split_arr = np.asarray(res["split"], np.int32)
    for i in rows:
        if i >= R:
            continue
        L = int(batch.lengths[i])
        oc = batch.codes[i, :L]
        if strand_arr[i] == 1:
            from .. import dna as _dna

            oc = _dna.revcomp(oc)
        cl, cr = int(cl_arr[i]), int(cr_arr[i])
        p = int(pos_arr[i])          # first aligned base (clip-advanced)
        m = L - cl - cr
        best = None
        # head-side: event inside (or just past) the clipped head span —
        # a may exceed cl when the event sits at the alignment boundary
        # (the reference's 5M1D95M mate of a 61M1D39M record)
        if 1 <= cl <= 16:
            lo = np.searchsorted(ev_pos, p - cl - 20 - 1)
            hi = np.searchsorted(ev_pos, p + 18)
            for j in range(lo, hi):
                pos0, ilen = ev[j]
                if ilen > 0:                       # deletion of d
                    d = ilen
                    pstart = p - cl - d
                    a = pos0 - pstart + 1
                    if not (1 <= a <= cl + d + 16) or a >= L or pstart < 0:
                        continue
                    head = oc[:a]
                    mm = int((head != gcodes[pstart : pstart + a]).sum())
                    if a <= cl:
                        # remaining clip bases map right after the event
                        rest = oc[a:cl]
                        mm += int(
                            (rest != gcodes[pos0 + d + 1
                                            : pos0 + d + 1 + len(rest)]).sum()
                        )
                    else:
                        # read[cl:a) moves from the old M region: remove
                        # its old mismatch contribution
                        seg = oc[cl:a]
                        mm -= int((seg != gcodes[p : p + len(seg)]).sum())
                else:                              # insertion of k
                    k = -ilen
                    pstart = p - cl + k
                    a = pos0 - pstart + 1
                    if not (0 <= a <= cl - k) or pstart < 0:
                        continue
                    head = oc[:a]
                    mm = int((head != gcodes[pstart : pstart + a]).sum())
                    rest = oc[a + k : cl]
                    mm += int(
                        (rest != gcodes[pos0 + 1 : pos0 + 1 + len(rest)]).sum()
                    )
                    d = -k
                total = int(mism_arr[i]) + mm
                gain = cl - 2 * mm
                if total <= max_mismatches and gain > 0 and (
                    best is None or total < best[0]
                ):
                    best = (total, pstart, a, d, cr, "head")
        # tail-side: event inside the clipped tail span
        if best is None and 1 <= cr <= 16:
            qe = p + m                              # first genome base past M
            lo = np.searchsorted(ev_pos, qe - 2)
            hi = np.searchsorted(ev_pos, qe + cr + 20)
            for j in range(lo, hi):
                pos0, ilen = ev[j]
                a = pos0 - p + 1                    # M bases before the event
                if ilen > 0:
                    d = ilen
                    if not (m - 16 <= a <= m + cr - 1) or a < 1:
                        continue
                    tail = oc[cl + a :]
                    gpos = pos0 + d + 1
                    if gpos + len(tail) > G:
                        continue
                    mm = int((tail != gcodes[gpos : gpos + len(tail)]).sum())
                    if a > m:
                        # bases between old M end and the event must match
                        mid = oc[cl + m : cl + a]
                        mm += int((mid != gcodes[p + m : p + a]).sum())
                    else:
                        # read[cl+a : cl+m) moves off the old M region
                        seg = oc[cl + a : cl + m]
                        mm -= int((seg != gcodes[p + a : p + m]).sum())
                else:
                    k = -ilen
                    if not (m - 2 <= a <= m + cr - 1 - k) or a < 1:
                        continue
                    tail = oc[cl + a + k :]
                    gpos = pos0 + 1
                    if gpos + len(tail) > G:
                        continue
                    mm = int((tail != gcodes[gpos : gpos + len(tail)]).sum())
                    d = -k
                total = int(mism_arr[i]) + mm
                gain = cr - 2 * mm
                if total <= max_mismatches and gain > 0 and (
                    best is None or total < best[0]
                ):
                    best = (total, p - cl, a, d, 0, "tail")
        if best is None:
            continue
        total, pstart, a, d, new_cr, side = best
        res["pos"] = np.asarray(res["pos"]).copy()
        res["split"] = np.asarray(res["split"]).copy()
        res["indel"] = np.asarray(res["indel"]).copy()
        res["clip_l"] = np.asarray(res["clip_l"]).copy()
        res["clip_r"] = np.asarray(res["clip_r"]).copy()
        res["mism"] = np.asarray(res["mism"]).copy()
        if side == "head":
            res["pos"][i] = np.uint32(pstart)
            res["split"][i] = np.int32(a)
            res["indel"][i] = np.int32(d)
            res["clip_l"][i] = 0
            res["clip_r"][i] = np.int32(new_cr)
        else:
            # tail-side: pos and the head clip stay; split is measured
            # from the unclipped read start ([hS] (split-h)M shape)
            res["split"][i] = np.int32(int(cl_arr[i]) + a)
            res["indel"][i] = np.int32(d)
            res["clip_r"][i] = 0
        res["mism"][i] = np.int32(total)
        n_res += 1
    return n_res


@timing.span("rescue")
def rescue_unmapped_mates(genome, b1, b2, r1, r2, cfg):
    """PE mate-window rescue: an unmapped end whose mate maps gets a
    direct mismatch scan over the mate's fragment window (both strands,
    FR orientation expected).  Needed where an end's subreads were all
    index-filtered as ultra-repetitive (repeat_threshold) so voting
    cannot see its perfect location inside a segmental duplication —
    the reference still pairs these via its PE candidate weighting over
    the full simple lists.  Updates the unmapped end's res in place;
    returns the number rescued."""
    from .. import dna as _dna

    gcodes = genome.codes
    G = len(gcodes)
    n_res = 0
    lim_frac = cfg.max_mismatches
    for (ba, ra, bb, rb) in ((b1, r1, b2, r2), (b2, r2, b1, r1)):
        ma = np.asarray(ra["mapped"], bool)
        mb = np.asarray(rb["mapped"], bool)
        rows = np.flatnonzero(ma & ~mb)
        if not len(rows):
            continue
        pos_a = np.asarray(ra["pos"], np.uint32)
        str_a = np.asarray(ra["strand"], np.int32)
        R = len(bb.lengths)
        for i in rows:
            if i >= R:
                continue
            L = int(bb.lengths[i])
            if L < 32:
                continue
            pa = int(pos_a[i])
            lo = max(pa - cfg.max_fragment - L, 0)
            hi = min(pa + cfg.max_fragment + L, G - L)
            if hi - lo < L:
                continue
            want_strand = 1 - int(str_a[i])
            oc = bb.codes[i, :L]
            if want_strand == 1:
                oc = _dna.revcomp(oc)
            win = np.lib.stride_tricks.sliding_window_view(
                gcodes[lo:hi + L], L
            )
            mms = (win != oc[None, :]).sum(axis=1)
            j = int(np.argmin(mms))
            mm = int(mms[j])
            if mm > lim_frac:
                continue
            for k in ("pos", "strand", "mism", "mapped", "mapq", "multi",
                      "indel", "split", "clip_l", "clip_r"):
                if k in rb:
                    rb[k] = np.asarray(rb[k]).copy()
            rb["pos"][i] = np.uint32(lo + j)
            rb["strand"][i] = np.int32(want_strand)
            rb["mism"][i] = np.int32(mm)
            rb["mapped"][i] = True
            if "multi" in rb:
                rb["multi"][i] = False
            if "indel" in rb:
                rb["indel"][i] = 0
            if "clip_l" in rb:
                rb["clip_l"][i] = 0
                rb["clip_r"][i] = 0
            if "mapq" in rb:
                rb["mapq"][i] = np.int32(
                    cfg.mapq_unique // max(1 + mm, 1)
                )
            n_res += 1
    return n_res
