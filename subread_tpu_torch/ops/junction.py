"""Exon-exon junction detection in PyTorch: port of
`subread_tpu/ops/junction.py` (subjunc).

Every function returns what its JAX twin returns, bit for bit, with these
conventions (see `subread_tpu_torch.device`):

  * uint32 values (genome positions, event edges) ride in int64 and are
    wrapped with `u32` wherever the JAX code computes in uint32;
  * the JAX code's uint32 -> int32 casts (`split`, `gap` of the event
    rescue) reinterpret the wrapped value as signed: `_i32`;
  * the JAX code casts positions with `astype(jnp.int64)`, which is int32
    without `jax_enable_x64`, so SENTINEL reads as -1 there.  The port
    computes positions in int64 with SENTINEL mapped to -1 (`_pos64`): the
    same values and orders below 2**31, and no wrap above it;
  * sorts are stable and argmax/argmin return the first index, as in JAX.

The functions are torch ops: they run on whatever device their tensors
lie on.  Hand kernels for them are later performance work.
"""

from __future__ import annotations

import torch

from ..device import SENTINEL, u32
from .extend import genome_window, softclip_bounds

MAX_INTRON = 500_000  # core.h:218 default maximum intron length
# base codes (A=0,G=1,C=2,T=3): GT..AG fwd donor, CT..AC rev donor
G, T, A, C = 1, 3, 0, 2


def _i32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor wrapped to int32, as a JAX int32 (or uint32 cast
    to int32) result: two's complement modulo 2**32, as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pos64(pos: torch.Tensor) -> torch.Tensor:
    """Positions as the JAX code's `astype(jnp.int64)` sees them: SENTINEL
    is -1, every other uint32 value itself (int64)."""
    return torch.where(pos == SENTINEL, -1, pos)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[r, idx[r]] per row (take_along_axis with one index per row)."""
    return torch.gather(a, 1, idx[:, None].to(torch.int64))[:, 0]


def _clip_fold(mm_comb, read_len, split, ok, mism, floor: int):
    """The soft-clip fold of a stitched explanation: clip bounds that may
    not consume a side below `floor` bases, no clip when the clips would
    leave fewer than 16 bases, and the mismatches of the kept region."""
    R, L = mm_comb.shape
    cl, cr = softclip_bounds(mm_comb, read_len)
    cl = torch.minimum(cl, torch.clamp(split - floor, min=0))
    cr = torch.minimum(cr, torch.clamp(read_len - split - floor, min=0))
    no_clip = (cl + cr >= read_len - 16) | ~ok
    cl = torch.where(no_clip, 0, cl).to(torch.int32)
    cr = torch.where(no_clip, 0, cr).to(torch.int32)
    pc = torch.cumsum(mm_comb.to(torch.int32), 1, dtype=torch.int32)
    head_mm = torch.where(cl > 0, _take(pc, torch.clamp(cl - 1, min=0)), 0)
    last_keep = torch.clamp(read_len - cr - 1, 0, L - 1)
    upto = _take(pc, last_keep)
    mism_clipped = torch.where(ok, torch.clamp(upto - head_mm, min=0), mism)
    return cl, cr, mism_clipped.to(torch.int32)


def _prefix(mm: torch.Tensor) -> torch.Tensor:
    """[R, L+1] mismatches in read[0:s]."""
    return torch.cumsum(
        torch.nn.functional.pad(mm.to(torch.int32), (1, 0)), 1, dtype=torch.int32
    )


def _suffix(mm: torch.Tensor) -> torch.Tensor:
    """[R, L+1] mismatches in read[s:]."""
    s = torch.flip(torch.cumsum(torch.flip(mm.to(torch.int32), [1]), 1,
                                dtype=torch.int32), [1])
    return torch.nn.functional.pad(s, (0, 1))


def junction_split_scan(genome_u32, oriented, read_len, head_pos, gap, valid,
                        guess_lo=None, guess_hi=None):
    """The junction split with the reference `donor_score` semantics (see
    the JAX function): the canonical donor/acceptor motif, 17-base confirm
    windows that match their own side (at most 1 mismatch) and not the
    other (at least 5), the best matched-own minus matched-other score with
    ties resolved centre-out, then the soft-clip fold.  Returns dict(split,
    mism, clip_l, clip_r, donor_strand) int32 [R] and ok bool [R]."""
    R, L = oriented.shape
    W = 17  # JUNCTION_CONFIRM_WINDOW
    dev = oriented.device
    ar = torch.arange(L, device=dev)[None, :]
    inside = ar < read_len[:, None]
    o = oriented.to(torch.int64)

    win_h = genome_window(genome_u32, head_pos, L + 2)
    win_t = genome_window(genome_u32, u32(head_pos + gap.to(torch.int64) - 2),
                          L + 2)
    mm_h = (win_h[:, :L] != o) & inside
    prefix = _prefix(mm_h)                         # read[0:s] vs LEFT side
    mm_t = (win_t[:, 2: L + 2] != o) & inside
    cum_t = _prefix(mm_t)                          # read[0:s] vs RIGHT side
    total = prefix + _suffix(mm_t)                 # mismatches if split at s

    d1, d2 = win_h[:, 0: L + 1], win_h[:, 1: L + 2]
    a1, a2 = win_t[:, 0: L + 1], win_t[:, 1: L + 2]
    donor_fwd = (d1 == G) & (d2 == T) & (a1 == A) & (a2 == G)
    donor_rev = (d1 == C) & (d2 == T) & (a1 == A) & (a2 == C)

    s_grid = torch.arange(L + 1, device=dev)[None, :]
    in_range = (s_grid >= W) & (s_grid <= read_len[:, None] - W)
    if guess_lo is not None:
        in_range = in_range & (s_grid >= guess_lo[:, None])
    if guess_hi is not None:
        in_range = in_range & (s_grid <= guess_hi[:, None])

    sW = torch.clamp(s_grid - W, 0, L).expand(R, L + 1)
    sPW = torch.clamp(s_grid + W, 0, L).expand(R, L + 1)
    at = lambda cum, idx: torch.gather(cum, 1, idx)
    lmm = prefix - at(prefix, sW)       # read[s-W:s] vs left
    rmm = at(cum_t, sPW) - cum_t        # read[s:s+W] vs right
    lnm = at(prefix, sPW) - prefix      # read[s:s+W] vs left
    rnm = cum_t - at(cum_t, sW)         # read[s-W:s] vs right
    confirm = (lmm <= 1) & (lmm + rmm <= 1) & (lnm >= 5) & (rnm >= 5)

    if guess_lo is not None and guess_hi is not None:
        center = torch.div(guess_lo + guess_hi, 2, rounding_mode="floor")[:, None]
    else:
        center = torch.div(read_len, 2, rounding_mode="floor")[:, None]
    zig = 2 * (s_grid - center).abs() - (s_grid < center).to(torch.int64)
    qual = (lnm + rnm - lmm - rmm).to(torch.int64) * (4 * L) - zig
    NEG = -(1 << 28)
    base_ok = in_range & confirm & valid[:, None]
    qf = torch.where(base_ok & donor_fwd, qual, NEG)
    qr = torch.where(base_ok & donor_rev, qual, NEG)
    sf = torch.argmax(qf, dim=1)
    sr = torch.argmax(qr, dim=1)
    vf, vr = _take(qf, sf), _take(qr, sr)
    use_rev = vr > vf
    split = torch.where(use_rev, sr, sf)
    ok = torch.where(use_rev, vr, vf) > NEG
    mism = torch.where(ok, _take(total, split), 1 << 20)

    # soft-clip fold of the stitched explanation: an exon side keeps at
    # least 8 bases
    mm_comb = torch.where(ar < split[:, None], mm_h, mm_t)
    split = split.to(torch.int32)
    cl, cr, mism_clipped = _clip_fold(mm_comb, read_len, split, ok, mism, 8)
    return dict(split=split, mism=mism_clipped, clip_l=cl, clip_r=cr,
                donor_strand=use_rev.to(torch.int32), ok=ok)


def pick_junction_pair(v, sc, max_indel: int, best=None, read_len=None):
    """(head, tail) clusters: the best candidate and its best compatible
    minor (see the JAX function).  Returns head_pos (uint32 values in
    int64), gap, guess_lo, guess_hi (int32), valid, ambiguous (bool),
    strand, best_pos, best_votes per read."""
    R, K = v.votes.shape
    dev = v.votes.device
    if best is None:
        best = torch.argmax(sc["score_k"], dim=1)   # major cluster index
    take = lambda a: _take(a, best)
    pos_k = _pos64(v.pos)
    b_pos = take(pos_k)
    b_strand = take(v.strand)
    b_cov_start = take(v.cov_start)
    b_cov_end = take(v.cov_end)
    b_valid = take(sc["valid_k"])
    b_votes = take(v.votes)

    same_strand = v.strand == b_strand[:, None]
    diff = pos_k - b_pos[:, None]
    not_self = torch.arange(K, device=dev)[None, :] != best[:, None]
    minor_is_tail = v.cov_start > b_cov_start[:, None]
    expected_sign = torch.where(minor_is_tail, 1, -1)
    gap_abs = diff.abs()
    distinct_cov = ((v.cov_start != b_cov_start[:, None])
                    & (v.cov_end != b_cov_end[:, None]))
    overlapped = torch.where(minor_is_tail, b_cov_end[:, None] - v.cov_start,
                             v.cov_end - b_cov_start[:, None])
    ok = (
        same_strand & not_self & (v.votes >= 1) & distinct_cov
        & (v.votes <= b_votes[:, None])
        & (overlapped <= 14) & (gap_abs >= 6)
        & (gap_abs > max_indel) & (gap_abs <= MAX_INTRON)
        & (torch.sign(diff) == expected_sign)
        & (v.pos != SENTINEL)
    )
    # minor choice: votes desc, coverage length desc, intron length asc,
    # first in table order
    cov_len_m = (v.cov_end - v.cov_start).to(torch.int32)
    vc_m = torch.where(ok, v.votes.to(torch.int32) * (1 << 10) + cov_len_m, -1)
    best_vc_m = vc_m.amax(1, keepdim=True)
    tie_m = ok & (vc_m == best_vc_m) & (best_vc_m >= 0)
    gap_pick_m = torch.where(tie_m, _i32(gap_abs), 1 << 30)
    minor_k = torch.argmin(gap_pick_m, dim=1)
    minor_ok = tie_m.any(1)
    take_n = lambda a: _take(a, minor_k)
    m_pos = take_n(pos_k)
    m_is_tail = take_n(minor_is_tail)
    m_cov_start, m_cov_end = take_n(v.cov_start), take_n(v.cov_end)
    head_pos = torch.where(m_is_tail, b_pos, m_pos)
    tail_pos = torch.where(m_is_tail, m_pos, b_pos)
    gap = _i32(tail_pos - head_pos)
    pair_valid = minor_ok & b_valid & (gap > 0)
    guess_lo = torch.where(m_is_tail, b_cov_end, m_cov_end) - 8
    guess_hi = torch.where(m_is_tail, m_cov_start, b_cov_start) + 8

    # big-margin ambiguity: another distinct location within 1 vote of the
    # best whose forward-read coverage span matches the best's (+-4)
    ambiguous = torch.zeros_like(pair_valid)
    if read_len is not None:
        Lr = read_len[:, None]
        cs_f = torch.where(v.strand == 1, Lr - v.cov_end, v.cov_start)
        ce_f = torch.where(v.strand == 1, Lr - v.cov_start, v.cov_end)
        b_cs = torch.where(b_strand == 1, read_len - b_cov_end, b_cov_start)
        b_ce = torch.where(b_strand == 1, read_len - b_cov_start, b_cov_end)
        ge = v.votes >= b_votes[:, None]
        within = (cs_f >= b_cs[:, None] - 4) & (ce_f <= b_ce[:, None] + 4)
        contains = (cs_f <= b_cs[:, None] + 4) & (ce_f >= b_ce[:, None] - 4)
        same_span = torch.where(ge, within, contains)
        distinct = pos_k != b_pos[:, None]
        n_amb = ((v.votes >= b_votes[:, None] - 1) & same_span & distinct
                 & (v.pos != SENTINEL)).sum(1)
        ambiguous = n_amb >= 1

    return dict(
        head_pos=u32(head_pos), gap=gap, valid=pair_valid, strand=b_strand,
        best_pos=b_pos, best_votes=b_votes, ambiguous=ambiguous,
        guess_lo=guess_lo.to(torch.int32), guess_hi=guess_hi.to(torch.int32),
    )


def candidate_structure(v, read_len, min_votes_second: int = 1,
                        max_simples: int = 3):
    """The reference's per-read candidate bookkeeping (see the JAX
    function): the table-order scan per distinct top vote level, the 3-slot
    big-margin record, the simple list with its cap, and the stored slots.
    Returns simple [R, K] bool, stored_k [R, 3] int32, has_slot [R, 3]
    bool, amb [R, K] bool."""
    R, K = v.votes.shape
    dev = v.votes.device
    alive = v.pos != SENTINEL
    votes = torch.where(alive, v.votes.to(torch.int32), 0)
    karr = torch.arange(K, device=dev)[None, :]

    # distinct top vote levels: top1 > top2 > top3
    top1 = votes.amax(1, keepdim=True)
    v2m = torch.where(votes < top1, votes, 0)
    top2 = v2m.amax(1, keepdim=True)
    v3m = torch.where(v2m < top2, v2m, 0)
    top3 = v3m.amax(1, keepdim=True)                 # floor for big-margin

    # table order: row (creation kv / 5) % 30, then in-row creation order
    bucket = torch.remainder(torch.div(v.anchor, 5, rounding_mode="floor"), 30)
    apk = v.apk if getattr(v, "apk", None) is not None else karr.expand(R, K)
    tkey = torch.where(alive, bucket * (1 << 16) + apk.to(torch.int64), 1 << 30)
    torder = torch.argsort(tkey, dim=1, stable=True)        # table scan
    trank = torch.argsort(torder, dim=1, stable=True)       # rank per candidate
    tk = lambda a: torch.gather(a, 1, torder)
    ut = lambda a: torch.gather(a, 1, trank)

    # first pass (top level) in table order: simple appends + the cap
    lvl_ok = votes >= torch.clamp(top1 - 2, min=1)
    simple_cand = alive & (votes >= min_votes_second)
    s0_t = tk(simple_cand & (votes == top1))
    cum0 = torch.cumsum(s0_t.to(torch.int32), 1)
    appended0_t = s0_t & (cum0 <= max_simples)
    # big-margin inserts precede the append in the same iteration
    processed_t = (cum0 - s0_t.to(torch.int32)) < max_simples
    bm_t = processed_t & tk(alive) & (tk(votes) >= top3)
    # later passes (top2, top3 levels): appends only
    n0 = appended0_t.sum(1, keepdim=True)
    s1_t = tk(simple_cand & (votes == top2) & (top2 > 0))
    appended1_t = s1_t & (n0 + torch.cumsum(s1_t.to(torch.int32), 1) <= max_simples)
    n1 = n0 + appended1_t.sum(1, keepdim=True)
    s2_t = tk(simple_cand & (votes == top3) & (top3 > 0))
    appended2_t = s2_t & (n1 + torch.cumsum(s2_t.to(torch.int32), 1) <= max_simples)
    simple = ut(appended0_t | appended1_t | appended2_t) & lvl_ok
    bm_ins = ut(bm_t)

    # kept big-margin records: top 3 by (votes, later table rank)
    keep_key = torch.where(bm_ins, votes.to(torch.int64) * 64 + trank, -1)
    order3 = torch.argsort(-keep_key, dim=1, stable=True)[:, :3]
    t3 = lambda a: torch.gather(a, 1, order3)
    rec_ok = t3(keep_key) >= 0
    rv = t3(votes)
    Lr = read_len[:, None]
    cs_f = torch.where(v.strand == 1, Lr - v.cov_end, v.cov_start)
    ce_f = torch.where(v.strand == 1, Lr - v.cov_start, v.cov_end)
    rcs, rce = t3(cs_f), t3(ce_f)

    # encounter: records with votes >= candidate-1 whose span matches
    vk, vj = votes[:, :, None], rv[:, None, :]
    csk, cek = cs_f[:, :, None], ce_f[:, :, None]
    csj, cej = rcs[:, None, :], rce[:, None, :]
    inside = (csj >= csk - 4) & (cej <= cek + 4)
    contains = (csj <= csk + 4) & (cej >= cek - 4)
    span_match = torch.where(vk >= vj, inside, contains)
    enc = ((vj >= vk - 1) & rec_ok[:, None, :] & span_match).sum(2)
    amb = (enc > 1) & alive

    # stored slots: simple entries in candidate order, position-deduped,
    # up to 3
    pos = v.pos
    earlier = karr[0][:, None] < karr[0][None, :]          # [K(j), K(k)]: j < k
    dup = ((pos[:, None, :] == pos[:, :, None]) & earlier[None]
           & simple[:, :, None]).any(1)
    stored = simple & ~dup
    rank = torch.cumsum(stored.to(torch.int32), 1) - 1
    stored = stored & (rank < 3)
    stored_k = torch.stack(
        [torch.argmax((stored & (rank == s)).to(torch.uint8), dim=1)
         for s in range(3)], dim=1,
    )
    has_slot = (torch.gather(stored, 1, stored_k)
                & (torch.gather(rank, 1, stored_k)
                   == torch.arange(3, device=dev)[None, :]))
    return dict(simple=simple, stored_k=stored_k.to(torch.int32),
                has_slot=has_slot, amb=amb)


def big_margin_ambiguous(v, read_len, min_votes_second: int = 1):
    """[R, K] `is_ambiguous_voting` flags (see candidate_structure)."""
    return candidate_structure(v, read_len, min_votes_second)["amb"]


def pick_stored_seed_junctions(v, sc, max_indel: int, read_len, cand_ok,
                               min_votes: int = 1, min_votes_second: int = 1,
                               max_simples: int = 3):
    """Per-stored-candidate junction seeding (see the JAX function): each
    stored result of candidate_structure with its own best minor from the
    [R, K, K] compatibility.  Returns dict of [R, 3]: head_pos (uint32
    values in int64), gap, guess_lo, guess_hi (int32), strand, valid."""
    R, K = v.votes.shape
    dev = v.votes.device
    cs = candidate_structure(v, read_len, min_votes_second, max_simples)
    alive = v.pos != SENTINEL
    votes = torch.where(alive, v.votes.to(torch.int32), 0)
    pos = _pos64(v.pos)

    # minor compatibility [R, Kmajor, Kminor]
    same_strand = v.strand[:, :, None] == v.strand[:, None, :]
    diff = pos[:, None, :] - pos[:, :, None]                 # minor - major
    not_self = ~torch.eye(K, dtype=torch.bool, device=dev)[None]
    gap_abs = diff.abs()
    cs_m, ce_m = v.cov_start, v.cov_end
    distinct_cov = ((cs_m[:, None, :] != cs_m[:, :, None])
                    & (ce_m[:, None, :] != ce_m[:, :, None]))
    minor_is_tail = cs_m[:, None, :] > cs_m[:, :, None]
    expected_sign = torch.where(minor_is_tail, 1, -1)
    overlapped = torch.where(minor_is_tail, ce_m[:, :, None] - cs_m[:, None, :],
                             ce_m[:, None, :] - cs_m[:, :, None])
    ok = (
        same_strand & not_self & distinct_cov
        & (votes[:, None, :] >= 1)
        & (votes[:, None, :] <= votes[:, :, None])           # minor <= major
        & (overlapped <= 14) & (gap_abs >= 6)
        & (gap_abs > max_indel) & (gap_abs <= MAX_INTRON)
        & (torch.sign(diff) == expected_sign)
        & alive[:, None, :] & alive[:, :, None]
    )
    cov_len = (ce_m - cs_m).to(torch.int32)
    vc = torch.where(ok, votes[:, None, :] * (1 << 10) + cov_len[:, None, :], -1)
    best_vc = vc.amax(2, keepdim=True)
    tie = ok & (vc == best_vc) & (best_vc >= 0)
    gap_pick = torch.where(tie, _i32(gap_abs), 1 << 30)
    minor_k = torch.argmin(gap_pick, dim=2)                  # [R, Kmajor]
    minor_found = tie.any(2)

    slot_k = cs["stored_k"].to(torch.int64)
    take_s = lambda a: torch.gather(a, 1, slot_k)
    s_pos = take_s(pos)
    s_minor_k = take_s(minor_k)
    m_pos = torch.gather(pos, 1, s_minor_k)
    m_is_tail = m_pos > s_pos
    head_pos = torch.where(m_is_tail, s_pos, m_pos)
    gap = _i32(torch.where(m_is_tail, m_pos, s_pos) - head_pos)
    valid = (
        cs["has_slot"] & ~take_s(cs["amb"]) & take_s(minor_found)
        & take_s(cand_ok) & (take_s(votes) >= min_votes) & (gap > 0)
    )
    s_cs, s_ce = take_s(cs_m), take_s(ce_m)
    m_cs = torch.gather(cs_m, 1, s_minor_k)
    m_ce = torch.gather(ce_m, 1, s_minor_k)
    m_read_tail = m_cs > s_cs          # minor covers the later read part
    guess_lo = torch.where(m_read_tail, s_ce, m_ce) - 8
    guess_hi = torch.where(m_read_tail, m_cs, s_cs) + 8
    return dict(
        head_pos=u32(head_pos), gap=gap, strand=take_s(v.strand), valid=valid,
        guess_lo=guess_lo.to(torch.int32), guess_hi=guess_hi.to(torch.int32),
    )


def junction_rescue(genome_u32, oriented, read_len, pos, ev_left, ev_right,
                    n_cand: int = 4):
    """Re-explain reads against the global junction event table (see the
    JAX function): the n_cand events whose left edge falls inside the read
    span, then the mirrored arm over the events whose right edge does, the
    fewest-mismatch event (nearest on ties) winning, then the soft-clip
    fold.  `ev_left`/`ev_right` hold uint32 values in int64, sorted by left
    edge and padded with SENTINEL.  Returns dict(mism, split, gap, clip_l,
    clip_r) int32 [R], pos (uint32 values in int64) and ok bool."""
    R, L = oriented.shape
    E = ev_left.shape[0]
    dev = oriented.device
    ar = torch.arange(L, device=dev)[None, :]
    inside = ar < read_len[:, None]
    o = oriented.to(torch.int64)
    cand = torch.arange(n_cand, device=dev)[None, :]
    rl = read_len[:, None]

    mm_h = (genome_window(genome_u32, pos, L) != o) & inside
    prefix = _prefix(mm_h)

    # events whose left edge lies inside the read span; the clamp to E-1
    # repeats the last (padding) event, which the wrapped split rejects
    first = torch.searchsorted(ev_left, pos.contiguous())
    cidx = torch.clamp(first[:, None] + cand, max=E - 1)
    c_left, c_right = ev_left[cidx], ev_right[cidx]
    split = _i32(c_left - pos[:, None] + 1)
    gap = _i32(c_right - c_left - 1)
    valid = (split >= 1) & (split <= rl - 1) & (gap > 0) & (cidx < E)

    BIG = 1 << 30
    best_score = torch.full((R,), BIG, dtype=torch.int32, device=dev)
    best_mism = torch.full((R,), 1 << 20, dtype=torch.int32, device=dev)
    best_split = torch.zeros(R, dtype=torch.int32, device=dev)
    best_gap = torch.zeros(R, dtype=torch.int32, device=dev)
    best_pos = pos

    def fold(m, c_split, c_gap, c_valid):
        # mism * 2**20 + gap in int32, wrapping as JAX's does
        score = torch.where(c_valid, _i32(m.to(torch.int64) * (1 << 20) + c_gap), BIG)
        better = score < best_score
        return (better, torch.where(better, score, best_score),
                torch.where(better & c_valid, m, best_mism),
                torch.where(better, c_split, best_split),
                torch.where(better, c_gap, best_gap))

    for c in range(n_cand):
        g_tail = genome_window(genome_u32, u32(pos + gap[:, c]), L)
        suffix = _suffix((g_tail != o) & inside)
        s_c = torch.clamp(split[:, c], 0, L)
        m = _take(prefix, s_c) + _take(suffix, s_c)
        _, best_score, best_mism, best_split, best_gap = fold(
            m, split[:, c], gap[:, c], valid[:, c])

    # mirrored arm: the read anchors the RIGHT exon; the anchor moves to
    # le - split + 1
    r_order = torch.argsort(ev_right, stable=True)
    evr_sorted, evl_sorted = ev_right[r_order], ev_left[r_order]
    first_r = torch.searchsorted(evr_sorted, u32(pos + 1).contiguous())
    cidx_r = torch.clamp(first_r[:, None] + cand, max=E - 1)
    cr_right, cr_left = evr_sorted[cidx_r], evl_sorted[cidx_r]
    split_r = _i32(cr_right - pos[:, None])
    gap_r = _i32(cr_right - cr_left - 1)
    valid_r = (split_r >= 1) & (split_r <= rl - 1) & (gap_r > 0) & (cidx_r < E)
    suffix_h = _suffix(mm_h)
    for c in range(n_cand):
        new_start = u32(cr_left[:, c] - split_r[:, c] + 1)
        pre2 = _prefix((genome_window(genome_u32, new_start, L) != o) & inside)
        s_c = torch.clamp(split_r[:, c], 0, L)
        m = _take(pre2, s_c) + _take(suffix_h, s_c)
        better, best_score, best_mism, best_split, best_gap = fold(
            m, split_r[:, c], gap_r[:, c], valid_r[:, c])
        best_pos = torch.where(better, new_start, best_pos)

    # soft-clip fold on the winning stitched explanation: each flank keeps
    # at least one aligned base
    ok = best_score < BIG
    mm_hw = (genome_window(genome_u32, best_pos, L) != o) & inside
    mm_tw = (genome_window(genome_u32, u32(best_pos + best_gap), L) != o) & inside
    mm_comb = torch.where(ar < best_split[:, None], mm_hw, mm_tw)
    cl, cr, mism_clipped = _clip_fold(mm_comb, read_len, best_split, ok,
                                      best_mism, 1)
    return dict(mism=mism_clipped, split=best_split, gap=best_gap,
                pos=best_pos, clip_l=cl, clip_r=cr, ok=ok)
