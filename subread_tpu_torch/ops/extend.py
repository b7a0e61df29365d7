"""Scan-2 realignment in PyTorch: port of `subread_tpu/ops/extend.py`.

Genome windows, read orientation, the single-indel split scan, the
reference soft-clip statistics and the max-scoring soft-clip window of the
junction scans, bit-equal to the JAX functions.  The
packed genome is an int64 tensor of uint32 words (see
`subread_tpu_torch.device`).  Gathers that JAX clamps are clamped here
explicitly.
"""

from __future__ import annotations

import torch

from ..device import u32


def _shl(a: torch.Tensor, k: int) -> torch.Tensor:
    """Columns shifted left by k, zero fill at the right (jnp.pad of a[:, k:])."""
    return torch.nn.functional.pad(a[:, k:], (0, k))


def _shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Columns shifted right by k, zero fill at the left."""
    return torch.nn.functional.pad(a[:, : a.shape[1] - k], (k, 0))


def genome_base(genome_u32: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """2-bit bases at linear positions (any shape)."""
    word = genome_u32[torch.clamp(pos >> 4, max=genome_u32.numel() - 1)]
    return (word >> ((pos & 15) << 1)) & 3


def genome_window(genome_u32: torch.Tensor, start: torch.Tensor,
                  L: int) -> torch.Tensor:
    """Bases of genome[start : start+L] per row — int64 [R, L].  The words
    w0 .. w0+nw-1 are exactly what the JAX row-gather path assembles."""
    nw = L // 16 + 2
    G = genome_u32.numel()
    w0 = torch.clamp(start >> 4, max=max(G - nw, 0))
    widx = w0[:, None] + torch.arange(nw, device=start.device)
    w = genome_u32[widx.clamp(max=G - 1)]
    ph = ((start & 15) << 1)[:, None]
    shifted = (w[:, :-1] >> ph) | torch.where(
        ph > 0, u32(w[:, 1:] << (32 - ph)), 0
    )
    sh = 2 * torch.arange(16, device=start.device)
    bases = ((shifted[:, :, None] >> sh) & 3).reshape(shifted.shape[0], -1)
    return bases[:, :L]


def oriented_read(codes: torch.Tensor, read_len: torch.Tensor,
                  strand: torch.Tensor, uniform_len: int | None = None
                  ) -> torch.Tensor:
    """Read codes in genome orientation: reverse-complemented where
    strand == 1 (uint8 [R, L], padded right)."""
    R, L = codes.shape
    if uniform_len is not None:
        rc = 3 - torch.flip(codes[:, :uniform_len], [1])
        if L > uniform_len:
            rc = torch.nn.functional.pad(rc, (0, L - uniform_len))
    else:
        ridx = read_len[:, None].to(torch.int64) - 1 - torch.arange(
            L, device=codes.device
        )
        rc = 3 - torch.gather(codes, 1, ridx.clamp(0, L - 1))
    return torch.where(strand[:, None] == 1, rc, codes)


def mismatch_matrix(genome_u32, oriented, read_len, pos) -> torch.Tensor:
    """bool [R, L]: read base i differs from genome base pos+i (False
    beyond read_len)."""
    R, L = oriented.shape
    g = genome_window(genome_u32, pos, L)
    inside = torch.arange(L, device=pos.device)[None, :] < read_len[:, None]
    return (g != oriented.to(torch.int64)) & inside


def place_single_indel(genome_u32, oriented, read_len, head_pos, indel,
                       max_indel_static: int = 16):
    """Optimal split for a single indel of known size (see the JAX
    function).  Returns (split int32 [R], mismatches int32 [R],
    mm_head bool [R, L], mm_tail bool [R, L]) — the JAX function's
    return_head_prefix="mm" form, the only one the pipeline uses.
    The tail shift reads suffix[min(s + ins, L)] directly, which is what
    the JAX where-chain over ins = 1..max_indel_static selects (an insertion
    longer than that leaves the suffix unshifted there, and here)."""
    R, L = oriented.shape
    dev = oriented.device
    ar = torch.arange(L, device=dev)[None, :]
    inside = ar < read_len[:, None]
    mm_head = mismatch_matrix(genome_u32, oriented, read_len, head_pos)
    prefix = torch.cumsum(
        torch.nn.functional.pad(mm_head.to(torch.int32), (1, 0)), 1
    )
    g_tail = genome_window(genome_u32, u32(head_pos + indel), L)
    mm_tail = (g_tail != oriented.to(torch.int64)) & inside
    suffix = torch.flip(torch.cumsum(torch.flip(mm_tail.to(torch.int32), [1]), 1), [1])
    suffix = torch.nn.functional.pad(suffix, (0, 1))              # [R, L+1]
    ins_len = torch.clamp(-indel, min=0).to(torch.int64)[:, None]
    s_grid = torch.arange(L + 1, device=dev)[None, :]
    ins_sh = torch.where(ins_len <= max_indel_static, ins_len, 0)
    tail_sel = torch.gather(suffix, 1, torch.clamp(s_grid + ins_sh, max=L))
    total = prefix + tail_sel
    valid = (s_grid >= 1) & (s_grid + ins_len <= read_len[:, None] - 1)
    total = torch.where(valid, total, 1 << 20)
    split = torch.argmin(total, dim=1)            # first minimum, as JAX
    best = torch.gather(total, 1, split[:, None])[:, 0]
    return split.to(torch.int32), best.to(torch.int32), mm_head, mm_tail


_SC_WINDOW = 5
_SC_MAX_ERROR = 1


def ref_clip_stats(mm_head, mm_tail, read_len, split, indel, cov_start,
                   cov_end, show_clip: bool = True):
    """The reference's final-alignment soft clips and mismatch/match counts
    (find_soft_clipping + final_CIGAR_quality); returns (head_clip,
    tail_clip, mism, match) int32 [R]."""
    R, L = mm_head.shape
    j = torch.arange(L, device=mm_head.device)[None, :]
    rl = read_len[:, None].to(torch.int64)
    ins = torch.clamp(-indel, min=0).to(torch.int64)[:, None]
    single = (indel == 0)[:, None]
    splitc = torch.where(single, rl, split[:, None].to(torch.int64))
    sec2_start = torch.where(single, 0, splitc + ins)
    in_sec1 = j < splitc
    in_sec2 = (j >= sec2_start) & (j < rl)
    mm = torch.where(in_sec1, mm_head, mm_tail) & (in_sec1 | in_sec2)
    mt = ~mm & (in_sec1 | in_sec2)

    # head scan (first M section)
    test1 = splitc
    c0 = cov_start[:, None].to(torch.int64)
    s0h = torch.where(c0 < 0, 0, torch.where(c0 >= test1, test1 - 1, c0 + 1))
    mmh = (mm & (j <= s0h)).to(torch.int32)
    win_h = mmh
    for dsh in range(1, _SC_WINDOW):
        win_h = win_h + _shl(mmh, dsh)
    trip_h = (win_h > _SC_MAX_ERROR) & (j <= s0h)
    tripped_h = trip_h.any(1, keepdim=True)
    jt_h = torch.where(trip_h, j, -1).amax(1, keepdim=True)
    lo_h = torch.where(tripped_h, jt_h, 0)
    m_h = mt & (j >= lo_h) & (j <= s0h)
    has_m_h = m_h.any(1, keepdim=True)
    lm_h = torch.where(m_h, j, 1 << 20).amin(1, keepdim=True)
    head = torch.where(has_m_h, lm_h, torch.where(tripped_h, s0h - 1, test1))
    head = torch.where(head >= test1, 0, head)
    head = torch.clamp(head, min=0)

    # tail scan (last M section)
    test2 = rl - sec2_start
    c1 = cov_end[:, None].to(torch.int64) - sec2_start
    s0t_rel = torch.where(c1 < 0, 0, torch.where(c1 >= test2, test2 - 1, c1 - 1))
    s0t = sec2_start + s0t_rel
    mmt = (mm & (j >= s0t)).to(torch.int32)
    win_t = mmt
    for dsh in range(1, _SC_WINDOW):
        win_t = win_t + _shr(mmt, dsh)
    trip_t = (win_t > _SC_MAX_ERROR) & (j >= s0t) & (j < rl)
    tripped_t = trip_t.any(1, keepdim=True)
    jt_t = torch.where(trip_t, j, 1 << 20).amin(1, keepdim=True)
    hi_t = torch.where(tripped_t, jt_t, rl - 1)
    m_t = mt & (j <= hi_t) & (j >= s0t)
    has_m_t = m_t.any(1, keepdim=True)
    lm_t = torch.where(m_t, j, -1).amax(1, keepdim=True)
    tail = torch.where(
        has_m_t, rl - 1 - lm_t, torch.where(tripped_t, test2 - s0t_rel, test2)
    )
    tail = torch.where(tail >= test2, 0, tail)
    tail = torch.clamp(tail, min=0)

    if not show_clip:
        head = torch.zeros_like(head)
        tail = torch.zeros_like(tail)
    else:
        both_gone = single & (head + tail >= rl - 1)
        head = torch.where(both_gone, 0, head)
        tail = torch.where(both_gone, 0, tail)

    keep = (j >= head) & (j < rl - tail)
    mism = (mm & keep).sum(1)
    non_clipped = rl[:, 0] - head[:, 0] - tail[:, 0]
    match = non_clipped - mism - ins[:, 0]
    i32 = lambda a: a.to(torch.int32)
    return i32(head[:, 0]), i32(tail[:, 0]), i32(mism), i32(match)


def softclip_bounds(mm: torch.Tensor, read_len: torch.Tensor):
    """Soft-clip bounds (clip_left, clip_right) int32 [R] of a mismatch
    profile bool [R, L]: keep the window [a, b) maximising match - 3 *
    mismatch, with the smallest clip on both sides among ties (see the JAX
    function; used by both junction scans)."""
    R, L = mm.shape
    dev = mm.device
    inside = torch.arange(L, device=dev)[None, :] < read_len[:, None]
    w = torch.where(inside, torch.where(mm, -3, 1), 0).to(torch.int32)
    S = torch.nn.functional.pad(torch.cumsum(w, 1, dtype=torch.int32), (1, 0))
    pm = torch.cummin(S, 1).values                 # min over a <= b of S[a]
    b = torch.argmax(S - pm, dim=1)                # first maximum, as JAX
    minv = torch.gather(pm, 1, b[:, None])
    idx = torch.arange(L + 1, device=dev)[None, :]
    a = torch.argmax(((S == minv) & (idx <= b[:, None])).to(torch.uint8), dim=1)
    rl = read_len.to(torch.int64)
    clip_left = a
    clip_right = torch.clamp(rl - b, min=0)
    too_much = clip_left + clip_right >= rl
    clip_left = torch.where(too_much, 0, clip_left)
    clip_right = torch.where(too_much, 0, clip_right)
    return clip_left.to(torch.int32), clip_right.to(torch.int32)
