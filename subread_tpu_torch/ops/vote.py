"""Seed-and-vote in PyTorch: port of `subread_tpu/ops/vote.py`.

The JAX module is the reference and its docstrings hold the design; this
port computes the same values, bit for bit, with the dtype convention of
`subread_tpu_torch.device` (uint32 values in int64, wrapped with `u32`).
`VoteParams`, `VoteResult`, `applied_subreads` and `static_offsets` are
copies, not imports: the JAX module imports JAX, which the machine with
the card does not have.

The hit gather is `ops.probe.probe_hits`, the port's CUDA kernel, called
through this module's attribute.  The host constants of the vote are made
on the device once per value (`_const`), so that a step queues no
host-to-device copy and a CUDA graph can record it (`align/graphstep.py`).
"""

from __future__ import annotations

import functools
from contextvars import ContextVar
from typing import NamedTuple

import numpy as np
import torch

from ..device import SENTINEL, popcount32, u32
from .probe import probe_hits

KMER = 16

# While a CUDA graph records a step (align/graphstep.py), the recorder
# stands in for each probe_hits launch: it ends the graph there, so that
# the launch itself stays out of every graph.
launch_split: ContextVar = ContextVar("launch_split", default=None)


def _gather(*args):
    split = launch_split.get()
    return probe_hits(*args) if split is None else split(*args)


def _const(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host array a as a tensor on device, made once per value and
    device and shared by every caller, which must not write to it.  Kept for
    the life of the process: a recorded CUDA graph reads it by address."""
    a = np.ascontiguousarray(a)
    return _const_of(a.dtype.str, a.shape, a.tobytes(), torch.device(device))


@functools.cache
def _const_of(dtype: str, shape: tuple, data: bytes, device: torch.device):
    a = np.frombuffer(data, dtype=dtype).reshape(shape).copy()
    return torch.from_numpy(a).to(device)


def _repeat_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    """a.repeat_interleave(n, dim=1) of a 2-D tensor, as a static-shape
    expand: each column n times in a row."""
    return a[:, :, None].expand(-1, -1, n).reshape(a.shape[0], a.shape[1] * n)


class VoteParams(NamedTuple):
    total_subreads: int = 10      # 10 DNA-seq / 14 RNA-seq (core-indel.c:4473)
    max_hits: int = 32            # bucket-window width per probe
    indel_tolerance: int = 5      # cluster tolerance (max indel length, -I)
    window: int = 24              # max cluster candidates scanned per anchor
    top_k: int = 4                # candidate clusters kept per read
    index_gap: int = 1            # 1 = full index (-F), 3 = gapped
    wide_slots: int = 0           # mixed rescue: saturated probes per read
    #                               re-gathered at wide_hits width
    wide_hits: int = 0
    compact: int = 0              # post-sort candidate-stream cut (0 = all)


class VoteResult(NamedTuple):
    """Per-read top-K vote clusters; tensors [R, K] (probe_kv [R, K, P]).
    Field meanings as in subread_tpu.ops.vote.VoteResult; pos, tail,
    anchor and probe_kv hold uint32 values in int64."""

    pos: torch.Tensor
    tail: torch.Tensor
    anchor: torch.Tensor
    votes: torch.Tensor
    strand: torch.Tensor
    cov_start: torch.Tensor
    cov_end: torch.Tensor
    probe_kv: torch.Tensor
    saturated: torch.Tensor
    apk: torch.Tensor = None


def applied_subreads(read_len: int, params: VoteParams) -> int:
    """The reference's per-length probe count (core.c:3116-3129)."""
    L = int(read_len)
    gap = params.index_gap
    if L < KMER:
        return 1
    cr = (L - 15 - gap) << 16
    if L <= 160:
        S = params.total_subreads
        step = max(cr // max(S - 1, 1) if S > 1 else cr, gap << 16)
    else:
        step = 6 << 16
        if cr // step > 62:
            step = cr // 62
    return 1 + cr // max(step, 1)


def static_offsets(read_len: int, params: VoteParams) -> np.ndarray:
    """Probe offsets for one static read length: int32 [applied*gap]."""
    S = params.total_subreads
    gap = params.index_gap
    L = int(read_len)
    cr = (L - 15 - gap) << 16
    if L <= 160:
        step_fx = max(gap << 16, cr // max(S - 1, 1) if S > 1 else cr)
    else:
        step_fx = 6 << 16
        if cr // step_fx > 62:
            step_fx = cr // 62
    n = 1 + cr // max(step_fx, 1)
    base = (np.arange(n, dtype=np.int64) * step_fx) >> 16
    if gap == 1:
        offsets = base
    else:
        base = base - base % gap
        offsets = (base[:, None] + np.arange(gap)[None, :]).reshape(-1)
    return np.minimum(offsets, max(L - KMER, 0)).astype(np.int32)


def subread_offsets(read_len: torch.Tensor, params: VoteParams,
                    n_sub: int) -> tuple[torch.Tensor, np.ndarray]:
    """Probe start offsets per read, int32 [R, n_sub*gap], plus the probe's
    subread id (numpy [P]); int32 arithmetic as the JAX version."""
    S = params.total_subreads
    gap = params.index_gap
    L = read_len.to(torch.int32)[:, None]
    cr = (L - 15 - gap) << 16
    short_fx = torch.clamp(
        cr // max(S - 1, 1) if S > 1 else torch.clamp(cr, min=1),
        min=gap << 16,
    )
    long_fx = torch.where(cr // (6 << 16) > 62, cr // 62, 6 << 16)
    step_fx = torch.where(L <= 160, short_fx, long_fx).to(torch.int32)
    s_idx = torch.arange(n_sub, dtype=torch.int32, device=L.device)[None, :]
    base = (s_idx * step_fx) >> 16
    if gap == 1:
        offsets = base
        sub_id = np.arange(n_sub, dtype=np.int32)
    else:
        phases = torch.arange(gap, dtype=torch.int32, device=L.device)
        base = base - base % gap
        offsets = (base[:, :, None] + phases).reshape(base.shape[0], n_sub * gap)
        sub_id = np.repeat(np.arange(n_sub, dtype=np.int32), gap)
    offsets = torch.minimum(offsets, torch.clamp(L - KMER, min=0))
    return offsets.to(torch.int32), sub_id


_SH16 = 2 * (KMER - 1 - np.arange(KMER))  # base j of a 16-mer at bits 2*(15-j)


def probe_keys_static(codes: torch.Tensor, ambig: torch.Tensor,
                      offsets: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe 16-mer keys at static offsets: (int64 [R, P] keys, bool [R, P]
    window ambiguity)."""
    dev = codes.device
    cols = _const(
        (offsets.astype(np.int64)[:, None] + np.arange(KMER)).reshape(-1), dev
    )
    sh = _const(_SH16, dev)
    R, P = codes.shape[0], len(offsets)
    c = codes[:, cols].to(torch.int64).reshape(R, P, KMER)
    keys = (c << sh).sum(-1)
    wa = ambig[:, cols].reshape(R, P, KMER).any(-1)
    return keys, wa


def rolling_keys(codes: torch.Tensor, ambig: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-offset 16-mer keys and window ambiguity over whole reads
    (windows past the right edge read zero padding, as the JAX version)."""
    R, L = codes.shape
    pc = torch.nn.functional.pad(codes.to(torch.int64), (0, KMER - 1))
    pa = torch.nn.functional.pad(ambig.to(torch.uint8), (0, KMER - 1))
    sh = _const(_SH16, codes.device)
    keys = (pc.unfold(1, KMER, 1) << sh).sum(-1)
    wamb = pa.unfold(1, KMER, 1).amax(-1) != 0
    return keys, wamb


def revcomp_keys(keys: torch.Tensor) -> torch.Tensor:
    """Reverse complement of packed 16-mer keys (uint32 values in int64)."""
    x = u32(~keys)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return u32(x << 16) | (x >> 16)


def _pad2(a: torch.Tensor, W: int, value) -> torch.Tensor:
    return torch.nn.functional.pad(a, (W, W), value=value)


def _vote_merged(kv: torch.Tensor, payload: torch.Tensor, params: VoteParams,
                 n_sub: int | None = None):
    """Sorted-stream anchored cluster votes (subread_tpu.ops.vote.
    _vote_merged).  Returns sorted (kv, votes, strand, pk) and the
    overflow flag (None when neither cut applies)."""
    R, C = kv.shape
    S = params.total_subreads if n_sub is None else n_sub
    # stable sort on kv alone: equal kv keep their column order, which the
    # anchor test's left window depends on
    kv_s, order = torch.sort(kv, dim=-1, stable=True)
    pay_s = torch.gather(payload, 1, order)
    CC = params.compact
    overflow = None
    if CC and CC < C:
        overflow = kv_s[:, CC] != SENTINEL
        kv_s = kv_s[:, :CC]
        pay_s = pay_s[:, :CC]
        C = CC
    strand_su = (pay_s >> 12) & 1
    strand_s = strand_su.to(torch.int32)
    sub_s = (pay_s >> 13) & 0x3F
    dual = S > 32
    if dual:
        mask_s = torch.where(sub_s < 32, 1 << sub_s.clamp(max=31), 0)
        mask_hi_s = torch.where(sub_s >= 32, 1 << (sub_s - 32).clamp(min=0), 0)
    else:
        mask_s = 1 << sub_s
        mask_hi_s = None
    # int16 anchor-ordering key packed with the strand, as the JAX version
    pk_s = ((pay_s >> 19) & 0xFF).to(torch.int16)
    sflip = strand_su.to(torch.int16) << 8
    spk_s = pk_s | sflip

    W = min(params.window, C)
    tol = params.indel_tolerance
    tol2 = 2 * params.indel_tolerance
    BIGPK = 0x7FFF
    pad_kv = _pad2(kv_s, W, SENTINEL)
    pad_mask = _pad2(mask_s, W, 0)
    pad_mask_hi = _pad2(mask_hi_s, W, 0) if dual else None
    pad_spk = _pad2(spk_s, W, 0x3FFF)

    # span-overflow guard (uint32 difference, as JAX)
    kvW = pad_kv[:, 2 * W: 2 * W + C]
    span_over = ((u32(kvW - kv_s) <= tol) & (kv_s != SENTINEL)).any(1)
    overflow = span_over if overflow is None else (overflow | span_over)

    def cand_at(d):
        kd = pad_kv[:, d: d + C]
        in_w = u32(kd - kv_s + tol) <= tol2
        spkd = pad_spk[:, d: d + C]
        return torch.where(in_w, spkd ^ sflip, BIGPK)

    minpk = torch.full((R, C), 0x7FFF, dtype=torch.int16, device=kv.device)
    leftpk = minpk.clone()
    for d in range(W):
        cand = cand_at(d)
        minpk = torch.minimum(minpk, cand)
        leftpk = torch.minimum(leftpk, cand)
    for d in range(W, 2 * W + 1):
        minpk = torch.minimum(minpk, cand_at(d))
    is_anchor = (minpk == pk_s) & (leftpk > pk_s) & (kv_s != SENTINEL)

    # first-match slot assignment: nearest same-strand anchor left/right
    own_kv = torch.where(is_anchor, kv_s, 0)
    aL0 = torch.cummax(torch.where(strand_s == 0, own_kv, 0), 1).values
    aL1 = torch.cummax(torch.where(strand_s == 1, own_kv, 0), 1).values
    aL = torch.where(strand_s == 1, aL1, aL0)
    own_kv_r = torch.where(is_anchor, kv_s, SENTINEL)

    def rev_cummin(a):
        return torch.flip(torch.cummin(torch.flip(a, [1]), 1).values, [1])

    aR0 = rev_cummin(torch.where(strand_s == 0, own_kv_r, SENTINEL))
    aR1 = rev_cummin(torch.where(strand_s == 1, own_kv_r, SENTINEL))
    aR = torch.where(strand_s == 1, aR1, aR0)
    okL = (aL > 0) & (u32(kv_s - aL) <= tol)
    okR = (aR != SENTINEL) & (u32(aR - kv_s) <= tol)
    bL = aL // 5 - kv_s // 5
    bR = aR // 5 - kv_s // 5
    rkL = torch.where(bL == 0, 0, -2 * bL)
    rkR = torch.where(bR == 0, 0, 2 * bR - 1)
    assigned = torch.where(
        okL & (~okR | (rkL <= rkR)), aL, torch.where(okR, aR, SENTINEL)
    )
    assigned = torch.where(kv_s == SENTINEL, SENTINEL - 1, assigned)

    # per-slot distinct-subread accumulation over assigned members
    asg_key = torch.where(
        kv_s == SENTINEL, 0xFFFFFFFD, u32(assigned << 1) | strand_su
    )
    own_key = u32(kv_s << 1) | strand_su
    pad_asg = _pad2(asg_key, W, 0xFFFFFFFE)
    acc_mask = torch.zeros_like(mask_s)
    acc_hi = torch.zeros_like(mask_s) if dual else None
    for d in range(2 * W + 1):
        hit = pad_asg[:, d: d + C] == own_key
        acc_mask |= torch.where(hit, pad_mask[:, d: d + C], 0)
        if dual:
            acc_hi |= torch.where(hit, pad_mask_hi[:, d: d + C], 0)
    votes = popcount32(acc_mask)
    if dual:
        votes = votes + popcount32(acc_hi)
    votes = torch.where(is_anchor, votes.to(torch.int32), 0)
    return kv_s, votes, strand_s, pk_s.to(torch.int32), overflow


def _top_k(work, minor, kv, strand, K: int, tol: int):
    """Greedy top-K (vote level desc, minor key asc, kv asc, column asc)
    with same-strand suppression within +-tol; returns (sel_idx, votes)."""
    R, C = work.shape
    BIGU = 0xFFFFFFFF
    col = torch.arange(C, dtype=torch.int64, device=work.device)[None, :]
    sel_idx = torch.zeros((R, K), dtype=torch.int64, device=work.device)
    sel_votes = torch.zeros((R, K), dtype=torch.int32, device=work.device)
    for k in range(K):
        vmax = work.amax(-1, keepdim=True)
        lvl = (work == vmax) & (work > 0)
        m1 = torch.where(lvl, minor, BIGU).amin(-1, keepdim=True)
        cand = lvl & (minor == m1)
        mkv = torch.where(cand, kv, BIGU).amin(-1, keepdim=True)
        cand = cand & (kv == mkv)
        best = torch.where(cand, col, 1 << 30).amin(-1)
        bestc = best.clamp(max=C - 1)
        sel_idx[:, k] = bestc
        sel_votes[:, k] = torch.clamp(vmax[:, 0], min=0)
        bkv = torch.gather(kv, 1, bestc[:, None])
        bstrand = torch.gather(strand, 1, bestc[:, None])
        diff = u32(kv - bkv)
        near = (diff <= tol) | (u32(-diff) <= tol)
        work = torch.where(near & (strand == bstrand), 0, work)
    return sel_idx, sel_votes


def probe_inputs(codes: torch.Tensor, ambig: torch.Tensor,
                 read_len: torch.Tensor, params: VoteParams,
                 static_len: int | None = None):
    """The probes of both strand scans, as vote_batch builds them: all
    forward-read probes, then all probes of the reversed read on the same
    offset grid (do_voting, core.c:3110-3186).  Returns (canonical keys
    int64 [R, P], valid bool [R, P], required stored orientation bool
    [R, P], own-scan offsets int32 — [P] when static_len is given, else
    [R, P] — and n_sub, the probes per scan before gap phases)."""
    R, L = codes.shape
    dev = codes.device
    gap = max(params.index_gap, 1)
    n_sub = applied_subreads(
        static_len if static_len is not None and static_len >= KMER else L,
        params,
    )
    P0 = n_sub * gap
    rev = _const(np.arange(2 * P0) >= P0, dev)[None, :]
    if static_len is not None and static_len >= KMER:
        offs_f = static_offsets(static_len, params)
        extract_np = np.concatenate([offs_f, static_len - KMER - offs_f])
        keys_raw, wamb_p = probe_keys_static(codes, ambig, extract_np)
        rck = revcomp_keys(keys_raw)
        keys = torch.minimum(keys_raw, rck)
        # flip_req: the stored orientation that makes a hit match this
        # probe (probe kmer = raw for forward probes, revcomp for reverse)
        flip_req = torch.where(rev, keys != rck, keys != keys_raw)
        valid = ~wamb_p & (read_len[:, None] >= static_len)
        own = _const(np.concatenate([offs_f, offs_f]).astype(np.int32), dev)
    else:
        offsets_f, _ = subread_offsets(read_len, params, n_sub)
        extract = torch.cat(
            [offsets_f, torch.clamp(read_len[:, None] - KMER - offsets_f, min=0)],
            dim=1,
        )
        keymat, wamb = rolling_keys(codes, ambig)
        rcmat = revcomp_keys(keymat)
        canonmat = torch.minimum(keymat, rcmat)
        in_read = (extract + KMER <= read_len[:, None]) & (read_len[:, None] >= KMER)
        off_c = extract.clamp(0, L - 1).to(torch.int64)
        keys = torch.gather(canonmat, 1, off_c)
        flip_req = torch.where(
            rev,
            torch.gather(canonmat != rcmat, 1, off_c),
            torch.gather(canonmat != keymat, 1, off_c),
        )
        valid = in_read & ~torch.gather(wamb, 1, off_c)
        own = torch.cat([offsets_f, offsets_f], dim=1).contiguous()
    return keys, valid, flip_req, own, n_sub


def vote_batch(
    codes: torch.Tensor,        # uint8 [R, L]
    ambig: torch.Tensor,        # bool [R, L]
    read_len: torch.Tensor,     # int32 [R]
    bucket_start: torch.Tensor,
    comb_rows: torch.Tensor,    # int32 [G, 24]
    bucket_bits: int,
    params: VoteParams,
    static_len: int | None = None,
    sub_base: torch.Tensor | None = None,
    sub_lo: torch.Tensor | None = None,
    sub_bits: int = 0,
    search_steps: int = 0,
) -> VoteResult:
    """Full vote step for a read batch over both strands (see
    subread_tpu.ops.vote.vote_batch)."""
    R = codes.shape[0]
    dev = codes.device
    H = params.max_hits
    gap = max(params.index_gap, 1)
    keys, valid, flip_req, own, n_sub = probe_inputs(
        codes, ambig, read_len, params, static_len
    )
    P0 = n_sub * gap
    is_rev_p = np.arange(2 * P0) >= P0
    P = 2 * P0
    C0 = P * H
    gather = lambda k, v, o, p, hh: _gather(
        k.contiguous(), v.contiguous(), o.contiguous(), p, bucket_start,
        comb_rows, sub_base, sub_lo, bucket_bits, sub_bits, search_steps, hh,
    )
    kv3, trunc = gather(keys, valid, flip_req, own, H)              # [R, C0]

    # static per-probe metadata: strand, own-scan subread id, arrival index
    sn_np = np.tile(np.repeat(np.arange(n_sub), gap), 2)
    pk_np = np.concatenate([np.arange(P0), np.arange(P0)])
    meta_np = is_rev_p.astype(np.int64) << 12 | sn_np << 13 | pk_np << 19
    meta = _const(meta_np, dev)                                     # [P]
    own_full = own.expand(R, P) if own.dim() == 1 else own
    strand_full = _const(is_rev_p.astype(np.int64), dev).expand(R, P)
    off3 = _repeat_cols(own_full, H)                                # [R, C0]
    payload = off3.to(torch.int64) | _const(np.repeat(meta_np, H), dev)[None, :]
    strand3 = _const(np.repeat(is_rev_p.astype(np.int64), H), dev).expand(R, C0)

    E = params.wide_slots
    trunc_w = None
    if E:
        # mixed-width rescue: re-gather the first E truncated probes of
        # each read at wide_hits width
        HW = params.wide_hits
        sel = torch.argsort((~trunc).to(torch.uint8), dim=1, stable=True)[:, :E]
        take_p = lambda a: torch.gather(a, 1, sel)
        sel_trunc = take_p(trunc)
        own_w = take_p(own_full).to(torch.int32)
        kv_w, trunc_ww = gather(take_p(keys), sel_trunc, take_p(flip_req), own_w, HW)
        trunc_w = trunc_ww.any(1) | (trunc.to(torch.int32).sum(1) > E)
        off_w = _repeat_cols(own_w, HW)
        payload_w = off_w.to(torch.int64) | _repeat_cols(
            torch.gather(meta.expand(R, P), 1, sel), HW
        )
        strand_w = _repeat_cols(take_p(strand_full), HW)
        kv3 = torch.cat([kv3, kv_w], dim=1)
        payload = torch.cat([payload, payload_w], dim=1)
        strand3 = torch.cat([strand3, strand_w], dim=1)
        off3 = torch.cat([off3, off_w], dim=1)
    kv_s, votes, strand_s, pk_s, overflow = _vote_merged(
        kv3, payload, params, n_sub
    )

    # top-K in the reference's simple-list order (see the JAX version)
    K = params.top_k
    tol = params.indel_tolerance
    row30 = (kv_s // 5) % 30
    arrival = strand_s.to(torch.int64) * P0 + pk_s
    minor = (row30 << 9) | arrival.clamp(max=511)
    sel_idx, sel_votes = _top_k(votes, minor, kv_s, strand_s, K, tol)
    take = lambda a: torch.gather(a, 1, sel_idx)
    sel_kv = take(kv_s)
    sel_strand = take(strand_s)
    sel_apk = take(arrival).to(torch.int32)

    # one [R, K, C] membership pass over the unsorted candidate stream
    neg = (1 << 32) - params.indel_tolerance
    kv3_m = kv3[:, None, :]
    diff_p = u32(kv3_m - sel_kv[:, :, None])
    member = (
        ((diff_p <= tol) | (diff_p >= neg))
        & (kv3_m != SENTINEL)
        & (strand3[:, None, :] == sel_strand[:, :, None])
    )
    off3_m = off3[:, None, :]
    sel_covmin = torch.where(member, off3_m, 1 << 30).amin(-1)
    sel_covmax = torch.where(member, off3_m, -1).amax(-1)
    sel_head = torch.where(
        member & (off3_m == sel_covmin[:, :, None]), kv3_m, SENTINEL
    ).amin(-1)
    sel_tail = torch.where(
        member & (off3_m == sel_covmax[:, :, None]), kv3_m, SENTINEL
    ).amin(-1)
    masked_kv = torch.where(member, kv3_m, SENTINEL)
    sel_pkv = masked_kv[:, :, :C0].reshape(R, K, P, H).amin(-1)
    if E:
        wide_min = masked_kv[:, :, C0:].reshape(R, K, E, HW).amin(-1)
        oh = sel[:, :, None] == torch.arange(P, device=dev)          # [R, E, P]
        contrib = torch.where(
            oh[:, None, :, :], wide_min[:, :, :, None], SENTINEL
        ).amin(2)                                                    # [R, K, P]
        sel_pkv = torch.minimum(sel_pkv, contrib)

    empty = sel_votes <= 0
    sat = trunc_w if trunc_w is not None else trunc.any(1)
    return VoteResult(
        pos=torch.where(empty, SENTINEL, sel_head),
        tail=torch.where(empty, SENTINEL, sel_tail),
        anchor=torch.where(empty, SENTINEL, sel_kv),
        votes=sel_votes,
        strand=sel_strand,
        cov_start=torch.where(empty, 0, sel_covmin).to(torch.int32),
        cov_end=torch.where(empty, 0, sel_covmax + KMER).to(torch.int32),
        probe_kv=torch.where(empty[:, :, None], SENTINEL, sel_pkv),
        saturated=sat | overflow if overflow is not None else sat,
        apk=torch.where(empty, 1 << 29, sel_apk),
    )


def merge_vote_results(a: VoteResult, b: VoteResult,
                       params: VoteParams) -> VoteResult:
    """Merge two top-K vote tables (block-split index): re-selected top-K,
    overlapping same-strand clusters keep the max of their votes."""
    K = params.top_k
    cat = lambda x, y: torch.cat([x, y], dim=1)
    pos = cat(a.pos, b.pos)
    tail = cat(a.tail, b.tail)
    anchor = cat(a.anchor, b.anchor)
    votes = cat(a.votes, b.votes)
    strand = cat(a.strand, b.strand)
    cov_s = cat(a.cov_start, b.cov_start)
    cov_e = cat(a.cov_end, b.cov_end)
    pkv = cat(a.probe_kv, b.probe_kv)
    apk_a = a.apk if a.apk is not None else torch.zeros_like(a.votes)
    apk_b = b.apk if b.apk is not None else torch.zeros_like(b.votes)
    apk = cat(apk_a, apk_b)
    row30 = (anchor // 5) % 30
    minor = (row30 << 9) | apk.to(torch.int64).clamp(0, 511)
    sel_idx, sel_votes = _top_k(
        votes, minor, anchor, strand, K, params.indel_tolerance
    )
    take = lambda arr: torch.gather(arr, 1, sel_idx)
    empty = sel_votes <= 0
    return VoteResult(
        pos=torch.where(empty, SENTINEL, take(pos)),
        tail=torch.where(empty, SENTINEL, take(tail)),
        anchor=torch.where(empty, SENTINEL, take(anchor)),
        votes=torch.clamp(sel_votes, min=0),
        strand=take(strand),
        cov_start=torch.where(empty, 0, take(cov_s)),
        cov_end=torch.where(empty, 0, take(cov_e)),
        probe_kv=torch.gather(
            pkv, 1, sel_idx[:, :, None].expand(-1, -1, pkv.shape[2])
        ),
        saturated=a.saturated | b.saturated,
        apk=torch.where(empty, 1 << 29, take(apk)),
    )
