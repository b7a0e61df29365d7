"""What chip_smoke.py (phases 2, 8, 11 and 13) and profile_probe_hits.py
measure of the probe_hits kernel: its inputs at the smoke's shapes, drawn from a
real vote's probes, and the bytes it must move on them, which give its
bound at the card's memory rate."""

from __future__ import annotations

import torch

from .ops.probe import COMB_W, GROUP
from .ops.vote import probe_inputs

# H100 SXM: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA's data sheet); probe_hits does a few integer operations a slot, so
# its bound is its bytes
HBM_BYTES_PER_S = 3.35e12


def smoke_shapes(al, rows: int, subjunc: bool, tag: str | None = None,
                 tier_rows: tuple[int, int] = (4096, 512)) -> list[tuple]:
    """The three shapes at which the smoke holds the kernel to its plain
    version, for an Aligner al with subread-align's probes (phase 2) or
    subjunc's (phase 8): the main pass (rows reads, all probes, H = max_hits,
    offsets per probe) and the rescue tiers' wide shapes (H = rescue_hits)
    at tier_rows reads, the tiers' capacities at batch_reads 8192.  Each
    is (name, rows, probes, H, shared_off) for probe_shapes; names start
    with tag (default "subjunc-" for subjunc's probes, else "")."""
    if tag is None:
        tag = "subjunc-" if subjunc else ""
    return [(f"{tag}main", rows, None, al.vote_params.max_hits, True),
            (f"{tag}wide-mixed", tier_rows[0], 8, al.rescue_hits, False),
            (f"{tag}wide-full", tier_rows[1], None, al.rescue_hits, subjunc)]


def probe_shapes(al, batch, vp, shapes):
    """The inputs of probe_hits at each of shapes, from the probes the vote
    with VoteParams vp builds from the uploaded reads batch (codes, ambig,
    lengths), on the Aligner's first index block: for each (name, rows,
    probes, H, shared_off), the first rows x probes of them (probes None:
    all), with offsets per probe ([P], as a static-length vote gives them)
    or per read ([R, P]).  Yields (name, rows, probes, H, (keys, valid,
    orient, off), index arguments)."""
    blk = al.dev_index.blocks[0]
    keys, valid, orient, own, _ = probe_inputs(*batch, vp, 100)
    own_rp = own[None, :].expand(keys.shape[0], -1)
    ix = (blk.bucket_start, blk.comb, blk.sub_base, blk.sub_lo,
          blk.bucket_bits, blk.sub_bits, blk.search_steps)
    for name, r, p, H, shared_off in shapes:
        p = keys.shape[1] if p is None else p
        a = (keys[:r, :p].contiguous(), valid[:r, :p].contiguous(),
             orient[:r, :p].contiguous(),
             own[:p].contiguous() if shared_off else own_rp[:r, :p].contiguous())
        yield name, r, p, H, a, ix


def probe_hits_bytes(a, ix, H) -> int:
    """Bytes probe_hits must move on the inputs a = (keys, valid, orient,
    off) and index ix, each input read once and each output written once,
    counting what these inputs need: every probe's key (8), valid and
    orient flags (1 + 1) and offset (4 per element of off); for each valid
    probe its two bucket_start words, its sub_base word when the index has
    a directory, its sub_lo word when its bucket is big, one check word a
    search step, and a position and a check16 (4 + 2) for each slot inside
    its bucket, [lo, min(hi, lo + H)); the kv (8 a slot) and truncated (1 a
    probe) outputs.  lo is found as probe_hits_reference finds it."""
    keys, valid, orient, off = a
    bucket_start, comb, sub_base, sub_lo, bb, sbits, steps = ix
    flat = comb.reshape(-1)
    bucket = keys >> (32 - bb)
    lo = bucket_start[bucket].to(torch.int64)
    hi = bucket_start[bucket + 1].to(torch.int64)
    qcheck = ((keys & ((1 << (32 - bb)) - 1)) << 1) | orient.to(torch.int64)
    big = torch.zeros_like(valid)
    if sbits:
        sb = sub_base[bucket].to(torch.int64)
        big = sb >= 0
        si = (sb.clamp(min=0) + (qcheck >> (33 - bb - sbits))).clamp(max=sub_lo.numel() - 1)
        lo = torch.where(big, sub_lo[si].to(torch.int64), lo)
    if steps:
        cur, length = lo, torch.clamp(hi - lo, max=1 << steps)
        for _ in range(steps):
            half = length >> 1
            mid = cur + half
            wi = ((mid >> 4) * COMB_W + GROUP + ((mid & 15) >> 1)).clamp(0, flat.numel() - 1)
            c = ((flat[wi].to(torch.int64) & 0xFFFFFFFF) >> ((mid & 1) << 4)) & 0xFFFF
            right = (c < qcheck) & (length > 0)
            cur = torch.where(right, mid + 1, cur)
            length = torch.where(right, length - half - 1, torch.minimum(half, length))
        lo = cur
    slots = (hi - lo).clamp(0, H)
    n, v = keys.numel(), valid
    per_valid = 8 + 4 * (sbits > 0) + 4 * big.to(torch.int64) + 4 * steps + 6 * slots
    return int(n * (8 + 1 + 1) + 4 * off.numel() + (per_valid * v).sum().item()
               + n * H * 8 + n)


def bound_ms(nbytes: int) -> float:
    """The least time the card can take to move nbytes."""
    return nbytes / HBM_BYTES_PER_S * 1e3
