"""The bytes the probe_hits kernel must move, and the least time the card
can take to move them.

Copied from `subread_tpu_torch/probe_bench.py` (`probe_hits_bytes`,
`bound_ms`, `HBM_BYTES_PER_S`) and the layout constants of
`subread_tpu_torch/ops/probe.py` (`GROUP`, `COMB_W`), at commit
7c152797eaed1811dec0341cbdfcc3f26f815f9f, so that the yardstick of a kernel
later changes rewrite stays as it is.  Only the import of the constants
changed.
"""

from __future__ import annotations

import torch

GROUP = 16                    # index entries per comb row
COMB_W = GROUP + GROUP // 2   # 16 positions + 8 packed check16 words

# H100 SXM: HBM3 at 3.35 TB/s (NVIDIA's data sheet); probe_hits does a few
# integer operations a slot, so its bound is its bytes
HBM_BYTES_PER_S = 3.35e12


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
