"""true_placed: the share of the window's reads (each mate counted) whose
primary record is mapped, on the contig of the read's planted origin, with
its reference interval [POS, POS + the bases its CIGAR consumes of the
reference) overlapping the origin's, and on the origin's strand.  A chimeric
mate's origin is either of its two pieces, on either strand.  A read the BAM
lacks counts as not placed."""

import numpy as np


def read(ctx):
    rec, ids, pool = ctx["records"], ctx["ids"], ctx["pool"]
    if len(ids) == 0:
        return None
    where = {n: c for c, n in enumerate(ctx["genome"].names)}
    cmap = np.asarray([where.get(n, -1) for n in rec.ref_names] + [-1], np.int64)
    span = rec.ref_spans()
    k = np.arange(len(ids)) % len(pool)
    placed = 0
    for m in range(pool.mates):
        i = ids[:, m]
        have = i >= 0
        j = np.where(have, i, 0)
        flag = rec.flag[j]
        c = cmap[np.where(rec.ref_id[j] >= 0, rec.ref_id[j], -1)]
        lo = rec.pos[j]
        hi = lo + span[j]
        ok = have & ((flag & 0x904) == 0)
        rev = pool.reverse[m][k]
        strand = (rev < 0) | (((flag & 0x10) != 0) == (rev == 1))
        first = (c == pool.contig[m][k]) & (lo < pool.end[m][k]) & (hi > pool.start[m][k])
        second = ((pool.second[m][k] >= 0) & (c == pool.second[m][k])
                  & (lo < pool.end2[m][k]) & (hi > pool.start2[m][k]))
        placed += int((ok & strand & (first | second)).sum())
    return placed / (len(ids) * pool.mates)
