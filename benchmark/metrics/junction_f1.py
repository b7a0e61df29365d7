"""junction_f1: the F1 of the window's junction table against the planted
junctions.  Recall is over the junctions that the reads the window fed
cross with both flanks at least 17 bases in one of them; precision is the
share of the table's rows (contig, edges, donor strand) that some fed read
crosses.  F1 = 2 P R / (P + R)."""

from benchmark.reference.check import junction_strands


def read(ctx):
    pool = ctx["pool"]
    if pool.junctions is None:
        return None
    names = ctx["genome"].names
    planted, strong = set(), set()
    for r in range(min(ctx["n_fed"], len(pool))):
        for c, le, re_, ds, s in pool.junctions[r]:
            key = (names[c], le, re_, ds)
            planted.add(key)
            if s:
                strong.add(key)
    table = junction_strands(ctx["out"] + ".junction.bed")
    if not table or not strong:
        return None
    p = len(table & planted) / len(table)
    r = len(table & strong) / len(strong)
    return 2 * p * r / (p + r) if p + r else 0.0
