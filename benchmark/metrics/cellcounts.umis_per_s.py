"""cellcounts.umis_per_s: the distinct (cell, gene, UMI) triples the
counter's finalise took in (the port's `cellcounts.umis` counters), over
the seconds of the `cellcounts.finalise` spans (dedup, UMI merge, cell
calling and the matrix files), in the traced window.  Read from what
`subread_tpu_torch.timing` records while the window's profiler runs; None
where it recorded no such span or counter."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "counters"):
        return None
    ns = sum(s.end_ns - s.start_ns for s in timing.spans() if s.name == "cellcounts.finalise")
    umis = sum(c.value for c in timing.counters() if c.name == "cellcounts.umis")
    if ns <= 0 or not umis:
        return None
    return umis / (ns / 1e9)
