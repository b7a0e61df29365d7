"""cellcounts.finalise_share: the seconds of the port's `cellcounts.finalise`
spans (the UMI dedup and merge, cell calling and the matrix files, once the
last batch is counted), over the traced window's seconds. Read from what
`subread_tpu_torch.timing` records while the window's profiler runs; None
where it recorded no such span."""

from benchmark.cell_spans import share_or_none


def read(ctx):
    return share_or_none(ctx, "cellcounts.finalise")
