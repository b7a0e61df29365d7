"""cellcounts.assign_share: the seconds of the port's `cellcounts.assign`
spans (the annotation's rescoring of each read's candidates, its contig and
offset, and the gene of its record), over the traced window's seconds. Read
from what `subread_tpu_torch.timing` records while the window's profiler
runs; None where it recorded no such span."""

from benchmark.cell_spans import share_or_none


def read(ctx):
    return share_or_none(ctx, "cellcounts.assign")
