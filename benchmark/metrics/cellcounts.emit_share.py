"""cellcounts.emit_share: the seconds of the port's `cellcounts.emit` spans
(encoding a batch's BAM records with their CB, UB and GX tags in one native
call, the BGZF deflates inside, and the BAM's close), over the traced
window's seconds. Read from what `subread_tpu_torch.timing` records while
the window's profiler runs; None where it recorded no such span."""

from benchmark.cell_spans import share_or_none


def read(ctx):
    return share_or_none(ctx, "cellcounts.emit")
