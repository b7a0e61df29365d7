"""cellcounts.align_share: the seconds of the port's `cellcounts.align` spans
(a batch's `Aligner.align_batch` on its R2 reads: the upload and queueing
of the device step, the wait for its results and the host rescues), over
the traced window's seconds. Read from what `subread_tpu_torch.timing`
records while the window's profiler runs; None where it recorded no such
span."""

from benchmark.cell_spans import share_or_none


def read(ctx):
    return share_or_none(ctx, "cellcounts.align")
