"""cellcounts.barcode_share: the seconds of the port's `cellcounts.barcode`
spans (matching a batch's R1 barcodes against the whitelist, exact and
within one base, and packing its (cell, gene, UMI) triples), over the
traced window's seconds. Read from what `subread_tpu_torch.timing` records
while the window's profiler runs; None where it recorded no such span."""

from benchmark.cell_spans import share_or_none


def read(ctx):
    return share_or_none(ctx, "cellcounts.barcode")
