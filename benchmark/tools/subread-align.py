"""subread-align: FASTQ in, BAM out, as `subread-align` runs it."""

from benchmark.aligner import AlignerTool

TOOL = AlignerTool("subread_tpu_torch.tools.align", subjunc=False)
