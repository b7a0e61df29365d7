"""subjunc: FASTQ in, BAM and the junction table out, as `subjunc` runs it."""

from benchmark.aligner import AlignerTool

TOOL = AlignerTool("subread_tpu_torch.tools.subjunc", subjunc=True)
