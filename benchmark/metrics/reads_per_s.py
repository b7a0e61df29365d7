"""reads_per_s: every read the window fed to the aligner (each mate
counted), all aligned and written to the BAM, over the seconds from the
call of align_file or align_file_pe to its return with the BAM closed (the
host clock, the card synchronised)."""


def read(ctx):
    return ctx["reads"] / ctx["window_s"]
