"""host.emit.native_share: the share of the window's BAM records that the
port packed with its native encoder (`native.format_bam_records`), of all
it packed: the `bam.records_native` counters over those and the
`bam.records_python` counters (`BamWriter.add_sam_fields`), each counted
per `emit` while the traced window's profiler runs.  A program without
those counters gives None; one that has them and packed no record
raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "counters"):
        return None
    native = python = 0
    seen = False
    for c in timing.counters():
        if c.name == "bam.records_native":
            native, seen = native + c.value, True
        elif c.name == "bam.records_python":
            python, seen = python + c.value, True
    if not seen:
        return None
    if native + python == 0:
        raise RuntimeError("the traced window packed no BAM record")
    return native / (native + python)
