"""host.emit.pack_share: the seconds the port's BAM writer spends packing
records (`BamWriter.add_sam_fields`, its flushes left out), counted per
chunk as `bam.pack_ns` inside `emit`, over the window's seconds.  Read from
what `subread_tpu_torch.timing` records while the traced window's profiler
runs.  A program without that recorder gives None; one that has it and
recorded no packing raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "counters"):
        return None
    ns = [c.value for c in timing.counters() if c.name == "bam.pack_ns"]
    if not ns:
        raise RuntimeError("the traced window recorded no bam.pack_ns")
    return sum(ns) / 1e9 / ctx["window_s"]
