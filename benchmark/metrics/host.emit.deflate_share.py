"""host.emit.deflate_share: the seconds of the port's BGZF flushes
(`BamWriter._flush`: deflate and write, `bgzf.deflate` spans), inside
`emit` and at the BAM's close, over the window's seconds.  Read from the
spans `subread_tpu_torch.timing` records while the traced window's profiler
runs.  A program without that recorder gives None; one that has it and
recorded no flush raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    ns = [s.end_ns - s.start_ns for s in timing.spans() if s.name == "bgzf.deflate"]
    if not ns:
        raise RuntimeError("the traced window recorded no bgzf.deflate span")
    return sum(ns) / 1e9 / ctx["window_s"]
