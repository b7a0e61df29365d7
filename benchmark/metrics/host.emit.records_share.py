"""host.emit.records_share: the self time of the port's `emit` spans, which
is record assembly (building each record and formatting it), over the
window's seconds.  Self time is an emit span's duration less the packing
counted in it (`bam.pack_ns`) and its child spans, the `bgzf.deflate`
flushes, which never overlap.  Read from what `subread_tpu_torch.timing`
records while the traced window's profiler runs (a run's only profiler
session).  A program without that recorder gives None; one that has it and
recorded no emit span raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    spans = timing.spans()
    emit = {i for i, s in enumerate(spans) if s.name == "emit"}
    if not emit:
        raise RuntimeError("the traced window recorded no emit span")
    ns = sum(spans[i].end_ns - spans[i].start_ns for i in emit)
    ns -= sum(s.end_ns - s.start_ns for s in spans if s.parent in emit)
    ns -= sum(c.value for c in timing.counters() if c.name == "bam.pack_ns")
    return ns / 1e9 / ctx["window_s"]
