"""host.emit.deflate_mb_per_s: uncompressed BAM megabytes (1e6 bytes) the
port's BGZF flushes take in (`bgzf.bytes_in` counters) per second of those
flushes (`bgzf.deflate` spans), over the traced window.  Read from what
`subread_tpu_torch.timing` records while the window's profiler runs.  A
program without that recorder gives None; one that has it and recorded no
flush raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "counters"):
        return None
    ns = sum(s.end_ns - s.start_ns for s in timing.spans() if s.name == "bgzf.deflate")
    n_in = sum(c.value for c in timing.counters() if c.name == "bgzf.bytes_in")
    if ns <= 0 or not n_in:
        raise RuntimeError("the traced window recorded no bgzf.deflate bytes")
    return n_in / 1e6 / (ns / 1e9)
