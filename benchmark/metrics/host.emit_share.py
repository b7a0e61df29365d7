"""host.emit_share: the host seconds in the port's BAM emission
(Aligner._emit_sam, _emit_sam_pe) over the window's seconds, from the
benchmark's spans around those methods in a traced run."""


def read(ctx):
    if "emit" not in ctx["host"]:
        return None
    return ctx["host"]["emit"] / ctx["window_s"]
