"""host.rescue_share: the host seconds in the port's host rescues
(Aligner._rescue_saturated, _rescue_saturated_pe and
align.indelevent.rescue_unmapped_mates, the name align/pipeline.py calls
it by) over the window's seconds, from the benchmark's spans around them in
a traced run."""


def read(ctx):
    if "rescue" not in ctx["host"]:
        return None
    return ctx["host"]["rescue"] / ctx["window_s"]
