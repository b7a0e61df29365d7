"""host.submit.graph_share: the share of the window's sub-batch device
steps that `submit_batch` and `submit_batch_pe` replayed as CUDA graphs, of
all they queued: the `submit.graph_steps` counters over those and the
`submit.eager_steps` counters, one a step while the traced window's
profiler runs.  A program without those counters gives None; one that has
them and queued no step raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "counters"):
        return None
    graph = eager = 0
    seen = False
    for c in timing.counters():
        if c.name == "submit.graph_steps":
            graph, seen = graph + c.value, True
        elif c.name == "submit.eager_steps":
            eager, seen = eager + c.value, True
    if not seen:
        return None
    if graph + eager == 0:
        raise RuntimeError("the traced window queued no sub-batch step")
    return graph / (graph + eager)
