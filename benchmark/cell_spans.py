"""Shares of a traced window in spans of the port's recorder
(`subread_tpu_torch.timing`) that read nothing where the program recorded
no such span, as a program without them records none: the cellcounts.*
metrics."""


def share_or_none(ctx, name: str):
    """The summed durations of the recorded spans called name over the
    window's seconds, or None where there is none."""
    from subread_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    ns = [s.end_ns - s.start_ns for s in timing.spans() if s.name == name]
    if not ns:
        return None
    return sum(ns) / 1e9 / ctx["window_s"]
