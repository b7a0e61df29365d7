"""device.idle: 1 minus the union of the intervals in which an operation
ran on the card, over the traced window's seconds (torch.profiler)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
