"""probe_hits_roofline: the least time the card could take over the
probe_hits launches of the traced window, their bytes (the frozen
probe_bytes.probe_hits_bytes, counted once the window has closed) at 3.35
TB/s, over those launches' device time from the profiler, in percent.  The
card's power limit is printed beside it (nvidia-smi)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["probe_launches"] or t["probe_s"] <= 0 or t["bound_s"] <= 0:
        return None
    return 100.0 * t["bound_s"] / t["probe_s"]
