"""ops.kernels_per_read: the CUDA kernels the profiler saw run inside the
traced window, over the reads (each mate counted) the window aligned."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["kernels"] or not ctx["reads"]:
        return None
    return t["kernels"] / ctx["reads"]
