"""setup_s: seconds from the start of the process to the first read of the
window (the host clock), as harness.run_cell takes them."""


def read(ctx):
    return ctx["setup_s"]
