"""setup.index_load_s: the seconds of load_index_any on the cached index
plus the Aligner's upload of it to the card (the host clock, the card
synchronised), the two steps run_align splits as time_load and
time_upload."""


def read(ctx):
    return ctx["index_load_s"] + ctx["upload_s"]
