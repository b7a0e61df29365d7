"""host.submit.launch_share: the host seconds in which `submit_batch` and
`submit_batch_pe` queue each sub-batch's device step (`_device_align`,
`_device_align_pe`: the vote, scan-2 and the rescue fold, launched without
waiting for the card; `submit.launch` spans), over the window's seconds.
Read from the spans `subread_tpu_torch.timing` records while the traced
window's profiler runs.  A program without that recorder gives None; one
that has it and recorded no launch raises."""


def read(ctx):
    from subread_tpu_torch import timing

    if not hasattr(timing, "spans"):
        return None
    ns = [s.end_ns - s.start_ns for s in timing.spans() if s.name == "submit.launch"]
    if not ns:
        raise RuntimeError("the traced window recorded no submit.launch span")
    return sum(ns) / 1e9 / ctx["window_s"]
