"""The recorder's clock on a card: under the CUDA-only profiler a
benchmark's traced run uses, spans are recorded, and a span around a sleep
kernel and the synchronise after it holds the kernel's device interval and
ends within 2 ms of it.  Skips where no card is present."""

import pytest
import torch

from subread_tpu_torch import timing


@pytest.mark.gpu
def test_a_span_holds_the_kernel_it_waits_for():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    timing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert timing.recording()
        with timing.span("sleep"):
            torch.cuda._sleep(20_000_000)     # about 10 ms
            torch.cuda.synchronize()
    assert not timing.recording()
    (s,) = timing.spans()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA" and "spin_kernel" in e.name()]
    assert len(kernels) == 1, [e.name() for e in kernels]
    k0 = kernels[0].start_ns()
    k1 = k0 + kernels[0].duration_ns()
    assert k1 - k0 > 1_000_000, (k0, k1)
    assert s.start_ns <= k0 and k1 <= s.end_ns, (s, k0, k1)
    assert s.end_ns - k1 < 2_000_000, (s.end_ns - k1)
