"""Host seconds spent in chosen functions while a run goes on.

Copied from `subread_tpu_torch/timing.py::host_seconds` at commit
7c152797eaed1811dec0341cbdfcc3f26f815f9f, with one addition: each call is
also kept as a span (label, start ns, end ns on the wall clock the profiler
uses), so a traced run can say what the host was doing while the card
idled.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def host_seconds(steps, sync=None, spans=None):
    """While active, each call of owner.name, for each (owner, name, label)
    or (owner, name, label, device_step) of steps, adds its host-clock
    seconds to the yielded dict under label; a device step's time runs to
    sync() after it.  owner is a class, an instance or a module; a nested
    call counts in its caller's entry too.  Where spans is a list, each
    call appends (label, start_ns, end_ns) to it.  The originals come back
    on exit."""
    secs = {}
    missing = object()
    saved = []

    def wrap(fn, label, device_step):
        def timed(*a, **k):
            t = time.perf_counter()
            w = time.time_ns()
            try:
                out = fn(*a, **k)
                if device_step and sync is not None:
                    sync()
                return out
            finally:
                secs[label] += time.perf_counter() - t
                if spans is not None:
                    spans.append((label, w, time.time_ns()))
        return timed

    for owner, name, label, *device_step in steps:
        secs.setdefault(label, 0.0)
        saved.append((owner, name, vars(owner).get(name, missing)))
        setattr(owner, name,
                wrap(getattr(owner, name), label, any(device_step)))
    try:
        yield secs
    finally:
        for owner, name, orig in reversed(saved):
            if orig is missing:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
