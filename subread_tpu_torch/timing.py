"""Timing in the port: the span and counter recorder that the align
pipeline's host layers report to, and the helpers the port's scripts on
the card share (chip_smoke.py, profile_torch_pe.py, profile_probe_hits.py):
a device stage timed by CUDA events and by the host clock on the same
calls, the card's own time per call of a function with a cold L2 and the
host's launch time taken out, the host seconds spent in chosen functions
while a run goes on, and the vote of one sub-batch on the first index
block.

The recorder keeps every span and counter in memory while a torch.profiler
session records, and nothing else then: a span's times are on the wall
clock (`time.time_ns`) that the profiler's host and device events use, so
the spans lie on the profiler's timeline.  Outside a profiler session a
span only adds its seconds to a per-name total (`totals`), which the CLI
prints.  No span waits for the device: one around a launch times the
launch.  Spans carry the index of the input chunk whose work they do (-1
outside the chunks, as in set-up), set by `set_chunk`.  The recorder is
one per process and not thread-safe: the pipeline's host steps run on one
thread.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int     # -1 while the span is open
    parent: int     # index in spans() of the enclosing span; -1 for none
    chunk: int


class Counter(NamedTuple):
    name: str
    chunk: int
    value: int


_spans: list[Span] = []
_counters: list[Counter] = []
_totals: dict[str, int] = {}
_open: list[int] = []   # indices of the open recorded spans, innermost last
_chunk = -1


def recording() -> bool:
    """Whether a torch.profiler session records, and spans with it."""
    return torch.autograd._profiler_enabled()


def set_chunk(chunk: int) -> None:
    """The input chunk the spans and counters that follow belong to."""
    global _chunk
    _chunk = chunk


@contextlib.contextmanager
def span(name: str):
    """A span around the block (or, as a decorator, the call)."""
    if not recording():
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            _totals[name] = _totals.get(name, 0) + time.perf_counter_ns() - t
        return
    i, t = len(_spans), time.time_ns()
    _spans.append(Span(name, t, -1, _open[-1] if _open else -1, _chunk))
    _open.append(i)
    try:
        yield
    finally:
        end = time.time_ns()
        _open.pop()
        _spans[i] = _spans[i]._replace(end_ns=end)
        _totals[name] = _totals.get(name, 0) + end - t


def count(name: str, value: int) -> None:
    """Add value to the named counter of the current chunk, while the
    profiler records."""
    if recording():
        _counters.append(Counter(name, _chunk, int(value)))


def spans() -> list[Span]:
    """The spans recorded so far, in the order they opened; a span's
    parent indexes this list."""
    return list(_spans)


def counters() -> list[Counter]:
    return list(_counters)


def totals() -> dict[str, float]:
    """Seconds in each span name since the process started (or clear())."""
    return {k: v / 1e9 for k, v in _totals.items()}


def clear() -> None:
    """Forget every span, counter and total."""
    if _open:
        raise RuntimeError("clear() inside an open span")
    _spans.clear()
    _counters.clear()
    _totals.clear()


def stage_ms(fn, reps: int = 20, cuda: bool = True) -> tuple[float, float]:
    """Medians of reps timings of fn() after one warm-up call: CUDA-event
    ms (nan without a card) and host ms from a synchronised start to the
    synchronise after it, taken on the same calls."""
    fn()
    ev, wall = [], []
    for _ in range(reps):
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
        t = time.perf_counter()
        if cuda:
            a.record()
        fn()
        if cuda:
            b.record()
            b.synchronize()
            ev.append(a.elapsed_time(b))
        wall.append((time.perf_counter() - t) * 1e3)
    return (statistics.median(ev) if ev else float("nan"),
            statistics.median(wall))


def device_ms(fn, reps: int = 20, flush_mb: int = 256) -> float:
    """Milliseconds the card spends on one call of fn(), with a cold L2
    cache and without the host's time to launch it: before each call the
    card writes flush_mb MB (five times the H100's 50 MB L2), which evicts
    what the call before it left there, then runs a sleep kernel that
    holds the stream while the host queues the call, so the events around
    the call time its kernels alone.  The sleep is lengthened until it
    outlasts the queueing (a shorter one would leave the card waiting on
    the host again).  Each call is synchronised before the next, so the
    launch queue never fills.  The median over reps calls; fn must not
    synchronise."""
    fn()
    flush = torch.empty(flush_mb << 18, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    cycles, out = 1 << 20, []
    while len(out) < reps:
        if cycles > 1 << 32:
            raise RuntimeError("device_ms: the host never queued a call "
                               "within the sleep (does fn synchronise?)")
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        flush.zero_()
        t = time.perf_counter()
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        queued_ms = (time.perf_counter() - t) * 1e3
        b.synchronize()
        if s.elapsed_time(a) > queued_ms:
            out.append(a.elapsed_time(b))
        else:
            cycles *= 4
    return statistics.median(out)


@contextlib.contextmanager
def host_seconds(steps, sync=None):
    """While active, each call of owner.name, for each (owner, name, label)
    or (owner, name, label, device_step) of steps, adds its host-clock
    seconds to the yielded dict under label; a device step's time runs to
    sync() after it.  owner is a class, an instance or a module; a nested
    call counts in its caller's entry too.  The originals come back on
    exit."""
    secs = {}
    missing = object()
    saved = []

    def wrap(fn, label, device_step):
        def timed(*a, **k):
            t = time.perf_counter()
            try:
                out = fn(*a, **k)
                if device_step and sync is not None:
                    sync()
                return out
            finally:
                secs[label] += time.perf_counter() - t
        return timed

    for owner, name, label, *device_step in steps:
        secs[label] = 0.0
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


def first_block_vote(al, codes, ambig, lens, vp, static_len=None):
    """The vote of one uploaded sub-batch on the Aligner's first index
    block with VoteParams vp, as Aligner._device_align calls it."""
    from .ops.vote import vote_batch

    blk = al.dev_index.blocks[0]
    return vote_batch(codes, ambig, lens, blk.bucket_start, blk.comb,
                      blk.bucket_bits, vp, static_len=static_len,
                      sub_base=blk.sub_base, sub_lo=blk.sub_lo,
                      sub_bits=blk.sub_bits, search_steps=blk.search_steps)
