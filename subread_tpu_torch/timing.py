"""Timing helpers shared by the port's scripts on the card (chip_smoke.py,
profile_torch_pe.py): a device stage timed by CUDA events and by the host
clock on the same calls, the host seconds spent in chosen functions while a
run goes on, and the vote of one sub-batch on the first index block."""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

from .ops.vote import vote_batch


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
    blk = al.dev_index.blocks[0]
    return vote_batch(codes, ambig, lens, blk.bucket_start, blk.comb,
                      blk.bucket_bits, vp, static_len=static_len,
                      sub_base=blk.sub_base, sub_lo=blk.sub_lo,
                      sub_bits=blk.sub_bits, search_steps=blk.search_steps)
