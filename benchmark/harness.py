"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the metrics.

What a run does with its configuration belongs to the configuration's tool
(`tools/<tool>.py`, found by the `tool` of the configuration's file): its
set-up and warm-up, its window, its spans, its planted faults and its check.
This file is what every tool shares: the clock, the profiler, the card's
memory peak, freeing the program's state before the check, the comparison of
each checked number with its limit, and the metrics' readers.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import tempfile
import time
from pathlib import Path

from .frozen.host_seconds import host_seconds

HERE = Path(__file__).resolve().parent
CACHE = HERE / "cache"


class Run:
    """The state of one run, which the tool fills in as it goes."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             fault: str | None = None, overrides: dict | None = None,
             cache: Path = CACHE, log=print) -> dict:
    """One run of the cell; returns the result line's fields and the
    numbers compared for `correct` (under "checks", each [value, limit])."""
    import torch

    ov = overrides or {}
    cell = spec.workload(workload)
    config = {**spec.config(cell["config"]), **ov.get("config", {})}
    tool = spec.tool(config["tool"])
    cuda = device.startswith("cuda")
    run = Run(config=config, traffic=spec.traffic(cell["traffic"]),
              limits={**spec.limits(workload), **ov.get("limits", {})},
              key=seed % (1 << 63), device=device, control=control,
              overrides=ov, cache=cache, log=log,
              sync=torch.cuda.synchronize if cuda else (lambda: None),
              steps={"imports": time.perf_counter() - t_start},
              tmp=tempfile.mkdtemp(prefix="bench-"))
    try:
        tool.setup(run)
        undo = tool.plant(run, fault) if fault else (lambda: None)
        setup_s = time.perf_counter() - t_start
        spans: list = []
        secs: dict = {}
        prof = None
        try:
            with contextlib.ExitStack() as stack:
                if trace:
                    from torch.profiler import ProfilerActivity, profile

                    stack.enter_context(tool.traced(run))
                    secs = stack.enter_context(host_seconds(tool.spans(), spans=spans))
                    prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                                   else [ProfilerActivity.CPU])
                    prof.start()
                    stack.callback(prof.stop)
                w0_ns = time.time_ns()
                run.w0 = time.perf_counter()
                tool.window(run, run.w0 + seconds)
                run.sync()
                window_s = time.perf_counter() - run.w0
                w1_ns = time.time_ns()
        finally:
            undo()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        trace_sum = None
        if trace:
            from .trace import device_events, summarise

            trace_sum = summarise(device_events(prof), w0_ns, w1_ns, spans,
                                  tool.kernel)
            trace_sum["window_s"] = window_s
            trace_sum.update(tool.trace_extra(run))
            prof = None
        tool.release(run)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- the reference judges what the window produced ----------------
        t = time.perf_counter()
        checks = tool.check(run)
        check_s = time.perf_counter() - t
        compared = {k: [v.item() if hasattr(v, "item") else v, run.limits[k]]
                    for k, v in checks.items()}
        correct = all(v <= lim for v, lim in compared.values())

        ctx = dict(cell=cell, config=config, setup_s=setup_s, window_s=window_s,
                   host=secs, trace=trace_sum, **tool.context(run))
        metrics = {}
        for m in spec.metrics(workload, trace):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"bench: {workload} seed {seed}: {run.reads} reads in "
            f"{window_s:.3f}s, set-up {setup_s:.3f}s ({tool.summary(run)}), "
            f"check {check_s:.1f}s; steps "
            + ", ".join(f"{k} {v:.2f}s" for k, v in run.steps.items()))
        result = dict(correct=bool(correct), attempted=run.reads,
                      failed=int(run.failed), metrics=metrics,
                      memory_peak_bytes=int(memory_peak), checks=compared)
        if trace:
            result["busy_s"] = trace_sum["busy_s"]
            result["window_s"] = window_s
            result["breakdown"] = dict(device_ops=trace_sum["device_ops"],
                                       idle_gaps=trace_sum["idle_gaps"])
        return result
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
