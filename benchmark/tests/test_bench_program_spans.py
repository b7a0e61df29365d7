"""The readers of the program's own spans and counters, on the CPU at the
size test_bench_correct.py uses: a traced run of each cell (the harness on
the CPU, its profiler on CPU ops) reports every one of them; record
assembly, the packing counted in `emit` and the deflates inside it add up
to the program's `emit` spans; and those agree with the benchmark's own
spans around `_emit_sam*` (host.emit_share)."""

import time

import pytest

from benchmark.harness import run_cell
from benchmark.spec import Spec

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.data["workloads"]]
READERS = ("host.emit.records_share", "host.emit.pack_share",
           "host.emit.deflate_share", "host.emit.deflate_mb_per_s",
           "host.submit.launch_share")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_spans(cell, index_cache, small):
    import torch

    from subread_tpu_torch import timing

    torch.set_num_threads(4)
    timing.clear()
    r = run_cell(Spec(), cell, 20261018, 1.0, True, time.perf_counter(),
                 device="cpu", overrides=small, cache=index_cache,
                 log=lambda s: None)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in READERS:
        assert m.get(name, 0) > 0, name
    window = r["window_s"]
    spans = timing.spans()
    emit = {i for i, s in enumerate(spans) if s.name == "emit"}
    emit_s = sum(spans[i].end_ns - spans[i].start_ns for i in emit) / 1e9
    deflate_in_emit = sum(s.end_ns - s.start_ns for s in spans
                          if s.name == "bgzf.deflate" and s.parent in emit) / 1e9
    parts = (m["host.emit.records_share"] + m["host.emit.pack_share"]) * window \
        + deflate_in_emit
    assert abs(parts - emit_s) <= 0.01 * emit_s, (parts, emit_s)
    # the program's emit against the benchmark's spans around _emit_sam*
    assert abs(emit_s - m["host.emit_share"] * window) <= 0.02 * window
